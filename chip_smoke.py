#!/usr/bin/env python3
"""Drive the PyTorch port's eval, train and stretch eval paths on one NVIDIA
GPU and check them.

    python3 chip_smoke.py [--profile DIR]

Phases, each printing one line:
  1. card       the card's name and power limit (nvidia-smi);
  2. build      nvcc build of ratrack_tpu_torch/csrc/*.cu: seconds, and
                registers / spill bytes per kernel from ptxas;
  3. kernel     every kernel at the main-path shapes (8 streams, 512-point
                clouds) against its plain PyTorch version on the same CUDA
                tensors: max abs error vs 1e-4 * max|plain| + 1e-5, selected
                indices equal, median CUDA-event times over 20 runs;
  4. slice      Track4D(npoint=512, k_max=32, sinkhorn_iters=500) with
                seeded random weights, the cached eval scan over 8
                synthetic streams x 4 frames on the GPU against the same
                weights and inputs on the CPU (plain versions): cls and
                flow within 1e-3, labels / track ids mismatching on at most
                1% of points / slots, kernel launch counts as expected;
  5. throughput the scan at 8 streams x 32 frames, frames/s (no gate);
  6. train_kernel the train kernels B9 (SA pair, 6 level configs) and B10
                (correlator, both stages) at the main-path shapes, forward
                and backward against their plain versions under autograd
                on the same CUDA tensors: outputs and batch statistics
                within 1e-4 * max|plain| + 1e-5, selections identical;
                every gradient with cosine >= 0.9999 and, in norm, no
                further from the plain version run in float64 than 1e-3
                of its norm plus twice the float32 plain version's
                distance (max-pool near-ties, see kernels/cases.py::
                compare_train); median CUDA-event ms of forward and
                backward;
  7. train_slice make_scan_train_step over 8 synthetic streams x 2 frames
                from the same seeded weights on the GPU (float32) and on
                the CPU (plain versions) in float64 and float32: against
                the float64 run, in norm, per-frame losses within 1e-3
                relative, each step's gradient leaves within 1e-3 of the
                whole gradient's norm, BN running statistics within 1e-4
                relative, each plus twice the CPU float32 run's own error
                (see phase_train_slice); train launch counts
                9T / 9T / 2T / 2T and no eval kernel; everything finite;
  8. train_throughput make_scan_train_step at 8 streams x 32 frames (the
                JAX scenario train_512pt_8streams): one warm-up, median of
                3, frames/s, ms/frame, peak device memory (no gate);
  9. stretch_kernel the stretch kernels at 8192 points, one stream, against
                their plain versions on the same CUDA tensors: B5 tiled kNN
                (both stages of the split correlator, Z-sorted clouds; also
                at 16384), B4 apply (both stages), B6 farthest point
                sampling (8192 points with the cloud mask, 512 with none;
                also 16384), B7 Sinkhorn (8 streams, m and n from 0..32);
                B1 and B2 again at 8192 points x 512 centers. Indices
                identical, values within phase 3's tolerance (B7: u, v and
                Z within 1e-4 on the valid block, the matching equal);
  10. stretch_slice Track4D(npoint=512, exact_fps, mov_budget=512,
                sinkhorn_kernel) at 8192 points, 1 stream x 2 frames on
                the GPU against the CPU (plain versions): phase 4's gates,
                launch counts 6T+3 / 6T+3 / 2T / 2T / 6T+3 / T for B1, B2,
                B5, B4, B6, B7 and none of B3;
  11. stretch_throughput the cached eval scan at 8192 x 16 frames and
                16384 x 8 frames, one stream, and the 512-point 8 x 32 scan
                with sinkhorn_kernel=True: one warm-up, median of 3,
                frames/s and peak device memory (no gate).
Then one JSON line with every kernel's route, source, launches (B1-B3
from phase 5's run, train kernels from phase 8's, B5 / B4 / B6 / B7 from
phase 11's 8192-point run), error, times summed over the calls one frame
step of that path makes (6 B1, 6 B2, 2 B3; 9 B9, 2 B10; 2 B5, 2 B4, 6 B6,
1 B7), the roofline bound of the same work (the larger of bytes / 3.35
TB/s and float32 operations / 67 TFLOP/s, counted by
kernels/cases.py::*_work) and, where one PyTorch call computes the same
function, that call's time; and last the result line. Any failed check
exits non-zero before the result line (phases 6-8 record their failed
checks and go on, so that one run reports all of them; the script then
exits non-zero). With no CUDA device, or without the ratrack_tpu_torch
package beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

N_STREAMS = 8
N_MAX = 512
K_MAX = 32
SINKHORN_ITERS = 500
SLICE_T = 4
SCAN_T = 32
TRAIN_SLICE_T = 2
TRAIN_SCAN_T = 32
STRETCH_N = 8192
STRETCH_BIG_N = 16384
STRETCH_NPOINT = 512
STRETCH_SLICE_T = 2
STRETCH_SCAN = ((8192, 16), (16384, 8))    # (points, frames), one stream
REPS = 20
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores

KERNELS = {
    "sa_pair": dict(
        source="ratrack_tpu_torch/csrc/sa_pair.cu",
        replaces="ratrack_tpu/ops/pallas_sa.py:192 (_sa_pair_kernel)"),
    "three_interpolate": dict(
        source="ratrack_tpu_torch/csrc/fp.cu",
        replaces="ratrack_tpu/ops/pallas_fp.py:54 (_fp_kernel)"),
    "knn_weight_aggregate": dict(
        source="ratrack_tpu_torch/csrc/correlator.cu",
        replaces="ratrack_tpu/ops/pallas_correlator.py:68 (_corr_kernel)"),
    "sa_pair_train_fwd": dict(
        source="ratrack_tpu_torch/csrc/sa_pair_train.cu",
        replaces="ratrack_tpu/ops/pallas_sa_train.py:1160 "
                 "(_pair_fwd_kernel_pk)"),
    "sa_pair_train_bwd": dict(
        source="ratrack_tpu_torch/csrc/sa_pair_train.cu",
        replaces="ratrack_tpu/ops/pallas_sa_train.py:1229 "
                 "(_pair_bwd_kernel_pk)"),
    "knn_weight_aggregate_train_fwd": dict(
        source="ratrack_tpu_torch/csrc/correlator.cu",
        replaces="ratrack_tpu/ops/pallas_correlator_train.py:184 "
                 "(_fwd_kernel)"),
    "knn_weight_aggregate_train_bwd": dict(
        source="ratrack_tpu_torch/csrc/correlator_train.cu",
        replaces="ratrack_tpu/ops/pallas_correlator_train.py:251 "
                 "(_bwd_kernel)"),
    "knn_tiled": dict(
        source="ratrack_tpu_torch/csrc/knn_tiled.cu",
        replaces="ratrack_tpu/ops/pallas_knn.py:81 (_knn_kernel)"),
    "knn_gather_apply": dict(
        source="ratrack_tpu_torch/csrc/correlator.cu",
        replaces="ratrack_tpu/ops/pallas_correlator.py:287 (_apply_kernel)"),
    "furthest_point_sample": dict(
        source="ratrack_tpu_torch/csrc/fps.cu",
        replaces="ratrack_tpu/ops/pallas_fps_kernel.py:63 (_fps_kernel)"),
    "sinkhorn_uv": dict(
        source="ratrack_tpu_torch/csrc/sinkhorn.cu",
        replaces="ratrack_tpu/ops/pallas_sinkhorn.py:44 (_kernel)"),
}
EVAL_KERNELS = ("sa_pair", "three_interpolate", "knn_weight_aggregate")
STRETCH_KERNELS = ("knn_tiled", "knn_gather_apply", "furthest_point_sample",
                   "sinkhorn_uv")
TRAIN_KERNELS = tuple(k for k in KERNELS
                      if k not in EVAL_KERNELS + STRETCH_KERNELS)


FAILED: list = []   # failed checks of phases 6-8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def record_failure(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    FAILED.append(msg)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def device_ms(torch, fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms. A spin kernel queued before the
    start event keeps the stream busy while the host enqueues fn's work,
    so host overhead does not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, name, got, want, got_idx, want_idx):
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item() + 1e-5
    idx_equal = bool(torch.equal(got_idx.long(), want_idx.long()))
    finite = bool(torch.isfinite(got).all().item())
    if not (err <= tol and idx_equal and finite):
        fail(f"{name}: max_abs_err {err} (tol {tol}), indices equal "
             f"{idx_equal}, finite {finite}")
    return err, tol


def new_summary(names):
    return {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None,
                    bytes=0, ops=0) for k in names}


def roofline(nbytes, ops):
    """(bound_ms, bound_by): the least time the card could take to move
    nbytes or to do ops float32 operations, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1000.0 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def tally(entry, weight, err, ms, plain_ms, library_ms, nbytes, ops):
    """Add `weight` calls of one config to a kernel's per-frame-step sums."""
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["ms"] += weight * ms
    entry["plain_ms"] += weight * plain_ms
    if library_ms is not None:
        entry["library_ms"] = (entry["library_ms"] or 0.0) + weight * library_ms
    entry["bytes"] += weight * nbytes
    entry["ops"] += weight * ops


def run_kernel_cases(torch, phase, runs, summary):
    """Each run: dict(kernel, config, run_k, run_p, check(got, want) ->
    (err, tol), work(got) -> (bytes, ops), library (a callable or None),
    weight (calls per frame step that count in the kernel's summary))."""
    with torch.inference_mode():
        for r in runs:
            got, want = r["run_k"](), r["run_p"]()
            torch.cuda.synchronize()
            err, tol = r["check"](got, want)
            nbytes, ops = r["work"](got)
            bound_ms, bound_by = roofline(nbytes, ops)
            ms = device_ms(torch, r["run_k"])
            plain_ms = device_ms(torch, r["run_p"])
            library_ms = (device_ms(torch, r["library"])
                          if r.get("library") else None)
            emit(phase=phase, kernel=r["kernel"], config=r["config"],
                 max_abs_err=err, tol=tol, indices_equal=True, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=bound_ms, bound_by=bound_by)
            tally(summary[r["kernel"]], r.get("weight", 1), err, ms,
                  plain_ms, library_ms, nbytes, ops)
            del got, want


def check_sa(torch, name):
    def check(got, want):
        errs = [compare(torch, f"{name}.{t}", got[i], want[i], got[i + 2],
                        want[i + 2]) for i, t in enumerate("ab")]
        return max(e for e, _ in errs), min(t for _, t in errs)
    return check


def check_out_idx(torch, name):
    return lambda got, want: compare(torch, name, got[0], want[0], got[1],
                                     want[1])


def sa_run(torch, cases, fused_sa, name, kw, weight=1):
    return dict(kernel="sa_pair", config=name, weight=weight,
                run_k=lambda: fused_sa.sa_pair(**kw, return_indices=True),
                run_p=lambda: fused_sa.sa_pair_reference(**kw),
                check=check_sa(torch, f"sa_pair[{name}]"),
                work=lambda got: cases.sa_pair_work(kw, *got))


def fp_run(torch, cases, fused_fp, name, kw, weight=1):
    return dict(kernel="three_interpolate", config=name, weight=weight,
                run_k=lambda: fused_fp.fused_three_interpolate(
                    **kw, return_indices=True),
                run_p=lambda: fused_fp.three_interpolate_reference(**kw),
                check=check_out_idx(torch, f"three_interpolate[{name}]"),
                work=lambda got: cases.three_interpolate_work(kw, got[0]),
                # one library call for the 3-NN selection: top-3 of the
                # dense distance matrix
                library=lambda: torch.topk(
                    torch.cdist(kw["unknown"], kw["known"]), 3, dim=-1,
                    largest=False))


def phase_kernels(torch, seed: int):
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_correlator, fused_fp, fused_sa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    pc1, m1, pc2, m2 = cases.clouds(seed, N_STREAMS, N_MAX)
    runs = []
    for head in ("pn_head", "mse"):
        for level in cases.SA_LEVELS:
            kw = cases.to_device(cases.sa_case(level, head, pc1, m1, gen),
                                 dev)
            runs.append(sa_run(torch, cases, fused_sa, f"{head}.{level}", kw))
        for level in cases.FP_LEVELS:
            kw = cases.to_device(cases.fp_case(level, pc1, m1, gen), dev)
            runs.append(fp_run(torch, cases, fused_fp, f"{head}.{level}", kw))
    for stage in (1, 2):
        kw = cases.to_device(cases.corr_case(stage, pc1, m1, pc2, m2, gen),
                             dev)
        runs.append(dict(
            kernel="knn_weight_aggregate", config=f"stage{stage}",
            run_k=lambda kw=kw: fused_correlator.fused_knn_weight_aggregate(
                **kw, return_indices=True),
            run_p=lambda kw=kw:
            fused_correlator.knn_weight_aggregate_reference(**kw),
            check=check_out_idx(torch, f"knn_weight_aggregate[stage{stage}]"),
            work=lambda got, kw=kw: cases.corr_work(kw, got[0])))
    summary = new_summary(EVAL_KERNELS)
    run_kernel_cases(torch, "kernel", runs, summary)
    return summary


def phase_stretch_kernels(torch, seed: int):
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import (fused_correlator, fused_fp, fused_knn,
                                       fused_sa, fused_sinkhorn, sampling)
    from ratrack_tpu_torch.tracker import associate

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 2)
    clouds = {n: cases.stretch_clouds(seed, n)
              for n in (STRETCH_N, STRETCH_BIG_N)}
    pc1, m1, pc2, m2 = clouds[STRETCH_N]
    runs = []

    def check_knn(name):
        def check(got, want):
            idx_ok = bool(torch.equal(got[0], want[0]))
            valid_ok = bool(torch.equal(got[2], want[2]))
            want_keys = want[1][want[2]]
            err = ((got[1][want[2]] - want_keys).abs().max().item()
                   if valid_ok and want_keys.numel() else 0.0)
            tol = 1e-4 * want_keys.abs().max().item() + 1e-5
            if not (idx_ok and valid_ok and err <= tol):
                fail(f"{name}: indices equal {idx_ok}, validity equal "
                     f"{valid_ok}, key err {err} (tol {tol})")
            return err, tol
        return check

    def library_knn(kw):
        # one library selection: top-16 of the masked dense distance matrix
        gone = ~kw["points_mask"].unsqueeze(1)
        return lambda: torch.topk(
            torch.cdist(kw["query"], kw["points"]).masked_fill_(
                gone, float("inf")), kw["k"], dim=-1, largest=False)

    for n, (c1, cm1, c2, cm2) in clouds.items():
        for stage in (1, 2):
            if n != STRETCH_N and stage == 2:
                continue
            kw = cases.to_device(cases.knn_tiled_case(stage, c1, cm1, c2,
                                                      cm2), dev)
            name = f"{n}.stage{stage}"
            runs.append(dict(
                kernel="knn_tiled", config=name,
                weight=int(n == STRETCH_N),
                run_k=lambda kw=kw: fused_knn.knn_indices_tiled(
                    **kw, return_keys=True),
                run_p=lambda kw=kw: fused_knn.knn_indices_tiled_reference(
                    **kw),
                check=check_knn(f"knn_tiled[{name}]"),
                work=lambda got, kw=kw: cases.knn_tiled_work(kw, got[0],
                                                             got[1]),
                library=library_knn(kw)))

    for stage in (1, 2):
        kw = cases.to_device(cases.apply_case(stage, pc1, m1, pc2, m2, gen),
                             dev)
        name = f"{STRETCH_N}.stage{stage}"

        def check_apply(got, want, kw=kw, name=name):
            return compare(torch, f"knn_gather_apply[{name}]", got, want,
                           kw["idx"], kw["idx"])
        runs.append(dict(
            kernel="knn_gather_apply", config=name,
            run_k=lambda kw=kw: fused_correlator.knn_gather_apply(**kw),
            run_p=lambda kw=kw: fused_correlator.knn_gather_apply_reference(
                **kw),
            check=check_apply,
            work=lambda got, kw=kw: cases.corr_work(kw, got, select=False)))

    def check_fps(name):
        def check(got, want):
            bad = int((got != want).sum())
            if bad:
                fail(f"{name}: {bad} of {want.numel()} samples differ")
            return 0.0, 0.0
        return check

    centers = cases.fps_centers(pc1, m1, STRETCH_NPOINT)
    # per 8192-point frame step: sa1 of both heads on the cloud, sa2 and
    # sa3 of both heads on the 512 centers with no mask
    for name, xyz, mask, weight in (
            (f"{STRETCH_N}.masked", pc1, m1, 2),
            (f"{STRETCH_NPOINT}.nomask", centers, None, 4),
            (f"{STRETCH_BIG_N}.masked", clouds[STRETCH_BIG_N][0],
             clouds[STRETCH_BIG_N][1], 0)):
        kw = cases.to_device(cases.fps_case(xyz, mask, STRETCH_NPOINT), dev)
        runs.append(dict(
            kernel="furthest_point_sample", config=name, weight=weight,
            run_k=lambda kw=kw: sampling.furthest_point_sample(**kw),
            run_p=lambda kw=kw: sampling.furthest_point_sample_reference(
                **kw),
            check=check_fps(f"furthest_point_sample[{name}]"),
            work=lambda got, kw=kw: cases.fps_work(kw, got)))

    kw, meta = cases.sinkhorn_case(seed, N_STREAMS, K_MAX, SINKHORN_ITERS)
    kw, meta = cases.to_device(kw, dev), cases.to_device(meta, dev)

    def check_sinkhorn(got, want):
        """u, v on the valid rows / columns and Z on the valid block within
        1e-4 absolute (the kernel sums in another order than torch, a few
        ulps an iteration); the matching equal."""
        k = K_MAX
        ar = torch.arange(k + 1, device=dev)
        rows = (ar < meta["m"].unsqueeze(1)) | (ar == k)
        cols = (ar < meta["n"].unsqueeze(1)) | (ar == k)
        err = max((got[0] - want[0])[rows].abs().max().item(),
                  (got[1] - want[1])[cols].abs().max().item())
        z = [kw["c"] + u.unsqueeze(2) + v.unsqueeze(1)
             - meta["norm"].reshape(-1, 1, 1) for u, v in (got, want)]
        block = rows.unsqueeze(2) & cols.unsqueeze(1)
        err = max(err, (z[0] - z[1])[block].abs().max().item())
        prev = torch.arange(k, device=dev, dtype=torch.int32).expand(
            N_STREAMS, k).contiguous()
        nxt = torch.full((N_STREAMS,), k, device=dev, dtype=torch.int32)
        a, b = [associate(meta["scores"], meta["m"], meta["n"], prev, nxt,
                          0.9, SINKHORN_ITERS, 0.01, use_fused_kernel=fused)
                for fused in (True, False)]
        same = (torch.equal(a.matched_prev, b.matched_prev)
                and torch.equal(a.track_id, b.track_id))
        finite = bool(torch.isfinite(got[0]).all()
                      and torch.isfinite(got[1]).all())
        if not (err <= 1e-4 and same and finite):
            fail(f"sinkhorn_uv: max abs err {err} (tol 1e-4), matching "
                 f"equal {same}, finite {finite}")
        return err, 1e-4
    runs.append(dict(
        kernel="sinkhorn_uv", config=f"{N_STREAMS}x{K_MAX + 1}",
        run_k=lambda: fused_sinkhorn.sinkhorn_uv(**kw),
        run_p=lambda: fused_sinkhorn.sinkhorn_uv_reference(**kw),
        check=check_sinkhorn,
        work=lambda got: cases.sinkhorn_work(kw, *got)))

    # B1 and B2 where N != M: the cloud against its 512 sampled centers
    for head in ("pn_head", "mse"):
        sa_kw = cases.to_device(cases.sa_case(
            "sa1", head, pc1, m1, gen, npoint=STRETCH_NPOINT), dev)
        runs.append(sa_run(torch, cases, fused_sa,
                           f"{STRETCH_N}.{head}.sa1", sa_kw, weight=0))
    fp_kw = cases.to_device(cases.fp_case("fp1", pc1, m1, gen,
                                          npoint=STRETCH_NPOINT), dev)
    runs.append(fp_run(torch, cases, fused_fp, f"{STRETCH_N}.fp1", fp_kw,
                       weight=0))

    summary = new_summary(STRETCH_KERNELS + ("sa_pair", "three_interpolate"))
    run_kernel_cases(torch, "stretch_kernel", runs, summary)
    return {k: summary[k] for k in STRETCH_KERNELS}


def counters():
    from ratrack_tpu_torch.ops import (fused_correlator,
                                       fused_correlator_train, fused_fp,
                                       fused_knn, fused_sa, fused_sa_train,
                                       fused_sinkhorn, sampling)
    return {"knn_tiled": fused_knn.knn_indices_tiled,
            "knn_gather_apply": fused_correlator.knn_gather_apply,
            "furthest_point_sample": sampling.furthest_point_sample,
            "sinkhorn_uv": fused_sinkhorn.sinkhorn_uv,
            "sa_pair": fused_sa.sa_pair,
            "three_interpolate": fused_fp.fused_three_interpolate,
            "knn_weight_aggregate":
                fused_correlator.fused_knn_weight_aggregate,
            "sa_pair_train_fwd": fused_sa_train.sa_pair_train_fwd,
            "sa_pair_train_bwd": fused_sa_train.sa_pair_train_bwd,
            "knn_weight_aggregate_train_fwd":
                fused_correlator_train.knn_weight_aggregate_train_fwd,
            "knn_weight_aggregate_train_bwd":
                fused_correlator_train.knn_weight_aggregate_train_bwd}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {k: fn.launches for k, fn in counters().items()}


def expected_launches(t: int):
    # per frame: pn_head(pc1) + decoder mse = 6 SA pairs and 6 FP; 2
    # correlator stages; plus the pc2 head once at block entry (3 + 3)
    return {**{k: 0 for k in TRAIN_KERNELS + STRETCH_KERNELS},
            "sa_pair": 6 * t + 3, "three_interpolate": 6 * t + 3,
            "knn_weight_aggregate": 2 * t}


def expected_stretch_launches(t: int):
    # as expected_launches, with the split correlator (a tiled kNN and an
    # apply per stage) in place of B3, a farthest point sampling per SA
    # level and one Sinkhorn launch per frame
    return {**{k: 0 for k in TRAIN_KERNELS}, "knn_weight_aggregate": 0,
            "sa_pair": 6 * t + 3, "three_interpolate": 6 * t + 3,
            "knn_tiled": 2 * t, "knn_gather_apply": 2 * t,
            "furthest_point_sample": 6 * t + 3, "sinkhorn_uv": t}


def expected_train_launches(t: int):
    # per frame step: 3 PNHeads (pc1, pc2, the decoder's mse) x 3 SA
    # levels, forward and backward; 2 correlator stages; no eval kernel
    return {**{k: 0 for k in EVAL_KERNELS + STRETCH_KERNELS},
            "sa_pair_train_fwd": 9 * t, "sa_pair_train_bwd": 9 * t,
            "knn_weight_aggregate_train_fwd": 2 * t,
            "knn_weight_aggregate_train_bwd": 2 * t}


def make_frames(torch, seed: int, t: int, device, n_max: int = N_MAX,
                streams: int = N_STREAMS, n_static: int = 300):
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, \
        to_tensors
    clips = [stack_frames(synthetic_clip(seed + s, t, n_max=n_max,
                                         g_max=K_MAX, n_static=n_static,
                                         n_objects=5))
             for s in range(streams)]
    return to_tensors(stack_frames(clips), device)


def stretch_frames(torch, seed: int, t: int, device, n_max: int):
    """One stream of the stretch scenarios' synthetic clips."""
    from ratrack_tpu_torch.kernels.cases import stretch_static_points
    return make_frames(torch, seed, t, device, n_max, 1,
                       stretch_static_points(n_max))


def stretch_model(torch, seed: int, device):
    from ratrack_tpu_torch.models import Track4D
    return Track4D(npoint=STRETCH_NPOINT, k_max=K_MAX,
                   sinkhorn_iters=SINKHORN_ITERS, exact_fps=True,
                   mov_budget=512, sinkhorn_kernel=True,
                   generator=torch.Generator().manual_seed(seed),
                   device=device)


def compare_slice(torch, phase, model, frames_cpu, want_launches, streams,
                  t, n_max):
    """The cached eval scan of `model` (on the CPU, plain versions) over
    frames_cpu, then the same on the card: shapes, finiteness, cls and flow
    within 1e-3, labels / track ids mismatching on at most 1%, launch
    counts as given. Leaves the model on the card."""
    from ratrack_tpu_torch.data import FrameBatch
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    scan = make_scan_eval_step_cached(model)
    t0 = time.perf_counter()
    _, cpu = scan(init_state(streams, K_MAX, device="cpu"), frames_cpu)
    cpu_s = time.perf_counter() - t0

    dev = torch.device("cuda")
    model.to(dev)
    frames = FrameBatch(*[x.to(dev) for x in frames_cpu])
    reset_counters()
    _, gpu = scan(init_state(streams, K_MAX, device=dev), frames)
    torch.cuda.synchronize()
    launches = read_counters()
    if launches != want_launches:
        fail(f"{phase} launch counts {launches}, expected {want_launches}")
    gpu = {k: v.cpu() for k, v in gpu.items()}

    pc1 = frames_cpu.pc1
    flow_cpu, flow_gpu = cpu["warp"] - pc1, gpu["warp"] - pc1
    for k, shape in (("cls", (streams, t, n_max)),
                     ("warp", (streams, t, n_max, 3)),
                     ("labels", (streams, t, n_max)),
                     ("track_id", (streams, t, K_MAX))):
        if tuple(gpu[k].shape) != shape:
            fail(f"{phase} {k} shape {tuple(gpu[k].shape)}, expected {shape}")
    if not (torch.isfinite(gpu["cls"]).all() and
            torch.isfinite(gpu["warp"]).all()):
        fail(f"{phase} outputs not finite")
    cls_err = (gpu["cls"] - cpu["cls"]).abs().max().item()
    flow_err = (flow_gpu - flow_cpu).abs().max().item()
    label_bad = int((gpu["labels"] != cpu["labels"]).sum())
    tid_bad = int((gpu["track_id"] != cpu["track_id"]).sum())
    n_clustered = int((cpu["labels"] >= 0).sum())
    n_tracks = int((cpu["track_id"] >= 0).sum())
    emit(phase=phase, streams=streams, frames=t, points=n_max,
         cls_max_abs_err=cls_err, flow_max_abs_err=flow_err,
         label_mismatch=label_bad, label_total=gpu["labels"].numel(),
         clustered_points=n_clustered, track_id_mismatch=tid_bad,
         track_id_total=gpu["track_id"].numel(), live_tracks=n_tracks,
         launches=launches, cpu_seconds=cpu_s)
    if cls_err > 1e-3 or flow_err > 1e-3:
        fail(f"{phase} cls err {cls_err} / flow err {flow_err} > 1e-3")
    if (label_bad > 0.01 * gpu["labels"].numel()
            or tid_bad > 0.01 * gpu["track_id"].numel()):
        fail(f"{phase} mismatches: labels {label_bad}, track ids {tid_bad}")


def phase_slice(torch, seed: int):
    from ratrack_tpu_torch.models import Track4D

    model = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    generator=torch.Generator().manual_seed(seed),
                    device="cpu")
    compare_slice(torch, "slice", model,
                  make_frames(torch, seed, SLICE_T, "cpu"),
                  expected_launches(SLICE_T), N_STREAMS, SLICE_T, N_MAX)
    return model


def phase_stretch_slice(torch, seed: int):
    model = stretch_model(torch, seed, "cpu")
    compare_slice(torch, "stretch_slice", model,
                  stretch_frames(torch, seed, STRETCH_SLICE_T, "cpu",
                                 STRETCH_N),
                  expected_stretch_launches(STRETCH_SLICE_T), 1,
                  STRETCH_SLICE_T, STRETCH_N)
    return model


def timed_scans(torch, scan, state0, frames, reps: int = 3):
    """One warm-up, then `reps` synchronised scans -> (seconds of each,
    launch counts of the first, outputs of the last, peak bytes)."""
    scan(state0, frames)                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches, out = [], None, None
    for rep in range(reps):
        if rep == 0:
            reset_counters()
        t0 = time.perf_counter()
        _, out = scan(state0, frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = read_counters()
    return times, launches, out, torch.cuda.max_memory_allocated()


def phase_stretch_throughput(torch, model, seed: int, card: str,
                             eval_fps: float, profile_dir):
    """The stretch scans (model: the 8192 / 16384-point Track4D on the
    card), then the 512-point 8-stream scan with the Sinkhorn kernel,
    beside phase 5's frames/s (eval_fps). Returns the launch counts of the
    8192-point scan."""
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    dev = torch.device("cuda")
    scan = make_scan_eval_step_cached(model)
    kept = None
    for n_max, t in STRETCH_SCAN:
        frames = stretch_frames(torch, seed + 300, t, dev, n_max)
        times, launches, out, peak = timed_scans(
            torch, scan, init_state(1, K_MAX, device=dev), frames)
        if launches != expected_stretch_launches(t):
            fail(f"stretch throughput launch counts {launches}, expected "
                 f"{expected_stretch_launches(t)}")
        if not torch.isfinite(out["cls"]).all():
            fail("stretch throughput outputs not finite")
        dt = statistics.median(times)
        emit(phase="stretch_throughput", points=n_max, streams=1,
             frames_per_stream=t, sinkhorn_iters=SINKHORN_ITERS,
             sinkhorn_kernel=True, frames_per_s=t / dt,
             ms_per_frame=1000.0 * dt / t, scan_seconds=times,
             peak_memory_gib=peak / 2 ** 30, card=card, launches=launches)
        if n_max == STRETCH_N:
            kept = launches
            if profile_dir:
                profile_scan(torch, scan, init_state(1, K_MAX, device=dev),
                             frames, profile_dir, 4, "stretch")
        del frames, out

    small = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    sinkhorn_kernel=True,
                    generator=torch.Generator().manual_seed(seed), device=dev)
    frames = make_frames(torch, seed + 100, SCAN_T, dev)
    times, launches, out, peak = timed_scans(
        torch, make_scan_eval_step_cached(small),
        init_state(N_STREAMS, K_MAX, device=dev), frames)
    want = {**expected_launches(SCAN_T), "sinkhorn_uv": SCAN_T}
    if launches != want:
        fail(f"sinkhorn-kernel throughput launch counts {launches}, "
             f"expected {want}")
    if not torch.isfinite(out["cls"]).all():
        fail("sinkhorn-kernel throughput outputs not finite")
    dt = statistics.median(times)
    n_frames = N_STREAMS * SCAN_T
    emit(phase="stretch_throughput", points=N_MAX, streams=N_STREAMS,
         frames_per_stream=SCAN_T, sinkhorn_iters=SINKHORN_ITERS,
         sinkhorn_kernel=True, frames_per_s=n_frames / dt,
         ms_per_frame=1000.0 * dt / n_frames, scan_seconds=times,
         peak_memory_gib=peak / 2 ** 30,
         frames_per_s_eager_sinkhorn=eval_fps, card=card, launches=launches)
    return kept


def phase_throughput(torch, model, seed: int, card: str, profile_dir):
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    dev = torch.device("cuda")
    scan = make_scan_eval_step_cached(model)
    frames = make_frames(torch, seed + 100, SCAN_T, dev)
    state0 = init_state(N_STREAMS, K_MAX, device=dev)
    times, launches, out, _ = timed_scans(torch, scan, state0, frames)
    if launches != expected_launches(SCAN_T):
        fail(f"throughput launch counts {launches}, expected "
             f"{expected_launches(SCAN_T)}")
    if not torch.isfinite(out["cls"]).all():
        fail("throughput outputs not finite")
    dt = statistics.median(times)
    n_frames = N_STREAMS * SCAN_T
    emit(phase="throughput", streams=N_STREAMS, frames_per_stream=SCAN_T,
         sinkhorn_iters=SINKHORN_ITERS, frames_per_s=n_frames / dt,
         ms_per_frame=1000.0 * dt / n_frames, scan_seconds=times,
         card=card, launches=launches)
    if profile_dir:
        profile_scan(torch, scan, state0, frames, profile_dir)
    return launches, n_frames / dt


def profile_scan(torch, scan, state0, frames, profile_dir, t: int = 4,
                 name: str = "eval", *extra):
    """torch.profiler over a t-frame scan(state0, frames, *extra): the top
    ops by device time into profile_dir/key_averages_<name>.txt, and the
    device busy share of the wall time printed as a `profile` line."""
    from torch.profiler import ProfilerActivity, profile
    from ratrack_tpu_torch.data import FrameBatch
    short = FrameBatch(*[x[:, :t] for x in frames])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scan(state0, short, *extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: an operator row repeats its kernels' device time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    with open(os.path.join(profile_dir, f"key_averages_{name}.txt"),
              "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=60))
    emit(phase="profile", scan=name, frames_per_stream=t, wall_s=wall,
         device_busy_s=device_us / 1e6,
         device_busy_share=device_us / 1e6 / wall)


def phase_train_kernels(torch, seed: int):
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_correlator_train, fused_sa_train

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 1)
    pc1, m1, pc2, m2 = cases.clouds(seed, N_STREAMS, N_MAX)

    def corr_kernel(**kw):
        return fused_correlator_train.fused_knn_weight_aggregate_train(
            **kw, return_indices=True)

    sa = (cases.sa_train_loss, cases.sa_train_run,
          fused_sa_train.sa_pair_train,
          fused_sa_train.sa_pair_train_reference)
    corr = (cases.corr_train_loss, cases.corr_train_run, corr_kernel,
            fused_correlator_train.knn_weight_aggregate_train_reference)
    runs = []   # (kernel, config, kwargs, (loss fn, run fn, kernel, plain))
    for head in ("pn_head", "mse"):
        for level in cases.SA_LEVELS:
            runs.append(("sa_pair_train", f"{head}.{level}", cases.to_device(
                cases.sa_train_case(level, head, pc1, m1, gen), dev), sa))
    for stage in (1, 2):
        runs.append(("knn_weight_aggregate_train", f"stage{stage}",
                     cases.to_device(cases.corr_train_case(
                         stage, pc1, m1, pc2, m2, gen), dev), corr))

    summary = new_summary(TRAIN_KERNELS)
    for kernel, config, kw, (loss_fn, run_fn, fk, fp) in runs:
        got, want = run_fn(fk, kw), run_fn(fp, kw)
        want64 = run_fn(fp, cases.to_float64(kw))
        torch.cuda.synchronize()
        bad, errs = cases.compare_train(got, want, want64)
        if bad:
            record_failure(f"{kernel}[{config}]: " + "; ".join(bad))
        err = {"fwd": max(v for k, v in errs.items() if k in want[0]),
               "bwd": max(v for k, v in errs.items() if k in want[1])}
        ms = {}
        for side, fn in (("kernel", fk), ("plain", fp)):
            with torch.no_grad():
                ms[f"{side}_fwd"] = device_ms(torch, lambda fn=fn: fn(**kw))
            loss, _, leaves = loss_fn(fn, kw)
            flat = [x for _, x in cases.flat_leaves(leaves)]
            ms[f"{side}_bwd"] = device_ms(
                torch, lambda loss=loss, flat=flat: torch.autograd.grad(
                    loss, flat, retain_graph=True))
            del loss, leaves, flat
        if kernel == "sa_pair_train":
            work = dict(zip(("fwd", "bwd"), cases.sa_train_work(kw, got[0])))
        else:
            work = dict(fwd=cases.corr_work(kw, got[0]["out"]),
                        bwd=cases.corr_train_bwd_work(kw, got[0]["out"]))
        bounds = {part: roofline(*work[part]) for part in work}
        emit(phase="train_kernel", kernel=kernel, config=config,
             fwd_max_abs_err=err["fwd"], grad_max_abs_err=err["bwd"],
             indices_equal=True, fwd_ms=ms["kernel_fwd"],
             fwd_plain_ms=ms["plain_fwd"], bwd_ms=ms["kernel_bwd"],
             bwd_plain_ms=ms["plain_bwd"], fwd_bound_ms=bounds["fwd"][0],
             fwd_bound_by=bounds["fwd"][1], bwd_bound_ms=bounds["bwd"][0],
             bwd_bound_by=bounds["bwd"][1])
        # a train frame step runs the pn_head on both clouds, the mse once
        weight = 2 if config.startswith("pn_head") else 1
        for part in ("fwd", "bwd"):
            tally(summary[f"{kernel}_{part}"], weight, err[part],
                  ms[f"kernel_{part}"], ms[f"plain_{part}"], None,
                  *work[part])
    return summary


def _train_run(torch, seed: int, device: str, dtype):
    """Track4D from the seed trained over TRAIN_SLICE_T synthetic frames on
    `device` in `dtype`, one frame a scan call so that each step's
    gradients can be read -> per-frame loss items, per-step gradients,
    launch counts, BN running statistics, parameters (float64 on the
    CPU except the parameters)."""
    from ratrack_tpu_torch.data import FrameBatch
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    dev = torch.device(device)
    model = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    generator=torch.Generator().manual_seed(seed),
                    device=dev).to(dtype=dtype)
    scan = make_scan_train_step(
        create_train_state(model, TrainConfig(), steps_per_epoch=100,
                           device=dev))
    frames = FrameBatch(*[x.to(dtype) if x.is_floating_point() else x
                          for x in make_frames(torch, seed + 7, TRAIN_SLICE_T,
                                               dev)])
    state = init_state(N_STREAMS, K_MAX, device=dev, dtype=dtype)
    items, grads = [], []
    reset_counters()
    t0 = time.perf_counter()
    for t in range(TRAIN_SLICE_T):
        state, it = scan(state, FrameBatch(*[x[:, t:t + 1] for x in frames]),
                         False)
        items.append({k: v[0].double().cpu() for k, v in it.items()})
        grads.append({n: p.grad.detach().double().cpu()
                      for n, p in model.named_parameters()})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(items=items, grads=grads, launches=read_counters(),
                seconds=time.perf_counter() - t0,
                stats={n: b.double().cpu() for n, b in model.named_buffers()
                       if b.is_floating_point()},
                params=[p.detach() for p in model.parameters()])


def phase_train_slice(torch, seed: int):
    """The card's float32 train steps against a float64 run on the CPU.
    A float32 run on the CPU measures how far float32 itself strays from
    float64: the max-pools make the gradient ill-conditioned (near-ties
    route a cotangent to either of two slots), and Adam's first update,
    about lr * sign(g), turns every near-zero gradient element that
    rounding flips into a 2 * lr step apart. So each check, on a whole
    tensor in norm (errors land on different elements in different
    runs), is |gpu - f64| <= tol + 2 |cpu32 - f64|: the card may be off
    float64 by 1e-3 (each frame's losses over the streams; each gradient
    leaf, of the whole gradient's norm) or 1e-4 (each BN running
    statistic) plus twice what the CPU's float32 run is off by."""
    ref = _train_run(torch, seed, "cpu", torch.float64)
    cpu = _train_run(torch, seed, "cpu", torch.float32)
    gpu = _train_run(torch, seed, "cuda", torch.float32)
    want = expected_train_launches(TRAIN_SLICE_T)
    if gpu["launches"] != want:
        record_failure(f"train slice launch counts {gpu['launches']}, "
                       f"expected {want}")
    finite = all(bool(torch.isfinite(x).all()) for x in
                 [v for it in gpu["items"] for v in it.values()]
                 + [g for gr in gpu["grads"] for g in gr.values()]
                 + gpu["params"])
    if not finite:
        record_failure("train slice: loss, gradients or parameters not "
                       "finite")

    worst = {}   # check -> (err / tol, where, gpu err, cpu32 err)

    def note(check, ratio, where, g_err, c_err):
        if ratio >= worst.get(check, (-1.0,))[0]:
            worst[check] = (ratio, where, g_err, c_err)

    for f, (y, c, g) in enumerate(zip(ref["items"], cpu["items"],
                                      gpu["items"])):
        for k in y:
            eg, ec = (g[k] - y[k]).norm().item(), (c[k] - y[k]).norm().item()
            note("loss", eg / (1e-3 * y[k].norm().item() + 2 * ec + 1e-6),
                 f"frame {f} {k}", eg, ec)
    for s, (y, c, g) in enumerate(zip(ref["grads"], cpu["grads"],
                                      gpu["grads"])):
        total = torch.cat([x.flatten() for x in y.values()]).norm().item()
        for n in y:
            eg, ec = (g[n] - y[n]).norm().item(), (c[n] - y[n]).norm().item()
            note("grad", eg / (1e-3 * total + 2 * ec + 1e-6),
                 f"step {s} {n}", eg / total, ec / total)
    for n, y in ref["stats"].items():
        eg = (gpu["stats"][n] - y).norm().item()
        ec = (cpu["stats"][n] - y).norm().item()
        note("bn_stats", eg / (1e-4 * y.norm().item() + 2 * ec + 1e-6), n,
             eg, ec)
    emit(phase="train_slice", streams=N_STREAMS, frames=TRAIN_SLICE_T,
         worst={k: dict(err_over_tol=v[0], at=v[1], gpu_err=v[2],
                        cpu32_err=v[3]) for k, v in worst.items()},
         losses_gpu=[{k: v.tolist() for k, v in it.items()}
                     for it in gpu["items"]],
         launches=gpu["launches"], cpu64_seconds=ref["seconds"],
         cpu32_seconds=cpu["seconds"], gpu_seconds=gpu["seconds"])
    for check, (ratio, where, g_err, c_err) in worst.items():
        if ratio > 1.0:
            record_failure(f"train slice {check} at {where}: error {g_err} "
                           f"against float64, the CPU's float32 {c_err}")


def phase_train_throughput(torch, seed: int, card: str, profile_dir):
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    dev = torch.device("cuda")
    model = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    generator=torch.Generator().manual_seed(seed), device=dev)
    scan = make_scan_train_step(
        create_train_state(model, TrainConfig(), steps_per_epoch=100,
                           device=dev))
    frames = make_frames(torch, seed + 200, TRAIN_SCAN_T, dev)
    state0 = init_state(N_STREAMS, K_MAX, device=dev)
    scan(state0, frames, False)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for rep in range(3):
        if rep == 0:
            reset_counters()
        t0 = time.perf_counter()
        _, items = scan(state0, frames, False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = read_counters()
    if launches != expected_train_launches(TRAIN_SCAN_T):
        record_failure(f"train throughput launch counts {launches}, "
                       f"expected {expected_train_launches(TRAIN_SCAN_T)}")
    if not all(bool(torch.isfinite(v).all()) for v in items.values()):
        record_failure("train throughput losses not finite")
    dt = statistics.median(times)
    n_frames = N_STREAMS * TRAIN_SCAN_T
    emit(phase="train_throughput", streams=N_STREAMS,
         frames_per_stream=TRAIN_SCAN_T, sinkhorn_iters=SINKHORN_ITERS,
         frames_per_s=n_frames / dt, ms_per_frame=1000.0 * dt / n_frames,
         scan_seconds=times,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         loss_first_last=[items["Loss"][0].mean().item(),
                          items["Loss"][-1].mean().item()],
         card=card, launches=launches)
    if profile_dir:
        profile_scan(torch, scan, state0, frames, profile_dir, 4, "train",
                     False)
    return launches


def ptxas_summary(log: str):
    """[{kernel, registers, spill_stores}] from nvcc's -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\w*?([a-z][a-z_]*_kernel)[EI]", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.append({"kernel": name, "spill_stores": int(m.group(1))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["kernel"] == name:
            out[-1]["registers"] = int(m.group(1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler tables of 4-frame "
                         "eval, train and 8192-point stretch scans (and "
                         "device busy-share lines)")
    args = ap.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ratrack_tpu_torch")):
        fail("the ratrack_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    from ratrack_tpu_torch.kernels import build
    build.load()
    emit(phase="build", seconds=build.last_build["seconds"],
         cached=build.last_build["cached"],
         ptxas=ptxas_summary(build.last_build["log"]))

    summary = phase_kernels(torch, SEED)
    model = phase_slice(torch, SEED)
    launches, eval_fps = phase_throughput(torch, model, SEED, card,
                                          args.profile)
    del model
    summary.update(phase_train_kernels(torch, SEED))
    phase_train_slice(torch, SEED)
    train_launches = phase_train_throughput(torch, SEED, card, args.profile)
    if FAILED:
        fail(f"{len(FAILED)} failed checks in phases 6-8")
    summary.update(phase_stretch_kernels(torch, SEED))
    model = phase_stretch_slice(torch, SEED)
    stretch_launches = phase_stretch_throughput(torch, model, SEED, card,
                                                eval_fps, args.profile)
    launches = {**{k: launches[k] for k in EVAL_KERNELS},
                **{k: train_launches[k] for k in TRAIN_KERNELS},
                **{k: stretch_launches[k] for k in STRETCH_KERNELS}}
    if not all(launches.values()):
        fail(f"a kernel was never launched on its path: {launches}")

    kernels = []
    for name, meta in KERNELS.items():
        entry = summary[name]
        bound_ms, bound_by = roofline(entry["bytes"], entry["ops"])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=entry["max_abs_err"], ms=entry["ms"],
            plain_ms=entry["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=entry["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
