#!/usr/bin/env python3
"""Drive the PyTorch port's eval, train, stretch, general-SA-level and
serving paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--profile DIR]

Phases, each printing one line:
  1. card       the card's name and power limit (nvidia-smi);
  2. build      nvcc build of ratrack_tpu_torch/csrc/*.cu: seconds, and
                registers / spill bytes per kernel from ptxas;
  3. kernel     every kernel at the main-path shapes (8 streams, 512-point
                clouds) against its plain PyTorch version on the same CUDA
                tensors: max abs error vs 1e-4 * max|plain| + 1e-5, selected
                indices equal, median CUDA-event times over 20 runs; B3's
                selection launch also on its own for each stage (indices
                equal to the plain `knn`; its time, the plain version's,
                one library call's and its bound);
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
                compare_train); median CUDA-event ms of a forward and of
                a backward call (each one launch of the wrapper); for
                B10's stage 1 products_torch_ms, its backward's four
                pair-layer products as torch.matmul (float32, TF32 off; a
                yardstick, used nowhere in the port); and how many of the
                forward's and the backward's thread-block clusters the
                card holds at once;
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
                B5 again on the clouds unsorted, as B10's selection takes
                them in train stretch (no weight in the summary);
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
  12. scale_kernel the one-scale kernels B1' (eval) and B8 (train, forward
                and backward) on every scale of three levels that are not
                a same-depth pair (one scale; three scales; two scales of
                depths 2 and 3), 8 streams x 512 points x 512 centers, 35
                input channels, against their plain versions as in phases
                3 and 6; B1' also at 8192 points x 512 centers, one stream;
                and a pair launch (B1, B9) against two one-scale launches:
                outputs, indices, statistics and weight gradients equal
                bit for bit, the feature gradient (float atomics) within
                1e-5 of its largest element; B9 twice on the same inputs:
                everything but the feature gradient identical;
  13. general_slice those three `SetAbstractionMSG` levels in eval and in
                one train forward + backward on the card against the CPU:
                eval outputs within 1e-4 x max + 1e-5; train outputs and
                running statistics likewise, gradients by phase 6's float64
                yardstick; launch counts by the JAX module's routing: eval
                1 / 3 / 0 of B1' and 0 / 0 / 1 of B1 (two scales take the
                pair kernel whatever their depths), train 1 / 3 / 2 of B8
                forward and backward and none of B9;
  14. serving   `serve.RadarTracker` over Track4D(npoint=512) on the card:
                8 streams x 4 synthetic scans against the same tracker on
                the CPU (0 label, point-track-id and track-id mismatches,
                flow and conf within 1e-3), then per-call wall time (median
                and worst of 50 calls after 5 warm-up calls) of `track()`
                on one stream (bucket 1) and of 8 submits + one `step()`
                (bucket 8) on random 360-point scans, with
                `sinkhorn_kernel` off and on; `last_bucket` and the launch
                counts of a step (9 B1, 9 B2, 2 B3, and 1 B7 when on);
  15. train_stretch make_scan_train_step over Track4D(npoint=512,
                exact_fps, mov_budget=512): one frame step of one stream
                at 8192 points on the card against float64 and float32
                runs on the CPU at phase 7's gates, launch counts 9 / 9 /
                2 / 2 of B9 / B10 forward and backward, 9 of B6 and 2 of
                B5 a frame step (5 at 16384 points, where the three
                fp1 levels select through it too); then frames/s and peak
                memory at 8192 points x 2 streams x 8 frames and 16384 x 1
                x 4 (one warm-up, median of 3, no gate).
Then one JSON line with every kernel's route, source, launches (B1-B3
from phase 5's run, train kernels from phase 8's, B5 / B4 / B6 / B7 from
phase 11's 8192-point run, B1' and B8 from phase 13's), error, times
summed over the calls one frame step of that path makes (6 B1, 6 B2, 2 B3;
9 B9, 2 B10; 2 B5, 2 B4, 6 B6, 1 B7; for B1' the 4 and for B8 the 6
scales that phase 13's three levels launch one by one), the roofline
bound of the same work (the largest of bytes / 3.35 TB/s, matrix-product
operations / 165 TFLOP/s, the card's fastest float32-accurate product:
3xTF32, a third of the 495 TF32 rate, and the other float32 operations /
67 TFLOP/s, counted by kernels/cases.py::*_work) and, where one PyTorch
call computes the same function, that call's time; for B1 also its
two sa1 calls of a stretch frame (8192 points x 512 centers: stretch_ms,
stretch_plain_ms, stretch_bound_ms), likewise for B2 its two fp1 calls of
a stretch frame (8192 unknowns x 512 known points), and for B3 its two
selection launches of an eval step (select_ms, select_plain_ms,
select_library_ms, select_bound_ms); and last the result
line. Any failed check exits non-zero before the result line (phases 6-8
and 12-15 record their failed checks and go on, so that one run reports
all of them; the script then exits non-zero). With no CUDA device, or without the ratrack_tpu_torch
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
TRAIN_STRETCH_SLICE_N = 8192                # one stream, one frame step
TRAIN_STRETCH_SCAN = ((8192, 2, 8), (16384, 1, 4))  # points, streams, frames
SERVE_SCANS = 4
SERVE_CALLS = 50
SERVE_WARMUP = 5
REPS = 20
SEED = 0
# B6's launch shapes timed against each other: (threads a block, blocks a
# stream) of one block and of a thread-block cluster, per cloud size
FPS_SHAPES = ((1024, 1), (128, 1), (128, 2), (128, 8))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
PRODUCT_OPS_PER_S = 495e12 / 3  # float32-accurate products: 3xTF32

KERNELS = {
    "sa_pair": dict(
        source="ratrack_tpu_torch/csrc/sa_pair.cu",
        replaces="ratrack_tpu/ops/pallas_sa.py:192 (_sa_pair_kernel)"),
    "sa_scale": dict(
        source="ratrack_tpu_torch/csrc/sa_pair.cu",
        replaces="ratrack_tpu/ops/pallas_sa.py:145 (_sa_kernel)"),
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
    "sa_scale_train_fwd": dict(
        source="ratrack_tpu_torch/csrc/sa_pair_train.cu",
        replaces="ratrack_tpu/ops/pallas_sa_train.py:246 (_fwd_kernel)"),
    "sa_scale_train_bwd": dict(
        source="ratrack_tpu_torch/csrc/sa_pair_train.cu",
        replaces="ratrack_tpu/ops/pallas_sa_train.py:287 (_bwd_kernel)"),
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
SCALE_KERNELS = ("sa_scale", "sa_scale_train_fwd", "sa_scale_train_bwd")
TRAIN_KERNELS = tuple(k for k in KERNELS if k not in
                      EVAL_KERNELS + STRETCH_KERNELS + SCALE_KERNELS)


FAILED: list = []   # failed checks of phases 6-8 and 12-15


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
                    bytes=0, mm_ops=0, ops=0) for k in names}


def roofline(nbytes, mm_ops, ops):
    """(bound_ms, bound_by): the least time the card could take to move
    nbytes, to do mm_ops matrix-product operations at the 3xTF32 rate or
    to do ops other float32 operations, whichever is longest."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(mm_ops / PRODUCT_OPS_PER_S, ops / FP32_OPS_PER_S)
    return (1000.0 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def tally(entry, weight, err, ms, plain_ms, library_ms, nbytes, mm_ops,
          ops):
    """Add `weight` calls of one config to a kernel's per-frame-step sums."""
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["ms"] += weight * ms
    entry["plain_ms"] += weight * plain_ms
    if library_ms is not None:
        entry["library_ms"] = (entry["library_ms"] or 0.0) + weight * library_ms
    entry["bytes"] += weight * nbytes
    entry["mm_ops"] += weight * mm_ops
    entry["ops"] += weight * ops


def run_kernel_cases(torch, phase, runs, summary):
    """Each run: dict(kernel, config, run_k, run_p, check(got, want) ->
    (err, tol), work(got) -> (bytes, ops), library (a callable or None),
    products (a callable or None: a yardstick timed beside the kernel),
    weight (calls per frame step that count in the kernel's summary))."""
    with torch.inference_mode():
        for r in runs:
            got, want = r["run_k"](), r["run_p"]()
            torch.cuda.synchronize()
            err, tol = r["check"](got, want)
            work = r["work"](got)
            bound_ms, bound_by = roofline(*work)
            ms = device_ms(torch, r["run_k"])
            plain_ms = device_ms(torch, r["run_p"])
            library_ms = (device_ms(torch, r["library"])
                          if r.get("library") else None)
            products_ms = (device_ms(torch, r["products"])
                           if r.get("products") else None)
            emit(phase=phase, kernel=r["kernel"], config=r["config"],
                 max_abs_err=err, tol=tol, indices_equal=True, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 products_torch_ms=products_ms, bound_ms=bound_ms,
                 bound_by=bound_by)
            tally(summary[r["kernel"]], r.get("weight", 1), err, ms,
                  plain_ms, library_ms, *work)
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


def select_run(torch, cases, fused_correlator, knn, name, kw):
    """B3's selection launch alone, against the plain `knn`."""
    q, p, mask = kw["query"], kw["points"], kw["mask_p"]

    def check(got, want):
        if not torch.equal(got.long(), want[1]):
            fail(f"knn_select[{name}]: indices differ from the plain knn")
        return 0.0, 0.0
    return dict(kernel="knn_select", config=name,
                run_k=lambda: fused_correlator.launch_knn(q, p, mask, 16),
                run_p=lambda: knn(16, q, p, mask),
                check=check,
                work=lambda got: cases.knn_select_work(q, p, mask, got),
                # one library selection: top-16 of the masked dense
                # distance matrix
                library=lambda: torch.topk(
                    torch.cdist(q, p).masked_fill_(
                        ~mask.unsqueeze(1), float("inf")), 16, dim=-1,
                    largest=False))


def phase_kernels(torch, seed: int):
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_correlator, fused_fp, fused_sa
    from ratrack_tpu_torch.ops.neighborhood import knn

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
        runs.append(select_run(torch, cases, fused_correlator, knn,
                               f"stage{stage}", kw))
    summary = new_summary(EVAL_KERNELS + ("knn_select",))
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

    # Z-sorted as the split correlator sorts them (the stretch eval path);
    # unsorted as B10's selection takes them in train stretch (no weight)
    for n, (c1, cm1, c2, cm2) in clouds.items():
        for stage, zsorted in ((1, True), (2, True), (1, False), (2, False)):
            if n != STRETCH_N and stage == 2:
                continue
            kw = cases.to_device(
                cases.knn_tiled_case(stage, c1, cm1, c2, cm2) if zsorted
                else dict(query=c1, points=c2 if stage == 1 else c1,
                          points_mask=cm2 if stage == 1 else cm1, k=16), dev)
            name = f"{n}.stage{stage}" + ("" if zsorted else ".unsorted")
            runs.append(dict(
                kernel="knn_tiled", config=name,
                weight=int(n == STRETCH_N and zsorted),
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
            work=lambda got, kw=kw: cases.corr_work(kw, got, select=False),
            # stage 1's two pair-layer products as torch.matmul (float32,
            # TF32 off): a yardstick, not a library call for the function
            products=(cases.apply_products(kw, kw["idx"]) if kw["mlp_ws"]
                      else None)))

    def check_fps(name):
        def check(got, want):
            bad = int((got != want).sum())
            if bad:
                fail(f"{name}: {bad} of {want.numel()} samples differ")
            return 0.0, 0.0
        return check

    fps_kws = {}
    centers = cases.fps_centers(pc1, m1, STRETCH_NPOINT)
    # per 8192-point frame step: sa1 of both heads on the cloud, sa2 and
    # sa3 of both heads on the 512 centers with no mask
    for name, xyz, mask, weight in (
            (f"{STRETCH_N}.masked", pc1, m1, 2),
            (f"{STRETCH_NPOINT}.nomask", centers, None, 4),
            (f"{STRETCH_BIG_N}.masked", clouds[STRETCH_BIG_N][0],
             clouds[STRETCH_BIG_N][1], 0)):
        kw = cases.to_device(cases.fps_case(xyz, mask, STRETCH_NPOINT), dev)
        fps_kws[name] = kw
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
    # (B1's two sa1 calls a stretch frame summed into the kernels line)
    for head in ("pn_head", "mse"):
        sa_kw = cases.to_device(cases.sa_case(
            "sa1", head, pc1, m1, gen, npoint=STRETCH_NPOINT), dev)
        runs.append(sa_run(torch, cases, fused_sa,
                           f"{STRETCH_N}.{head}.sa1", sa_kw, weight=1))
    # (B2's two fp1 calls a stretch frame, both at 128 channels)
    fp_kw = cases.to_device(cases.fp_case("fp1", pc1, m1, gen,
                                          npoint=STRETCH_NPOINT), dev)
    runs.append(fp_run(torch, cases, fused_fp, f"{STRETCH_N}.fp1", fp_kw,
                       weight=2))

    summary = new_summary(STRETCH_KERNELS + ("sa_pair", "three_interpolate"))
    run_kernel_cases(torch, "stretch_kernel", runs, summary)

    # B6 again with its launch shape forced: one block against a cluster,
    # each equal to the kernel's own choice (held to the plain loop above)
    for name, kw in fps_kws.items():
        want = sampling.furthest_point_sample(**kw)
        n = kw["xyz"].shape[1]
        for shape in FPS_SHAPES:
            if n > 16 * shape[0] * shape[1]:      # over 16 points a thread
                continue
            got = sampling.furthest_point_sample(**kw, shape=shape)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"furthest_point_sample[{name}] with {shape[0]} threads "
                     f"x {shape[1]} blocks a stream differs from its default")
            emit(phase="stretch_kernel", kernel="furthest_point_sample",
                 config=name, threads=shape[0], blocks_per_stream=shape[1],
                 indices_equal=True,
                 ms=device_ms(torch, lambda: sampling.furthest_point_sample(
                     **kw, shape=shape)))
    out = {k: summary[k] for k in STRETCH_KERNELS}
    out["sa_pair_stretch"] = summary["sa_pair"]
    out["three_interpolate_stretch"] = summary["three_interpolate"]
    return out


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
            "sa_scale": fused_sa.sa_scale,
            "sa_scale_train_fwd": fused_sa_train.sa_scale_train_fwd,
            "sa_scale_train_bwd": fused_sa_train.sa_scale_train_bwd,
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
    return {**{k: 0 for k in TRAIN_KERNELS + STRETCH_KERNELS + SCALE_KERNELS},
            "sa_pair": 6 * t + 3, "three_interpolate": 6 * t + 3,
            "knn_weight_aggregate": 2 * t}


def expected_stretch_launches(t: int):
    # as expected_launches, with the split correlator (a tiled kNN and an
    # apply per stage) in place of B3, a farthest point sampling per SA
    # level and one Sinkhorn launch per frame
    return {**{k: 0 for k in TRAIN_KERNELS + SCALE_KERNELS},
            "knn_weight_aggregate": 0,
            "sa_pair": 6 * t + 3, "three_interpolate": 6 * t + 3,
            "knn_tiled": 2 * t, "knn_gather_apply": 2 * t,
            "furthest_point_sample": 6 * t + 3, "sinkhorn_uv": t}


def expected_train_launches(t: int):
    # per frame step: 3 PNHeads (pc1, pc2, the decoder's mse) x 3 SA
    # levels, forward and backward; 2 correlator stages; no eval kernel
    return {**{k: 0 for k in EVAL_KERNELS + STRETCH_KERNELS + SCALE_KERNELS},
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


def stretch_frames(torch, seed: int, t: int, device, n_max: int,
                   streams: int = 1):
    """`streams` streams of the stretch scenarios' synthetic clips."""
    from ratrack_tpu_torch.kernels.cases import stretch_static_points
    return make_frames(torch, seed, t, device, n_max, streams,
                       stretch_static_points(n_max))


def stretch_model(torch, seed: int, device, sinkhorn_kernel: bool = True):
    from ratrack_tpu_torch.models import Track4D
    return Track4D(npoint=STRETCH_NPOINT, k_max=K_MAX,
                   sinkhorn_iters=SINKHORN_ITERS, exact_fps=True,
                   mov_budget=512, sinkhorn_kernel=sinkhorn_kernel,
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

    def work(kernel, kw, outs):
        if kernel == "sa_pair_train":
            return dict(zip(("fwd", "bwd"), cases.sa_train_work(kw, outs)))
        return dict(fwd=cases.corr_work(kw, outs["out"]),
                    bwd=cases.corr_train_bwd_work(kw, outs["out"]))

    from ratrack_tpu_torch.kernels import build
    lib = build.load()
    emit(phase="train_kernel", check="sa_train_clusters",
         launches_per_forward=2,
         launches_per_backward=2, blocks_per_cluster=8,
         clusters_of_a_pair_launch=2 * N_STREAMS,
         forward_clusters_held_at_once=lib.ratrack_sa_train_fwd_clusters(
             N_STREAMS, 2),
         backward_clusters_held_at_once=lib.ratrack_sa_train_bwd_clusters(
             N_STREAMS, 2))
    summary = new_summary(TRAIN_KERNELS)
    for kernel, config, kw, fns in runs:
        # a train frame step runs the pn_head on both clouds, the mse once
        train_kernel_case(torch, cases, summary, "train_kernel", kernel,
                          config, kw, fns, work,
                          2 if config.startswith("pn_head") else 1)
    return summary


def train_kernel_case(torch, cases, summary, phase, kernel, config, kw, fns,
                      work, weight):
    """One train kernel config forward and backward against its plain
    version (fns = loss fn, run fn, kernel wrapper, plain version; work
    (kernel, kw, outputs) -> {"fwd": (bytes, ops), "bwd": ...}): checks by
    cases.compare_train with the float64 yardstick, times, bounds, and
    `weight` calls added to summary[kernel_fwd / kernel_bwd]."""
    loss_fn, run_fn, fk, fp = fns
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
    products_ms = None
    if kernel == "knn_weight_aggregate_train" and kw["mlp_ws"]:
        products_ms = device_ms(torch, cases.corr_train_products(fk, kw))
    w = work(kernel, kw, got[0])
    bounds = {part: roofline(*w[part]) for part in w}
    emit(phase=phase, kernel=kernel, config=config,
         fwd_max_abs_err=err["fwd"], grad_max_abs_err=err["bwd"],
         indices_equal=True, fwd_ms=ms["kernel_fwd"],
         fwd_plain_ms=ms["plain_fwd"], bwd_ms=ms["kernel_bwd"],
         bwd_plain_ms=ms["plain_bwd"], products_torch_ms=products_ms,
         fwd_bound_ms=bounds["fwd"][0], fwd_bound_by=bounds["fwd"][1],
         bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1])
    for part in ("fwd", "bwd"):
        tally(summary[f"{kernel}_{part}"], weight, err[part],
              ms[f"kernel_{part}"], ms[f"plain_{part}"], None, *w[part])


def _train_run(torch, seed: int, device: str, dtype, stretch_n: int = 0):
    """Track4D from the seed trained on `device` in `dtype`, one frame a
    scan call so that each step's gradients can be read -> per-frame loss
    items, per-step gradients, launch counts, BN running statistics,
    parameters (float64 on the CPU except the parameters). By default the
    512-point model over N_STREAMS streams x TRAIN_SLICE_T frames; with
    stretch_n the stretch model (512 centers, true FPS, compact DBSCAN)
    over one stream x one frame of stretch_n points."""
    from ratrack_tpu_torch.data import FrameBatch
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    dev = torch.device(device)
    if stretch_n:
        streams, n_frames = 1, 1
        model = stretch_model(torch, seed, dev, sinkhorn_kernel=False)
        frames = stretch_frames(torch, seed + 7, n_frames, dev, stretch_n)
    else:
        streams, n_frames = N_STREAMS, TRAIN_SLICE_T
        model = Track4D(npoint=N_MAX, k_max=K_MAX,
                        sinkhorn_iters=SINKHORN_ITERS,
                        generator=torch.Generator().manual_seed(seed),
                        device=dev)
        frames = make_frames(torch, seed + 7, n_frames, dev)
    model = model.to(dtype=dtype)
    scan = make_scan_train_step(
        create_train_state(model, TrainConfig(), steps_per_epoch=100,
                           device=dev))
    frames = FrameBatch(*[x.to(dtype) if x.is_floating_point() else x
                          for x in frames])
    state = init_state(streams, K_MAX, device=dev, dtype=dtype)
    items, grads = [], []
    reset_counters()
    t0 = time.perf_counter()
    for t in range(n_frames):
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
    compare_train_runs(torch, seed, "train_slice",
                       expected_train_launches(TRAIN_SLICE_T),
                       dict(streams=N_STREAMS, frames=TRAIN_SLICE_T))


def compare_train_runs(torch, seed: int, phase: str, want: dict, shape: dict,
                       stretch_n: int = 0):
    """_train_run on the CPU in float64 and float32 and on the card, held
    together by phase_train_slice's gates; `want` the card's launch
    counts, `shape` what the phase's line says of its size."""
    ref = _train_run(torch, seed, "cpu", torch.float64, stretch_n)
    cpu = _train_run(torch, seed, "cpu", torch.float32, stretch_n)
    gpu = _train_run(torch, seed, "cuda", torch.float32, stretch_n)
    if gpu["launches"] != want:
        record_failure(f"{phase} launch counts {gpu['launches']}, "
                       f"expected {want}")
    finite = all(bool(torch.isfinite(x).all()) for x in
                 [v for it in gpu["items"] for v in it.values()]
                 + [g for gr in gpu["grads"] for g in gr.values()]
                 + gpu["params"])
    if not finite:
        record_failure(f"{phase}: loss, gradients or parameters not finite")

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
    emit(phase=phase, **shape,
         worst={k: dict(err_over_tol=v[0], at=v[1], gpu_err=v[2],
                        cpu32_err=v[3]) for k, v in worst.items()},
         losses_gpu=[{k: v.tolist() for k, v in it.items()}
                     for it in gpu["items"]],
         launches=gpu["launches"], cpu64_seconds=ref["seconds"],
         cpu32_seconds=cpu["seconds"], gpu_seconds=gpu["seconds"])
    for check, (ratio, where, g_err, c_err) in worst.items():
        if ratio > 1.0:
            record_failure(f"{phase} {check} at {where}: error {g_err} "
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


def phase_scale_kernels(torch, seed: int):
    """Phase 12: kernels B1' and B8 against their plain versions, and a
    pair launch against two one-scale launches."""
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_sa, fused_sa_train

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 3)
    pc1, m1, _, _ = cases.clouds(seed, N_STREAMS, N_MAX)
    spc, sm, _, _ = cases.stretch_clouds(seed, STRETCH_N)
    summary = new_summary(SCALE_KERNELS)

    def eval_run(name, kw, weight):
        return dict(kernel="sa_scale", config=name, weight=weight,
                    run_k=lambda: fused_sa.sa_scale(**kw,
                                                    return_indices=True),
                    run_p=lambda: fused_sa.sa_scale_reference(**kw),
                    check=check_out_idx(torch, f"sa_scale[{name}]"),
                    work=lambda got: cases.sa_scale_work(kw, *got))

    # in eval the two scales of mixed_depth run as one B1 launch on the
    # model's path: its scales are checked here and count for no launch
    runs = [eval_run(f"{level}.{i}", cases.to_device(kw, dev),
                     int(level != "mixed_depth"))
            for level in cases.GENERAL_LEVELS
            for i, kw in enumerate(cases.sa_scale_cases(level, pc1, m1, gen))]
    runs.append(eval_run(
        f"{STRETCH_N}.one_scale.0", cases.to_device(cases.sa_scale_cases(
            "one_scale", spc, sm, gen, npoint=STRETCH_NPOINT)[0], dev), 0))
    run_kernel_cases(torch, "scale_kernel", runs, summary)

    fns = (cases.sa_scale_train_loss, cases.sa_scale_train_run,
           fused_sa_train.sa_scale_train,
           fused_sa_train.sa_scale_train_reference)
    for level in cases.GENERAL_LEVELS:
        for i, kw in enumerate(cases.sa_scale_train_cases(level, pc1, m1,
                                                          gen)):
            train_kernel_case(
                torch, cases, summary, "scale_kernel", "sa_scale_train",
                f"{level}.{i}", cases.to_device(kw, dev), fns,
                lambda _, kw, outs: dict(zip(
                    ("fwd", "bwd"), cases.sa_scale_train_work(kw, outs))), 1)

    # a pair launch == two one-scale launches
    worst, bad = 0.0, []
    for level in cases.SA_LEVELS:
        kw = cases.to_device(cases.sa_case(level, "pn_head", pc1, m1, gen),
                             dev)
        pair = fused_sa.sa_pair(**kw, return_indices=True)
        for t, single in enumerate(cases.split_sa_case(kw)):
            out, idx = fused_sa.sa_scale(**single, return_indices=True)
            worst = max(worst, (out - pair[t]).abs().max().item())
            if not (torch.equal(out, pair[t])
                    and torch.equal(idx, pair[t + 2])):
                bad.append(f"sa_pair[{level}] scale {t}")
        kw = cases.to_device(cases.sa_train_case(level, "pn_head", pc1, m1,
                                                 gen), dev)
        outs, grads = cases.sa_train_run(fused_sa_train.sa_pair_train, kw)
        # the same launch again: everything but dPF (float atomics) repeats
        outs2, grads2 = cases.sa_train_run(fused_sa_train.sa_pair_train, kw)
        if not all(torch.equal(v, outs2[k]) for k, v in outs.items()) or \
                not all(torch.equal(g, grads2[k]) for k, g in grads.items()
                        if not k.startswith("pf")):
            bad.append(f"sa_pair_train[{level}] differs from run to run")
        for t, (tag, single) in enumerate(zip(
                "ab", cases.split_sa_train_case(kw))):
            o1, g1 = cases.sa_scale_train_run(fused_sa_train.sa_scale_train,
                                              single, seed=t)
            pairs = [(v, outs[cases.pair_key(k, tag)]) for k, v in o1.items()]
            pairs += [(g, grads[cases.pair_key(k, tag)])
                      for k, g in g1.items()
                      if k != "pf"]
            for a, b in pairs:
                worst = max(worst, (a.double() - b.double()).abs().max().item())
                if not torch.equal(a, b):
                    bad.append(f"sa_pair_train[{level}] scale {t}")
            # dPF is scattered with float atomics, in another order each run
            d = (g1["pf"] - grads[f"pf{tag}"]).abs().max().item()
            if d > 1e-5 * grads[f"pf{tag}"].abs().max().item() + 1e-7:
                bad.append(f"sa_pair_train[{level}] scale {t}: dPF off {d}")
    emit(phase="scale_kernel", check="pair_equals_two_singles",
         max_abs_err=worst, failures=sorted(set(bad)))
    if bad:
        record_failure("a pair launch differs from two one-scale launches: "
                       + "; ".join(sorted(set(bad))))
    return summary


def general_level(torch, level: str, seed: int, dtype, device):
    """A `SetAbstractionMSG` of cases.GENERAL_LEVELS with seeded weights and
    batch norm statistics, in eval mode, on `device` in `dtype`."""
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.models import SetAbstractionMSG, init_parameters
    radii, nsamples, mlps, c_feat = cases.GENERAL_LEVELS[level]
    gen = torch.Generator().manual_seed(seed)
    mod = SetAbstractionMSG(N_MAX, radii, nsamples, mlps, 3 + c_feat)
    init_parameters(mod, gen)
    with torch.no_grad():
        for name, buf in mod.named_buffers():
            noise = torch.rand(buf.shape, generator=gen)
            buf.copy_(0.2 * noise - 0.1 if name.endswith("running_mean")
                      else 0.5 + noise)
        for name, prm in mod.named_parameters():
            if ".bn_" in name:
                prm.add_(0.2 * torch.rand(prm.shape, generator=gen) - 0.1)
    return mod.eval().requires_grad_(False).to(device=device, dtype=dtype)


def phase_general_slice(torch, seed: int):
    """Phase 13: the general SA level, eval and one train step, the card
    against the CPU. Returns the card's launch counts over all levels."""
    from ratrack_tpu_torch.kernels import cases

    pc1, m1, _, _ = cases.clouds(seed, N_STREAMS, N_MAX)
    gen = torch.Generator().manual_seed(seed + 4)
    c_feat = cases.GENERAL_LEVELS["one_scale"][3]
    feats = torch.randn((N_STREAMS, N_MAX, c_feat), generator=gen)
    total = {k: 0 for k in SCALE_KERNELS}
    zero = {k: 0 for k in counters()}

    def run(level, device, dtype, train):
        mod = general_level(torch, level, seed + 5, dtype, device)
        xyz, mask = pc1.to(device=device, dtype=dtype), m1.to(device)
        f = feats.to(device=device, dtype=dtype).clone()
        if not train:
            with torch.no_grad():
                return {"out": mod(xyz, f, mask)[1]}, {}
        mod.train().requires_grad_(True)
        f.requires_grad_(True)
        out = mod(xyz, f, mask)[1]
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            seed + 6)).to(device=device, dtype=dtype)
        (out * cot).sum().backward()
        outs = {"out": out.detach(),
                **{n: b.detach().clone() for n, b in mod.named_buffers()}}
        grads = {"features": f.grad,
                 **{n: p.grad for n, p in mod.named_parameters()}}
        return outs, grads

    for level, (radii, *_rest) in cases.GENERAL_LEVELS.items():
        n_scales = len(radii)
        for train in (False, True):
            want = run(level, "cpu", torch.float32, train)
            want64 = run(level, "cpu", torch.float64, train) if train else None
            reset_counters()
            got = run(level, "cuda", torch.float32, train)
            torch.cuda.synchronize()
            launches = read_counters()
            names = (("sa_scale_train_fwd", "sa_scale_train_bwd") if train
                     else ("sa_scale",))
            expect = {**zero, **{k: n_scales for k in names}}
            if not train and n_scales == 2:   # eval: two scales -> one B1
                expect = {**zero, "sa_pair": 1}
            if launches != expect:
                record_failure(f"general slice {level} train={train}: "
                               f"launch counts {launches}, expected {expect}")
            for k in names:
                total[k] += launches[k]
            got = tuple({k: v.cpu() for k, v in part.items()} for part in got)
            bad, errs = cases.compare_train(got, want, want64)
            if bad:
                record_failure(f"general slice {level} train={train}: "
                               + "; ".join(bad))
            emit(phase="general_slice", level=level, scales=n_scales,
                 train=train, streams=N_STREAMS, points=N_MAX,
                 out_max_abs_err=errs["out"],
                 worst_max_abs_err=max(errs.values()),
                 launches={k: v for k, v in launches.items() if v})
    return total


def serve_scans(seed: int, n_scans: int):
    """A synthetic stream as raw scans [x y z RCS v_r]: scan 0 the first
    record's pc2 side, scan t + 1 record t's pc1 side."""
    import numpy as np
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip
    s = stack_frames(synthetic_clip(seed, n_scans, n_max=N_MAX, g_max=K_MAX,
                                    n_static=300, n_objects=5))
    scans = [np.concatenate([s.pc2[0][s.mask2[0]], s.ft2[0][s.mask2[0]]], 1)]
    for i in range(n_scans):
        scans.append(np.concatenate([s.pc1[i][s.mask1[i]],
                                     s.ft1[i][s.mask1[i]]], 1))
    return scans


def phase_serving(torch, seed: int, card: str):
    """Phase 14: the serving entry point on the card against the CPU, then
    its per-call wall time."""
    import numpy as np
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.serve import RadarTracker

    def model(device, sinkhorn_kernel=False):
        return Track4D(npoint=N_MAX, k_max=K_MAX,
                       sinkhorn_iters=SINKHORN_ITERS,
                       sinkhorn_kernel=sinkhorn_kernel,
                       generator=torch.Generator().manual_seed(seed),
                       device=device)

    scans = [serve_scans(seed + 400 + s, SERVE_SCANS)
             for s in range(N_STREAMS)]
    results = {}
    for device in ("cpu", "cuda"):
        svc = RadarTracker(model(device), n_max=N_MAX, max_streams=N_STREAMS)
        sids = [svc.open_stream() for _ in range(N_STREAMS)]
        outs = []
        for t in range(SERVE_SCANS + 1):
            for sid in sids:
                svc.submit(sid, scans[sid][t])
            res = svc.step()
            if t == 0 and res:
                record_failure("serving: a first scan gave a result")
            if t > 0:
                outs.append([res[sid] for sid in sids])
        results[device] = outs
    bad = {"labels": 0, "point_track_id": 0, "track_id": 0}
    flow_err = conf_err = 0.0
    clustered = 0
    for step_c, step_g in zip(results["cpu"], results["cuda"]):
        for c, g in zip(step_c, step_g):
            for k in bad:
                bad[k] += int((getattr(c, k) != getattr(g, k)).sum())
            flow_err = max(flow_err, float(np.abs(c.flow - g.flow).max()))
            conf_err = max(conf_err, float(np.abs(c.conf - g.conf).max()))
            clustered += int((c.labels >= 0).sum())
            if not (np.isfinite(g.flow).all() and g.flow.shape == (N_MAX, 3)
                    and g.labels.shape == (N_MAX,)
                    and g.track_id.shape == (K_MAX,)):
                record_failure("serving: output shape or finiteness")
    emit(phase="serving", check="card_vs_cpu", streams=N_STREAMS,
         scans=SERVE_SCANS, mismatches=bad, clustered_points=clustered,
         flow_max_abs_err=flow_err, conf_max_abs_err=conf_err)
    if any(bad.values()) or flow_err > 1e-3 or conf_err > 1e-3:
        record_failure(f"serving card vs CPU: mismatches {bad}, flow err "
                       f"{flow_err}, conf err {conf_err}")

    rng = np.random.RandomState(seed)

    def scan():
        return np.concatenate([rng.randn(360, 3).astype(np.float32) * 10,
                               rng.randn(360, 2).astype(np.float32)], axis=1)

    step_launches = {"sa_pair": 9, "three_interpolate": 9,
                     "knn_weight_aggregate": 2}
    for sinkhorn_kernel in (False, True):
        net = model("cuda", sinkhorn_kernel)
        for name, bucket in (("serve_latency_1stream", 1),
                             ("serve_throughput_8streams", N_STREAMS)):
            svc = RadarTracker(net, n_max=N_MAX, max_streams=bucket)
            sids = [svc.open_stream() for _ in range(bucket)]

            def call():
                if bucket == 1:
                    return svc.track(sids[0], scan())
                for sid in sids:
                    svc.submit(sid, scan())
                return svc.step()

            call()                                   # first scans: no pair
            for _ in range(SERVE_WARMUP):
                call()
            times = []
            reset_counters()
            for _ in range(SERVE_CALLS):
                t0 = time.perf_counter()
                out = call()
                times.append(1000.0 * (time.perf_counter() - t0))
            launches = read_counters()
            want = {**{k: 0 for k in counters()},
                    **{k: v * SERVE_CALLS for k, v in step_launches.items()},
                    "sinkhorn_uv": SERVE_CALLS * int(sinkhorn_kernel)}
            if launches != want:
                record_failure(f"{name} launch counts {launches}, expected "
                               f"{want}")
            if svc.last_bucket != bucket or out is None:
                record_failure(f"{name}: bucket {svc.last_bucket}, expected "
                               f"{bucket}")
            emit(phase="serving", scenario=name, bucket=svc.last_bucket,
                 sinkhorn_kernel=sinkhorn_kernel, calls=SERVE_CALLS,
                 ms_per_call_median=statistics.median(times),
                 ms_per_call_worst=max(times), ms_per_call_best=min(times),
                 scans_per_s=1000.0 * bucket / statistics.median(times),
                 launches_per_step={k: v // SERVE_CALLS
                                    for k, v in launches.items() if v},
                 card=card)


def expected_train_stretch_launches(t: int, n_max: int):
    # as expected_train_launches, plus a farthest point sampling per SA
    # level (3 heads x 3 levels) and the tiled kNN as the selection of both
    # correlator stages; at 16384 points the three fp1 levels (16384
    # unknown x 512 known points) select through it too
    per_frame = 2 + (3 if n_max * STRETCH_NPOINT > 4 * 1024 * 1024 else 0)
    return {**expected_train_launches(t), "furthest_point_sample": 9 * t,
            "knn_tiled": per_frame * t}


def phase_train_stretch(torch, seed: int, card: str):
    """Phase 15: the train stretch path, one frame step against the CPU,
    then frames/s and peak memory of the two scenarios."""
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    n = TRAIN_STRETCH_SLICE_N
    compare_train_runs(torch, seed, "train_stretch_slice",
                       expected_train_stretch_launches(1, n),
                       dict(points=n, streams=1, frames=1), stretch_n=n)
    dev = torch.device("cuda")
    for n_max, streams, t in TRAIN_STRETCH_SCAN:
        model = stretch_model(torch, seed, dev, sinkhorn_kernel=False)
        scan = make_scan_train_step(create_train_state(
            model, TrainConfig(), steps_per_epoch=100, device=dev))
        frames = stretch_frames(torch, seed + 500, t, dev, n_max, streams)
        state0 = init_state(streams, K_MAX, device=dev)
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
        want = expected_train_stretch_launches(t, n_max)
        if launches != want:
            record_failure(f"train stretch {n_max} launch counts {launches}, "
                           f"expected {want}")
        if not all(bool(torch.isfinite(v).all()) for v in items.values()):
            record_failure(f"train stretch {n_max}: losses not finite")
        dt = statistics.median(times)
        emit(phase="train_stretch", points=n_max, streams=streams,
             frames_per_stream=t, sinkhorn_iters=SINKHORN_ITERS,
             sinkhorn_kernel=False, frames_per_s=streams * t / dt,
             ms_per_frame=1000.0 * dt / (streams * t), scan_seconds=times,
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             loss_first_last=[items["Loss"][0].mean().item(),
                              items["Loss"][-1].mean().item()],
             card=card, launches=launches)
        del model, scan, frames, items


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
    del model
    summary.update(phase_scale_kernels(torch, SEED))
    scale_launches = phase_general_slice(torch, SEED)
    phase_serving(torch, SEED, card)
    phase_train_stretch(torch, SEED, card)
    if FAILED:
        fail(f"{len(FAILED)} failed checks in phases 12-15")
    launches = {**{k: launches[k] for k in EVAL_KERNELS},
                **{k: train_launches[k] for k in TRAIN_KERNELS},
                **{k: stretch_launches[k] for k in STRETCH_KERNELS},
                **scale_launches}
    if not all(launches.values()):
        fail(f"a kernel was never launched on its path: {launches}")

    kernels = []
    for name, meta in KERNELS.items():
        entry = summary[name]
        bound_ms, bound_by = roofline(entry["bytes"], entry["mm_ops"],
                                      entry["ops"])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=entry["max_abs_err"], ms=entry["ms"],
            plain_ms=entry["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=entry["library_ms"]))
    # B1 and B2 at the stretch shape: both heads' sa1 (8192 points x 512
    # centers) and fp1 (8192 unknowns x 512 known points); B3's selection
    # launches of an eval step
    for name, part, prefix in (("sa_pair", "sa_pair_stretch", "stretch"),
                               ("three_interpolate",
                                "three_interpolate_stretch", "stretch"),
                               ("knn_weight_aggregate", "knn_select",
                                "select")):
        entry = summary[part]
        bound_ms, _ = roofline(entry["bytes"], entry["mm_ops"], entry["ops"])
        extra = {f"{prefix}_ms": entry["ms"],
                 f"{prefix}_plain_ms": entry["plain_ms"],
                 f"{prefix}_bound_ms": bound_ms}
        if entry["library_ms"] is not None:
            extra[f"{prefix}_library_ms"] = entry["library_ms"]
        next(k for k in kernels if k["name"] == name).update(extra)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
