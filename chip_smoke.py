#!/usr/bin/env python3
"""Drive the PyTorch port's eval and train paths on one NVIDIA GPU and
check them.

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
                3, frames/s, ms/frame, peak device memory (no gate).
Then one JSON line with every kernel's route, source, launches (eval
kernels from phase 5's run, train kernels from phase 8's), error and
times, and last the result line. Any failed check exits non-zero before
the result line (phases 6-8 record their failed checks and go on, so
that one run reports all of them; the script then exits non-zero). With
no CUDA device, or without the ratrack_tpu_torch package beside this
file, it exits non-zero at once.
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
REPS = 20
SEED = 0

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
}
EVAL_KERNELS = ("sa_pair", "three_interpolate", "knn_weight_aggregate")
TRAIN_KERNELS = tuple(k for k in KERNELS if k not in EVAL_KERNELS)


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


def phase_kernels(torch, seed: int):
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_correlator, fused_fp, fused_sa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    pc1, m1, pc2, m2 = cases.clouds(seed, N_STREAMS, N_MAX)
    runs = []   # (kernel, config, kernel fn, plain fn)
    for head in ("pn_head", "mse"):
        for level in cases.SA_LEVELS:
            kw = cases.to_device(cases.sa_case(level, head, pc1, m1, gen),
                                 dev)
            runs.append(("sa_pair", f"{head}.{level}",
                         lambda kw=kw: fused_sa.sa_pair(
                             **kw, return_indices=True),
                         lambda kw=kw: fused_sa.sa_pair_reference(**kw)))
        for level in cases.FP_LEVELS:
            kw = cases.to_device(cases.fp_case(level, pc1, m1, gen), dev)
            runs.append(("three_interpolate", f"{head}.{level}",
                         lambda kw=kw: fused_fp.fused_three_interpolate(
                             **kw, return_indices=True),
                         lambda kw=kw: fused_fp.three_interpolate_reference(
                             **kw)))
    for stage in (1, 2):
        kw = cases.to_device(cases.corr_case(stage, pc1, m1, pc2, m2, gen),
                             dev)
        runs.append(("knn_weight_aggregate", f"stage{stage}",
                     lambda kw=kw: fused_correlator.fused_knn_weight_aggregate(
                         **kw, return_indices=True),
                     lambda kw=kw:
                     fused_correlator.knn_weight_aggregate_reference(**kw)))

    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
               for k in EVAL_KERNELS}
    with torch.inference_mode():
        for kernel, config, run_k, run_p in runs:
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            if kernel == "sa_pair":
                errs = [compare(torch, f"{kernel}[{config}].{t}", got[i],
                                want[i], got[i + 2], want[i + 2])
                        for i, t in enumerate("ab")]
                err = max(e for e, _ in errs)
                tol = min(t for _, t in errs)
            else:
                err, tol = compare(torch, f"{kernel}[{config}]", got[0],
                                   want[0], got[1], want[1])
            ms, plain_ms = device_ms(torch, run_k), device_ms(torch, run_p)
            emit(phase="kernel", kernel=kernel, config=config,
                 max_abs_err=err, tol=tol, indices_equal=True, ms=ms,
                 plain_ms=plain_ms)
            s = summary[kernel]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["ms"] += ms
            s["plain_ms"] += plain_ms
    return summary


def counters():
    from ratrack_tpu_torch.ops import (fused_correlator,
                                       fused_correlator_train, fused_fp,
                                       fused_sa, fused_sa_train)
    return {"sa_pair": fused_sa.sa_pair,
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
    return {**{k: 0 for k in TRAIN_KERNELS},
            "sa_pair": 6 * t + 3, "three_interpolate": 6 * t + 3,
            "knn_weight_aggregate": 2 * t}


def expected_train_launches(t: int):
    # per frame step: 3 PNHeads (pc1, pc2, the decoder's mse) x 3 SA
    # levels, forward and backward; 2 correlator stages; no eval kernel
    return {**{k: 0 for k in EVAL_KERNELS},
            "sa_pair_train_fwd": 9 * t, "sa_pair_train_bwd": 9 * t,
            "knn_weight_aggregate_train_fwd": 2 * t,
            "knn_weight_aggregate_train_bwd": 2 * t}


def make_frames(torch, seed: int, t: int, device):
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, \
        to_tensors
    clips = [stack_frames(synthetic_clip(seed + s, t, n_max=N_MAX,
                                         g_max=K_MAX, n_static=300,
                                         n_objects=5))
             for s in range(N_STREAMS)]
    return to_tensors(stack_frames(clips), device)


def phase_slice(torch, seed: int):
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    model = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    generator=torch.Generator().manual_seed(seed))
    scan = make_scan_eval_step_cached(model)
    t0 = time.perf_counter()
    frames_cpu = make_frames(torch, seed, SLICE_T, "cpu")
    _, cpu = scan(init_state(N_STREAMS, K_MAX), frames_cpu)
    cpu_s = time.perf_counter() - t0

    dev = torch.device("cuda")
    model.to(dev)
    frames = make_frames(torch, seed, SLICE_T, dev)
    reset_counters()
    _, gpu = scan(init_state(N_STREAMS, K_MAX, device=dev), frames)
    torch.cuda.synchronize()
    launches = read_counters()
    want = expected_launches(SLICE_T)
    if launches != want:
        fail(f"slice launch counts {launches}, expected {want}")
    gpu = {k: v.cpu() for k, v in gpu.items()}

    pc1 = frames_cpu.pc1
    flow_cpu, flow_gpu = cpu["warp"] - pc1, gpu["warp"] - pc1
    for k, shape in (("cls", (N_STREAMS, SLICE_T, N_MAX)),
                     ("warp", (N_STREAMS, SLICE_T, N_MAX, 3)),
                     ("labels", (N_STREAMS, SLICE_T, N_MAX)),
                     ("track_id", (N_STREAMS, SLICE_T, K_MAX))):
        if tuple(gpu[k].shape) != shape:
            fail(f"slice {k} shape {tuple(gpu[k].shape)}, expected {shape}")
    if not (torch.isfinite(gpu["cls"]).all() and
            torch.isfinite(gpu["warp"]).all()):
        fail("slice outputs not finite")
    cls_err = (gpu["cls"] - cpu["cls"]).abs().max().item()
    flow_err = (flow_gpu - flow_cpu).abs().max().item()
    label_bad = int((gpu["labels"] != cpu["labels"]).sum())
    tid_bad = int((gpu["track_id"] != cpu["track_id"]).sum())
    n_clustered = int((cpu["labels"] >= 0).sum())
    n_tracks = int((cpu["track_id"] >= 0).sum())
    emit(phase="slice", streams=N_STREAMS, frames=SLICE_T,
         cls_max_abs_err=cls_err, flow_max_abs_err=flow_err,
         label_mismatch=label_bad, label_total=gpu["labels"].numel(),
         clustered_points=n_clustered, track_id_mismatch=tid_bad,
         track_id_total=gpu["track_id"].numel(), live_tracks=n_tracks,
         launches=launches, cpu_seconds=cpu_s)
    if cls_err > 1e-3 or flow_err > 1e-3:
        fail(f"slice cls err {cls_err} / flow err {flow_err} > 1e-3")
    if (label_bad > 0.01 * gpu["labels"].numel()
            or tid_bad > 0.01 * gpu["track_id"].numel()):
        fail(f"slice mismatches: labels {label_bad}, track ids {tid_bad}")
    return model


def phase_throughput(torch, model, seed: int, card: str, profile_dir):
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    dev = torch.device("cuda")
    scan = make_scan_eval_step_cached(model)
    frames = make_frames(torch, seed + 100, SCAN_T, dev)
    state0 = init_state(N_STREAMS, K_MAX, device=dev)
    scan(state0, frames)                              # warm-up
    torch.cuda.synchronize()
    times, launches = [], None
    for rep in range(3):
        if rep == 0:
            reset_counters()
        t0 = time.perf_counter()
        _, out = scan(state0, frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = read_counters()
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
    return launches


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

    summary = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
               for k in TRAIN_KERNELS}
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
        emit(phase="train_kernel", kernel=kernel, config=config,
             fwd_max_abs_err=err["fwd"], grad_max_abs_err=err["bwd"],
             indices_equal=True, fwd_ms=ms["kernel_fwd"],
             fwd_plain_ms=ms["plain_fwd"], bwd_ms=ms["kernel_bwd"],
             bwd_plain_ms=ms["plain_bwd"])
        for part in ("fwd", "bwd"):
            s = summary[f"{kernel}_{part}"]
            s["max_abs_err"] = max(s["max_abs_err"], err[part])
            s["ms"] += ms[f"kernel_{part}"]
            s["plain_ms"] += ms[f"plain_{part}"]
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
                    generator=torch.Generator().manual_seed(seed)).to(
                        device=dev, dtype=dtype)
    scan = make_scan_train_step(
        create_train_state(model, TrainConfig(), steps_per_epoch=100))
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
                    generator=torch.Generator().manual_seed(seed)).to(dev)
    scan = make_scan_train_step(
        create_train_state(model, TrainConfig(), steps_per_epoch=100))
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
        m = re.search(r"entry function '_Z\w*?([a-z][a-z_]*_kernel)E", line)
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
                         "eval and train scans (and device busy-share "
                         "lines)")
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
    launches = phase_throughput(torch, model, SEED, card, args.profile)
    del model
    summary.update(phase_train_kernels(torch, SEED))
    phase_train_slice(torch, SEED)
    train_launches = phase_train_throughput(torch, SEED, card, args.profile)
    launches = {**{k: launches[k] for k in EVAL_KERNELS},
                **{k: train_launches[k] for k in TRAIN_KERNELS}}
    if FAILED:
        fail(f"{len(FAILED)} failed checks in phases 6-8")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=meta["source"],
             replaces=meta["replaces"], launches=launches[name],
             max_abs_err=summary[name]["max_abs_err"],
             ms=summary[name]["ms"], plain_ms=summary[name]["plain_ms"])
        for name, meta in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
