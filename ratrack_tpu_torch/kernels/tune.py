"""Time the launch shapes of kernel B6, the forward and backward of kernels
B9 / B8, the backward of kernel B10, the aggregate kernel (B4, B3, B10's
forward), kernel B7, kernels B1 / B1', kernel B5, kernel B2 and B3's
selection launch on the card.

    python3 -m ratrack_tpu_torch.kernels.tune [--fps] [--sa] [--corr]
                                              [--apply] [--sinkhorn]
                                              [--sa-eval] [--knn] [--fp]
                                              [--select]

B6 (`csrc/fps.cu`) takes its launch shape (threads a block, blocks a
stream: one block, or a thread-block cluster) from a table by N; this
script measures the candidates at N = 512 (no mask), 4096, 8192 and 16384
(masked stretch clouds), 512 samples each, each checked against the plain
loop, so that the table can be read off its output. For B9 / B8 (--sa) it
prints the backward's and the forward's time per level config, and the
forward at the train stretch shapes. For B10 (--corr) the backward per
stage with the time of each of its kernels (torch.profiler) beside its
four pair-layer products as torch.matmul. For the aggregate kernel
(--apply) B4 per stage at 8192 points, B3 (its kNN and aggregate
launches) and B10's forward per stage at 8 streams x 512 points, each with
its kernels' times (torch.profiler) and the aggregate launch at 64 and 128
pair rows a block (the table of csrc/correlator.cu::default_block_rows was
read off it), and for stage 1 its two pair-layer products as torch.matmul
(products_torch_ms). For B7 (--sinkhorn) 8 streams x 33 x 33 at 0 and 500
iterations, its own shape and every variant (lanes a row; exp(c + v) a
term, exp(c) once times exp(v), and the skeleton without exp or log, the
latency floor of the launch shape), with the cost of one half-step: the
difference of the two times over 1,000 half-steps. For B1 / B1'
(--sa-eval) each level config at 8 streams x 512 points, the GENERAL_LEVELS
scales and sa1 at 8192 points x 512 centers, at every center tile, the
kernel's own choice and its skeleton (the ball query, the compaction and
the index output without a layer: the launch's floor) (the table of
csrc/sa_pair.cu::default_tile was read off it). For B5 (--knn) both
stages at 8192 points and stage 1 at 16384, Z-sorted and unsorted, at
every launch shape (queries a block, candidates a chunk), as the port
builds it (chunk gate on), with the gate off and as the skeleton (every
chunk scanned, nothing inserted: the scan's floor)
(ops/fused_knn.py::KERNEL_SHAPE was read off it). For B2 (--fp) each FP
level at 8 streams x 512 points (fp3 / fp2 / fp1: 64 / 128 / 128
channels), fp1 of one stream (serving bucket 1) and of an 8192-point
cloud under its 512 farthest-point centers, at every launch shape
(unknowns a block, lanes an unknown), the kernel's own choice and its
skeleton (one known point a lane: the staging, the merge and the
weighted sum, the launch's floor) (csrc/fp.cu::default_shape was read
off it). For B3's selection launch (--select) both correlator stages at
8 streams x 512 points (eval), 1 x 512 (serving bucket 1) and 1 x 4096
(the largest dense cloud), at every tile of queries, the kernel's own
choice and the skeleton (every candidate staged and scanned, nothing
inserted) (csrc/correlator.cu::default_knn_queries was read off it).
The skeletons and the gate off are measuring builds of the same sources
(build.measuring), never the port's. One JSON line per measurement, the
card's name and power limit first. Times are medians of 20 CUDA-event
runs after 3 warm-up runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from ..ops import (fused_correlator, fused_correlator_train, fused_fp,
                   fused_knn, fused_sa, fused_sa_train, fused_sinkhorn,
                   sampling)
from . import build, cases

NPOINT = 512
# (threads a block, blocks a stream) per cloud size
FPS_SHAPES = {
    512: [(512, 1), (256, 1), (128, 1), (64, 1), (128, 2), (64, 4)],
    4096: [(1024, 1), (512, 1), (256, 1), (256, 4)],
    8192: [(1024, 1), (512, 1), (1024, 2), (512, 4), (256, 4), (256, 8),
           (128, 8)],
    16384: [(1024, 1), (1024, 2), (512, 4), (256, 4), (256, 8), (128, 8)],
}


def device_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() in ms; a spin kernel queued first hides
    the host's enqueue time."""
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


def measured_ms(macros, fn) -> float:
    """device_ms of fn() with the kernels of the measuring build that
    defines `macros` (none: the port's own build)."""
    with build.measuring(*macros):
        return device_ms(fn)


def kernel_breakdown(fn, reps: int = 5) -> dict:
    """{kernel name: device ms a call} of the CUDA kernels fn() launches,
    by torch.profiler over `reps` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1][:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def fps_cases(seed: int = 0):
    """{N: arguments of furthest_point_sample} on the card, as the stretch
    frame step calls it."""
    dev = torch.device("cuda")
    out = {}
    pc, mask, _, _ = cases.stretch_clouds(seed, 8192)
    out[512] = cases.to_device(cases.fps_case(
        cases.fps_centers(pc, mask, NPOINT), None, NPOINT), dev)
    for n in (4096, 8192, 16384):
        pc, mask, _, _ = cases.stretch_clouds(seed, n)
        out[n] = cases.to_device(cases.fps_case(pc, mask, NPOINT), dev)
    return out


def time_fps_shapes(emit=print):
    """Every candidate shape of FPS_SHAPES against the plain loop (indices
    equal, or the shape is reported as wrong) and its time; the kernel's
    own choice as shape None."""
    for n, kw in fps_cases().items():
        want = sampling.furthest_point_sample_reference(**kw)
        for shape in [None] + FPS_SHAPES[n]:
            got = sampling.furthest_point_sample(**kw, shape=shape)
            torch.cuda.synchronize()
            emit(json.dumps(dict(
                kernel="furthest_point_sample", n=n, shape=shape,
                equal=bool(torch.equal(got, want)),
                ms=device_ms(lambda: sampling.furthest_point_sample(
                    **kw, shape=shape)))))


def time_sa_backward(emit=print, streams: int = 8, seed: int = 0):
    """The backward of B9 at the six level configs and of B8 at their
    scales, 8 streams x 512 points: ms a launch."""
    emit(json.dumps(dict(
        clusters_held=build.load().ratrack_sa_train_bwd_clusters(streams, 2),
        clusters_of_a_pair_launch=2 * streams)))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    pc, mask, _, _ = cases.clouds(seed, streams, 512)
    for head in ("pn_head", "mse"):
        for level in cases.SA_LEVELS:
            kw = cases.to_device(cases.sa_train_case(level, head, pc, mask,
                                                     gen), dev)
            runs = [("sa_pair_train_bwd", cases.sa_train_loss,
                     fused_sa_train.sa_pair_train, kw)]
            runs += [(f"sa_scale_train_bwd.{t}", cases.sa_scale_train_loss,
                      fused_sa_train.sa_scale_train, single)
                     for t, single in zip("ab", cases.split_sa_train_case(kw))]
            for name, loss_fn, fn, case in runs:
                loss, _, leaves = loss_fn(fn, case)
                flat = [x for _, x in cases.flat_leaves(leaves)]
                emit(json.dumps(dict(
                    kernel=name, config=f"{head}.{level}",
                    ms=device_ms(lambda: torch.autograd.grad(
                        loss, flat, retain_graph=True)))))


def time_sa_forward(emit=print, streams: int = 8, seed: int = 0):
    """The forward of B9 at the six level configs and of B8 at their
    scales, 8 streams x 512 points, then B9 at sa1 of the train stretch
    shapes (8192 points x 2 streams, 16384 x 1; 512 farthest-point
    centers): ms a call."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    pc, mask, _, _ = cases.clouds(seed, streams, 512)
    for head in ("pn_head", "mse"):
        for level in cases.SA_LEVELS:
            kw = cases.to_device(cases.sa_train_case(level, head, pc, mask,
                                                     gen), dev)
            runs = [("sa_pair_train_fwd", fused_sa_train.sa_pair_train, kw)]
            runs += [(f"sa_scale_train_fwd.{t}", fused_sa_train.sa_scale_train,
                      single)
                     for t, single in zip("ab", cases.split_sa_train_case(kw))]
            for name, fn, case in runs:
                with torch.no_grad():
                    emit(json.dumps(dict(
                        kernel=name, config=f"{head}.{level}",
                        ms=device_ms(lambda: fn(**case)))))
    for n, b in ((8192, 2), (16384, 1)):
        pc, mask, _, _ = cases.clouds(
            seed, b, n, n_static=cases.stretch_static_points(n))
        kw = cases.to_device(cases.sa_train_case(
            "sa1", "pn_head", pc, mask, gen,
            centers=cases.fps_centers(pc, mask, NPOINT)), dev)
        with torch.no_grad():
            emit(json.dumps(dict(
                kernel="sa_pair_train_fwd", config=f"{n}pt.{b}.sa1",
                ms=device_ms(lambda: fused_sa_train.sa_pair_train(**kw)))))


def time_corr_backward(emit=print, streams: int = 8, seed: int = 0):
    """The backward of B10 per stage at 8 streams x 512 points, ms a
    launch, and for stage 1 its four pair-layer products as torch.matmul
    (float32, TF32 off) on tensors of the same shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    pc1, m1, pc2, m2 = cases.clouds(seed, streams, 512)

    def kernel(**kw):
        return fused_correlator_train.fused_knn_weight_aggregate_train(
            **kw, return_indices=True)
    for stage in (1, 2):
        kw = cases.to_device(cases.corr_train_case(stage, pc1, m1, pc2, m2,
                                                   gen), dev)
        loss, _, leaves = cases.corr_train_loss(kernel, kw)
        flat = [x for _, x in cases.flat_leaves(leaves)]
        def bwd():
            return torch.autograd.grad(loss, flat, retain_graph=True)
        line = dict(kernel="knn_weight_aggregate_train_bwd",
                    config=f"stage{stage}", ms=device_ms(bwd),
                    kernels_ms=kernel_breakdown(bwd))
        if kw["mlp_ws"]:
            line["products_torch_ms"] = device_ms(
                cases.corr_train_products(kernel, kw))
        emit(json.dumps(line))


def time_apply(emit=print, streams: int = 8, seed: int = 0):
    """The aggregate kernel: B4 per stage at 8192 points (one stream), B3
    and B10's forward per stage at `streams` x 512 points; ms a call, the
    kernels' times, the aggregate launch at each block shape (B3's through
    B4's entry on B3's indices) and, for stage 1, the two pair-layer
    products as torch.matmul (float32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)

    def shapes(kw, idx):
        return {rows: device_ms(lambda: fused_correlator.knn_gather_apply(
            idx, **kw, block_rows=rows)) for rows in (64, 128)}

    def line(kernel, config, fn, kw, idx):
        out = dict(kernel=kernel, config=config, ms=device_ms(fn),
                   kernels_ms=kernel_breakdown(fn))
        if kernel != "knn_weight_aggregate_train_fwd":
            out["block_rows_ms"] = shapes(kw, idx)
        if kw["mlp_ws"]:
            out["products_torch_ms"] = device_ms(cases.apply_products(kw,
                                                                      idx))
        emit(json.dumps(out))

    pc1, m1, pc2, m2 = cases.stretch_clouds(seed, 8192)
    for stage in (1, 2):
        kw = cases.to_device(cases.apply_case(stage, pc1, m1, pc2, m2, gen),
                             dev)
        idx = kw.pop("idx")
        line("knn_gather_apply", f"8192.stage{stage}",
             lambda: fused_correlator.knn_gather_apply(idx, **kw), kw, idx)
    pc1, m1, pc2, m2 = cases.clouds(seed, streams, 512)
    for stage in (1, 2):
        kw = cases.to_device(cases.corr_train_case(stage, pc1, m1, pc2, m2,
                                                   gen), dev)
        w_dir, mask = kw.pop("w_dir"), kw.pop("mask_p")
        _, idx = fused_correlator.fused_knn_weight_aggregate(
            **kw, mask_p=mask, return_indices=True)
        line("knn_weight_aggregate", f"{streams}x512.stage{stage}",
             lambda: fused_correlator.fused_knn_weight_aggregate(
                 **kw, mask_p=mask), kw, idx)
        with torch.no_grad():
            line("knn_weight_aggregate_train_fwd",
                 f"{streams}x512.stage{stage}",
                 lambda: fused_correlator_train.
                 fused_knn_weight_aggregate_train(**kw, mask_p=mask,
                                                  w_dir=w_dir), kw, idx)


def time_sinkhorn(emit=print, streams: int = 8, seed: int = 0):
    """B7 at `streams` x 33 x 33, its own shape and every variant, at 0 and
    500 iterations: ms a call and us a half-step."""
    kw, _ = cases.sinkhorn_case(seed, streams, 32, 500)
    kw = cases.to_device(kw, torch.device("cuda"))
    variants = [(None, None)] + [(lanes, mode)
                                 for lanes in fused_sinkhorn.KERNEL_LANES
                                 for mode in fused_sinkhorn.KERNEL_MODES]
    for lanes, mode in variants:
        ms = {iters: device_ms(lambda: fused_sinkhorn.sinkhorn_uv(
            **dict(kw, iters=iters), lanes=lanes, mode=mode))
            for iters in (0, 500)}
        emit(json.dumps(dict(
            kernel="sinkhorn_uv", lanes=lanes, mode=mode, ms_iters_0=ms[0],
            ms_iters_500=ms[500],
            us_per_half_step=(ms[500] - ms[0]) / 1000 * 1000)))


def time_sa_eval(emit=print, streams: int = 8, seed: int = 0):
    """B1 at the six level configs (8 streams x 512 points), B1' at the
    GENERAL_LEVELS scales and B1 at sa1 of an 8192-point cloud with 512
    farthest-point centers: ms a call at every center tile, and the
    skeleton's at the kernel's own."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    pc, mask, _, _ = cases.clouds(seed, streams, 512)
    runs = [(f"{head}.{level}", fused_sa.sa_pair, cases.to_device(
        cases.sa_case(level, head, pc, mask, gen), dev))
        for head in ("pn_head", "mse") for level in cases.SA_LEVELS]
    runs += [(f"{level}.{i}", fused_sa.sa_scale, cases.to_device(kw, dev))
             for level in cases.GENERAL_LEVELS
             for i, kw in enumerate(cases.sa_scale_cases(level, pc, mask,
                                                         gen))]
    spc, smask, _, _ = cases.stretch_clouds(seed, 8192)
    runs += [(f"8192.{head}.sa1", fused_sa.sa_pair, cases.to_device(
        cases.sa_case("sa1", head, spc, smask, gen, npoint=NPOINT), dev))
        for head in ("pn_head", "mse")]
    for config, fn, kw in runs:
        ms = {str(tile): device_ms(lambda: fn(**kw, tile=tile))
              for tile in (None,) + fused_sa.KERNEL_TILES}
        ms["None.skeleton"] = measured_ms(["RATRACK_SKELETON"],
                                          lambda: fn(**kw))
        emit(json.dumps(dict(kernel=fn.__name__, config=config, ms=ms)))


def time_knn(emit=print, seed: int = 0):
    """B5 for both stages of the split correlator at 8192 points and stage
    1 at 16384, Z-sorted (the stretch eval path) and unsorted (B10's
    selection in train stretch), and stage 1 at 8192 with only the valid
    points as queries: ms a call with the chunk gate on (the port's build)
    and off and the skeleton, at every launch shape for stage 1."""
    dev = torch.device("cuda")
    shapes = [None] + [(q, c) for q in fused_knn.KERNEL_QUERIES
                       for c in fused_knn.KERNEL_CHUNKS]
    builds = {"gate": [], "nogate": ["RATRACK_KNN_NO_GATE"],
              "skeleton": ["RATRACK_SKELETON"]}
    for n in (8192, 16384):
        pc1, m1, pc2, m2 = cases.stretch_clouds(seed, n)
        # (stage, Z-sorted, only the query cloud's valid points as queries)
        for stage, zsorted, valid_only in (
                (1, True, False), (1, False, False), (2, True, False),
                (2, False, False), (1, True, True)):
            if n != 8192 and (stage == 2 or valid_only):
                continue
            kw = (cases.knn_tiled_case(stage, pc1, m1, pc2, m2)
                  if zsorted else
                  dict(query=pc1, points=pc2 if stage == 1 else pc1,
                       points_mask=m2 if stage == 1 else m1, k=16))
            if valid_only:   # Z-sorted: the valid points come first
                kw["query"] = kw["query"][:, :int(m1.sum())].contiguous()
            kw = cases.to_device(kw, dev)
            emit(json.dumps(dict(
                kernel="knn_indices_tiled",
                config=f"{n}.stage{stage}."
                       f"{'zsorted' if zsorted else 'unsorted'}"
                       + (".valid_queries" if valid_only else ""),
                ms={f"{shape}.{name}": measured_ms(
                    macros, lambda: fused_knn.knn_indices_tiled(
                        **kw, shape=shape))
                    for shape in (shapes if stage == 1 and not valid_only
                                  else [None])
                    for name, macros in builds.items()},
                kernels_ms=kernel_breakdown(
                    lambda: fused_knn.knn_indices_tiled(**kw)))))


def time_fp(emit=print, streams: int = 8, seed: int = 0):
    """B2 at each FP level (`streams` x 512 points) and at fp1 of an
    8192-point cloud under 512 centers: ms a call at every launch shape,
    the kernel's own and its skeleton's."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    pc, mask, _, _ = cases.clouds(seed, streams, 512)
    runs = [(f"{streams}x512.{level}", cases.fp_case(level, pc, mask, gen))
            for level in cases.FP_LEVELS]
    runs.append(("1x512.fp1", cases.fp_case("fp1", pc[:1], mask[:1], gen)))
    spc, smask, _, _ = cases.stretch_clouds(seed, 8192)
    runs.append(("8192x512.fp1", cases.fp_case("fp1", spc, smask, gen,
                                                npoint=NPOINT)))
    shapes = [None] + list(fused_fp.KERNEL_SHAPES)
    for config, kw in runs:
        kw = cases.to_device(kw, dev)
        ms = {str(shape): device_ms(lambda: fused_fp.fused_three_interpolate(
            **kw, shape=shape)) for shape in shapes}
        ms["None.skeleton"] = measured_ms(
            ["RATRACK_SKELETON"],
            lambda: fused_fp.fused_three_interpolate(**kw))
        emit(json.dumps(dict(kernel="three_interpolate", config=config,
                             ms=ms)))


def time_select(emit=print, seed: int = 0):
    """B3's selection launch (ops.fused_correlator.launch_knn, k = 16) for
    both stages at 8 streams x 512 points, 1 x 512 and 1 x 4096: ms a call
    at every tile of queries, the kernel's own and the skeleton's."""
    dev = torch.device("cuda")
    for streams, n in ((8, 512), (1, 512), (1, 4096)):
        pc1, m1, pc2, m2 = (cases.clouds(seed, streams, n) if n == 512
                            else cases.stretch_clouds(seed, n))
        for stage in (1, 2):
            q, p, mask = [t.to(dev).contiguous() for t in (
                (pc1, pc2, m2) if stage == 1 else (pc1, pc1, m1))]
            ms = {str(queries): device_ms(
                lambda: fused_correlator.launch_knn(q, p, mask, 16,
                                                    queries=queries))
                for queries in (None,) + fused_correlator.KNN_QUERIES}
            ms["None.skeleton"] = measured_ms(
                ["RATRACK_SKELETON"],
                lambda: fused_correlator.launch_knn(q, p, mask, 16))
            emit(json.dumps(dict(kernel="knn_select",
                                 config=f"{streams}x{n}.stage{stage}",
                                 ms=ms)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fps", action="store_true", help="only kernel B6")
    ap.add_argument("--sa", action="store_true", help="only kernels B9 / B8")
    ap.add_argument("--corr", action="store_true",
                    help="only kernel B10's backward")
    ap.add_argument("--apply", action="store_true",
                    help="only the aggregate kernel (B4, B3, B10's forward)")
    ap.add_argument("--sinkhorn", action="store_true", help="only kernel B7")
    ap.add_argument("--sa-eval", action="store_true",
                    help="only kernels B1 / B1'")
    ap.add_argument("--knn", action="store_true", help="only kernel B5")
    ap.add_argument("--fp", action="store_true", help="only kernel B2")
    ap.add_argument("--select", action="store_true",
                    help="only B3's selection launch")
    args = ap.parse_args()
    every = not (args.fps or args.sa or args.corr or args.apply
                 or args.sinkhorn or args.sa_eval or args.knn or args.fp
                 or args.select)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if args.fps or every:
        time_fps_shapes()
    if args.sa or every:
        time_sa_backward()
        time_sa_forward()
    if args.corr or every:
        time_corr_backward()
    if args.apply or every:
        time_apply()
    if args.sinkhorn or every:
        time_sinkhorn()
    if args.sa_eval or every:
        time_sa_eval()
    if args.knn or every:
        time_knn()
    if args.fp or every:
        time_fp()
    if args.select or every:
        time_select()


if __name__ == "__main__":
    main()
