"""Time the launch shapes of kernel B6, the forward and backward of kernels
B9 / B8 and the backward of kernel B10 on the card.

    python3 -m ratrack_tpu_torch.kernels.tune [--fps] [--sa] [--corr]

B6 (`csrc/fps.cu`) takes its launch shape (threads a block, blocks a
stream: one block, or a thread-block cluster) from a table by N; this
script measures the candidates at N = 512 (no mask), 4096, 8192 and 16384
(masked stretch clouds), 512 samples each, each checked against the plain
loop, so that the table can be read off its output. For B9 / B8 (--sa) it
prints the backward's and the forward's time per level config, and the
forward at the train stretch shapes. For B10 (--corr) the backward per
stage with the time of each of its kernels (torch.profiler) beside its
four pair-layer products as torch.matmul. One JSON line per measurement,
the card's name and power limit first. Times are medians of 20 CUDA-event
runs after 3 warm-up runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from ..ops import fused_correlator_train, fused_sa_train, sampling
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fps", action="store_true", help="only kernel B6")
    ap.add_argument("--sa", action="store_true", help="only kernels B9 / B8")
    ap.add_argument("--corr", action="store_true", help="only kernel B10")
    args = ap.parse_args()
    every = not (args.fps or args.sa or args.corr)
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


if __name__ == "__main__":
    main()
