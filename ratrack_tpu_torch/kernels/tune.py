"""Time the launch shapes of kernel B6 and the backward of kernels B9 / B8
on the card, each checked against the plain version first.

    python3 -m ratrack_tpu_torch.kernels.tune [--fps] [--sa]

B6 (`csrc/fps.cu`) takes its launch shape (threads a block, blocks a
stream: one block, or a thread-block cluster) from a table by N; this
script measures the candidates at N = 512 (no mask), 4096, 8192 and 16384
(masked stretch clouds), 512 samples each, so that the table can be read
off its output. For B9 / B8 it prints the backward's time per level
config. One JSON line per measurement, the card's name and power limit
first. Times are medians of 20 CUDA-event runs after 3 warm-up runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from ..ops import fused_sa_train, sampling
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fps", action="store_true", help="only kernel B6")
    ap.add_argument("--sa", action="store_true", help="only kernels B9 / B8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if args.fps or not args.sa:
        time_fps_shapes()
    if args.sa or not args.fps:
        time_sa_backward()


if __name__ == "__main__":
    main()
