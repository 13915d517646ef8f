"""One run of one cell: set-up, the measured window, the traced slice,
the check against the reference, and the result's line.

The window dispatches whole blocks back to back (a closed loop) until
`seconds` have passed; each block's outputs come back to the host inside
it. The rate is every frame of every block completed over the time from
the first dispatch to the last block's synchronise. Set-up is everything
before the window: imports, the kernel library, weights, traffic and one
warm-up block of the cell's own shapes. The model is reached only through
the cell's family (spec.py): its weights, their preparation, the traced
slice's work and FLOPs, and the comparison.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, spec, traffic
from .trace import profile_frames, sync

FORBIDDEN = ("jax", "jaxlib", "flax", "ratrack_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (ratrack_tpu_torch is not ratrack_tpu)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Run:
    """What a run measured, as the per-layer readers take it."""
    cell: spec.Cell
    kind: str
    frames: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    slice: object = None
    work: dict = field(default_factory=dict)   # layer -> [work tuples]
    flops_per_frame: int = 0
    busy_s: float | None = None      # averaged over the ranks

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.window_s


@dataclass
class Measured:
    """The program's side of a run, its state freed: what the check
    compares."""
    run: Run
    weights: dict           # the weights both sides start from
    frames: object          # the compared frames (every rank's streams)
    prog: dict              # the program's outputs or readings of them
    peak: int               # memory_peak_bytes


def run_program(cell: spec.Cell, seed: int, seconds: float, trace: bool,
                device, t_start: float, mesh=None) -> Measured:
    """Set-up, the window, the traced slice and the program's side of
    the check, the program's state freed at the end."""
    wl, mix, fam = cell.workload, cell.traffic, cell.family
    streams = mix["streams"] if mesh is None else mix["streams"] // mesh.dp
    entry_cls = spec.entry_module(wl["entry"], cell.home).Entry
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    weights = fam.make_weights(cell, seed, device)
    full = pool = traffic.make_pool(mix, seed, device)
    weights = fam.prepare(cell, weights, full, device)
    if mesh is not None:    # this rank's streams
        lo = mesh.rank * streams
        pool = traffic.FrameBatch(*[x[lo:lo + streams] for x in full])
    entry = entry_cls(cell, weights, pool, device, mesh)
    entry.warm_up()
    sync(device)
    run = Run(cell=cell, kind=entry.kind)
    run.setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    j = 1
    while True:
        run.frames += entry.run_block(j)
        j += 1
        if _agree(mesh, time.perf_counter() - t0 >= seconds, device):
            break
    run.window_s = time.perf_counter() - t0
    peak = _reduce(mesh, torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0, device, "max")

    if trace:
        frames = min(wl["trace_frames"], mix["block_frames"])
        run.slice = profile_frames(entry, j, frames, device)
        run.work = fam.slice_work(cell, pool, j, frames, entry.kind)
        run.flops_per_frame = fam.flops_per_frame(cell, entry.kind)

    frames, prog = entry.sample(rng)
    if mesh is not None:    # the reference follows every rank's streams
        frames = traffic.FrameBatch(*[
            x[:, :frames.pc1.shape[1]]
            for x in traffic.block(full, 0, mix["block_frames"])])
        run.busy_s = (None if run.slice is None else _reduce(
            mesh, run.slice.busy_s(), device, "sum") / mesh.dp)
    entry.release()
    del entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Measured(run, weights, frames, prog, int(peak))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, mesh=None) -> dict:
    """One run -> the result (the contract's keys, and `check`); None on
    the ranks after the first."""
    m = run_program(cell, seed, seconds, trace, device, t_start, mesh)
    if mesh is not None and mesh.rank != 0:
        return None
    run, peak = m.run, m.peak
    values = numbers(cell, run.kind, m.weights, m.frames, m.prog)
    correct, rows = check.verdict(values, cell.workload["check"]["limits"])

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": value_of(m["name"], run),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = dict(correct=bool(correct), attempted=run.frames, failed=0,
                  metrics=metrics,
                  device=dict(platform="gpu" if device.type == "cuda"
                              else device.type,
                              kind=(torch.cuda.get_device_name(device)
                                    if device.type == "cuda" else "cpu"),
                              count=cell.chips, memory_peak_bytes=peak))
    if trace:
        sl = run.slice
        result["device"].update(busy_s=sl.busy_s() if mesh is None
                                else run.busy_s, window_s=sl.wall_s)
        result["breakdown"] = dict(
            device_ops=[list(x) for x in sl.top_device_ops()],
            idle_gaps=[list(x) for x in sl.idle_gaps()])
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def numbers(cell: spec.Cell, kind: str, weights, frames, got,
            ref=None) -> dict:
    """The check's numbers of `got` (the program's outputs or readings,
    or the control's in their place) against the family's reference
    (run here unless `ref` is given) -> {name: value}."""
    fam = cell.family
    if ref is None:
        ref = fam.reference(kind, cell, weights, frames)
    return fam.compare(kind, got, ref, weights, frames)


def _agree(mesh, done: bool, device) -> bool:
    """Rank 0's decision, on every rank (one process: `done`)."""
    if mesh is None:
        return done
    import torch.distributed as dist
    flag = torch.tensor([float(done)], device=device)
    dist.broadcast(flag, src=0, group=mesh.group)
    return bool(flag.item())


def _reduce(mesh, value: float, device, op: str) -> float:
    """`value` summed or maxed over the ranks (one process: itself)."""
    if mesh is None:
        return value
    import torch.distributed as dist
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()),
                    group=mesh.group)
    return t.item()


def value_of(name: str, run: Run) -> float:
    """An end-to-end metric of the run, by its name."""
    if name == "setup_s":
        return run.setup_s
    if name in ("eval_frames_per_s", "train_frames_per_s"):
        return run.frames_per_s
    raise KeyError(f"no end-to-end metric {name!r}")
