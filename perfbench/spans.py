"""The program's spans by layer, and what the per-layer readers take from
them in the traced slice.

ratrack_tpu_torch/trace.py opens a `record_function` span named
`ratrack.<name>` at each layer boundary of the frame step while a
profiler records; the slice keeps them among its host operations, on the
clock of the host's launch calls and the device's operations. A layer's
intervals are the union of its spans' (spans nest and repeat: each
instant counts once). Three helpers read them: host time inside a
layer, the launch calls that start inside it, and the device's idle
time whose gap starts inside it (the gaps `trace.Slice.idle_gaps` finds:
between one device operation's end and the next one's start).

A program without these spans (the parent of the change that brought
them) reads None, as does a slice with no kernel (the CPU, where every
operation runs inside its span and no device waits).
"""

from __future__ import annotations

import bisect

# layer -> the names of its spans (trace.py::SPANS)
LAYERS = {
    "head": ("ratrack.head",),
    "cost_volume": ("ratrack.cost_volume",),
    "decoder": ("ratrack.decoder",),
    "clustering": ("ratrack.dbscan", "ratrack.descriptors"),
    "association": ("ratrack.affinity", "ratrack.sinkhorn",
                    "ratrack.assign_ids"),
    "forward": ("ratrack.forward",),
    "loss": ("ratrack.loss",),
    "backward": ("ratrack.backward",),
    "allreduce": ("ratrack.allreduce",),
    "optimizer": ("ratrack.optimizer",),
}
# the layers that partition a frame step of each kind
STEP_LAYERS = {
    "eval": ("head", "cost_volume", "decoder", "clustering", "association"),
    "train": ("forward", "loss", "backward", "allreduce", "optimizer"),
}
# the host's calls that launch a kernel, as CUPTI names them
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"))


def union(sl, layers) -> list:
    """The union of the intervals of the layers' spans in the slice ->
    [(start_us, end_us)], disjoint and sorted."""
    names = {n for layer in layers for n in LAYERS[layer]}
    out = []
    for _, s, e in sorted((o for o in sl.host_ops if o[0] in names),
                          key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def _inside(ivs, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ivs[i][1]


def host_s(sl, layers) -> float | None:
    """Seconds of the slice inside the layers' spans; None where it holds
    none of them."""
    ivs = union(sl, layers)
    return sum(e - s for s, e in ivs) / 1e6 if ivs else None


def launches(sl, layers) -> int | None:
    """Launch calls of the host that start inside the layers' spans."""
    ivs = union(sl, layers)
    if not ivs:
        return None
    starts = [s for s, _ in ivs]
    return sum(1 for name, s, _ in sl.host_ops
               if name in LAUNCH_CALLS and _inside(ivs, starts, s))


def idle_in(sl, layers) -> tuple | None:
    """(device idle seconds whose gap starts inside the layers' spans, all
    device idle seconds between the slice's device operations); None
    where the slice holds none of the spans or no gap."""
    ivs = union(sl, layers)
    starts = [s for s, _ in ivs]
    inside = total = 0.0
    end = None
    for _, s, e in sorted(sl.device_ops, key=lambda o: o[1]):
        if end is not None and s > end:
            total += s - end
            if ivs and _inside(ivs, starts, end):
                inside += s - end
        end = e if end is None else max(end, e)
    if not ivs or total <= 0.0:
        return None
    return inside / 1e6, total / 1e6


def _slice(run, kind):
    """The run's traced slice where it is of `kind` and holds kernels."""
    sl = run.slice
    if sl is None or run.kind != kind or not sl.kernels:
        return None
    return sl


def host_ms(run, kind, layer):
    """Host milliseconds a frame step inside the layer's spans."""
    sl = _slice(run, kind)
    seconds = None if sl is None else host_s(sl, (layer,))
    return None if seconds is None else 1e3 * seconds / sl.frame_steps


def launches_per_frame(run, kind, layer):
    """Launch calls inside the layer's spans a stream-frame (the unit of
    readers.launches_per_frame)."""
    sl = _slice(run, kind)
    count = None if sl is None else launches(sl, (layer,))
    return None if count is None else count / sl.frames


def idle_in_layers_pct(run, kind):
    """100 x the device idle time whose gap starts inside a span of the
    kind's frame step layers / all device idle time in the slice."""
    sl = _slice(run, kind)
    idle = None if sl is None else idle_in(sl, STEP_LAYERS[kind])
    return None if idle is None else 100.0 * idle[0] / idle[1]
