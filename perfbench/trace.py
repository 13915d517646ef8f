"""The traced slice: torch.profiler (CPU and CUDA activities) over the
first frames of the block after the window, reduced to what the
per-layer readers take.

Device operations are the CUDA events of the trace (kernels, copies,
sets); a kernel is one that is neither a copy nor a set. Busy time is the
union of the device operations' intervals; the slice's wall time runs
from the first block's dispatch to the end of its synchronise. An idle
gap of the device is named by the benchmark's span and the innermost
host operation running where it starts.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class Slice:
    wall_s: float
    frames: int
    frame_steps: int
    kernels: list = field(default_factory=list)   # (name, start_us, end_us)
    device_ops: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)   # (name, start, end)

    def busy_s(self) -> float:
        """Union of the device operations' intervals."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e6

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name `match` accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def top_device_ops(self, n=10):
        by = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10, lookback=256):
        """Idle device time summed by what the host was doing where each
        gap starts -> [(label, seconds)], the largest first. The host
        operation is the latest started one still running there (looked
        for among the `lookback` latest), else "python"."""
        ops = sorted(self.device_ops, key=lambda o: o[1])
        spans = [o for o in self.host_ops if o[0].startswith("bench.")]
        host = sorted((o for o in self.host_ops
                       if not o[0].startswith("bench.")),
                      key=lambda o: o[1])
        starts = [o[1] for o in host]
        gaps, end = [], None
        for _, s, e in ops:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        by = {}
        for g0, g1 in gaps:
            span = next((nm for nm, s, e in spans if s <= g0 <= e),
                        "outside")
            inner = "python"
            i = bisect.bisect_right(starts, g0) - 1
            for k in range(i, max(i - lookback, -1), -1):
                if host[k][2] >= g0:
                    inner = host[k][0]
                    break
            label = f"{span}: {inner}"
            by[label] = by.get(label, 0.0) + (g1 - g0) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

def annotation(ev) -> bool:
    """A span's mirror on the device's timeline (record_function's, the
    optimizer's): it covers the kernels inside it and is none itself."""
    return ev.device_type.name == "CUDA" and (
        getattr(ev, "is_user_annotation", False)
        or ev.name.startswith(("bench.", "Optimizer.")))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_frames(entry, block: int, frame_steps: int, device):
    """Profile the first `frame_steps` frames of block `block` -> Slice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frames = entry.run_block(block, frame_steps)
        sync(device)
        wall = time.perf_counter() - t0
    sl = Slice(wall_s=wall, frames=frames, frame_steps=frame_steps)
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if annotation(ev):
            continue
        if ev.device_type == DeviceType.CUDA:
            sl.device_ops.append((ev.name, s, e))
            if not ev.name.startswith(COPY_PREFIXES):
                sl.kernels.append((ev.name, s, e))
        else:
            sl.host_ops.append((ev.name, s, e))
    return sl
