"""What the per-layer readers (metrics/<name>.py) share. A reader takes
the run (harness.Run) and returns its number, or None where the run has
nothing for it to read; it never returns 0 for a share of a roofline or
of a peak."""

from __future__ import annotations

from . import work


def _traced(run, kind):
    return run.slice is not None and run.kind == kind


def launches_per_frame(run, kind):
    """CUDA kernels launched in the slice a frame."""
    if not _traced(run, kind):
        return None
    return len(run.slice.kernels) / run.slice.frames


def device_idle_pct(run, kind):
    """100 x (1 - device busy / slice wall)."""
    if not _traced(run, kind):
        return None
    return 100.0 * (1.0 - run.slice.busy_s() / run.slice.wall_s)


def roofline(run, kind, layer):
    """100 x the least time the card could take for the layer's counted
    work in the slice (the family's slice_work) / the device time there
    of its kernels (the family's KERNELS)."""
    if not _traced(run, kind) or not run.work.get(layer):
        return None
    pattern = run.cell.family.KERNELS[f"{layer}.{kind}"]
    seconds = run.slice.kernel_s(lambda name: pattern.search(name))
    if seconds <= 0.0:
        return None
    return 100.0 * sum(work.bound_s(w) for w in run.work[layer]) / seconds


def mfu(run, kind):
    """100 x the model's FLOPs a frame x the window's frames/s / the
    product peak of the cards used."""
    if not _traced(run, kind):
        return None
    return (100.0 * run.flops_per_frame * run.frames_per_s
            / (work.PRODUCT_OPS_PER_S * run.cell.chips))
