"""What the per-layer readers (metrics/<name>.py) share. A reader takes
the run (harness.Run) and returns its number, or None where the run has
nothing for it to read; it never returns 0 for a share of a roofline or
of a peak."""

from __future__ import annotations

import re

from . import work

# the kernels of a layer, by the names the trace gives them (csrc/*.cu)
KERNELS = {
    "set_abstraction.eval": re.compile(r"(^|[^A-Za-z_])sa_kernel\b"),
    "cost_volume.eval": re.compile(
        r"(^|[^A-Za-z_])(knn_staged_kernel|aggregate_kernel|"
        r"knn_prep_kernel|knn_select_kernel)\b"),
    "set_abstraction.train": re.compile(
        r"(^|[^A-Za-z_])(select_kernel|fwd_cluster_kernel|"
        r"bwd_cluster_kernel)\b|finish_kernel.*ScalePair"),
    "cost_volume.train": re.compile(
        r"(^|[^A-Za-z_])(knn_staged_kernel|aggregate_kernel|bwd_head_kernel|"
        r"pair_layer_kernel|bwd_tail_kernel)\b|"
        r"finish_kernel(?!.*ScalePair)"),
}


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
    work in the slice / its kernels' device time there."""
    if not _traced(run, kind) or not run.work.get(layer):
        return None
    pattern = KERNELS[f"{layer}.{kind}"]
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
