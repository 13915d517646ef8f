"""Kernel launch calls of the host a stream-frame that start inside the
spans of the affinity, the Sinkhorn and the id assignment
(ratrack.affinity, ratrack.sinkhorn, ratrack.assign_ids) in the traced
slice (eval)."""

from perfbench.spans import launches_per_frame


def read(run):
    return launches_per_frame(run, "eval", "association")
