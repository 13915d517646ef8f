"""Host milliseconds a frame step inside the spans of the affinity, the
Sinkhorn and the id assignment (ratrack.affinity, ratrack.sinkhorn,
ratrack.assign_ids) in the traced slice (train)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "train", "association")
