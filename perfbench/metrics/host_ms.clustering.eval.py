"""Host milliseconds a frame step inside the spans of DBSCAN and the
descriptors (ratrack.dbscan, ratrack.descriptors) in the traced slice
(eval)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "eval", "clustering")
