"""Host milliseconds a frame step inside the spans of the PNHead of each
cloud (ratrack.head) in the traced slice (eval)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "eval", "head")
