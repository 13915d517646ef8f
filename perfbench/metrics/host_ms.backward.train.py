"""Host milliseconds a frame step inside the spans of the backward
(ratrack.backward) in the traced slice (train)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "train", "backward")
