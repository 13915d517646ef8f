"""Host milliseconds a frame step inside the spans of the train step's
model call (ratrack.forward) in the traced slice (train)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "train", "forward")
