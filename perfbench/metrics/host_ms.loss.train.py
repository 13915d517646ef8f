"""Host milliseconds a frame step inside the spans of the loss
(ratrack.loss) in the traced slice (train)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "train", "loss")
