"""Host milliseconds a frame step inside the spans of zero_grad and the
Adam and schedule step (ratrack.optimizer) in the traced slice (train)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "train", "optimizer")
