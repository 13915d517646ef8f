"""Share of the device's idle time in the traced slice whose gap starts
while the host is inside a span of the frame step's layers (forward,
loss, backward, allreduce, optimizer; train)."""

from perfbench.spans import idle_in_layers_pct


def read(run):
    return idle_in_layers_pct(run, "train")
