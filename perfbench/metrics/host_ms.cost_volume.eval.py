"""Host milliseconds a frame step inside the spans of the cost volume
(ratrack.cost_volume) in the traced slice (eval)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "eval", "cost_volume")
