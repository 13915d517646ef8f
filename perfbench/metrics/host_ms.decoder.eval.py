"""Host milliseconds a frame step inside the spans of the flow decoder and
its GRU (ratrack.decoder) in the traced slice (eval)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "eval", "decoder")
