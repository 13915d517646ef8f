"""Kernel launch calls of the host a stream-frame that start inside the
spans of the flow decoder and its GRU (ratrack.decoder) in the traced
slice (eval)."""

from perfbench.spans import launches_per_frame


def read(run):
    return launches_per_frame(run, "eval", "decoder")
