"""CUDA kernels launched a frame in the traced slice (train)."""

from perfbench.readers import launches_per_frame


def read(run):
    return launches_per_frame(run, "train")
