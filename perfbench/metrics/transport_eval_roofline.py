"""Kernel B11's share of its roofline in the traced slice (eval): the
least time for FLOT's dense transport work (the family's slice_work)
over the device time of its kernels."""

from perfbench.readers import roofline


def read(run):
    return roofline(run, "eval", "transport")
