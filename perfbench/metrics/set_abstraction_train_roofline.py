"""The set_abstraction kernels' share of their roofline in the traced slice
(train): the least time for their counted work over their device time."""

from perfbench.readers import roofline


def read(run):
    return roofline(run, "train", "set_abstraction")
