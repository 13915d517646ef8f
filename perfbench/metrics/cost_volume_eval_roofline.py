"""The cost_volume kernels' share of their roofline in the traced slice
(eval): the least time for their counted work over their device time."""

from perfbench.readers import roofline


def read(run):
    return roofline(run, "eval", "cost_volume")
