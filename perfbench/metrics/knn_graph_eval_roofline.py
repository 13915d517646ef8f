"""Kernel B5's share of its roofline in the traced slice when it builds
FLOT's kNN graphs at k = 32 (eval): the least time for their counted
work over the device time of its kernels."""

from perfbench.readers import roofline


def read(run):
    return roofline(run, "eval", "knn_graph")
