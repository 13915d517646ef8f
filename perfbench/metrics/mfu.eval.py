"""The whole step's share of the cards' product peak over the window
(eval): the model's FLOPs a frame (perfbench/work.py) x frames/s."""

from perfbench.readers import mfu


def read(run):
    return mfu(run, "eval")
