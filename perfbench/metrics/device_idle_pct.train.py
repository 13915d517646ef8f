"""Share of the traced slice's wall time in which no operation ran on the
device (train)."""

from perfbench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run, "train")
