"""Kernel launch calls of the host a stream-frame that start inside the
spans of FLOT's feature SetConvs (ratrack.setconv) in the traced slice
(eval), by the flot family's own table of FLOT's layers."""

from perfbench import spec

FLOT = spec.load_module(spec.HERE / "families" / "flot.py",
                        "perfbench_family_flot")


def read(run):
    return FLOT.launches_per_frame(run, "eval", "setconv")
