"""The flot family's own parts: its readers of FLOT's layers on a
hand-made slice, its work counts against the dense algorithm, and its
FLOPs against the products the reference computes."""

import math
import time

import pytest
import torch
from torch.overrides import TorchFunctionMode

from perfbench import harness, spec, work
from perfbench.reference import flot as reference_flot
from perfbench.tests.tiny import CPU, SEED, tiny_cell
from perfbench.tests.test_perfbench_spans import _run
from perfbench.trace import Slice

CELL = "eval_flot8k_b8"


def _slice():
    """Two frame steps of one stream (times in us): graph [0, 4], setconv
    [4, 10] with a nested setconv [5, 6], transport [10, 14], refine [14,
    20]; launches at 1 (graph), 5 and 7 (setconv), 11 (transport)."""
    host = [("ratrack.graph", 0, 4), ("ratrack.setconv", 4, 10),
            ("ratrack.setconv", 5, 6), ("ratrack.transport", 10, 14),
            ("ratrack.refine", 14, 20), ("bench.dispatch", 0, 30)]
    host += [("cudaLaunchKernel", t, t + 0.5) for t in (1, 5, 7, 11)]
    kernels = [("void (anonymous namespace)::transport_cost_kernel(...)",
                11, 13)]
    return Slice(wall_s=30e-6, frames=2, frame_steps=2, kernels=kernels,
                 device_ops=list(kernels), host_ops=host)


@pytest.mark.parametrize("name,value", [
    ("launches.setconv.eval", 1.0), ("launches.transport.eval", 0.5)])
def test_flot_layer_readers(name, value):
    read = spec.metric_reader(name)
    assert read(_run(_slice())) == pytest.approx(value)
    assert read(_run(_slice(), "train")) is None


def test_transport_pattern_names_its_kernels_only():
    pattern = spec.cell(CELL).family.KERNELS["transport.eval"]
    for name in ("transport_cost_kernel", "transport_cols_kernel",
                 "void (anonymous namespace)::transport_rows_kernel(float)"):
        assert pattern.search(name), name
    assert not pattern.search("sinkhorn_kernel<8, 1, 1>")


def test_slice_work_counts_the_dense_algorithm():
    cell = spec.cell(CELL)
    b, n = cell.traffic["streams"], cell.traffic["n_max"]
    got = cell.family.slice_work(cell, None, 1, 4, "eval")
    assert len(got["transport"]) == 4 and len(got["knn_graph"]) == 5
    nbytes, mm, other = got["transport"][0]
    assert nbytes == 4 * b * (2 * n * 128 + 3 * n * 3)
    assert mm == b * 2 * n * n * 131
    assert other == b * n * n * (4 + 8)
    assert got["knn_graph"][0][2] == work.DIST_OPS * b * n * n
    # well under the card's time for either at 8192 points
    assert work.bound_s(got["transport"][0]) < 1e-3


class _Macs(TorchFunctionMode):
    """Multiply-adds of every matrix product called inside the block."""

    def __init__(self):
        super().__init__()
        self.macs = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul):
            a, b = args[:2]
            self.macs += a.numel() * b.shape[-1]
        return func(*args, **(kwargs or {}))


def test_flops_count_the_reference_products():
    """2 x the reference's product multiply-adds on one frame pair, less
    pc2's feature net (the program carries it), plus the plan's row sums
    (a sum, not a product), equal the family's FLOPs a stream-frame."""
    cell = tiny_cell(CELL)
    n, model = cell.traffic["n_max"], cell.config["model"]
    m = harness.run_program(cell, SEED, 0.1, False, CPU, time.perf_counter())
    p1, p2 = m.frames.pc1[0, 0], m.frames.pc2[0, 0]
    w = m.weights
    counter = _Macs()
    with counter:
        reference_flot.frame(w, p1, p2, model)
    net = _Macs()
    idx = reference_flot.knn_graph(p2, model["nb_neighbors"])
    with net:
        reference_flot.features(w, "feat_conv", p2, p2, idx)
    macs = counter.macs - net.macs + n * n
    assert cell.family.flops_per_frame(cell, "eval") == 2 * macs
    assert math.isclose(spec.cell(CELL).family.flops_per_frame(
        spec.cell(CELL), "eval") / 1e9, 118.8, rel_tol=0.01)
