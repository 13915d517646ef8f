"""Family `flot`: FLOT (Puy, Boulch, Marlet, ECCV 2020, arXiv:2007.11142),
scene flow between two whole point clouds, the model of every
configuration whose file says "family": "flot".

The program is `ratrack_tpu_torch.models.flot.FLOT` through
`train.step.make_scan_flow_step_cached` (entries/flow_scan.py); the plain
reference is reference/flot.py. Two numbers are compared over the compared
frames, each the largest gap in metres between the program's vector and
the reference's at any point: `flow_gap` (the refined flow) and
`ot_flow_gap` (the transport's flow).

FLOT's spans (the program's trace.py: ratrack.graph, .setconv,
.transport, .refine) are not RaTrack's layers, which spans.LAYERS holds,
so this family keeps its own table and the reader of its launch calls
(`launches_per_frame`).
"""

from __future__ import annotations

import math
import re

import torch

from perfbench import check, spans, work
from perfbench.reference import flot as reference_flot

MODEL_KEYS = ("nb_neighbors", "nb_iter", "support_m")
WIDTHS = (32, 64, 128)     # the SetConvs' output widths
FEATURES = WIDTHS[-1]
EPSILON = math.log(0.05)   # eps = exp(EPSILON) + 0.03 = 0.08
GAMMA = 0.0                # gamma = 1
# clouds with more pairs than this take kernel B5 for their graph (the
# program's ops/neighborhood.py::KNN_DENSE_LIMIT)
KNN_DENSE_LIMIT = 4 * 1024 * 1024
KERNELS = {
    "transport.eval": re.compile(
        r"(^|[^A-Za-z_])transport_(cost|cols|rows)_kernel\b"),
    "knn_graph.eval": re.compile(
        r"(^|[^A-Za-z_])(knn_prep_kernel|knn_select_kernel)\b"),
}
# layer -> the names of its spans
LAYERS = {
    "graph": ("ratrack.graph",),
    "setconv": ("ratrack.setconv",),
    "transport": ("ratrack.transport",),
    "refine": ("ratrack.refine",),
}


def _shapes() -> dict:
    """The program's state dict: {name: shape}."""
    out = {}
    for net in ("feat_conv", "ref_conv"):
        for i, (c_in, c) in enumerate(zip((3,) + WIDTHS[:-1], WIDTHS), 1):
            for layer, (o, k) in enumerate(((c, c_in + 3), (2 * c, c),
                                            (c, 2 * c)), 1):
                out[f"{net}{i}.fc{layer}.weight"] = (o, k)
                out[f"{net}{i}.bn{layer}.weight"] = (o,)
                out[f"{net}{i}.bn{layer}.bias"] = (o,)
    out.update({"fc.weight": (3, FEATURES), "fc.bias": (3,),
                "epsilon": (1,), "gamma": (1,)})
    return out


def make_weights(cell, seed: int, device) -> dict:
    """One draw on the device: the 1x1 layers' and the linear layer's
    weights N(0, 1 / fan in), the instance norms' scales 1 + N(0, 0.1^2)
    and shifts N(0, 0.1^2), the linear bias N(0, 0.1^2); epsilon = ln 0.05
    and gamma = 0 (assumed: eps 0.08, gamma 1)."""
    shapes = _shapes()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draw = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        x = draw[at:at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        if name in ("epsilon", "gamma"):
            x = torch.full(shape, EPSILON if name == "epsilon" else GAMMA,
                           device=device)
        elif name.endswith("weight") and ".bn" not in name:
            x = x / shape[1] ** 0.5
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


def prepare(cell, weights: dict, pool, device) -> dict:
    return weights


def reference(kind: str, cell, weights, frames, control=False):
    """The reference's flow and ot_flow on the host; `control`: with TF32
    products."""
    with check.reference_precision(control):
        return reference_flot.flow(weights, frames, cell.config["model"])


def compare(kind: str, got, ref, weights, frames) -> dict:
    return {f"{k}_gap": float((got[k] - ref[k]).abs().max())
            for k in ("flow", "ot_flow")}


def fault_readings(kind: str, cell, weights, frames, ref, seed: int,
                   exchange=None) -> dict:
    """The reference with the 10 m support left out, and with graphs of 16
    neighbours, against the reference: what FAULTS plant in the
    program."""
    model = cell.config["model"]
    rows = {}
    for name, change in (("support_dropped", dict(support_m=math.inf)),
                         ("graph_k16", dict(nb_neighbors=16))):
        with check.reference_precision(False):
            got = reference_flot.flow(weights, frames, dict(model, **change))
        rows[name] = compare(kind, got, ref, weights, frames)
    return rows


def _support_dropped(monkeypatch, kind):
    """The transport moves mass between points at any distance."""
    from ratrack_tpu_torch.models import flot
    orig = flot.unbalanced_transport_flow
    monkeypatch.setattr(
        flot, "unbalanced_transport_flow",
        lambda f1, f2, p1, p2, eps, gamma, iters, support: orig(
            f1, f2, p1, p2, eps, gamma, iters, math.inf))


def _graph_k16(monkeypatch, kind):
    """Every kNN graph of 16 neighbours, not 32."""
    from ratrack_tpu_torch.models.flot import FLOT
    orig = FLOT.graph

    def graph(self, pc):
        saved, self.nb_neighbors = self.nb_neighbors, 16
        try:
            return orig(self, pc)
        finally:
            self.nb_neighbors = saved
    monkeypatch.setattr(FLOT, "graph", graph)


def _broken_outputs(monkeypatch, fault):
    """The scan's outputs with the second half of the streams replaced by
    the first's, or one point's flow moved by 1 cm."""
    from ratrack_tpu_torch.train import step
    orig_make = step.make_scan_flow_step_cached

    def make(model):
        scan = orig_make(model)

        def broken(frames):
            out = {k: v.clone() for k, v in scan(frames).items()}
            if fault == "half_batch":
                h = out["flow"].shape[0] // 2
                for v in out.values():
                    v[h:] = v[:h]
            else:
                out["flow"][0, 0, 0, 0] += 0.01
            return out
        return broken
    monkeypatch.setattr(step, "make_scan_flow_step_cached", make)


# the faults a cell of the family can have, each planted in the program
# by plant(monkeypatch, kind) (the benchmark's tests: each comes out not
# correct)
FAULTS = {
    "support_dropped": _support_dropped,
    "graph_k16": _graph_k16,
    "half_batch": lambda mp, kind: _broken_outputs(mp, "half_batch"),
    "answer_altered": lambda mp, kind: _broken_outputs(mp, "answer_altered"),
}


def _transport_work(b: int, n: int, m: int, iters: int):
    """B11's work on b streams, counting the dense n x m algorithm: the
    products of the cost and the distances, 4 n m operations an
    iteration, 8 n m for the plan's flow and row sums; the features,
    clouds and flow in and out."""
    t = work._t
    nbytes = work.case_bytes(t(b, n, FEATURES), t(b, m, FEATURES),
                             t(b, n, 3), t(b, m, 3), t(b, n, 3))
    return (nbytes, b * 2 * n * m * (FEATURES + 3),
            b * n * m * (4 * iters + 8))


def _graph_work(b: int, n: int, k: int):
    """B5's work on one graph of b clouds of n points."""
    t = work._t
    sel = dict(query=t(b, n, 3), points=t(b, n, 3), points_mask=None, k=k)
    return work.knn_tiled_work(sel, t(b, n, k, dtype=torch.int64),
                               t(b, n, k))


def slice_work(cell, pool, j, frames, kind):
    """The kernel work of the slice's frame steps: a graph a frame step
    (two at the block's first frame, whose pc2 has its own) where the
    clouds take B5, and one transport."""
    model = cell.config["model"]
    b, n = cell.traffic["streams"], cell.traffic["n_max"]
    graphs = frames + 1 if n * n > KNN_DENSE_LIMIT else 0
    return {
        "transport": [_transport_work(b, n, n, model["nb_iter"])] * frames,
        "knn_graph": [_graph_work(b, n, model["nb_neighbors"])] * graphs,
    }


def _set_conv_macs(c_in: int, c: int) -> int:
    return (c_in + 3) * c + c * 2 * c + 2 * c * c


def flops_per_frame(cell, kind: str) -> int:
    """2 x the multiply-adds of a stream-frame: one cloud's feature net
    and the refinement (over its n k edges), the linear layer, the cost
    product, and the transport's products (K^T a and K b an iteration,
    the plan's T q and row sums)."""
    model = cell.config["model"]
    n, k = cell.traffic["n_max"], model["nb_neighbors"]
    net = sum(_set_conv_macs(a, c) for a, c in zip((3,) + WIDTHS[:-1],
                                                   WIDTHS))
    macs = 2 * n * k * net + n * FEATURES * 3
    macs += n * n * FEATURES + n * n * (2 * model["nb_iter"] + 4)
    return 2 * macs


def tiny(cell):
    """The cell cut to a size the CPU runs in seconds: two streams of 256
    points (all valid), 4-frame blocks, the check over 3 frames. Every
    other setting, the limits included, is the cell's."""
    cell.traffic.update(streams=2, block_frames=4, clip_frames=4, clips=2,
                        n_max=256, n_static=256 - cell.traffic["n_objects"]
                        * cell.traffic["pts_per_obj"])
    cell.workload["check"]["frames"] = 3
    return cell


# ---- the readers of FLOT's layers -----------------------------------------

def union(sl, layer) -> list:
    """The union of the intervals of the layer's spans in the slice ->
    [(start_us, end_us)], disjoint and sorted."""
    out = []
    for _, s, e in sorted((o for o in sl.host_ops if o[0] in LAYERS[layer]),
                          key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def _traced(run, kind):
    sl = run.slice
    if sl is None or run.kind != kind or not sl.kernels:
        return None
    return sl


def launches_per_frame(run, kind, layer):
    """Launch calls of the host that start inside the layer's spans, a
    stream-frame."""
    sl = _traced(run, kind)
    ivs = [] if sl is None else union(sl, layer)
    if not ivs:
        return None
    starts = [s for s, _ in ivs]
    count = sum(1 for name, s, _ in sl.host_ops
                if name in spans.LAUNCH_CALLS
                and spans._inside(ivs, starts, s))
    return count / sl.frames
