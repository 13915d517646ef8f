"""Family `flow`, for the benchmark's tests only: the small scene-flow
model of ../program.py against its plain reference (../reference.py).

It enters as a model_config change would, through new files alone: this
family, its configuration, mix, workload and entry under
perfbench/tests/flow/, found by spec.cell(..., home=<that directory>).
One number is compared, `flow_gap`: the largest gap (metres) between
the program's flow and the reference's over the valid points of the
compared frames.
"""

from __future__ import annotations

import torch

from perfbench import check
from perfbench.tests.flow.reference import flow as reference_flow

MODEL_KEYS = ("width", "sinkhorn_iters", "epsilon", "max_dist")
KERNELS = {}    # no kernel of its own: no roofline to read


def make_weights(cell, seed: int, device) -> dict:
    """One draw on the device, N(0, 1 / fan in) for every leaf."""
    c = cell.config["model"]["width"]
    shapes = {"w1": (3, c), "b1": (c,), "w2": (c, c), "b2": (c,),
              "wr": (3, 3), "br": (3,)}
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(torch.Size(s).numel() for s in shapes.values()),
                       generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = torch.Size(shape).numel()
        fan_in = shape[0] if len(shape) == 2 else 10
        out[name] = draw[at:at + n].view(shape) / fan_in ** 0.5
        at += n
    return out


def prepare(cell, weights: dict, pool, device) -> dict:
    return weights


def reference(kind: str, cell, weights, frames, control=False):
    """The reference's flow on the host; `control`: with TF32 products."""
    with check.reference_precision(control):
        return {"flow": reference_flow(weights, frames, cell.config["model"])}


def compare(kind: str, got, ref, weights, frames) -> dict:
    mask = frames.mask1.cpu()
    return {"flow_gap": float((got["flow"] - ref["flow"]).abs()
                              .amax(-1)[mask].max())}


def fault_readings(kind: str, cell, weights, frames, ref, seed: int,
                   exchange=None) -> dict:
    """No reading beyond the control's."""
    return {}


def _perturbed_weights(monkeypatch, kind):
    """The program starts from weights each moved by about a thousandth."""
    from perfbench.tests.flow import program
    init = program.FlowModel.__init__

    def perturbed(self, weights, **model):
        gen = torch.Generator().manual_seed(0)
        init(self, {k: v * (1 + 1e-3 * torch.randn(v.shape, generator=gen))
                    for k, v in weights.items()}, **model)
    monkeypatch.setattr(program.FlowModel, "__init__", perturbed)


def _broken_flow(monkeypatch, fault):
    """The flow of the second half of the streams replaced by the
    first's, or one point's flow altered, where the model produces it."""
    from perfbench.tests.flow import program
    call = program.FlowModel.__call__

    def broken(self, pc1, pc2, mask1, mask2):
        flow = call(self, pc1, pc2, mask1, mask2).clone()
        if fault == "half_batch":
            h = flow.shape[0] // 2
            flow[h:] = flow[:h]
        else:       # the first valid point of stream 0, by 1 cm
            flow[0, int(mask1[0].nonzero()[0]), 0] += 0.01
        return flow
    monkeypatch.setattr(program.FlowModel, "__call__", broken)


FAULTS = {
    "weights_perturbed": _perturbed_weights,
    "half_batch": lambda mp, kind: _broken_flow(mp, "half_batch"),
    "answer_altered": lambda mp, kind: _broken_flow(mp, "answer_altered"),
}


def slice_work(cell, pool, j, frames, kind) -> dict:
    """No kernel of its own: no roofline to read."""
    return {}


def flops_per_frame(cell, kind: str) -> int:
    """2 x the multiply-adds of the products of a frame: both clouds'
    features, the cosines, the plan's mean of pc2 and the refinement."""
    n, c = cell.traffic["n_max"], cell.config["model"]["width"]
    return 2 * (2 * n * (3 * c + c * c) + n * n * c + n * n * 3 + n * 9)


def tiny(cell):
    """The cell is tiny already."""
    return cell
