"""Seeded weights of a configuration, made on the device in one draw.

The names and shapes are the reference model's (reference/model.py),
which are the program's, so the one state dict loads into both. One
torch.Generator on the device draws every number in one call; each
leaf takes its slice:

  Linear weight (out, in)   N(0, 1 / in), the scale of flax's lecun init
  Linear bias               N(0, 0.1^2)
  batch norm weight         1 + N(0, 0.1^2); bias N(0, 0.1^2)
  running mean              N(0, 0.1^2); running variance exp(N(0, 0.2^2))
  bin_score                 1 (the association uses the constant 0.9)

Random weights put a stream's motion scores on one side of the model's
threshold as often as not, and a frame with no moving point leaves
DBSCAN, the descriptors and the association nothing to do.
`place_motion_threshold` shifts the motion head's output bias so that a
given share of a probe frame's points score above the threshold.
"""

from __future__ import annotations

import torch

from .reference.model import Track4D


def make_state_dict(model_args: dict, seed: int, device) -> dict:
    """{name: tensor} on `device` for Track4D(**model_args)."""
    spec = Track4D(**model_args).state_dict()
    total = sum(t.numel() for t in spec.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, t in spec.items():
        x = draw[at:at + t.numel()].view(t.shape)
        at += t.numel()
        leaf = name.rsplit(".", 1)[-1]
        is_bn = ".bn_" in name
        if name == "bin_score":
            x = torch.ones_like(x)
        elif leaf == "running_var":
            x = torch.exp(0.2 * x)
        elif leaf == "weight" and is_bn:
            x = 1.0 + 0.1 * x
        elif leaf == "weight":
            x = x / t.shape[1] ** 0.5
        else:               # biases, batch norm shifts, running means
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


CLS_BIAS = "fd_layer.cp.linear.bias"


def place_motion_threshold(model_args: dict, weights: dict, frame,
                           share: float) -> dict:
    """`weights` with the motion head's output bias shifted so that
    `share` of the valid points of `frame` (a FrameBatch of (B, ...))
    score above `mov_thres` in the reference -> a new dict."""
    model = Track4D(**model_args).to(frame.pc1.device).eval()
    model.load_state_dict(weights)
    with torch.no_grad():
        z = model.cls_logit(frame)[frame.mask1]
    thres = torch.tensor(model_args["mov_thres"], dtype=z.dtype)
    shift = torch.quantile(z, 1.0 - share) - torch.logit(thres).to(z.device)
    return dict(weights, **{CLS_BIAS: weights[CLS_BIAS] - shift})
