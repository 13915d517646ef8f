"""The training loss of the reference: 0.5 scene flow + 0.5 affinity
+ 1.0 motion segmentation per stream (segmentation alone in pretraining),
NaN terms zeroed."""

from __future__ import annotations

import torch

_EPS = 1e-7


def _bce(p, y):
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))


def _masked_mean(x, mask):
    dims = tuple(range(1, x.dim()))
    s = torch.where(mask, x, torch.zeros_like(x)).sum(dim=dims)
    c = mask.float().sum(dim=dims)
    return torch.where(c > 0, s / torch.clamp_min(c, 1.0), torch.zeros_like(s))


def loss(out, fr, pretrain=False):
    """-> total (B,)."""
    err = torch.sqrt(torch.sum(torch.square(out["warp"] - fr.gt_flow), -1)
                     + 1e-20)
    sf = torch.nan_to_num(_masked_mean(err, fr.mask1))
    bce = _bce(out["cls"], fr.gt_cls.float())
    seg = torch.nan_to_num(0.4 * _masked_mean(bce, fr.mask1 & fr.gt_cls)
                           + 0.6 * _masked_mean(bce, fr.mask1 & ~fr.gt_cls))
    pair = out["prev_valid"].unsqueeze(2) & out["curr_valid"].unsqueeze(1)
    gt = (out["prev_gt_id"].unsqueeze(2) == out["curr_gt_id"].unsqueeze(1)) \
        & pair
    trk = _masked_mean(_bce(out["aff"], gt.float()), pair)
    trk = torch.nan_to_num(torch.where(pair.flatten(1).any(dim=1), trk,
                                       torch.zeros_like(trk)))
    return seg if pretrain else 0.5 * sf + 0.5 * trk + 1.0 * seg
