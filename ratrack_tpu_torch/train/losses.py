"""Multi-task loss: scene flow + affinity + motion segmentation, per stream.

Counterpart of `ratrack_tpu/train/losses.py` (reference
`src/losses/loss.py:8-146`), batched over streams: every term is computed
per stream, so a (B,) vector comes out where the JAX function, vmapped,
gives one value per clip.

  total = 0.5 flow + 0.5 affinity + 1.0 seg; under pretrain seg alone
  (a `torch.where`, as in JAX, so the gate may be a tensor); NaN terms are
  zeroed (nan_to_num).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_EPS = 1e-7


def _bce(p, y):
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))


def _masked_mean(x, mask):
    """Mean over the valid entries of each stream: x, mask (B, ...) -> (B,);
    0 where a stream has none."""
    dims = tuple(range(1, x.dim()))
    s = torch.where(mask, x, torch.zeros_like(x)).sum(dim=dims)
    c = mask.to(torch.float32).sum(dim=dims)
    return torch.where(c > 0, s / torch.clamp_min(c, 1.0),
                       torch.zeros_like(s))


def flow_loss(warp, gt_flow, mask):
    """Mean over valid points of |warp - gt_flow|."""
    err = torch.sqrt(torch.sum(torch.square(warp - gt_flow), dim=-1) + 1e-20)
    return _masked_mean(err, mask)


def motion_seg_loss(cls, gt_cls, mask):
    """Class-weighted BCE: 0.4 positives + 0.6 negatives."""
    bce = _bce(cls, gt_cls.to(torch.float32))
    return (0.4 * _masked_mean(bce, mask & gt_cls)
            + 0.6 * _masked_mean(bce, mask & ~gt_cls))


def affinity_loss(aff, prev_gt_id, prev_valid, curr_gt_id, curr_valid):
    """BCE of the (K, K) affinity block against the GT identity mapping
    prev_gt_id[i] == curr_gt_id[j]; 0 for a stream with no valid pair."""
    pair_ok = prev_valid.unsqueeze(2) & curr_valid.unsqueeze(1)
    gt = (prev_gt_id.unsqueeze(2) == curr_gt_id.unsqueeze(1)) & pair_ok
    loss = _masked_mean(_bce(aff, gt.to(torch.float32)), pair_ok)
    return torch.where(pair_ok.flatten(1).any(dim=1), loss,
                       torch.zeros_like(loss))


def track4d_loss(outputs: Dict[str, torch.Tensor], frame, pretrain
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total (B,), items {Loss, SceneFlowLoss, TrackingLoss, SegLoss}
    each (B,)) from a Track4D train step's outputs."""
    sf = torch.nan_to_num(flow_loss(outputs["warp"], frame.gt_flow,
                                    frame.mask1))
    seg = torch.nan_to_num(motion_seg_loss(outputs["cls"], frame.gt_cls,
                                           frame.mask1))
    trk = torch.nan_to_num(affinity_loss(
        outputs["aff"], outputs["prev_gt_id"], outputs["prev_valid"],
        outputs["curr_gt_id"], outputs["curr_valid"]))
    full = 0.5 * sf + 0.5 * trk + 1.0 * seg
    total = torch.where(torch.as_tensor(pretrain, device=seg.device), seg,
                        full)
    items = {"Loss": total, "SceneFlowLoss": sf, "TrackingLoss": trk,
             "SegLoss": seg}
    return total, items
