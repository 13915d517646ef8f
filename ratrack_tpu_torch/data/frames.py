"""Fixed-shape frame-pair records fed to the model.

Counterpart of `ratrack_tpu/data/frames.py`, which imports JAX's numpy and
so cannot be imported where JAX is absent. Same 14 fields in the same order;
the generator fills them with numpy arrays and `to_tensors` moves a record
(or a stack of records, any leading dims) onto a torch device. The model
consumes leading dims (B,) for one frame step and (B, T) for a scan.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class FrameBatch(NamedTuple):
    pc1: torch.Tensor         # (..., N, 3) radar xyz, frame t+1
    pc2: torch.Tensor         # (..., N, 3) radar xyz, frame t
    ft1: torch.Tensor         # (..., N, 2) [RCS, v_r] of pc1
    ft2: torch.Tensor         # (..., N, 2) of pc2
    mask1: torch.Tensor       # (..., N) bool
    mask2: torch.Tensor       # (..., N) bool
    pc1_comp: torch.Tensor    # (..., N, 3) ego-motion-compensated pc1
    gt_cls: torch.Tensor      # (..., N) bool, moving point
    gt_flow: torch.Tensor     # (..., N, 3) GT warped positions
    gt_dense: torch.Tensor    # (..., N) int32 dense GT slot, -1 none
    gt_label_ids: torch.Tensor  # (..., G) int32 persistent GT label id
    gt_valid: torch.Tensor    # (..., G) bool
    new_seq: torch.Tensor     # (...) bool, reset recurrent state first
    frame_number: torch.Tensor  # (...) int32 dataset frame index (t+1)


def empty_frame(n_max: int, g_max: int) -> FrameBatch:
    z3 = np.zeros((n_max, 3), np.float32)
    z2 = np.zeros((n_max, 2), np.float32)
    zb = np.zeros((n_max,), bool)
    return FrameBatch(
        pc1=z3, pc2=z3.copy(), ft1=z2, ft2=z2.copy(),
        mask1=zb, mask2=zb.copy(), pc1_comp=z3.copy(),
        gt_cls=zb.copy(), gt_flow=z3.copy(),
        gt_dense=np.full((n_max,), -1, np.int32),
        gt_label_ids=np.full((g_max,), -1, np.int32),
        gt_valid=np.zeros((g_max,), bool),
        new_seq=np.asarray(False),
        frame_number=np.asarray(0, np.int32),
    )


def to_tensors(frame: FrameBatch, device=None) -> FrameBatch:
    """numpy (or tensor) record -> contiguous torch tensors on `device`
    (None: the card, `default_device()`)."""
    device = resolve_device(device)
    return FrameBatch(*[
        torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=device).contiguous()
        for x in frame])
