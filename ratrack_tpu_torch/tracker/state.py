"""Recurrent per-stream tracking state carried across frames, batched.
Counterpart of `ratrack_tpu/tracker/state.py` with a leading stream dim."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

DESC_DIM = 141  # 3 pos + 3 pos-var + 128 feat + 3 flow + 2 rrv + 2 rrv-var


class TrackState(NamedTuple):
    h: torch.Tensor           # (B, gru_layers, 128) float32
    desc: torch.Tensor        # (B, K, DESC_DIM) float32, previous objects
    valid: torch.Tensor       # (B, K) bool
    track_id: torch.Tensor    # (B, K) int32
    gt_id: torch.Tensor       # (B, K) int32 (negative = unmatched)
    next_id: torch.Tensor     # (B,) int32
    frame_idx: torch.Tensor   # (B,) int32


def init_state(batch: int, k_max: int, gru_layers: int = 5,
               hidden: int = 128, device=None,
               dtype=torch.float32) -> TrackState:
    """A fresh state for `batch` streams on `device` (None: the card,
    `default_device()`)."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return TrackState(
        h=torch.zeros((batch, gru_layers, hidden), dtype=dtype,
                      device=device),
        desc=torch.zeros((batch, k_max, DESC_DIM), dtype=dtype,
                         device=device),
        valid=torch.zeros((batch, k_max), dtype=torch.bool, device=device),
        track_id=torch.full((batch, k_max), -1, **i32),
        gt_id=torch.full((batch, k_max), -1, **i32),
        next_id=torch.zeros((batch,), **i32),
        frame_idx=torch.zeros((batch,), **i32),
    )


def reset_where(new_seq: torch.Tensor, state: TrackState,
                fresh: TrackState) -> TrackState:
    """Fresh state for streams with new_seq, carried state elsewhere;
    next_id is never reset (track ids stay unique across clips)."""
    def pick(f, s):
        sel = new_seq.reshape(new_seq.shape + (1,) * (s.dim() - 1))
        return torch.where(sel, f, s)
    out = TrackState(*[pick(f, s) for f, s in zip(fresh, state)])
    return out._replace(next_id=state.next_id)
