"""The cached-backbone eval scan over B streams x T frames.

Counterpart of `ratrack_tpu/train/step.py::make_scan_eval_step_cached` and
`chain_contiguous` (:406-462). The JAX scan's vmap over streams is the
batch dimension here and `lax.scan` is a Python loop over T.

Frame t's pc2 is frame t-1's pc1 in a contiguous stream, and in eval the
PNHead is a pure function of the cloud: the pc2 head is computed once at
block entry and each frame's f1 is carried as the next frame's f2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.frames import FrameBatch
from ..tracker.state import TrackState

KEEP = ("cls", "warp", "labels", "track_id", "conf", "n")


def chain_contiguous(frame_numbers, new_seq) -> bool:
    """True iff, within the block, each frame's pc2 is the previous
    frame's pc1: frame numbers strictly consecutive and no sequence reset
    after the first frame (the block-entry pc2 head is always fresh)."""
    fno = np.asarray(frame_numbers)
    ns = np.asarray(new_seq)
    return bool(np.all(np.diff(fno) == 1) and not np.any(ns[1:]))


def frame_at(frames: FrameBatch, t: int) -> FrameBatch:
    """Frame t of a (B, T, ...) block as contiguous (B, ...) tensors."""
    return FrameBatch(*[x[:, t].contiguous() for x in frames])


def make_scan_eval_step_cached(model):
    """-> scan_eval(track_state, frames (B, T, ...)) ->
    (new_state, {key: (B, T, ...)} for the keys in KEEP)."""

    @torch.inference_mode()
    def scan_eval(track_state: TrackState, frames: FrameBatch):
        f0 = frame_at(frames, 0)
        f2 = model.head_stage(f0.pc2, f0.ft2, f0.mask2)
        outs = {k: [] for k in KEEP}
        for t in range(frames.pc1.shape[1]):
            out, track_state, f2 = model.step_cached(frame_at(frames, t),
                                                     track_state, f2)
            for k in KEEP:
                outs[k].append(out[k])
        return track_state, {k: torch.stack(v, dim=1)
                             for k, v in outs.items()}

    return scan_eval
