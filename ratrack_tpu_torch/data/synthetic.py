"""Synthetic radar clip generator (numpy only).

A copy of `ratrack_tpu/data/synthetic.py` that needs no JAX: the same
RandomState draws in the same order, so a seed gives array-for-array
identical clips in both packages (pinned by tests/test_torch_port_ops.py).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .frames import FrameBatch, empty_frame


def synthetic_clip(seed: int, n_frames: int, n_max: int = 512,
                   g_max: int = 32, n_static: int = 300, n_objects: int = 4,
                   pts_per_obj: int = 12) -> List[FrameBatch]:
    """Generate a clip of frame-pair records (numpy arrays) with exact GT."""
    rng = np.random.RandomState(seed)
    static = rng.randn(n_static, 3).astype(np.float32) \
        * np.array([15, 10, 1.5], np.float32) + [25, 0, 1]
    centers = rng.uniform([5, -15, 0], [45, 15, 2],
                          (n_objects, 3)).astype(np.float32)
    vels = rng.uniform(-0.8, 0.8, (n_objects, 3)).astype(np.float32)
    vels[:, 2] = 0
    shapes = [rng.randn(pts_per_obj, 3).astype(np.float32) * 0.4
              for _ in range(n_objects)]
    label_ids = 100 + np.arange(n_objects)

    def cloud_at(t):
        objs = [centers[i] + vels[i] * t + shapes[i]
                for i in range(n_objects)]
        pts = np.concatenate(objs + [static], axis=0)
        obj_id = np.concatenate(
            [np.full(pts_per_obj, i, np.int32) for i in range(n_objects)]
            + [np.full(n_static, -1, np.int32)])
        return pts, obj_id

    def feats_at(t, pts):
        """Per-scan [RCS, v_r]: ft2 of pair t == ft1 of pair t-1."""
        rng_t = np.random.RandomState(seed * 100003 + t)
        n = pts.shape[0]
        ft = np.zeros((n_max, 2), np.float32)
        ft[:n] = rng_t.randn(n, 2).astype(np.float32) * 0.1
        # radial velocity ~ projection of velocity on the line of sight
        for i in range(n_objects):
            sl = slice(i * pts_per_obj, (i + 1) * pts_per_obj)
            p = pts[sl]
            los = p / (np.linalg.norm(p, axis=1, keepdims=True) + 1e-6)
            ft[sl, 1] = np.sum(los * vels[i], axis=1)
        return ft

    frames = []
    for t in range(n_frames):
        pc1_raw, oid1 = cloud_at(t + 1)   # "pc1" is the later frame t+1
        pc2_raw, _ = cloud_at(t)
        n = pc1_raw.shape[0]
        if n > n_max:
            raise ValueError(f"{n} points exceed n_max={n_max}")
        f = empty_frame(n_max, g_max)._asdict()
        pc1 = np.zeros((n_max, 3), np.float32)
        pc1[:n] = pc1_raw
        pc2 = np.zeros((n_max, 3), np.float32)
        pc2[:n] = pc2_raw
        mask = np.zeros(n_max, bool)
        mask[:n] = True
        ft = feats_at(t + 1, pc1_raw)
        ft2 = feats_at(t, pc2_raw)

        gt_dense = np.full(n_max, -1, np.int32)
        gt_dense[:n] = oid1
        gt_cls = np.zeros(n_max, bool)
        gt_cls[:n] = oid1 >= 0
        # GT flow positions: moving points rigidly step back one frame
        gt_flow = pc1.copy()
        for i in range(n_objects):
            sl = slice(i * pts_per_obj, (i + 1) * pts_per_obj)
            gt_flow[sl] = pc1[sl] - vels[i]

        gt_ids = np.full(g_max, -1, np.int32)
        gt_ids[:n_objects] = label_ids
        gt_valid = np.zeros(g_max, bool)
        gt_valid[:n_objects] = True

        f.update(pc1=pc1, pc2=pc2, ft1=ft, ft2=ft2, mask1=mask,
                 mask2=mask.copy(), pc1_comp=pc1.copy(), gt_cls=gt_cls,
                 gt_flow=gt_flow, gt_dense=gt_dense, gt_label_ids=gt_ids,
                 gt_valid=gt_valid, new_seq=np.asarray(t == 0),
                 frame_number=np.asarray(t + 1, np.int32))
        frames.append(FrameBatch(**f))
    return frames


def stack_frames(frames: List[FrameBatch]) -> FrameBatch:
    """Stack records along a new leading axis (time or batch)."""
    return FrameBatch(*[np.stack([np.asarray(getattr(f, name))
                                  for f in frames])
                        for name in FrameBatch._fields])
