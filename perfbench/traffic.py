"""Traffic of the benchmark: synthetic radar clips drawn from the seed.

`synthetic_clip` is a frozen copy of the program's clip generator
(ratrack_tpu_torch/data/synthetic.py): static points around the sensor
and rigid objects moving at constant velocity, with exact ground truth.
`make_pool` reads a traffic mix (mixes/<name>.json) and lays out, for each
of `streams` streams, `clips` clips of `clip_frames` frames back to back
along the time axis; a clip's first frame carries new_seq. The window
plays blocks of `block_frames` frames from the pool in order and wraps
around.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class FrameBatch(NamedTuple):
    """A frame-pair record (the program's field order): pc1 is frame t+1,
    pc2 frame t."""
    pc1: object
    pc2: object
    ft1: object
    ft2: object
    mask1: object
    mask2: object
    pc1_comp: object
    gt_cls: object
    gt_flow: object
    gt_dense: object
    gt_label_ids: object
    gt_valid: object
    new_seq: object
    frame_number: object


def empty_frame(n_max: int, g_max: int) -> FrameBatch:
    z3 = np.zeros((n_max, 3), np.float32)
    z2 = np.zeros((n_max, 2), np.float32)
    zb = np.zeros((n_max,), bool)
    return FrameBatch(
        pc1=z3, pc2=z3.copy(), ft1=z2, ft2=z2.copy(), mask1=zb,
        mask2=zb.copy(), pc1_comp=z3.copy(), gt_cls=zb.copy(),
        gt_flow=z3.copy(), gt_dense=np.full((n_max,), -1, np.int32),
        gt_label_ids=np.full((g_max,), -1, np.int32),
        gt_valid=np.zeros((g_max,), bool), new_seq=np.asarray(False),
        frame_number=np.asarray(0, np.int32))


def synthetic_clip(seed: int, n_frames: int, n_max: int = 512,
                   g_max: int = 32, n_static: int = 300, n_objects: int = 4,
                   pts_per_obj: int = 12) -> List[FrameBatch]:
    """A clip of frame-pair records (numpy arrays) with exact GT."""
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
        for i in range(n_objects):
            sl = slice(i * pts_per_obj, (i + 1) * pts_per_obj)
            p = pts[sl]
            los = p / (np.linalg.norm(p, axis=1, keepdims=True) + 1e-6)
            ft[sl, 1] = np.sum(los * vels[i], axis=1)
        return ft

    frames = []
    for t in range(n_frames):
        pc1_raw, oid1 = cloud_at(t + 1)
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


def stack_frames(frames):
    """Stack records along a new leading axis."""
    return FrameBatch(*[np.stack([np.asarray(getattr(f, k)) for f in frames])
                        for k in FrameBatch._fields])


# clip seeds stay below 2**32 / 100003, so that the generator's per-scan
# seeds (seed * 100003 + t) fit numpy's 32-bit RandomState
CLIP_SEEDS = 2 ** 32 // 100003 - 1024


def clip_seeds(seed: int, count: int) -> List[int]:
    """`count` distinct clip seeds drawn from the run's seed."""
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    return [int(s) for s in rng.choice(CLIP_SEEDS, size=count,
                                       replace=False)]


def make_pool(mix: dict, seed: int, device) -> FrameBatch:
    """A mix's clips as one FrameBatch of (streams, clips * clip_frames,
    ...) tensors on `device`."""
    t, streams = mix, mix["streams"]
    seeds = clip_seeds(seed, streams * t["clips"])
    rows = []
    for s in range(streams):
        clips = [stack_frames(synthetic_clip(
            seeds[s * t["clips"] + c], t["clip_frames"], n_max=t["n_max"],
            g_max=t["g_max"], n_static=t["n_static"],
            n_objects=t["n_objects"], pts_per_obj=t["pts_per_obj"]))
            for c in range(t["clips"])]
        rows.append(FrameBatch(*[np.concatenate(x) for x in zip(*clips)]))
    pool = stack_frames(rows)
    return FrameBatch(*[torch.from_numpy(np.ascontiguousarray(x)).to(device)
                        for x in pool])


def block(pool: FrameBatch, j: int, frames: int) -> FrameBatch:
    """Block j of the pool (wrapping around): (streams, frames, ...)."""
    per = pool.pc1.shape[1] // frames
    t0 = (j % per) * frames
    return FrameBatch(*[x[:, t0:t0 + frames] for x in pool])


def frame_at(frames: FrameBatch, t: int) -> FrameBatch:
    return FrameBatch(*[x[:, t].contiguous() for x in frames])
