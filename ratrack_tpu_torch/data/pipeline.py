"""Deterministic VoD clip streaming → padded FrameBatch records.

The port's own copy of `ratrack_tpu/data/pipeline.py`: the same records,
array for array (tests/test_torch_port_data.py). Records are NumPy
`data.frames.FrameBatch`es; nothing here touches torch or a device, so
`Prefetcher`'s thread makes no CUDA call (the consumer moves a record to
its device).

Replaces the reference's stateful torch Dataset
(`src/dataset_classes/track_vod_3d.py:24-131`) — whose internal cursor is
silently copied per DataLoader worker — with an explicit, deterministic
iterator over (clip, frame) pairs. Per record, it does everything the
reference spreads between `__getitem__` and the epoch body
(`src/main_utils.py:76-126`): loads radar frames t and t+1, ego-motion
compensation, moving-label filtering, GT in-box masks, and rigid GT flow —
then pads to the fixed budget and emits a FrameBatch.

Frame-skip behaviour: the reference swallows any per-frame exception and
moves on (`track_vod_3d.py:121-122`, `main_utils.py:107-108`); here only
FileNotFoundError / malformed-file errors skip the frame, and each skip is
recorded in `self.skipped` instead of passing silently.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .frames import FrameBatch, empty_frame
from .gt import build_frame_gt, rigid_gt_flow
from .vod import (VodLocations, FrameData, Transforms,
                  parse_tracking_labels, filter_moving_labels,
                  ego_motion_radar, compensate_ego)

# hardcoded reference splits (track_vod_3d.py:34-36)
TRAIN_CLIPS = ["delft_2", "delft_3", "delft_4", "delft_6", "delft_9",
               "delft_11", "delft_12", "delft_13", "delft_19", "delft_23",
               "delft_24", "delft_26", "delft_27"]
VAL_CLIPS = ["delft_1", "delft_10", "delft_14", "delft_22"]
TEST_CLIPS = ["delft_7", "delft_8", "delft_16", "delft_18", "delft_20",
              "delft_21", "delft_25"]

# inclusive contiguous frame ranges per clip (the reference ships these as
# one-number-per-line txt files under src/clips/; every file is a plain
# [first..last] range, so the ranges are stored directly)
CLIP_RANGES = {
    "delft_1": (0, 543), "delft_2": (544, 1311), "delft_3": (1312, 1802),
    "delft_4": (1803, 2199), "delft_6": (2200, 2531),
    "delft_7": (2532, 2797), "delft_8": (2798, 3276),
    "delft_9": (3277, 3574), "delft_10": (3575, 3609),
    "delft_11": (3610, 4047), "delft_12": (4049, 4386),
    "delft_13": (4387, 4651), "delft_14": (4652, 5085),
    "delft_16": (6334, 6570), "delft_18": (6571, 6758),
    "delft_19": (6759, 7542), "delft_20": (7543, 7899),
    "delft_21": (7900, 8197), "delft_22": (8198, 8480),
    "delft_23": (8481, 8748), "delft_24": (8749, 9095),
    "delft_25": (9096, 9517), "delft_26": (9518, 9775),
    "delft_27": (9776, 9930),
}


def _pad_or_subsample(arr: np.ndarray, n_max: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, C) → ((n_max, C), mask, kept-row indices).

    Reference keeps all raw points; when a frame exceeds the budget we
    deterministically subsample (seeded by frame number).
    """
    n = arr.shape[0]
    if n > n_max:
        keep = np.random.RandomState(seed).choice(n, n_max, replace=False)
        keep.sort()
        arr = arr[keep]
        n = n_max
    else:
        keep = np.arange(n)
    out = np.zeros((n_max,) + arr.shape[1:], arr.dtype)
    out[:n] = arr
    mask = np.zeros(n_max, bool)
    mask[:n] = True
    return out, mask, keep


class VodTrackStream:
    """Sequential frame-pair stream over VoD clips."""

    def __init__(self, cfg, split: Optional[str] = None,
                 clips: Optional[List[str]] = None):
        self.cfg = cfg
        split = split or ("val" if cfg.eval else "train")
        self.clips = clips if clips is not None else {
            "train": TRAIN_CLIPS, "val": VAL_CLIPS,
            "test": TEST_CLIPS}[split]
        self.loc = VodLocations(cfg.dataset_path)
        self.clips_dir = cfg.clips_dir  # optional txt override directory
        self.skipped: List[Tuple[str, int, str]] = []

    def clip_frames(self, clip: str) -> List[int]:
        if self.clips_dir:
            path = os.path.join(self.clips_dir, clip + ".txt")
            if os.path.exists(path):
                with open(path) as f:
                    return [int(x) for x in f.read().splitlines()
                            if x.strip()]
        first, last = CLIP_RANGES[clip]
        return list(range(first, last + 1))

    def __len__(self) -> int:
        return sum(len(self.clip_frames(c)) for c in self.clips)

    def _load_frame(self, frame_number: int):
        fd = FrameData(self.loc, str(frame_number).zfill(5))
        tr = Transforms(fd)
        labels = parse_tracking_labels(fd.tracking_labels)
        mov = filter_moving_labels(labels, fd.detection_labels)
        return fd, tr, mov

    def _frame_bundle(self, frame_number: int):
        """(fd, tr, mov, gt) for one frame — the per-frame host work."""
        fd, tr, mov = self._load_frame(frame_number)
        gt = build_frame_gt(mov, fd.radar[:, :3], tr,
                            self.cfg.min_obj_points)
        return fd, tr, mov, gt

    def record(self, clip: str, frame_number: int, new_seq: bool,
               bundle2=None) -> FrameBatch:
        """Build one FrameBatch for the pair (frame_number+1, frame_number).

        `bundle2`: optional cached `_frame_bundle(frame_number)` — each
        record's pc1 side is the NEXT record's pc2 side, so the iterator
        threads bundles forward and halves file decode + GT (OBB) work.
        Use `record_with_bundle` to also receive this record's pc1 bundle.
        """
        return self.record_with_bundle(clip, frame_number, new_seq,
                                       bundle2)[0]

    def record_with_bundle(self, clip: str, frame_number: int,
                           new_seq: bool, bundle2=None):
        cfg = self.cfg
        fd1, tr1, mov1, gt1 = bundle1 = self._frame_bundle(frame_number + 1)
        fd2, tr2, mov2, gt2 = bundle2 or self._frame_bundle(frame_number)

        radar1, radar2 = fd1.radar, fd2.radar
        pc1_raw, ft1_raw = radar1[:, :3], radar1[:, 3:5]  # [RCS, v_r]
        pc2_raw, ft2_raw = radar2[:, :3], radar2[:, 3:5]

        ego = ego_motion_radar(tr1, tr2)
        pc1_comp_raw = compensate_ego(pc1_raw, ego)
        gt_flow_raw = rigid_gt_flow(pc1_raw, pc1_comp_raw, gt1, gt2)

        pc1, mask1, keep1 = _pad_or_subsample(pc1_raw, cfg.n_max,
                                              frame_number + 1)
        pc2, mask2, keep2 = _pad_or_subsample(pc2_raw, cfg.n_max,
                                              frame_number)
        ft1 = np.zeros((cfg.n_max, 2), np.float32)
        ft1[:keep1.size] = ft1_raw[keep1]
        ft2 = np.zeros((cfg.n_max, 2), np.float32)
        ft2[:keep2.size] = ft2_raw[keep2]

        pc1_comp = np.zeros((cfg.n_max, 3), np.float32)
        pc1_comp[:keep1.size] = pc1_comp_raw[keep1]
        gt_flow = pc1.copy()
        gt_flow[:keep1.size] = gt_flow_raw[keep1]

        gt_cls = np.zeros(cfg.n_max, bool)
        gt_cls[:keep1.size] = gt1.cls[keep1]

        # dense GT slots in label order (combined objects only)
        ids = gt1.obj_ids_in_order[:cfg.g_max]
        id_to_slot = {obj_id: i for i, obj_id in enumerate(ids)}
        dense_raw = np.array(
            [id_to_slot.get(int(v), -1) for v in gt1.point_obj_combined],
            np.int32)
        gt_dense = np.full(cfg.n_max, -1, np.int32)
        gt_dense[:keep1.size] = dense_raw[keep1]
        gt_label_ids = np.full(cfg.g_max, -1, np.int32)
        gt_label_ids[:len(ids)] = ids
        gt_valid = np.zeros(cfg.g_max, bool)
        gt_valid[:len(ids)] = True

        rec = FrameBatch(
            pc1=pc1, pc2=pc2, ft1=ft1, ft2=ft2, mask1=mask1, mask2=mask2,
            pc1_comp=pc1_comp, gt_cls=gt_cls, gt_flow=gt_flow,
            gt_dense=gt_dense, gt_label_ids=gt_label_ids, gt_valid=gt_valid,
            new_seq=np.asarray(new_seq),
            frame_number=np.asarray(frame_number + 1, np.int32))
        return rec, bundle1

    def __iter__(self) -> Iterator[Tuple[str, FrameBatch]]:
        """Yields (clip_name, FrameBatch); bad frames are skipped + logged."""
        for clip in self.clips:
            frames = self.clip_frames(clip)
            new_seq = True
            prev = None       # (frame_number, bundle) threaded forward
            for f in frames[:-1]:
                bundle2 = prev[1] if prev and prev[0] == f else None
                try:
                    rec, bundle1 = self.record_with_bundle(clip, f, new_seq,
                                                           bundle2)
                except (FileNotFoundError, ValueError, IndexError) as e:
                    self.skipped.append((clip, f, repr(e)))
                    prev = None
                    continue
                prev = (f + 1, bundle1)
                new_seq = False
                yield clip, rec


class Prefetcher:
    """Background-thread iterator prefetch with a bounded queue.

    Overlaps host-side record assembly (file decode, GT construction,
    padding — the work the reference does synchronously inside its epoch
    loop between device steps) with device compute. Exceptions from the
    producer re-raise at the consumer.
    """

    _END = object()

    def __init__(self, iterable, depth: int = 4):
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: List[BaseException] = []

        def run():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as e:          # re-raised on the consumer
                self._err.append(e)
            finally:
                self._q.put(self._END)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                if self._err:
                    raise self._err[0]
                return
            yield item


def split_clips_balanced(clips: List[str], lengths: List[int],
                         n_groups: int) -> List[List[str]]:
    """Greedy longest-first partition of clips into n_groups balanced by
    total frame count. Groups may be empty when n_groups > len(clips)."""
    order = sorted(range(len(clips)), key=lambda i: -lengths[i])
    groups: List[List[str]] = [[] for _ in range(n_groups)]
    totals = [0] * n_groups
    for i in order:
        g = totals.index(min(totals))
        groups[g].append(clips[i])
        totals[g] += lengths[i]
    return groups


def batched_blocks(make_stream, groups: List[List[str]],
                   group_lengths: List[int], t: int,
                   n_max: int, g_max: int) -> Iterator[FrameBatch]:
    """Round B parallel clip-stream iterators into [B, T] frame blocks.

    Streams wrap cyclically until the longest group is exhausted, so every
    block has the same static shape (one XLA compilation). Wrapping restarts
    a group's clips from scratch — each restart begins with new_seq=True,
    exactly like the reference dataset's wrap-to-clip-0 behaviour
    (src/dataset_classes/track_vod_3d.py:53-63); short groups therefore
    see some frames more than once per epoch (deliberate oversampling in
    exchange for a single block shape). Empty groups yield all-padding
    frames whose masks zero out every loss term.

    `make_stream(clips)` must return a re-iterable of (clip, rec).
    """
    b = len(groups)
    pad = FrameBatch(*[np.asarray(x) for x in empty_frame(n_max, g_max)])

    def cyclic(clips: List[str]) -> Iterator[FrameBatch]:
        if not clips:
            while True:
                yield pad
        while True:
            n_yielded = 0
            for _, rec in make_stream(clips):
                n_yielded += 1
                yield rec
            if n_yielded == 0:       # all frames skipped → avoid spinning
                while True:
                    yield pad

    iters = [cyclic(g) for g in groups]
    # the longest group (estimated record count) drives the epoch length
    rounds = max(1, -(-max(group_lengths) // t))
    del b
    for _ in range(rounds):
        cols = [[next(it) for _ in range(t)] for it in iters]
        yield FrameBatch(*[
            np.stack([np.stack([np.asarray(getattr(r, f)) for r in col])
                      for col in cols])
            for f in FrameBatch._fields])
