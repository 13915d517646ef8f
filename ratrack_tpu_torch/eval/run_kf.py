"""Offline Kalman re-tracking over exported detections + MOT scoring.

The port's own copy of `ratrack_tpu/eval/run_kf.py`: the same printed
table (tests/test_torch_port_offline_eval.py).

The reference vendors AB3DMOT for exactly this (SURVEY.md §2.4 L7,
src/AB3DMOT_libs/model.py:17-542) but never wires it in (README.md:185-187
"planned integration"). This CLI closes that gap: it reads the per-frame
result dumps, treats each point-set track as a box DETECTION (centroid +
axis-aligned extent, yaw 0 — radar point sets carry no orientation),
re-associates them across frames with the constant-velocity Kalman tracker
(`eval/kalman.py`, VoD params: hungarian, 3D centroid distance, thres 2 m,
min_hits/max_age lifecycle), and scores the re-identified tracks with the
same point-set-IoU MOT metrics as `eval.run` — so the learned Sinkhorn
association and the classical KF association are directly comparable.

Usage:
    python -m ratrack_tpu_torch.eval.run_kf --results ./results \
        --dataset /path/to/vod --split val [--min-hits 4] [--max-age 8]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..data.pipeline import VodTrackStream
from ..data.vod import ego_motion_radar
from .export import parse_frame_results
from .kalman import BoxDet, KalmanTracker
from .mot_metrics import (integrated_mot, namespace_ids,
                          GTFrame, PredFrame)
from .run import gt_point_sets, format_table


def dets_from_points(preds) -> List[Tuple[int, BoxDet]]:
    """Point-set predictions → (pred index, box detection) pairs.

    The pred index is carried explicitly: empty point sets are skipped, so
    positions in the detection list do NOT align with `preds`.
    """
    dets = []
    for j, (conf, _tid, pts) in enumerate(preds):
        if pts.shape[0] == 0:
            continue
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        dets.append((j, BoxDet(xyz=(lo + hi) / 2.0, yaw=0.0,
                               lwh=np.maximum(hi - lo, 0.1), conf=conf)))
    return dets


def clip_ego_motions(stream: VodTrackStream,
                     frame_numbers: List[int]) -> List:
    """Per-frame radar-frame ego transforms for `retrack_clip`.

    Entry i maps radar coordinates of frame i−1 into frame i via
    KalmanTracker's inv(T)·p (T = ego_motion_radar(prev, cur), the
    reference pose algebra from AB3DMOT_libs/model.py:221-223 applied in
    the radar frame the result dumps live in — the vendored tracker works
    in camera coordinates, model.py:228-246). Entry 0 is None (no previous
    frame, mirroring the vendored `frame > 0` gate, model.py:489-492), as
    is any entry whose pose/calib file is missing (the vendored code
    scans forward for a readable pose pair, model.py:209-225; skipping
    compensation for that frame is the deterministic equivalent).
    """
    egos: List = [None]
    for prev, cur in zip(frame_numbers, frame_numbers[1:]):
        try:
            tr0 = stream._load_frame(prev)[1]
            tr1 = stream._load_frame(cur)[1]
            egos.append(ego_motion_radar(tr0, tr1))
        except (FileNotFoundError, ValueError, IndexError, KeyError):
            egos.append(None)
    return egos


def retrack_clip(frames: List[PredFrame], min_hits: int,
                 max_age: int, match_dist: float,
                 ego_motions: Optional[List] = None) -> List[PredFrame]:
    """Replace per-frame track ids with Kalman-tracker ids.

    Detections the KF has not yet confirmed (hits < min_hits) are dropped,
    mirroring AB3DMOT's output lifecycle. Each original point set is
    claimed by at most one tracker output (nearest unclaimed centroid).
    `ego_motions` (optional, aligned with `frames`) enables the vendored
    preset's ego compensation of predicted track positions
    (model.py:489-492).
    """
    trk = KalmanTracker(match_dist=match_dist, min_hits=min_hits,
                        max_age=max_age)
    out: List[PredFrame] = []
    for fi, preds in enumerate(frames):
        indexed = dets_from_points(preds)
        ego = ego_motions[fi] if ego_motions else None
        tracked = trk.track([d for _, d in indexed], ego_motion=ego)
        frame_out: PredFrame = []
        claimed: set = set()
        for tid, box, conf in tracked:
            best_j, best_d = -1, match_dist
            for j, det in indexed:
                if j in claimed:
                    continue
                d = float(np.linalg.norm(box.xyz - det.xyz))
                if d < best_d:
                    best_j, best_d = j, d
            if best_j >= 0:
                claimed.add(best_j)
                frame_out.append((conf, int(tid), preds[best_j][2]))
        out.append(frame_out)
    return out


def evaluate_kf(results_dir: str, dataset_path: str, split: str = "val",
                iou_thres: float = 0.25, min_obj_points: int = 2,
                min_hits: int = 4, max_age: int = 8,
                match_dist: float = 2.0,
                ego_comp: bool = False) -> Dict[str, float]:
    cfg = Config(dataset_path=dataset_path, min_obj_points=min_obj_points)
    stream = VodTrackStream(cfg, split=split)
    gt_all: List[GTFrame] = []
    pred_all: List[PredFrame] = []
    for ci, clip in enumerate(stream.clips):
        clip_dir = os.path.join(results_dir, clip)
        if not os.path.isdir(clip_dir):
            continue
        gts, preds, frame_numbers = [], [], []
        for name in sorted(os.listdir(clip_dir)):
            if not name.endswith(".txt"):
                continue
            try:
                g = gt_point_sets(stream, int(name[:-4]))
            except (FileNotFoundError, ValueError, IndexError):
                continue
            gts.append(g)
            frame_numbers.append(int(name[:-4]))
            preds.append(parse_frame_results(os.path.join(clip_dir, name)))
        egos = clip_ego_motions(stream, frame_numbers) if ego_comp else None
        tracked = retrack_clip(preds, min_hits, max_age, match_dist, egos)
        gts, tracked = namespace_ids(gts, tracked, ci)
        gt_all.extend(gts)
        pred_all.extend(tracked)
    return integrated_mot(gt_all, pred_all, iou_thres)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Kalman re-tracking + MOT scoring over results")
    p.add_argument("--results", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--split", default="val",
                   choices=["train", "val", "test"])
    p.add_argument("--iou", type=float, default=0.25)
    p.add_argument("--min-obj-points", type=int, default=2)
    p.add_argument("--min-hits", type=int, default=4)
    p.add_argument("--max-age", type=int, default=8)
    p.add_argument("--match-dist", type=float, default=2.0)
    p.add_argument("--ego-comp", action="store_true",
                   help="compensate predicted track positions with the "
                        "per-frame radar ego motion (vendored preset "
                        "behavior, model.py:489-492)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    m = evaluate_kf(args.results, args.dataset, args.split, args.iou,
                    args.min_obj_points, args.min_hits, args.max_age,
                    args.match_dist, args.ego_comp)
    if args.json:
        print(json.dumps({k: v for k, v in m.items()
                          if not isinstance(v, dict)}))
    else:
        print(format_table(m))


if __name__ == "__main__":
    main()
