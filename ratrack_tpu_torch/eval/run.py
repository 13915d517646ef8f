"""Offline MOT evaluation CLI: results tree + VoD GT → SAMOTA/AMOTA table.

The port's own copy of `ratrack_tpu/eval/run.py`
(tests/test_torch_port_eval.py holds the two equal).

The reference's published table (README.md:167-170) is produced by the
authors' *unreleased* modified-AB3DMOT evaluation over the per-frame result
dumps (README.md:174-176). This module is that missing piece: it reads the
`results/<clip>/<frame>.txt` files written by eval mode
(`eval/export.py`, format of src/main_utils.py:166-184), reconstructs the
GT moving-object point sets from the dataset (same in-box test the train
path uses), and scores with point-set-IoU CLEAR-MOT + recall-integrated
AMOTA/sAMOTA (`eval/mot_metrics.py`).

Usage:
    python -m ratrack_tpu_torch.eval.run --results ./results \
        --dataset /path/to/vod --split val [--iou 0.25]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from ..config import Config
from ..data.pipeline import VodTrackStream
from ..data.gt import build_frame_gt
from .export import parse_frame_results
from .mot_metrics import (integrated_mot, namespace_ids,
                          GTFrame, PredFrame)


def gt_point_sets(stream: VodTrackStream, frame_number: int) -> GTFrame:
    """GT moving objects of one frame → {label id: (M,3) raw points}.

    Uses the identical pipeline the train path uses (moving-label filter +
    OBB in-box test + rider merge + min-points filter) over the RAW cloud,
    so GT membership is exact against exported original coordinates.
    """
    fd, tr, mov = stream._load_frame(frame_number)
    pc = fd.radar[:, :3]
    gt = build_frame_gt(mov, pc, tr, stream.cfg.min_obj_points)
    return {int(obj_id): pc[idx] for obj_id, idx in gt.objs.items()}


def gt_point_sets_from_record(rec) -> GTFrame:
    """GT objects of a FrameBatch record → {label id: (M,3) points}.

    Dataset-agnostic counterpart of `gt_point_sets`: uses the record's own
    dense GT slots over the padded cloud, so any stream (synthetic
    included) can be MOT-scored against its exported results.
    """
    pc1 = np.asarray(rec.pc1)
    dense = np.asarray(rec.gt_dense)
    ids = np.asarray(rec.gt_label_ids)
    valid = np.asarray(rec.gt_valid)
    mask = np.asarray(rec.mask1)
    out: GTFrame = {}
    for slot in range(ids.shape[0]):
        if not valid[slot]:
            continue
        pts = pc1[(dense == slot) & mask]
        if pts.shape[0]:
            out[int(ids[slot])] = pts
    return out


def evaluate_results_stream(stream, results_dir: str,
                            iou_thres: float = 0.25) -> Dict[str, float]:
    """MOT metrics for any (clip, record) stream against a results tree."""
    gt_frames: List[GTFrame] = []
    pred_frames: List[PredFrame] = []
    per_clip: Dict[str, Dict[str, float]] = {}
    cur, g, p = None, [], []
    clip_idx = [0]

    def flush(clip):
        if g:
            per_clip[clip] = integrated_mot(g, p, iou_thres)
            g2, p2 = namespace_ids(g, p, clip_idx[0])
            gt_frames.extend(g2)
            pred_frames.extend(p2)
        clip_idx[0] += 1

    for clip, rec in stream:
        if clip != cur:
            flush(cur)
            g, p = [], []
            cur = clip
        path = os.path.join(results_dir, clip,
                            f"{int(rec.frame_number):05d}.txt")
        if not os.path.exists(path):
            continue
        g.append(gt_point_sets_from_record(rec))
        p.append(parse_frame_results(path))
    flush(cur)
    overall = integrated_mot(gt_frames, pred_frames, iou_thres)
    overall["per_clip"] = per_clip
    return overall


def collect_clip(stream: VodTrackStream, results_dir: str, clip: str):
    """Frame-aligned (gt_frames, pred_frames) for one clip.

    Frames are keyed by the exported frame number (= t+1 of each pair).
    Result files with no GT counterpart (skipped GT frames) are dropped,
    matching how the reference's offline eval walks its result tree.
    """
    clip_dir = os.path.join(results_dir, clip)
    gt_frames: List[GTFrame] = []
    pred_frames: List[PredFrame] = []
    if not os.path.isdir(clip_dir):
        return gt_frames, pred_frames
    for name in sorted(os.listdir(clip_dir)):
        if not name.endswith(".txt"):
            continue
        frame_number = int(name[:-4])
        try:
            gts = gt_point_sets(stream, frame_number)
        except (FileNotFoundError, ValueError, IndexError):
            continue
        gt_frames.append(gts)
        pred_frames.append(parse_frame_results(
            os.path.join(clip_dir, name)))
    return gt_frames, pred_frames


def evaluate_results(results_dir: str, dataset_path: str, split: str = "val",
                     iou_thres: float = 0.25,
                     min_obj_points: int = 2) -> Dict[str, float]:
    """Aggregate MOT metrics over every clip of `split`."""
    cfg = Config(dataset_path=dataset_path, min_obj_points=min_obj_points)
    stream = VodTrackStream(cfg, split=split)
    gt_frames: List[GTFrame] = []
    pred_frames: List[PredFrame] = []
    per_clip = {}
    for ci, clip in enumerate(stream.clips):
        g, p = collect_clip(stream, results_dir, clip)
        if g:
            per_clip[clip] = integrated_mot(g, p, iou_thres)
        # per-clip id namespaces: GT/track ids are only unique per sequence
        g, p = namespace_ids(g, p, ci)
        gt_frames.extend(g)
        pred_frames.extend(p)
    overall = integrated_mot(gt_frames, pred_frames, iou_thres)
    overall["per_clip"] = per_clip
    return overall


def format_table(m: Dict[str, float]) -> str:
    """Reference-README-style metric table (README.md:167-170)."""
    rows = [("SAMOTA", m["samota"] * 100), ("AMOTA", m["amota"] * 100),
            ("AMOTP", m["amotp"] * 100), ("MOTA", m["mota"] * 100),
            ("MODA", m["moda"] * 100), ("MT", m["mt"] * 100),
            ("ML", m["ml"] * 100)]
    lines = ["| Metric | Value |", "|---|---|"]
    lines += [f"| {k} | {v:.2f} |" for k, v in rows]
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Offline MOT evaluation over exported results")
    p.add_argument("--results", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--split", default="val",
                   choices=["train", "val", "test"])
    p.add_argument("--iou", type=float, default=0.25)
    p.add_argument("--min-obj-points", type=int, default=2)
    p.add_argument("--json", action="store_true",
                   help="print full metrics as one JSON line")
    args = p.parse_args(argv)

    m = evaluate_results(args.results, args.dataset, args.split, args.iou,
                         args.min_obj_points)
    if args.json:
        print(json.dumps({k: v for k, v in m.items() if k != "per_clip"}))
    else:
        print(format_table(m))
        for clip, cm in m["per_clip"].items():
            print(f"{clip}: samota={cm['samota']*100:.2f} "
                  f"amota={cm['amota']*100:.2f} mota={cm['mota']*100:.2f} "
                  f"idsw={cm['idsw']} gt={cm['n_gt']}")


if __name__ == "__main__":
    main()
