"""VoD detection-AP CLI + point-track -> KITTI detection conversion.

The port's own copy of `ratrack_tpu/eval/run_ap.py`: the same KITTI
lines byte for byte (tests/test_torch_port_offline_eval.py).

Two entry modes:

  * label-dir evaluation (the reference Evaluation.evaluate usage,
    src/vod/evaluation/evaluate.py:18-47):

        python -m ratrack_tpu_torch.eval.run_ap --gt <label_dir> --dt <pred_dir>

    where both directories hold KITTI-format label txts (predictions with
    a 16th score column). Prints the entire-area + driving-corridor-ROI
    mAP_11 table for Car/Pedestrian/Cyclist.

  * tracking-results evaluation: first convert the per-frame point-set
    dumps (results/<clip>/<frame>.txt, eval/export.py format) into KITTI
    detection files with `--results/--dataset/--out-dt`, then evaluate
    against the dataset's detection labels. RaTrack is class-agnostic
    (moving-object point sets, no class head — reference README "no
    bounding boxes"), so converted detections carry a single
    user-chosen class name (--det-class); the AP of that class measures
    moving-object localization, the other classes measure nothing. This
    capability note mirrors PARITY.md.

Conversion geometry: a track's box is the axis-aligned extent of its
points in the radar frame (yaw 0 — radar point sets carry no
orientation), transformed to camera coordinates for `location`
(bottom-center convention: camera y is the box bottom), with the 2D bbox
from projecting the 3D corners through the camera intrinsics — needed
because the evaluator's min-height-40px rule (clean_data) filters on it.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np

from ..data.projection import read_intrinsic
from ..data.vod import FrameData, Transforms, VodLocations
from .detection_ap import load_annotations, official_evaluation
from .export import parse_frame_results


def _corners3d(center: np.ndarray, lwh: np.ndarray) -> np.ndarray:
    """(8, 3) axis-aligned box corners in the source (radar) frame."""
    l, w, h = lwh
    dx = np.array([l, l, -l, -l, l, l, -l, -l]) / 2.0
    dy = np.array([w, -w, -w, w, w, -w, -w, w]) / 2.0
    dz = np.array([h, h, h, h, -h, -h, -h, -h]) / 2.0
    return center[None, :] + np.stack([dx, dy, dz], axis=1)


def kitti_lines_from_point_tracks(preds, transforms: Transforms,
                                  intrinsic: np.ndarray,
                                  det_class: str = "Pedestrian",
                                  min_extent: float = 0.1) -> List[str]:
    """Point-set tracks of one frame -> KITTI detection label lines."""
    lines = []
    for conf, _tid, pts in preds:
        if pts.shape[0] == 0:
            continue
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        center = (lo + hi) / 2.0
        ext = np.maximum(hi - lo, min_extent)        # radar (x, y, z)
        l, w, h = float(ext[0]), float(ext[1]), float(ext[2])
        corners_cam = (transforms.t_camera_radar @ np.concatenate(
            [_corners3d(center, np.array([l, w, h])),
             np.ones((8, 1))], axis=1).T).T[:, :3]
        uvw = intrinsic[:3, :3] @ corners_cam.T + intrinsic[:3, 3:4]
        depth = uvw[2]
        if (depth <= 0.1).any():
            continue                                  # behind the camera
        uv = (uvw[:2] / depth).T
        bbox = [uv[:, 0].min(), uv[:, 1].min(),
                uv[:, 0].max(), uv[:, 1].max()]
        center_cam = (transforms.t_camera_radar
                      @ np.array([*center, 1.0]))[:3]
        # KITTI location = bottom-center in camera coords (y down)
        loc = [center_cam[0], center_cam[1] + h / 2.0, center_cam[2]]
        vals = ["%.4f" % v for v in
                [0.0, 0, -10.0, *bbox, h, w, l, *loc, 0.0, conf]]
        lines.append(" ".join([det_class] + vals))
    return lines


def convert_results_tree(results_dir: str, dataset_path: str,
                         out_dir: str, det_class: str = "Pedestrian",
                         radar_variant: str = "radar") -> int:
    """results/<clip>/<frame>.txt -> out_dir/<frame>.txt KITTI detections."""
    loc = VodLocations(dataset_path, radar_variant)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for clip in sorted(os.listdir(results_dir)):
        clip_dir = os.path.join(results_dir, clip)
        if not os.path.isdir(clip_dir):
            continue
        for name in sorted(os.listdir(clip_dir)):
            if not name.endswith(".txt"):
                continue
            frame_no = name[:-4]
            fd = FrameData(loc, frame_no)
            tr = Transforms(fd)
            k = read_intrinsic(fd, "radar")
            preds = parse_frame_results(os.path.join(clip_dir, name))
            lines = kitti_lines_from_point_tracks(preds, tr, k, det_class)
            with open(os.path.join(out_dir, name), "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
            n += 1
    return n


def format_ap_table(res: dict) -> str:
    rows = ["{:<14s} {:>12s} {:>12s}".format("class", "3d mAP11",
                                             "bev mAP11")]
    for area in ("entire_area", "roi"):
        rows.append(f"-- {area} --")
        for cls in ("Car", "Pedestrian", "Cyclist"):
            k3, kb = f"{cls}_3d_all", f"{cls}_bev_all"
            if k3 in res[area]:
                rows.append("{:<14s} {:>12.2f} {:>12.2f}".format(
                    cls, res[area][k3], res[area][kb]))
    return "\n".join(rows)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="VoD official KITTI-style detection AP")
    p.add_argument("--gt", required=True,
                   help="GT detection-label dir (KITTI txt)")
    p.add_argument("--dt", help="prediction label dir (KITTI txt + score)")
    p.add_argument("--results", help="tracking results tree to convert")
    p.add_argument("--dataset", help="VoD root (for --results conversion)")
    p.add_argument("--out-dt", default="./results_kitti_dets",
                   help="where converted detections are written")
    p.add_argument("--det-class", default="Pedestrian")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    dt_dir = args.dt
    if dt_dir is None:
        if not (args.results and args.dataset):
            p.error("need --dt, or --results with --dataset")
        convert_results_tree(args.results, args.dataset, args.out_dt,
                             args.det_class)
        dt_dir = args.out_dt

    dt_annos, ids = load_annotations(dt_dir)
    gt_annos, _ = load_annotations(args.gt, ids)
    res = official_evaluation(gt_annos, dt_annos)
    if args.json:
        print(json.dumps(res))
    else:
        print(format_ap_table(res))


if __name__ == "__main__":
    main()
