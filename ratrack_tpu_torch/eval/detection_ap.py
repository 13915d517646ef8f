"""VoD official KITTI-style detection AP (entire-area + driving-corridor).

The port's own copy of `ratrack_tpu/eval/detection_ap.py`: the same
tables (tests/test_torch_port_offline_eval.py).

Pure-NumPy reimplementation of the reference evaluation capability
(`src/vod/evaluation/`): the L7 layer the round-1 review flagged as the
one importable reference capability with no equivalent here.

Protocol (all citations into the reference repository):
  * KITTI label parsing — evaluation_common.py:20-57 (`dimensions`
    reordered hwl -> lhw, missing score column -> zeros);
  * per-frame cleaning — kitti_official_evaluate.py:32-117 `clean_data`:
    class matching with "neighbor" classes (Van for Car, Person_sitting
    for Pedestrian) ignored rather than penalized; difficulty filter
    (bbox height <= 40 px or occlusion > 4 -> ignored); the
    "driving corridor" ROI variant ignores boxes with camera-frame
    x outside [-4, 4] or z > 25 m (:71-80, custom_method=3);
  * overlaps — image bbox IoU (:119-148), BEV rotated IoU over camera
    (x, z) with dims (l, w) (rotate_iou_cpu.py convention,
    :433-446 calculate_iou_partly metric 1; the +0.01 rotation nudge
    lands on the DETECTIONS (the :533 call site swaps the arguments)
    perturbation of :440), 3D IoU = BEV intersection x camera-y extent
    overlap (:156-188);
  * matching/statistics — compute_statistics_jit (:191-331): per-GT
    greedy assignment (highest score for recall thresholds, greatest
    overlap for PR points), ignored-GT/DT bookkeeping, don't-care
    suppression on the image metric;
  * recall thresholds — get_thresholds (:8-29): 41 recall sample points
    over the sorted matched-detection scores;
  * AP — precision curves max-smoothed from the tail (:594-601),
    mAP_11 = mean of precision[0::4] x 100 (:613-617), mAP_40
    (:620-625);
  * reported keys — get_official_eval_result (:744-762): per class,
    difficulty 0, the SECOND overlap table (0.5 image / 0.25 bev / 0.25
    3d for Pedestrian+Cyclist, 0.5 for Car), as
    {entire_area|roi}: {<cls>_{3d,bev,aos}_all}.

The rotated-rectangle intersection uses Sutherland–Hodgman clipping
(exactly what rotate_iou_cpu.py's corner/edge routines compute); corner
generation follows rbbox_to_corners (rotate_iou_cpu.py:206-229).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence

import numpy as np

CLASS_NAMES = ("Car", "Pedestrian", "Cyclist")
# clean_data's class universe (kitti_official_evaluate.py:33)
_VALID_CLASS_NAMES = ("car", "pedestrian", "cyclist", "van",
                      "person_sitting", "truck")
_MIN_HEIGHT_PX = 40.0
_MAX_OCCLUSION = 4
_ROI_LEFT, _ROI_RIGHT, _ROI_MAX_DIST = -4.0, 4.0, 25.0
_N_SAMPLE_PTS = 41

# min_overlaps table (get_official_eval_result :733-739), second set
# ("overlap_0_5"): rows = metric (image, bev, 3d), cols = class index in
# _VALID_CLASS_NAMES
_MIN_OVERLAPS = np.array([[0.7, 0.50, 0.50, 0.7, 0.50, 0.5],
                          [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                          [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])


# ---------------------------------------------------------------------------
# annotations
# ---------------------------------------------------------------------------

def parse_label_file(path: str) -> Dict[str, np.ndarray]:
    """KITTI label txt -> annotation dict (evaluation_common.py:20-57)."""
    with open(path) as f:
        content = [ln.strip().split(" ") for ln in f.readlines()
                   if ln.strip()]
    ann = {
        "name": np.array([x[0] for x in content]),
        "truncated": np.array([float(x[1]) for x in content]),
        "occluded": np.array([int(float(x[2])) for x in content]),
        "alpha": np.array([float(x[3]) for x in content]),
        "bbox": np.array([[float(v) for v in x[4:8]]
                          for x in content]).reshape(-1, 4),
        # label order h,w,l -> stored l,h,w (reference [:, [2, 0, 1]])
        "dimensions": np.array([[float(v) for v in x[8:11]]
                                for x in content]).reshape(-1, 3)[:,
                                                                  [2, 0, 1]],
        "location": np.array([[float(v) for v in x[11:14]]
                              for x in content]).reshape(-1, 3),
        "rotation_y": np.array([float(x[14]) for x in content]).reshape(-1),
    }
    if content and len(content[0]) == 16:
        ann["score"] = np.array([float(x[15]) for x in content])
    else:
        ann["score"] = np.zeros(len(content))
    return ann


def load_annotations(label_dir: str,
                     frame_ids: Sequence[str] | None = None):
    """All 5-digit .txt label files of a directory, sorted by frame id."""
    if frame_ids is None:
        prog = re.compile(r"^\d{5}\.txt$")
        frame_ids = sorted(f[:-4] for f in os.listdir(label_dir)
                           if prog.match(f))
    return ([parse_label_file(os.path.join(label_dir, f"{i}.txt"))
             for i in frame_ids], list(frame_ids))


# ---------------------------------------------------------------------------
# overlaps
# ---------------------------------------------------------------------------

def image_box_overlap(boxes: np.ndarray, query: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """Pixel-box overlap (kitti_official_evaluate.py:119-148), (N, K).

    criterion -1 -> IoU; 0 -> intersection / boxes-row area (the
    reference's don't-care suppression mode, :308)."""
    n, k = boxes.shape[0], query.shape[0]
    out = np.zeros((n, k))
    if n == 0 or k == 0:
        return out
    iw = (np.minimum(boxes[:, None, 2], query[None, :, 2])
          - np.maximum(boxes[:, None, 0], query[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query[None, :, 3])
          - np.maximum(boxes[:, None, 1], query[None, :, 1]))
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    a1 = ((boxes[:, 2] - boxes[:, 0])
          * (boxes[:, 3] - boxes[:, 1]))[:, None]
    if criterion == 0:
        return inter / np.maximum(np.broadcast_to(a1, inter.shape), 1e-12)
    a2 = ((query[:, 2] - query[:, 0]) * (query[:, 3] - query[:, 1]))[None]
    return inter / np.maximum(a1 + a2 - inter, 1e-12)


def _rect_corners(rbox: np.ndarray) -> np.ndarray:
    """(cx, cy, dx, dy, angle) -> (4, 2) corners
    (rbbox_to_corners, rotate_iou_cpu.py:206-229)."""
    cx, cy, dx, dy, ang = rbox
    c, s = np.cos(ang), np.sin(ang)
    xs = np.array([-dx / 2, -dx / 2, dx / 2, dx / 2])
    ys = np.array([-dy / 2, dy / 2, dy / 2, -dy / 2])
    return np.stack([c * xs + s * ys + cx, -s * xs + c * ys + cy], axis=1)


def _polygon_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip convex `subject` by convex `clip`."""
    def inside(p, a, b):
        return ((b[0] - a[0]) * (p[1] - a[1])
                - (b[1] - a[1]) * (p[0] - a[0])) >= 0

    def intersection(p1, p2, a, b):
        d1 = p2 - p1
        d2 = b - a
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-12:
            return p2
        t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
        return p1 + t * d1

    # ensure counter-clockwise clip polygon for the inside() sign
    def ccw(poly):
        area2 = 0.0
        for i in range(len(poly)):
            j = (i + 1) % len(poly)
            area2 += poly[i][0] * poly[j][1] - poly[j][0] * poly[i][1]
        return poly if area2 >= 0 else poly[::-1]

    output = list(ccw(subject))
    clip = ccw(clip)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        src, output = output, []
        if not src:
            break
        prev = src[-1]
        for cur in src:
            if inside(cur, a, b):
                if not inside(prev, a, b):
                    output.append(intersection(prev, cur, a, b))
                output.append(cur)
            elif inside(prev, a, b):
                output.append(intersection(prev, cur, a, b))
            prev = cur
    return np.array(output) if output else np.zeros((0, 2))


def _polygon_area(poly: np.ndarray) -> float:
    if poly.shape[0] < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1))
                           - np.dot(y, np.roll(x, -1))))


def rotate_iou(boxes: np.ndarray, query: np.ndarray,
               criterion: int = -1) -> np.ndarray:
    """Rotated-rectangle overlap matrix (rotate_iou_eval semantics).

    boxes/query rows: (cx, cy, dx, dy, angle). criterion -1 -> IoU,
    2 -> raw intersection area (used by the 3D metric).
    """
    n, k = boxes.shape[0], query.shape[0]
    out = np.zeros((n, k))
    for i in range(n):
        ci = _rect_corners(boxes[i])
        ai = boxes[i, 2] * boxes[i, 3]
        for j in range(k):
            inter = _polygon_area(_polygon_clip(ci, _rect_corners(query[j])))
            if criterion == 2:
                out[i, j] = inter
            else:
                aj = query[j, 2] * query[j, 3]
                out[i, j] = inter / max(ai + aj - inter, 1e-12)
    return out


def _bev_boxes(ann: Dict[str, np.ndarray], perturb_rot: bool) -> np.ndarray:
    """(x, z, l, w, ry) camera-BEV boxes (calculate_iou_partly metric 1).

    `perturb_rot` reproduces the reference's +0.01 rotation nudge.
    NOTE the nudge lands on the DETECTION side: the reference's
    calculate_iou_partly perturbs its first argument
    (kitti_official_evaluate.py:414/424/437), and the :533 call site
    passes (dt_annotations, gt_annotations) — swapped against the
    signature — so the perturbed "gt_boxes" are the detections."""
    rot = ann["rotation_y"] + (0.01 if perturb_rot else 0.0)
    return np.concatenate([ann["location"][:, [0, 2]],
                           ann["dimensions"][:, [0, 2]],
                           rot[:, None]], axis=1)


def d3_box_overlap(gt_ann, dt_ann) -> np.ndarray:
    """3D IoU (d3_box_overlap, kitti_official_evaluate.py:156-188):
    BEV rotated intersection x camera-y extent overlap / volume union.
    Rows = dt, cols = gt (calculate_iou_partly argument order)."""
    dt_bev = _bev_boxes(dt_ann, perturb_rot=True)   # nudge on DT (:533)
    gt_bev = _bev_boxes(gt_ann, perturb_rot=False)
    inter_bev = rotate_iou(dt_bev, gt_bev, criterion=2)
    out = np.zeros_like(inter_bev)
    for i in range(dt_bev.shape[0]):
        yi = dt_ann["location"][i, 1]
        hi = dt_ann["dimensions"][i, 1]
        vol_i = float(np.prod(dt_ann["dimensions"][i]))
        for j in range(gt_bev.shape[0]):
            if inter_bev[i, j] <= 0:
                continue
            yj = gt_ann["location"][j, 1]
            hj = gt_ann["dimensions"][j, 1]
            iw = min(yi, yj) - max(yi - hi, yj - hj)
            if iw <= 0:
                continue
            vol_j = float(np.prod(gt_ann["dimensions"][j]))
            inc = iw * inter_bev[i, j]
            out[i, j] = inc / max(vol_i + vol_j - inc, 1e-12)
    return out


def frame_overlaps(gt_ann, dt_ann, metric: int) -> np.ndarray:
    """(n_dt, n_gt) overlap matrix for one frame at the given metric."""
    if metric == 0:
        return image_box_overlap(dt_ann["bbox"] + 0.01, gt_ann["bbox"])
    if metric == 1:
        return rotate_iou(_bev_boxes(dt_ann, True), _bev_boxes(gt_ann,
                                                               False))
    if metric == 2:
        return d3_box_overlap(gt_ann, dt_ann)
    raise ValueError(metric)


# ---------------------------------------------------------------------------
# cleaning + statistics
# ---------------------------------------------------------------------------

def clean_frame(gt_ann, dt_ann, cls_idx: int, roi: bool):
    """clean_data port (kitti_official_evaluate.py:32-117)."""
    cls_name = _VALID_CLASS_NAMES[cls_idx]
    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_ann["name"])):
        name = str(gt_ann["name"][i]).lower()
        height = gt_ann["bbox"][i, 3] - gt_ann["bbox"][i, 1]
        if name == cls_name:
            valid = 1
        elif cls_name == "pedestrian" and name == "person_sitting":
            valid = 0
        elif cls_name == "car" and name == "van":
            valid = 0
        else:
            valid = -1
        ignore = (gt_ann["occluded"][i] > _MAX_OCCLUSION
                  or height <= _MIN_HEIGHT_PX)
        if roi:
            x, _, z = gt_ann["location"][i]
            if x < _ROI_LEFT or x > _ROI_RIGHT or z > _ROI_MAX_DIST:
                ignore = True
        if valid == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_ann["name"][i]) == "DontCare":
            dc_bboxes.append(gt_ann["bbox"][i])

    for i in range(len(dt_ann["name"])):
        x, _, z = dt_ann["location"][i]
        valid = 1 if str(dt_ann["name"][i]).lower() == cls_name else -1
        height = abs(dt_ann["bbox"][i, 3] - dt_ann["bbox"][i, 1])
        if height < _MIN_HEIGHT_PX:
            ignored_dt.append(1)
        elif roi and (x < _ROI_LEFT or x > _ROI_RIGHT
                      or z > _ROI_MAX_DIST):
            ignored_dt.append(1)
        elif valid == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    dc = (np.stack(dc_bboxes, 0).astype(np.float64) if dc_bboxes
          else np.zeros((0, 4)))
    return num_valid_gt, np.array(ignored_gt, np.int64), \
        np.array(ignored_dt, np.int64), dc


def compute_statistics(overlaps, gt_ann, dt_ann, ignored_gt, ignored_dt,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False):
    """compute_statistics_jit port (kitti_official_evaluate.py:191-331).

    overlaps: (n_dt, n_gt). Returns (tp, fp, fn, matched gt thresholds).
    """
    dt_scores = dt_ann["score"]
    det_size = len(dt_scores)
    gt_size = len(gt_ann["name"])
    assigned = [False] * det_size
    ignored_threshold = [compute_fp and dt_scores[i] < thresh
                         for i in range(det_size)]
    no_det = -1e7
    tp = fp = fn = 0
    thresholds = []

    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = no_det
        max_overlap = 0.0
        assigned_ignored = False
        for j in range(det_size):
            if ignored_dt[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and score > valid_detection):
                det_idx = j
                valid_detection = score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored)
                  and ignored_dt[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == no_det and ignored_dt[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored = True
        if valid_detection == no_det and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != no_det
              and (ignored_gt[i] == 1 or ignored_dt[det_idx] == 1)):
            assigned[det_idx] = True
        elif valid_detection != no_det:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            assigned[det_idx] = True

    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_dt[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        if metric == 0 and dc_bboxes.shape[0]:
            # don't-care suppression on the image metric (:299-313)
            # criterion=0: intersection over the DETECTION box area
            # (kitti_official_evaluate.py:308), not IoU
            dc_overlap = image_box_overlap(dt_ann["bbox"], dc_bboxes,
                                           criterion=0)
            n_stuff = 0
            for i in range(dc_bboxes.shape[0]):
                for j in range(det_size):
                    if (assigned[j] or ignored_dt[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if dc_overlap[j, i] > min_overlap:
                        assigned[j] = True
                        n_stuff += 1
            fp -= n_stuff
    return tp, fp, fn, np.array(thresholds)


def get_thresholds(scores: np.ndarray, num_gt: int) -> np.ndarray:
    """Recall-sampled score thresholds (kitti_official_evaluate.py:8-29)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (_N_SAMPLE_PTS - 1.0)
    return np.array(thresholds)


# ---------------------------------------------------------------------------
# AP
# ---------------------------------------------------------------------------

def eval_class(gt_annos, dt_annos, cls_idx: int, metric: int,
               roi: bool, overlaps=None) -> np.ndarray:
    """Precision curve (41 recall points) for one class/metric/area.

    `overlaps` (per-frame matrices) depend only on the metric — callers
    evaluating several classes/areas precompute them once per metric
    (as the reference's calculate_iou_partly does outside its loops);
    the Python rotated-polygon clipping dominates the evaluation cost.
    """
    assert len(gt_annos) == len(dt_annos)
    min_overlap = _MIN_OVERLAPS[metric, cls_idx]
    cleaned = [clean_frame(g, d, cls_idx, roi)
               for g, d in zip(gt_annos, dt_annos)]
    if overlaps is None:
        overlaps = [frame_overlaps(g, d, metric)
                    for g, d in zip(gt_annos, dt_annos)]
    total_valid_gt = sum(c[0] for c in cleaned)

    all_thresholds = []
    for ov, (g, d), (_, ig, idt, dc) in zip(overlaps,
                                            zip(gt_annos, dt_annos),
                                            cleaned):
        _, _, _, th = compute_statistics(ov, g, d, ig, idt, dc, metric,
                                         min_overlap, compute_fp=False)
        all_thresholds.extend(th.tolist())
    if total_valid_gt == 0 or not all_thresholds:
        return np.zeros(_N_SAMPLE_PTS)
    thresholds = get_thresholds(np.array(all_thresholds), total_valid_gt)

    pr = np.zeros((len(thresholds), 3))
    for ov, (g, d), (_, ig, idt, dc) in zip(overlaps,
                                            zip(gt_annos, dt_annos),
                                            cleaned):
        for t, thr in enumerate(thresholds):
            tp, fp, fn, _ = compute_statistics(
                ov, g, d, ig, idt, dc, metric, min_overlap, thresh=thr,
                compute_fp=True)
            pr[t] += (tp, fp, fn)

    precision = np.zeros(_N_SAMPLE_PTS)
    for t in range(len(thresholds)):
        precision[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 1], 1e-12)
    # tail max-smoothing (:594-601)
    for t in range(_N_SAMPLE_PTS):
        precision[t] = precision[t:].max()
    return precision


def map_11(precision: np.ndarray) -> float:
    """11-point interpolated AP x 100 (get_m_ap, :613-617)."""
    return float(precision[0::4].sum() / 11.0 * 100.0)


def map_40(precision: np.ndarray) -> float:
    """40-point AP x 100 (get_m_ap_r40, :620-625)."""
    return float(precision[1:].sum() / 40.0 * 100.0)


def official_evaluation(gt_annos, dt_annos,
                        classes: Sequence[str] = CLASS_NAMES) -> Dict:
    """The reference Evaluation.evaluate() result structure
    (evaluate.py:18-47 + get_official_eval_result :744-762): per class,
    mAP_11 of the 3d and bev metrics at the second overlap table, for
    the entire annotated area and the driving-corridor ROI."""
    out = {"entire_area": {}, "roi": {}}
    ov = {m: [frame_overlaps(g, d, m)
              for g, d in zip(gt_annos, dt_annos)] for m in (1, 2)}
    for area, roi in (("entire_area", False), ("roi", True)):
        for name in classes:
            cls_idx = _VALID_CLASS_NAMES.index(name.lower())
            p3d = eval_class(gt_annos, dt_annos, cls_idx, metric=2,
                             roi=roi, overlaps=ov[2])
            pbev = eval_class(gt_annos, dt_annos, cls_idx, metric=1,
                              roi=roi, overlaps=ov[1])
            out[area][f"{name}_3d_all"] = map_11(p3d)
            out[area][f"{name}_bev_all"] = map_11(pbev)
            out[area][f"{name}_3d_all_R40"] = map_40(p3d)
            out[area][f"{name}_bev_all_R40"] = map_40(pbev)
    means = {}
    for area in out:
        vals = [out[area][f"{n}_3d_all"] for n in classes]
        means[f"{area}_mAP_3d"] = float(np.mean(vals))
    out["summary"] = means
    return out
