"""Ground-truth assembly: oriented boxes, in-box tests, rigid GT flow.

The port's own copy of `ratrack_tpu/data/gt.py` (tests/test_torch_port_data.py).

Vectorized NumPy replacements for the reference's open3d-based GT path:
  * get_bbx_param (track4d_utils.py:528-546): label → oriented box in the
    radar frame (center via t_radar_camera, extent [l,w,h], rotation
    t_radar_lidar · Rz(-(ry+π/2)));
  * OrientedBoundingBox.get_point_indices_within_bounding_box →
    |Rᵀ(p−c)| ≤ extent/2 (closed) in `points_in_obb`;
  * filter_object_points (track4d_utils.py:105-176): per-point moving
    mask + per-point object id, rider/bicycle merge, min-points filter;
  * get_gt_flow_new (track4d_utils.py:337-359): per-point rigid
    box1→box2 transform for moving points, ego-compensated position
    otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .vod import ObjectLabel, Transforms


@dataclasses.dataclass
class OrientedBox:
    center: np.ndarray   # (3,)
    rot: np.ndarray      # (3,3)
    extent: np.ndarray   # (3,) full lengths [l, w, h]

    @property
    def pose(self) -> np.ndarray:
        t = np.eye(4, dtype=np.float64)
        t[:3, :3] = self.rot
        t[:3, 3] = self.center
        return t


def _rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def box_from_label(label: ObjectLabel, transforms: Transforms) -> OrientedBox:
    """Label (camera coords) → oriented box in the radar frame."""
    center = (transforms.t_radar_camera
              @ np.array([label.x, label.y, label.z, 1.0]))[:3]
    extent = np.array([label.l, label.w, label.h], np.float64)
    rot = transforms.t_radar_lidar[:3, :3] @ _rot_z(-(label.ry + np.pi / 2))
    return OrientedBox(center.astype(np.float64), rot, extent)


def points_in_obb(points: np.ndarray, box: OrientedBox) -> np.ndarray:
    """(N,3) → (N,) bool, closed in-box test in the box frame.

    Routed through the native C++ path when available (`data.native`,
    same closed-inequality semantics); NumPy otherwise.
    """
    from .native import points_in_obb as native_obb
    return native_obb(points, box.center, box.rot, box.extent)


@dataclasses.dataclass
class FrameGT:
    """Per-frame GT tensors over the raw (un-padded) cloud."""
    cls: np.ndarray            # (N,) bool — point inside any moving box
    point_obj_id: np.ndarray   # (N,) int32 label id (last box wins, PRE-merge
                               #  — reference cls_obj_id), -1 none
    point_obj_combined: np.ndarray  # (N,) int32 id after rider-merge and
                               # min-points filter (for GT matching), -1 none
    boxes: Dict[int, OrientedBox]          # all (moving) boxes by label id
    objs: Dict[int, np.ndarray]            # label id → point indices (combined)
    obj_ids_in_order: List[int]            # insertion order of `objs`
    ids_with_points: List[int]             # pre-merge/pre-filter, ≥1 point


def build_frame_gt(labels: Dict[int, ObjectLabel], points: np.ndarray,
                   transforms: Transforms, min_obj_points: int) -> FrameGT:
    """filter_object_points equivalent (track4d_utils.py:105-176).

    `labels` should already be moving-filtered. Per-point `cls` covers every
    in-box point (including objects later dropped by the min-points filter,
    as in the reference); `objs` applies rider-merge then the min-points
    filter.
    """
    n = points.shape[0]
    cls = np.zeros(n, bool)
    point_obj = np.full(n, -1, np.int32)
    boxes: Dict[int, OrientedBox] = {}
    objs: Dict[int, np.ndarray] = {}
    centres: Dict[int, np.ndarray] = {}
    for key, label in labels.items():
        boxes[label.id] = box_from_label(label, transforms)
    for obj_id, box in boxes.items():
        inside = points_in_obb(points, box)
        idx = np.where(inside)[0]
        if idx.size == 0:
            continue
        cls[idx] = True
        point_obj[idx] = obj_id
        objs[obj_id] = idx
        centres[obj_id] = points[idx].mean(axis=0)

    # rider + nearest-object merge (track4d_utils.py:142-158); the merged
    # membership is tracked separately — the reference leaves cls_obj_id
    # untouched by the merge (GT flow keeps using pre-merge ids).
    point_obj_combined = point_obj.copy()
    to_pop: List[int] = []
    for obj_id in list(objs):
        if labels[obj_id].type != "rider":
            continue
        best, best_d = -1, np.inf
        for other in objs:
            if other == obj_id:
                continue
            d = np.linalg.norm(centres[obj_id] - centres[other])
            if d < best_d:
                best, best_d = other, d
        if best == -1:
            continue
        to_pop.append(obj_id)
        point_obj_combined[objs[obj_id]] = best
        objs[best] = np.unique(np.concatenate([objs[obj_id], objs[best]]))

    # min-points filter (track4d_utils.py:160-171)
    for obj_id, idx in objs.items():
        if idx.size < min_obj_points and obj_id not in to_pop:
            to_pop.append(obj_id)
    combined = {k: v for k, v in objs.items() if k not in to_pop}
    for obj_id in to_pop:
        point_obj_combined[point_obj_combined == obj_id] = -1
    return FrameGT(cls=cls, point_obj_id=point_obj,
                   point_obj_combined=point_obj_combined, boxes=boxes,
                   objs=combined, obj_ids_in_order=list(combined),
                   ids_with_points=list(centres))


# per-class box-motion thresholds in meters (filter_moving_boxes,
# track4d_utils.py:617-652)
_MOTION_THRESHOLDS = {
    "Pedestrian": 0.06, "human_depiction": 0.06,
    "Car": 0.15, "truck": 0.15,
    "Cyclist": 0.10, "rider": 0.10, "bicycle": 0.10,
    "ride_uncertain": 0.10, "ride_other": 0.10, "motor": 0.10,
    "moped_scooter": 0.10,
}
_MOTION_THRESHOLD_DEFAULT = 0.20


def filter_moving_labels_by_motion(labels0: Dict[int, ObjectLabel],
                                   labels1: Dict[int, ObjectLabel],
                                   transforms0: Transforms,
                                   transforms1: Transforms
                                   ) -> Dict[int, ObjectLabel]:
    """Motion-threshold moving filter (reference filter_moving_boxes,
    track4d_utils.py:593-662) — the alternative to the detection-flag
    filter: an object is moving when its ego-compensated frame-0 box
    center moves more than a per-class threshold to its frame-1 center.

    Reference quirks preserved: BOTH boxes are parameterized with the
    frame-0 transforms (`get_bbx_param(.., transforms0, ..)` at :612), and
    the compensated center is hom(c) @ inv(T_ego.T) (get_bbx_param_ego,
    :559-578). Objects absent from frame 0 are not classified (not moving).
    """
    a = transforms0.t_odom_camera @ transforms0.t_camera_radar
    b = transforms1.t_odom_camera @ transforms1.t_camera_radar
    ego = np.linalg.inv(a) @ b
    inv_ego_t = np.linalg.inv(ego.T)

    out: Dict[int, ObjectLabel] = {}
    for obj_id, lbl1 in labels1.items():
        lbl0 = labels0.get(obj_id)
        if lbl0 is None:
            continue
        c0 = transforms0.t_radar_camera @ np.array(
            [lbl0.x, lbl0.y, lbl0.z, 1.0])
        c0_comp = (c0 @ inv_ego_t)[:3]
        c1 = (transforms0.t_radar_camera @ np.array(
            [lbl1.x, lbl1.y, lbl1.z, 1.0]))[:3]
        thres = _MOTION_THRESHOLDS.get(lbl1.type, _MOTION_THRESHOLD_DEFAULT)
        if np.abs(np.linalg.norm(c0_comp - c1)) > thres:
            out[obj_id] = lbl1
    return out


def rigid_gt_flow(points: np.ndarray, comp_points: np.ndarray,
                  gt1: FrameGT, gt2: FrameGT) -> np.ndarray:
    """GT warped positions per point (get_gt_flow_new,
    track4d_utils.py:337-359).

    Moving point in object o present in both frames: p' = T₂ · T₁⁻¹ · p
    using the box poses; otherwise the ego-compensated position.
    """
    out = comp_points.astype(np.float64).copy()
    with_points2 = set(gt2.ids_with_points)
    for obj_id in gt1.boxes:
        # reference gate: the object must have ≥1 in-box point in frame 2
        # (pre-merge objs_centre2 keys) and a frame-2 box.
        if obj_id not in gt2.boxes or obj_id not in with_points2:
            continue
        sel = (gt1.point_obj_id == obj_id) & gt1.cls
        if not np.any(sel):
            continue
        t12 = gt2.boxes[obj_id].pose @ np.linalg.inv(gt1.boxes[obj_id].pose)
        p = points[sel].astype(np.float64)
        hom = np.concatenate([p, np.ones((p.shape[0], 1))], axis=1)
        out[sel] = (t12 @ hom.T).T[:, :3]
    return out.astype(np.float32)
