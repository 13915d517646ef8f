"""View-of-Delft dataset reader (KITTI-style tree).

The port's own copy of `ratrack_tpu/data/vod.py` (tests/test_torch_port_data.py
holds the two equal).

Covers the live subset of the reference VoD devkit:
  * directory layout            — src/vod/configuration/file_locations.py:40-74
  * radar scan (N,7) float32    — src/vod/frame/data_loader.py:164-180
    [x, y, z, RCS, v_r, v_r_compensated, time]
  * lidar scan (N,4) float32    — data_loader.py:190-198
  * calib txt → intrinsic (3,4) + extrinsic (4,4)
                                — src/vod/frame/transformations.py:226-258
  * pose json-lines → odom/map/UTM → camera (4,4)
                                — transformations.py:260-281
  * tracking / detection label txt
                                — data_loader.py:200-236,
                                  src/dataset_classes/kitti/kitti_trk_vod.py:22-45
  * derived transform graph (camera/lidar/radar/odom)
                                — transformations.py:44-225

Pure NumPy + stdlib; all loads are eager per frame (small files).
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import cached_property
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class VodLocations:
    """Directory layout of a VoD root (reference file_locations.py:40-74).

    `radar_variant` selects the 1/3/5-scan aggregated radar directories
    that VoD ships ('radar', 'radar_3frames', 'radar_5frames').
    """
    root_dir: str
    radar_variant: str = "radar"

    def _p(self, *parts: str) -> str:
        return os.path.join(self.root_dir, *parts)

    @property
    def radar_dir(self): return self._p(self.radar_variant, "training", "velodyne")
    @property
    def radar_calib_dir(self): return self._p(self.radar_variant, "training", "calib")
    @property
    def lidar_dir(self): return self._p("lidar", "training", "velodyne")
    @property
    def lidar_calib_dir(self): return self._p("lidar", "training", "calib")
    @property
    def pose_dir(self): return self._p("lidar", "training", "pose")
    @property
    def tracking_label_dir(self): return self._p("lidar", "training", "label_2_tracking")
    @property
    def detection_label_dir(self): return self._p("lidar", "training", "label_2")


@dataclasses.dataclass
class ObjectLabel:
    """One tracking-label line.

    Token layout (kitti_trk_vod.py:22-35):
    type id occluded alpha xmin ymin xmax ymax h w l x y z ry
    (x, y, z in camera coordinates; ry = yaw about camera -Z per VoD docs).
    """
    type: str
    id: int
    occ: float
    alpha: float
    bbox2d: np.ndarray
    h: float
    w: float
    l: float
    x: float
    y: float
    z: float
    ry: float


def parse_tracking_labels(lines: List[str]) -> Dict[int, ObjectLabel]:
    """Frame's tracking label lines → {object id: label}."""
    out: Dict[int, ObjectLabel] = {}
    for line in lines:
        t = line.split(" ")
        if len(t) < 15:
            continue
        vals = [float(v) for v in t[1:15]]
        obj = ObjectLabel(
            type=t[0], id=int(t[1]), occ=vals[1], alpha=vals[2],
            bbox2d=np.array(vals[3:7], np.float32),
            h=vals[7], w=vals[8], l=vals[9],
            x=vals[10], y=vals[11], z=vals[12], ry=vals[13])
        out[obj.id] = obj
    return out


def moving_flags_from_detection(det_lines: List[str]) -> List[bool]:
    """VoD-RaTrack detection labels carry a moving flag in the 'truncated'
    column (reference filter_moving_boxes_det, track4d_utils.py:581-590)."""
    flags = []
    for line in det_lines:
        t = line.split(" ")
        flags.append(len(t) > 1 and int(float(t[1])) == 1)
    return flags


def filter_moving_labels(labels: Dict[int, ObjectLabel],
                         det_lines: List[str]) -> Dict[int, ObjectLabel]:
    """Positional pairing of detection-line moving flags with tracking
    labels, exactly as the reference does (line i ↔ i-th dict key)."""
    flags = moving_flags_from_detection(det_lines)
    keys = list(labels.keys())
    out = {}
    for i, flag in enumerate(flags):
        if i >= len(keys):
            break
        if flag:
            out[keys[i]] = labels[keys[i]]
    return out


class FrameData:
    """Lazy per-frame file access (reference FrameDataLoader)."""

    def __init__(self, loc: VodLocations, frame_number: str):
        self.loc = loc
        self.frame_number = frame_number

    def _read(self, path, reader):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return reader(path)

    @cached_property
    def radar(self) -> np.ndarray:
        from .native import decode_scan
        p = os.path.join(self.loc.radar_dir, f"{self.frame_number}.bin")
        return self._read(p, lambda q: decode_scan(q, 7))

    @cached_property
    def lidar(self) -> np.ndarray:
        from .native import decode_scan
        p = os.path.join(self.loc.lidar_dir, f"{self.frame_number}.bin")
        return self._read(p, lambda q: decode_scan(q, 4))

    @cached_property
    def tracking_labels(self) -> List[str]:
        p = os.path.join(self.loc.tracking_label_dir,
                         f"{self.frame_number}.txt")
        return self._read(p, lambda q: open(q).read().splitlines())

    @cached_property
    def detection_labels(self) -> List[str]:
        p = os.path.join(self.loc.detection_label_dir,
                         f"{self.frame_number}.txt")
        return self._read(p, lambda q: open(q).read().splitlines())


def _read_calib(path: str) -> np.ndarray:
    """calib txt → homogeneous extrinsic (4,4); line 2 = P, line 5 = Tr."""
    with open(path) as f:
        lines = f.readlines()
    ext = np.array(lines[5].strip().split(" ")[1:],
                   np.float32).reshape(3, 4)
    return np.concatenate([ext, [[0, 0, 0, 1]]], axis=0)


class Transforms:
    """Per-frame homogeneous transform graph (reference FrameTransformMatrix).

    Naming: t_a_b maps b-frame coordinates into a-frame.
    """

    def __init__(self, frame: FrameData):
        self.frame = frame

    @cached_property
    def t_camera_radar(self) -> np.ndarray:
        return _read_calib(os.path.join(
            self.frame.loc.radar_calib_dir,
            f"{self.frame.frame_number}.txt"))

    @cached_property
    def t_camera_lidar(self) -> np.ndarray:
        return _read_calib(os.path.join(
            self.frame.loc.lidar_calib_dir,
            f"{self.frame.frame_number}.txt"))

    @cached_property
    def t_radar_camera(self): return np.linalg.inv(self.t_camera_radar)

    @cached_property
    def t_lidar_camera(self): return np.linalg.inv(self.t_camera_lidar)

    @cached_property
    def t_lidar_radar(self):
        return self.t_lidar_camera @ self.t_camera_radar

    @cached_property
    def t_radar_lidar(self):
        return self.t_radar_camera @ self.t_camera_lidar

    @cached_property
    def _pose_rows(self) -> List[dict]:
        """The pose file is json-lines: row 0 odom, row 1 map, row 2 UTM
        (reference transformations.py:260-281)."""
        p = os.path.join(self.frame.loc.pose_dir,
                         f"{self.frame.frame_number}.json")
        return [json.loads(line) for line in open(p)]

    def _pose(self, row: int, key: str) -> np.ndarray:
        return np.array(self._pose_rows[row][key], np.float32).reshape(4, 4)

    @cached_property
    def t_odom_camera(self) -> np.ndarray:
        return self._pose(0, "odomToCamera")

    @cached_property
    def t_map_camera(self) -> np.ndarray:
        return self._pose(1, "mapToCamera")

    @cached_property
    def t_utm_camera(self) -> np.ndarray:
        return self._pose(2, "UTMToCamera")

    # World transforms carry km-scale translations (map ~1e3 m, UTM ~1e5 m);
    # float32 inversion leaves ~1e-4..1e-1 m of error there, so these three
    # inverses are computed in float64.
    @cached_property
    def t_camera_odom(self):
        return np.linalg.inv(self.t_odom_camera.astype(np.float64))

    @cached_property
    def t_camera_map(self):
        return np.linalg.inv(self.t_map_camera.astype(np.float64))

    @cached_property
    def t_camera_utm(self):
        return np.linalg.inv(self.t_utm_camera.astype(np.float64))


def transform_points(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply homogeneous transform to (N,3) points → (N,3)."""
    hom = np.concatenate(
        [points, np.ones((points.shape[0], 1), points.dtype)], axis=1)
    return (t @ hom.T).T[:, :3]


def ego_motion_radar(tr0: Transforms, tr1: Transforms) -> np.ndarray:
    """Radar-frame ego motion between two frames.

    Reference track_vod_3d.py:106-112:
      T = inv(odom·cam_radar)₀ · (odom·cam_radar)₁.
    """
    a = tr0.t_odom_camera @ tr0.t_camera_radar
    b = tr1.t_odom_camera @ tr1.t_camera_radar
    return np.linalg.inv(a) @ b


def compensate_ego(points: np.ndarray, ego_motion: np.ndarray) -> np.ndarray:
    """Ego-compensated positions (track_vod_3d.py:114-115):
    hom(p) @ inv(T.T), keeping xyz. Routed through the native C++ path
    when available (single implementation; NumPy fallback lives there)."""
    from .native import compensate_ego as native_comp
    return native_comp(points, ego_motion)
