"""Camera projection utilities of the VoD devkit.

The port's own copy of `ratrack_tpu/data/projection.py`
(tests/test_torch_port_data.py).

Re-implements the devkit's image-projection helpers
(src/vod/frame/transformations.py:296-388): homogeneous coordinates,
3D→2D pinhole projection with a (3, 4) or (4, 4) projection matrix,
canvas cropping, and the end-to-end `project_pcl_to_image`. The devkit's
intrinsics come from calib line 2 (`P2:`); `Transforms.intrinsic` exposes
them alongside the extrinsics that `data.vod` already parses.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .vod import FrameData


def read_intrinsic(frame: FrameData, sensor: str = "radar") -> np.ndarray:
    """(3, 4) camera projection matrix from the sensor's calib file
    (reference get_sensor_transforms, transformations.py:226-258)."""
    d = (frame.loc.radar_calib_dir if sensor == "radar"
         else frame.loc.lidar_calib_dir)
    path = os.path.join(d, f"{frame.frame_number}.txt")
    with open(path) as f:
        lines = f.readlines()
    return np.array(lines[2].strip().split(" ")[1:],
                    np.float32).reshape(3, 4)


def homogeneous_coordinates(points: np.ndarray) -> np.ndarray:
    """(N, 3) → (N, 4)."""
    if points.shape[1] != 3:
        raise ValueError(f"{points.shape[1]} must be Nx3!")
    return np.hstack([points, np.ones((points.shape[0], 1), np.float32)])


def homogeneous_transformation(points: np.ndarray,
                               transform: np.ndarray) -> np.ndarray:
    """(N, 4) × (4, 4) homogeneous transform (transformations.py:284-295)."""
    if transform.shape != (4, 4):
        raise ValueError(f"{transform.shape} must be 4x4!")
    if points.shape[1] != 4:
        raise ValueError(f"{points.shape[1]} must be Nx4!")
    return transform.dot(points.T).T


def project_3d_to_2d(points: np.ndarray,
                     projection_matrix: np.ndarray) -> np.ndarray:
    """Homogeneous camera-frame points → rounded integer pixel coords."""
    if points.shape[-1] != 4:
        raise ValueError(f"{points.shape[-1]} must be 4!")
    pm = projection_matrix
    if pm.shape == (3, 4):
        pm = np.concatenate([pm, [[0, 0, 0, 1]]], axis=0)
    uvw = pm.dot(points.T)
    uvw = uvw / uvw[2]
    return np.round(uvw[:2].T).astype(np.int64)


def canvas_crop(points: np.ndarray, image_size: Tuple[int, int],
                points_depth: np.ndarray | None = None) -> np.ndarray:
    """In-frame mask; also requires positive depth when given.

    image_size is (height, width), devkit convention."""
    idx = points[:, 0] > 0
    idx &= points[:, 0] < image_size[1]
    idx &= points[:, 1] > 0
    idx &= points[:, 1] < image_size[0]
    if points_depth is not None:
        idx &= points_depth > 0
    return idx


def project_pcl_to_image(point_cloud: np.ndarray, t_camera_pcl: np.ndarray,
                         camera_projection_matrix: np.ndarray,
                         image_shape: Tuple[int, int]):
    """Sensor-frame cloud → (pixel uv, depth) inside the image canvas
    (transformations.py:361-388)."""
    hom = homogeneous_coordinates(point_cloud[:, :3].astype(np.float32))
    cam = homogeneous_transformation(hom, t_camera_pcl)
    depth = cam[:, 2]
    uvs = project_3d_to_2d(cam, camera_projection_matrix)
    keep = canvas_crop(uvs, image_shape, depth)
    return uvs[keep], depth[keep]
