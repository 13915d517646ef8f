"""Generate a miniature VoD-format dataset tree on disk.

The port's own copy of `ratrack_tpu/data/fixture.py`: the same tree, byte
for byte (tests/test_torch_port_data.py).

Used by tests and smoke configs to exercise the real file-parsing path
(bins, calib txt, pose json, label txt) without the actual dataset — the
role the upstream devkit's example_set plays.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _write_calib(path: str, extrinsic: np.ndarray) -> None:
    p = "P2: " + " ".join(["%.6f" % v for v in np.eye(3, 4).flatten()])
    tr = "Tr_velo_to_cam: " + " ".join(
        ["%.6f" % v for v in extrinsic[:3].flatten()])
    with open(path, "w") as f:
        f.write("header0\nheader1\n" + p + "\nl3\nl4\n" + tr + "\n")


def make_vod_fixture(root: str, frames: range, n_points: int = 80,
                     seed: int = 0, clip_motion: float = 0.3) -> None:
    """Write radar bins + calib + pose + labels for `frames`.

    World: 2 moving objects (Car id=7, Pedestrian id=9) + static clutter.
    The detection labels mark both as moving (flag column = 1). Labels are
    written in camera coordinates consistent with the calib transforms.
    """
    rng = np.random.RandomState(seed)
    for sub in ["radar/training/velodyne", "radar/training/calib",
                "lidar/training/velodyne", "lidar/training/calib",
                "lidar/training/pose", "lidar/training/label_2",
                "lidar/training/label_2_tracking"]:
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    # simple geometry: camera == lidar == radar frames (identity extrinsics)
    extrinsic = np.eye(4, dtype=np.float32)
    static = rng.randn(n_points - 20, 3).astype(np.float32) \
        * np.array([10, 6, 0.8], np.float32) + [15, 0, 0.5]
    car0 = np.array([10.0, 2.0, 0.5])
    ped0 = np.array([8.0, -3.0, 0.9])
    car_v = np.array([clip_motion, 0.05, 0.0])
    ped_v = np.array([0.05, clip_motion * 0.5, 0.0])
    car_half = np.array([3.5, 1.8, 1.6]) * 0.45
    ped_half = np.array([0.8, 0.8, 1.8]) * 0.45
    car_shape = np.clip(rng.randn(12, 3) * [0.8, 0.35, 0.3],
                        -car_half, car_half).astype(np.float32)
    ped_shape = np.clip(rng.randn(8, 3) * 0.15,
                        -ped_half, ped_half).astype(np.float32)

    for t in frames:
        fid = str(t).zfill(5)
        car_c = car0 + car_v * t
        ped_c = ped0 + ped_v * t
        pts = np.concatenate([car_shape + car_c, ped_shape + ped_c, static])
        n = pts.shape[0]
        radar = np.zeros((n, 7), np.float32)
        radar[:, :3] = pts
        radar[:, 3] = rng.rand(n)          # RCS
        los = pts / (np.linalg.norm(pts, axis=1, keepdims=True) + 1e-6)
        radar[:12, 4] = los[:12] @ car_v / 0.1
        radar[12:20, 4] = los[12:20] @ ped_v / 0.1
        radar[:, 5] = radar[:, 4]
        radar.tofile(os.path.join(root, "radar/training/velodyne",
                                  fid + ".bin"))
        lidar = np.zeros((n, 4), np.float32)
        lidar[:, :3] = pts
        lidar.tofile(os.path.join(root, "lidar/training/velodyne",
                                  fid + ".bin"))
        for cal_dir in ["radar/training/calib", "lidar/training/calib"]:
            _write_calib(os.path.join(root, cal_dir, fid + ".txt"),
                         extrinsic)
        pose = np.eye(4, dtype=np.float32)  # stationary ego
        with open(os.path.join(root, "lidar/training/pose",
                               fid + ".json"), "w") as f:
            f.write(json.dumps({"odomToCamera": pose.flatten().tolist()})
                    + "\n")
            f.write(json.dumps({"mapToCamera": pose.flatten().tolist()})
                    + "\n")
            f.write(json.dumps({"UTMToCamera": pose.flatten().tolist()})
                    + "\n")

        # labels: camera coords == radar coords here. Box center/rotation
        # must invert the box_from_label mapping: with identity extrinsics,
        # rot = Rz(-(ry+π/2)); use ry=-π/2 → identity rotation.
        def label_line(obj_type, oid, c, l, w, h):
            return (f"{obj_type} {oid} 0 0 0 0 50 50 "
                    f"{h} {w} {l} {c[0]} {c[1]} {c[2]} {-np.pi/2}")

        trk = [label_line("Car", 7, car_c, 3.5, 1.8, 1.6),
               label_line("Pedestrian", 9, ped_c, 0.8, 0.8, 1.8)]
        with open(os.path.join(root, "lidar/training/label_2_tracking",
                               fid + ".txt"), "w") as f:
            f.write("\n".join(trk) + "\n")
        det = ["Car 1 0 0 0 0 50 50 1.6 1.8 3.5 0 0 0 0",
               "Pedestrian 1 0 0 0 0 50 50 1.8 0.8 0.8 0 0 0 0"]
        with open(os.path.join(root, "lidar/training/label_2",
                               fid + ".txt"), "w") as f:
            f.write("\n".join(det) + "\n")
