"""BEV and camera-canvas visualisation of tracking output.

The port's own copy of `ratrack_tpu/utils/vis.py` (host numpy and
matplotlib; no torch, no card): the eval CLI's `vis_dir` renders one PNG a
frame through `plot_frame_bev` (reference src/main_utils.py:211-246:
static points in grey, moving points coloured by track id, the ids at
the objects' centres, scene-flow arrows), and the devkit's 2D views
(`plot_projection_2d`, the label boxes). matplotlib is imported inside
each renderer, with the Agg backend, so importing this module needs none
and the card's path never does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def plot_projection_2d(path: str, points: np.ndarray,
                       t_camera_sensor: np.ndarray,
                       projection_matrix: np.ndarray,
                       image_shape=(1216, 1936),
                       image: Optional[np.ndarray] = None,
                       title: str = "") -> str:
    """Project a sensor-frame cloud into the camera canvas and render it.

    The devkit-visualizer capability (reference Visualization2D,
    src/vod/visualization/vis_2d.py): points colored by depth over the
    camera image (or a blank canvas when no image is available).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.projection import project_pcl_to_image

    uvs, depth = project_pcl_to_image(points, t_camera_sensor,
                                      projection_matrix, image_shape)
    fig, ax = plt.subplots(figsize=(10, 6))
    if image is not None:
        ax.imshow(image)
    else:
        ax.set_xlim(0, image_shape[1])
        ax.set_ylim(image_shape[0], 0)
        ax.set_facecolor("0.1")
    if uvs.shape[0]:
        sc = ax.scatter(uvs[:, 0], uvs[:, 1], c=depth, s=8, cmap="turbo")
        fig.colorbar(sc, ax=ax, label="depth (m)")
    ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


# reference 2D label palette (src/vod/visualization/settings.py:1-3)
LABEL_COLOR_PALETTE_2D = {"Cyclist": (1.0, 0.0, 0.0),
                          "Pedestrian": (0.0, 1.0, 0.0),
                          "Car": (0.0, 0.0, 1.0)}


def label_box_corners_2d(labels, t_camera_lidar: np.ndarray,
                         projection_matrix: np.ndarray):
    """Project 3D label boxes into image-plane corner octets.

    Mirrors the reference corner math exactly
    (src/vod/visualization/helpers.py:27-129 get_3d_label_corners +
    get_2d_label_corners): the camera-frame box center maps into the
    lidar frame, the l/w/h corner template rotates by -(ry + π/2) about
    lidar z with the bottom face at z=0, and the corners project back
    through t_camera_lidar and the camera projection matrix.

    Args:
      labels: iterable of data.vod.ObjectLabel (camera-frame KITTI box).
      t_camera_lidar: (4, 4) homogeneous lidar→camera transform.
      projection_matrix: (3, 4) camera projection.
    Returns:
      list of dicts {label_class, id, corners (8, 2), range}, sorted by
      range ascending (reference draw order).
    """
    t_lidar_camera = np.linalg.inv(t_camera_lidar)
    out = []
    for lb in labels:
        rotation = -(lb.ry + np.pi / 2)
        rot = np.array([
            [np.cos(rotation), -np.sin(rotation), 0.0],
            [np.sin(rotation), np.cos(rotation), 0.0],
            [0.0, 0.0, 1.0]])
        xc = np.array([lb.l, lb.l, -lb.l, -lb.l,
                       lb.l, lb.l, -lb.l, -lb.l]) / 2.0
        yc = np.array([lb.w, -lb.w, -lb.w, lb.w,
                       lb.w, -lb.w, -lb.w, lb.w]) / 2.0
        zc = np.array([0.0, 0.0, 0.0, 0.0, lb.h, lb.h, lb.h, lb.h])
        center = (t_lidar_camera
                  @ np.array([lb.x, lb.y, lb.z, 1.0]))[:3]
        c3d = (rot @ np.vstack([xc, yc, zc])).T + center       # (8, 3)
        hom = np.concatenate([c3d, np.ones((8, 1))], axis=1)
        cam = (t_camera_lidar @ hom.T).T                       # (8, 4)
        img = cam @ np.asarray(projection_matrix).T            # (8, 3)
        corners = img[:, :2] / img[:, 2:3]
        out.append({"label_class": lb.type, "id": lb.id,
                    "corners": corners,
                    "range": float(np.linalg.norm([lb.x, lb.y, lb.z]))})
    return sorted(out, key=lambda d: d["range"])


def plot_label_boxes_2d(ax, boxes, palette=None, alpha: float = 0.2):
    """Draw projected box faces onto a matplotlib axes.

    Reference plot_boxes (helpers.py:148-168): the 6 faces as filled
    polygons, class-colored (unknown classes white at a lighter
    alpha)."""
    from matplotlib.patches import Polygon

    palette = palette or LABEL_COLOR_PALETTE_2D
    faces = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
             (1, 2, 6, 5), (2, 3, 7, 6), (0, 3, 7, 4)]
    for box in boxes:
        color = palette.get(box["label_class"], (1.0, 1.0, 1.0))
        a = 0.15 if color == (1.0, 1.0, 1.0) else alpha
        c = np.asarray(box["corners"])
        for f in faces:
            ax.add_patch(Polygon(c[list(f)], closed=True,
                                 facecolor=color, edgecolor=color,
                                 alpha=a, linewidth=1.0))


def plot_projection_2d_with_labels(path: str, points: np.ndarray,
                                   labels, t_camera_sensor: np.ndarray,
                                   t_camera_lidar: np.ndarray,
                                   projection_matrix: np.ndarray,
                                   image_shape=(1216, 1936),
                                   image: Optional[np.ndarray] = None,
                                   title: str = "") -> str:
    """Camera-canvas render: depth-colored cloud + projected label boxes.

    The Visualization2D capability (vis_2d.py:30-47 plot_gt_labels over
    draw_plot's radar scatter)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.projection import project_pcl_to_image

    uvs, depth = project_pcl_to_image(points, t_camera_sensor,
                                      projection_matrix, image_shape)
    fig, ax = plt.subplots(figsize=(10, 6))
    if image is not None:
        ax.imshow(image)
    else:
        ax.set_facecolor("0.1")
    if uvs.shape[0]:
        ax.scatter(uvs[:, 0], uvs[:, 1], c=depth, s=8, cmap="turbo")
    plot_label_boxes_2d(
        ax, label_box_corners_2d(labels, t_camera_lidar,
                                 projection_matrix))
    ax.set_xlim(0, image_shape[1])
    ax.set_ylim(image_shape[0], 0)
    ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_frame_bev(path: str, pc1: np.ndarray, mask: np.ndarray,
                   cls: np.ndarray, labels: np.ndarray,
                   track_ids: np.ndarray, flow: Optional[np.ndarray] = None,
                   mov_thres: float = 0.5, title: str = "") -> str:
    """Render one frame's tracking state to `path` (PNG).

    Args:
      pc1: (N, 3) points (x forward, y left — VoD radar frame).
      mask: (N,) validity.
      cls: (N,) moving probability.
      labels: (N,) cluster slot per point (-1 none).
      track_ids: (K,) persistent id per slot.
      flow: optional (N, 3) scene flow, drawn as arrows on moving points.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    valid = np.asarray(mask, bool)
    pts = np.asarray(pc1)[valid]
    mov = np.asarray(cls)[valid] > mov_thres
    lbl = np.asarray(labels)[valid]

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(-pts[~mov, 1], pts[~mov, 0], s=4, c="0.75", label="static")
    if mov.any():
        # color moving points by track id (stable across frames)
        ids = np.asarray(track_ids)
        pt_tid = np.where(lbl >= 0, ids[np.clip(lbl, 0, len(ids) - 1)], -1)
        cmap = plt.get_cmap("tab20")
        colors = [cmap(int(t) % 20) if t >= 0 else (0, 0, 0, 1)
                  for t in pt_tid[mov]]
        ax.scatter(-pts[mov, 1], pts[mov, 0], s=14, c=colors, label="moving")
        if flow is not None:
            fl = np.asarray(flow)[valid]
            ax.quiver(-pts[mov, 1], pts[mov, 0], -fl[mov, 1], fl[mov, 0],
                      angles="xy", scale_units="xy", scale=0.5, width=2e-3,
                      color="tab:red", alpha=0.6)
        # annotate object centres with their track id
        for k in np.unique(lbl[mov & (lbl >= 0)]):
            sel = lbl == k
            c = pts[sel].mean(axis=0)
            tid = int(pt_tid[sel][0])
            ax.annotate(str(tid), (-c[1], c[0]), fontsize=9,
                        fontweight="bold")
    ax.set_xlabel("-y (m)")
    ax.set_ylabel("x (m)")
    ax.set_title(title)
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
