"""Scene-flow and motion-segmentation metrics (host-side NumPy).

The port's own copy of `ratrack_tpu/train/metrics.py` (that package's
`train/__init__.py` imports JAX), held equal to it by
tests/test_torch_port_eval.py.

Ports of the reference evaluation formulas:
  * eval_scene_flow (`src/main_utils.py:342-374`): EPE and the
    Resolution-Normalized Error family — errors divided by the ratio of
    radar to lidar angular-resolution footprints per point
    (get_carterian_res, main_utils.py:272-309) — plus Strict/Relaxed
    Accuracy Scores.
  * eval_motion_seg (`src/main_utils.py:377-389`): accuracy / mIoU /
    sensitivity of the thresholded moving mask.

The reference computes these over the raw (un-padded) clouds; here the
validity mask selects the same set. A reference quirk is preserved: the
mov/stat split indexes `mask == 0` for "moving" (main_utils.py:361-362)
even though the mask passed in is the continuous moving probability — we
apply the same comparison to the same input.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_SENSOR_RES = {
    "radar": (0.2, np.deg2rad(1.0), np.deg2rad(1.6)),
    "lidar": (0.04, np.deg2rad(0.4), np.deg2rad(0.08)),
}


def cartesian_resolution(pc: np.ndarray, sensor: str) -> np.ndarray:
    """Per-point xyz measurement resolution for a spherical sensor model.

    pc: (N, 3). Returns (N, 3) |∂xyz/∂(r,θ,φ)|·res, reference
    get_carterian_res (main_utils.py:272-309).
    """
    r_res, t_res, p_res = _SENSOR_RES[sensor]
    res = np.array([r_res, t_res, p_res])
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    r = np.sqrt(x * x + y * y + z * z) + 1e-12
    theta = np.arcsin(np.clip(z / r, -1, 1))
    phi = np.arctan2(y, x)
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)
    grad_x = np.stack([cp * ct, -r * st * cp, -r * ct * sp], 1)
    grad_y = np.stack([sp * ct, -r * sp * st, r * ct * cp], 1)
    grad_z = np.stack([st, r * ct, np.zeros_like(r)], 1)
    return np.stack([np.abs(g) @ res for g in (grad_x, grad_y, grad_z)], 1)


def eval_scene_flow(pc: np.ndarray, pred: np.ndarray, labels: np.ndarray,
                    mask: np.ndarray, valid: np.ndarray) -> Dict[str, float]:
    """pc/pred/labels: (N, 3); mask: (N,) moving prob; valid: (N,) bool."""
    pc, pred, labels, mask = (a[valid] for a in (pc, pred, labels, mask))
    error = np.sqrt(np.sum((pred - labels) ** 2, 1) + 1e-20)
    epe = float(np.mean(error))
    gtflow_len = np.sqrt(np.sum(labels * labels, 1) + 1e-20)

    res_r = np.sqrt(np.sum(cartesian_resolution(pc, "radar"), 1) + 1e-20)
    res_l = np.sqrt(np.sum(cartesian_resolution(pc, "lidar"), 1) + 1e-20)
    rn_error = error / (res_r / res_l)
    rne = float(np.mean(rn_error))
    mov_rne = float(np.sum(rn_error[mask == 0]) / (np.sum(mask == 0) + 1e-6))
    stat = rn_error[mask == 1]
    stat_rne = float(np.mean(stat)) if stat.size else 0.0
    avg_rne = 0.5 * (mov_rne + stat_rne)

    sas = float(np.mean(np.logical_or(rn_error <= 0.10,
                                      rn_error / gtflow_len <= 0.10)))
    ras = float(np.mean(np.logical_or(rn_error <= 0.20,
                                      rn_error / gtflow_len <= 0.20)))
    return {"rne": rne, "50-50 rne": avg_rne, "mov_rne": mov_rne,
            "stat_rne": stat_rne, "sas": sas, "ras": ras, "epe": epe}


def eval_motion_seg(pred: np.ndarray, gt: np.ndarray,
                    valid: np.ndarray) -> Dict[str, float]:
    """pred: (N,) thresholded 0/1; gt: (N,) 0/1; valid: (N,) bool."""
    pred, gt = pred[valid], gt[valid]
    tp = np.logical_and(pred == 1, gt == 1).sum() + 1e-20
    tn = np.logical_and(pred == 0, gt == 0).sum() + 1e-20
    fp = np.logical_and(pred == 1, gt == 0).sum() + 1e-20
    fn = np.logical_and(pred == 0, gt == 1).sum() + 1e-20
    acc = (tp + tn) / (tp + tn + fp + fn)
    sen = tp / (tp + fn)
    miou = 0.5 * (tp / (tp + fp + fn + 1e-4) + tn / (tn + fp + fn + 1e-4))
    return {"acc": float(acc), "miou": float(miou), "sen": float(sen)}
