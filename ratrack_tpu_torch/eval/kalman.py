"""Kalman-filter multi-object tracker over 3D box detections.

The port's own copy of `ratrack_tpu/eval/kalman.py`: the same ids and
states (tests/test_torch_port_offline_eval.py).

Re-implementation of the vendored AB3DMOT capability the reference plans
to integrate for its offline metrics (SURVEY.md §2.4, L7), pinned by
EXECUTING the vendored tracker as an oracle (tests/test_kf_oracle.py
loads the reference's `src/AB3DMOT_libs/model.py` with a faithful
filterpy stub and asserts per-frame output parity on constructed
birth/miss/churn sequences).

Semantics mirrored from the vendored code (file:line):
  * VoD preset: hungarian matching, 'dist_3d' metric, threshold 2 m,
    min_hits 4, max_age 8 (model.py:82-84).
  * KF: 10-state [x y z θ l w h vx vy vz] constant-velocity filter;
    P0 = 10·I with 10000·I on velocities, Q = I with 0.01·I on
    velocities, R = I (kalman_filter.py:17-56 — filterpy defaults where
    not set); filterpy's Joseph-form covariance update.
  * θ kept in [-π, π) after predict and update (model.py:173-178,
    :295/:343); acute-angle orientation correction of the TRACK's θ
    against the observation before the update (model.py:180-199).
  * 'dist_3d' matches on the corner-average box centers — the bottom
    center lifted by h/2 — not the raw (x, y, z)
    (dist_metrics.py:205-216 via box2corners3d_camcoord).
  * matching: affinity = −dist (dets × trks), hungarian on −affinity,
    then pairs with affinity < −thres are unmatched
    (matching.py:51-113; ties at exactly the threshold stay matched).
  * lifecycle: predict increments every track's time_since_update; a
    match resets it; OUTPUT includes coasting tracks (predicted state)
    while time_since_update < max_age, gated on hits >= min_hits or
    frame_count <= min_hits; tracks die at time_since_update >= max_age
    after the output pass (model.py:365-385).
  * ego motion compensation (when supplied) runs AFTER prediction,
    replacing the track position with inv(T) @ position
    (model.py:236-250 ego_from_vod).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

# state: [x, y, z, yaw, l, w, h, vx, vy, vz]
_DIM_X, _DIM_Z = 10, 7


def _within_range(theta: float) -> float:
    """model.py:173-178."""
    if theta >= np.pi:
        theta -= np.pi * 2
    if theta < -np.pi:
        theta += np.pi * 2
    return theta


@dataclasses.dataclass
class BoxDet:
    """One 3D box detection: center xyz, yaw, size lwh, confidence.

    xyz follows the reference's camera-coordinate convention where y is
    the box BOTTOM; the matching metric lifts it by h/2 (lwh[2]/2).
    """
    xyz: np.ndarray
    yaw: float
    lwh: np.ndarray
    conf: float = 1.0

    @property
    def z(self) -> np.ndarray:
        return np.concatenate(
            [np.asarray(self.xyz, float), [float(self.yaw)],
             np.asarray(self.lwh, float)])


class _Track:
    def __init__(self, det: BoxDet, track_id: int):
        self.x = np.zeros(_DIM_X)
        self.x[:_DIM_Z] = det.z
        # filterpy order (kalman_filter.py:47-49): velocity block scaled
        # before the global ×10
        self.P = np.eye(_DIM_X)
        self.P[7:, 7:] *= 1000.0
        self.P *= 10.0
        self.hits = 1
        self.time_since_update = 0
        self.conf = det.conf
        self.id = track_id

    def predict(self) -> None:
        f = np.eye(_DIM_X)
        f[0, 7] = f[1, 8] = f[2, 9] = 1.0
        q = np.eye(_DIM_X)
        q[7:, 7:] *= 0.01                  # kalman_filter.py:52
        self.x = f @ self.x
        self.P = f @ self.P @ f.T + q
        self.x[3] = _within_range(self.x[3])
        self.time_since_update += 1

    def update(self, det: BoxDet) -> None:
        h = np.zeros((_DIM_Z, _DIM_X))
        h[:, :_DIM_Z] = np.eye(_DIM_Z)
        r = np.eye(_DIM_Z)                 # filterpy default R
        z = det.z.copy()
        # acute-angle orientation correction (model.py:180-199): adjust
        # the TRACK's θ so |θ_obs − θ_pre| is acute
        theta_pre = _within_range(self.x[3])
        theta_obs = _within_range(z[3])
        if (abs(theta_obs - theta_pre) > np.pi / 2.0
                and abs(theta_obs - theta_pre) < np.pi * 3 / 2.0):
            theta_pre = _within_range(theta_pre + np.pi)
        if abs(theta_obs - theta_pre) >= np.pi * 3 / 2.0:
            if theta_obs > 0:
                theta_pre += np.pi * 2
            else:
                theta_pre -= np.pi * 2
        self.x[3] = theta_pre
        z[3] = theta_obs

        y = z - h @ self.x
        s = h @ self.P @ h.T + r
        k = self.P @ h.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        # Joseph-form covariance update (filterpy KalmanFilter.update)
        i_kh = np.eye(_DIM_X) - k @ h
        self.P = i_kh @ self.P @ i_kh.T + k @ r @ k.T
        self.x[3] = _within_range(self.x[3])
        self.hits += 1
        self.time_since_update = 0
        self.conf = det.conf

    def center(self) -> np.ndarray:
        """Corner-average center: bottom center lifted by h/2 in y
        (dist_metrics.py:205-216)."""
        c = self.x[:3].copy()
        c[1] -= self.x[6] / 2.0
        return c


def _det_center(d: BoxDet) -> np.ndarray:
    c = np.asarray(d.xyz, float).copy()
    c[1] -= float(d.lwh[2]) / 2.0
    return c


class KalmanTracker:
    """Frame-by-frame tracker: track(dets) → [(id, BoxDet-state, conf)].

    Defaults are the vendored VoD preset (model.py:82-84)."""

    def __init__(self, match_dist: float = 2.0, min_hits: int = 4,
                 max_age: int = 8, greedy: bool = False):
        self.match_dist = match_dist
        self.min_hits = min_hits
        self.max_age = max_age
        self.greedy = greedy
        self.tracks: List[_Track] = []
        self.frame = 0
        self._next_id = 0                  # per-tracker id counter (no
                                           # cross-instance leakage)

    def track(self, dets: List[BoxDet],
              ego_motion: Optional[np.ndarray] = None
              ) -> List[Tuple[int, BoxDet, float]]:
        self.frame += 1
        for t in self.tracks:
            t.predict()
        if ego_motion is not None:
            # reference order: compensation AFTER prediction
            # (model.py:489-492), replacing the position with inv(T)·p
            inv = np.linalg.inv(ego_motion)
            for t in self.tracks:
                hom = np.concatenate([t.x[:3], [1.0]])
                t.x[:3] = (inv @ hom)[:3]

        matches, un_t, un_d = self._associate(dets)
        for ti, di in matches:
            self.tracks[ti].update(dets[di])
        for di in un_d:
            self.tracks.append(_Track(dets[di], self._next_id))
            self._next_id += 1

        # output BEFORE death; coasting tracks report predicted state
        out = []
        for t in self.tracks:
            if (t.time_since_update < self.max_age
                    and (t.hits >= self.min_hits
                         or self.frame <= self.min_hits)):
                det = BoxDet(t.x[:3].copy(), float(t.x[3]),
                             t.x[4:7].copy(), t.conf)
                out.append((t.id, det, t.conf))
        self.tracks = [t for t in self.tracks
                       if t.time_since_update < self.max_age]
        return out

    def _associate(self, dets: List[BoxDet]):
        """matching.py:51-113 with the dets × trks orientation (ties
        break the reference's way)."""
        nt, nd = len(self.tracks), len(dets)
        if nt == 0 or nd == 0:
            return [], list(range(nt)), list(range(nd))
        # affinity = -dist over (dets, trks), corner-average centers
        aff = np.zeros((nd, nt), dtype=np.float32)
        for d, det in enumerate(dets):
            cd = _det_center(det)
            for t, trk in enumerate(self.tracks):
                aff[d, t] = -np.linalg.norm(cd - trk.center())
        if self.greedy:
            pairs = self._greedy_pairs(-aff)
        else:
            rows, cols = linear_sum_assignment(-aff)
            pairs = list(zip(rows, cols))
        matches, matched_t, matched_d = [], set(), set()
        for d, t in pairs:
            # aff < -thres → filtered out (ties at the threshold kept)
            if aff[d, t] >= -self.match_dist:
                matches.append((t, d))
                matched_t.add(t)
                matched_d.add(d)
        un_t = [i for i in range(nt) if i not in matched_t]
        un_d = [j for j in range(nd) if j not in matched_d]
        return matches, un_t, un_d

    @staticmethod
    def _greedy_pairs(cost: np.ndarray):
        """First-come-first-serve over globally sorted costs
        (matching.py:24-50)."""
        nd, nt = cost.shape
        order = np.argsort(cost.reshape(-1))
        dm = [-1] * nd
        tm = [-1] * nt
        pairs = []
        for idx in order:
            d, t = int(idx // nt), int(idx % nt)
            if dm[d] == -1 and tm[t] == -1:
                dm[d] = t
                tm[t] = d
                pairs.append((d, t))
        return pairs
