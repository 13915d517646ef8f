"""Tracking-result export in the reference's text format.

The port's own copy of `ratrack_tpu/eval/export.py`: the same text byte
for byte (tests/test_torch_port_eval.py).

Reference (`src/main_utils.py:166-184`): one file per frame at
results/<clip>/<frame:05d>.txt, one line per tracked object:

  NA 1 -1 -1 <conf> <track_id> x y z x y z ...

with the per-object point list being the ORIGINAL pc1 coordinates of the
object's points (channels 3:6 of the 139-ch tensor). Committed sample
outputs under the reference's src/result/4dmot_runthis/ follow this shape.
"""

from __future__ import annotations

import os

import numpy as np


def format_frame_results(labels: np.ndarray, track_ids: np.ndarray,
                         confs: np.ndarray, n_clusters: int,
                         pc1: np.ndarray) -> str:
    """Build the per-frame result text.

    Args:
      labels: (N,) cluster slot per point (-1 none).
      track_ids: (K,) persistent id per slot.
      confs: (K,) match confidence per slot.
      n_clusters: number of valid slots.
      pc1: (N, 3) original point coordinates.
    """
    lines = []
    for k in range(n_clusters):
        idx = np.where(labels == k)[0]
        if idx.size == 0:
            continue
        parts = ["NA", "1", "-1", "-1", str(float(confs[k])),
                 str(int(track_ids[k]))]
        for i in idx:
            parts.extend(str(float(v)) for v in pc1[i])
        lines.append(" ".join(parts))
    return "\n".join(lines) + ("\n" if lines else "")


def write_frame_results(results_dir: str, clip: str, frame_number: int,
                        text: str) -> str:
    d = os.path.join(results_dir, clip)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{frame_number:05d}.txt")
    with open(path, "w") as f:
        f.write(text)
    return path


def parse_frame_results(path: str):
    """Inverse of format_frame_results → list of (conf, track_id, (M,3) pts)."""
    out = []
    for line in open(path):
        t = line.split()
        if len(t) < 6:
            continue
        conf, tid = float(t[4]), int(t[5])
        coords = np.array([float(v) for v in t[6:]],
                          np.float32).reshape(-1, 3)
        out.append((conf, tid, coords))
    return out
