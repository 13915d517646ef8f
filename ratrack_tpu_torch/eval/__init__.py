"""Evaluation: result export, the Kalman box tracker, SAMOTA/AMOTA metrics.
The CLIs score a results tree: `python -m ratrack_tpu_torch.eval.run`
(the Sinkhorn tracks as written), `.run_kf` (re-tracked by the Kalman
filter) and `.run_ap` (VoD's KITTI-style detection AP)."""

from .export import (format_frame_results, parse_frame_results,
                     write_frame_results)
from .kalman import BoxDet, KalmanTracker
from .mot_metrics import clear_mot, integrated_mot, point_set_iou

__all__ = ["format_frame_results", "write_frame_results",
           "parse_frame_results", "BoxDet", "KalmanTracker",
           "point_set_iou", "clear_mot", "integrated_mot"]
