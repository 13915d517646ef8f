"""Evaluation: result export and SAMOTA/AMOTA metrics (the Kalman
re-tracker of the JAX package's eval/ is not ported yet)."""

from .export import (format_frame_results, parse_frame_results,
                     write_frame_results)
from .mot_metrics import clear_mot, integrated_mot, point_set_iou

__all__ = ["format_frame_results", "write_frame_results",
           "parse_frame_results", "point_set_iou", "clear_mot",
           "integrated_mot"]
