"""The cached-backbone eval scan (the train path is not ported yet)."""

from .step import chain_contiguous, make_scan_eval_step_cached

__all__ = ["chain_contiguous", "make_scan_eval_step_cached"]
