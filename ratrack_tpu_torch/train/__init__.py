"""Train and eval steps, losses, metrics and train checkpoints."""

from .checkpoint import (latest_exists, restore_model, restore_train_state,
                         save_train_state)
from .losses import track4d_loss
from .metrics import eval_motion_seg, eval_scene_flow
from .step import (TrainConfig, TrainState, chain_contiguous,
                   create_train_state, make_eval_step, make_optimizer,
                   make_pipelined_eval_step, make_scan_eval_step,
                   make_scan_eval_step_cached, make_scan_train_step,
                   make_train_step, optimizer_step)

__all__ = [
    "TrainConfig", "TrainState", "chain_contiguous", "create_train_state",
    "eval_motion_seg", "eval_scene_flow", "latest_exists", "make_eval_step", "make_optimizer",
    "make_pipelined_eval_step", "make_scan_eval_step",
    "make_scan_eval_step_cached", "make_scan_train_step",
    "make_train_step", "optimizer_step", "restore_model",
    "restore_train_state",
    "save_train_state", "track4d_loss",
]
