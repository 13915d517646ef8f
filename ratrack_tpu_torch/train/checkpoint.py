"""Train checkpoints: model, optimizer, schedule and step in one file.

Counterpart of `ratrack_tpu/train/checkpoint.py`, whose orbax format is
not carried over: `torch.save` of the state dicts, read back with
`torch.load(weights_only=True)` into an existing TrainState, so resuming
gives the same next step as not stopping. Names follow the JAX package's
last / last<ep> / best convention: <root>/<name>.pt.

A `.pt` file may also be a reference-format state_dict
(`utils/convert.py::save_reference_checkpoint`); `is_train_checkpoint`
tells the two apart by content.
"""

from __future__ import annotations

import os
import pickle

import torch

from .step import TrainState


def _path(root: str, name: str) -> str:
    return os.path.abspath(os.path.join(root, f"{name}.pt"))


def save_train_state(root: str, name: str, ts: TrainState) -> str:
    """Write ts to <root>/<name>.pt (through a temporary file and an
    atomic rename, so a crash never leaves half a checkpoint)."""
    path = _path(root, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"model": ts.model.state_dict(),
                "optimizer": ts.optimizer.state_dict(),
                "scheduler": ts.scheduler.state_dict(),
                "step": ts.step}, tmp)
    os.replace(tmp, path)
    return path


def latest_exists(root: str, name: str = "last") -> bool:
    """True iff <root>/<name>.pt exists."""
    return os.path.isfile(_path(root, name))


def is_train_checkpoint(path: str) -> bool:
    """True iff `path` holds one of this module's checkpoints: a dict with
    model, optimizer, scheduler and step. False for anything else, a
    reference state_dict or a whole-module pickle among them."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # weights_only refuses a module pickle
        return False
    return isinstance(ckpt, dict) and {
        "model", "optimizer", "scheduler", "step"} <= set(ckpt)


def restore_train_state(root: str, name: str, ts: TrainState) -> TrainState:
    """Load <root>/<name>.pt into ts (same model and optimizer layout) and
    return it."""
    ckpt = torch.load(_path(root, name), map_location="cpu",
                      weights_only=True)
    ts.model.load_state_dict(ckpt["model"])
    ts.optimizer.load_state_dict(ckpt["optimizer"])
    ts.scheduler.load_state_dict(ckpt["scheduler"])
    ts.step = int(ckpt["step"])
    return ts


def restore_model(root: str, name: str, model: torch.nn.Module):
    """Load only the model's weights and batch norm statistics of
    <root>/<name>.pt into `model` (for serving and evaluation, which need
    no optimizer) and return it, in the mode it was in."""
    ckpt = torch.load(_path(root, name), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(ckpt["model"])
    return model
