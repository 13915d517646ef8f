"""Data parallelism over clip streams: one process a card, NCCL.

Counterpart of `ratrack_tpu/parallel/mesh.py`. The JAX package shards the
clip-batch axis over a 'dp' mesh axis, replicates the parameters and
all-reduces the mean-over-streams gradient; frames within a clip are
serially dependent (GRU hidden state, previous objects), so throughput
scales by adding clips. In PyTorch the idiom is one process per card
(launched by `torchrun`) joined by a process group: each rank holds a full
copy of the model, streams its own contiguous block of clips, and the
train step all-reduces the gradients and the batch norm running
statistics once a frame (train/step.py). Eval needs no collective: streams
are independent.

A `Mesh` is the process group seen from one rank. JAX arrays are global,
so `shard_clips` there places a whole batch; here each rank holds its own
shard, so `shard_clips` returns this rank's block and `gather_clips`
brings the blocks back together, in clip order, where the whole batch is
wanted (logging, tests).
"""

from __future__ import annotations

import contextlib
import os
from collections import Counter
from dataclasses import dataclass
from typing import List

import torch
import torch.distributed as dist

# torch.distributed's collectives, counted by `count_collectives`
COLLECTIVES = (
    "all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast_object_list", "reduce", "gather",
    "gather_object", "scatter", "scatter_object_list", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "barrier",
    "monitored_barrier", "send", "recv", "isend", "irecv")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group: `dp` ranks, one shard of
    the clip axis each; this process is `rank` and computes on `device`;
    `devices` lists every rank's device, in rank order."""
    dp: int
    rank: int
    device: torch.device
    devices: List[str]
    group: object

    axis_names = ("dp",)


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise RuntimeError(f"{name} is not set: launch with torchrun (or set "
                           "RANK, WORLD_SIZE and LOCAL_RANK)")
    return int(os.environ[name])


def init_from_env(device=None, init_method: str = "env://") -> torch.device:
    """Join the process group that RANK / WORLD_SIZE / LOCAL_RANK describe
    (as `torchrun` sets them) and return this rank's device.

    `device=None` is the card: card LOCAL_RANK becomes the current device
    (so `default_device()` resolves to it) and the group is NCCL's. It
    raises where there is no NCCL or fewer cards than LOCAL_RANK + 1:
    nothing falls back to gloo or to the CPU. `device="cpu"` joins a gloo
    group on the CPU (the tests). `init_method` is torch.distributed's:
    `env://` (MASTER_ADDR / MASTER_PORT, as torchrun sets them) or a
    `file://` path shared by the ranks."""
    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    local = _env_int("LOCAL_RANK")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data parallelism on the card needs CUDA; "
                               "pass device=\"cpu\" for gloo on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL")
        if torch.cuda.device_count() < local + 1:
            raise RuntimeError(
                f"LOCAL_RANK {local} needs {local + 1} cards, "
                f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(local)
        dev, backend = torch.device("cuda", local), "nccl"
    else:
        dev = torch.device(device)
        if dev.type != "cpu":
            raise ValueError(f"device {device!r}: None (the card, NCCL) or "
                             "\"cpu\" (gloo)")
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev


def make_mesh(dp: int | None = None) -> Mesh:
    """The mesh of the joined process group (`init_from_env`). `dp`
    defaults to the world size. Every process is one shard, so a `dp`
    other than the world size is refused: above it as JAX refuses more
    devices than exist, below it because a rank outside the mesh would
    hold no shard and hang the collectives of the others."""
    world = dist.get_world_size()
    dp = dp or world
    if dp > world:
        raise ValueError(f"dp={dp} > available devices {world}")
    if dp < world:
        raise ValueError(f"dp={dp} < {world} processes: every process is "
                         "one shard of the mesh")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    devices: List[str] = [""] * world
    dist.all_gather_object(devices, str(device))
    return Mesh(dp, dist.get_rank(), device, devices, dist.group.WORLD)


def _map(fn, tree):
    """fn over the tensor leaves of a tensor, NamedTuple, tuple, list or
    dict; other leaves (None, numbers) pass through."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def shard_clips(mesh: Mesh, tree):
    """This rank's contiguous block of the leading clip-batch axis of every
    tensor of `tree` (a FrameBatch, a TrackState, a tensor, or a tuple or
    dict of them): the block that JAX's P("dp") places on device `rank`.
    0-d tensors are replicated.

    The clip-batch must divide evenly over the mesh: padding silently
    would corrupt the mean-over-streams loss (inactive pad streams would
    enter the gradient), so a non-divisible batch is an explicit error."""
    b = next(x for x in _leaves(tree) if x.dim() > 0).shape[0]
    if b % mesh.dp != 0:
        raise ValueError(
            f"clip batch {b} does not divide over dp={mesh.dp}; drop or pad "
            f"streams to a multiple of dp before sharding")
    per = b // mesh.dp
    lo = mesh.rank * per
    return _map(lambda x: x[lo:lo + per] if x.dim() > 0 else x, tree)


def gather_clips(mesh: Mesh, tree):
    """The whole clip batch from every rank's shard: each tensor of `tree`
    all-gathered along its leading axis, in rank (so clip) order. One
    collective a tensor; 0-d tensors are returned as they are."""
    def gather(x):
        if x.dim() == 0:
            return x
        x = x.contiguous()
        # bool moves as bytes (uint8), which every backend gathers
        wire = x.view(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(wire) for _ in range(mesh.dp)]
        dist.all_gather(parts, wire, group=mesh.group)
        out = torch.cat(parts)
        return out.view(torch.bool) if x.dtype == torch.bool else out
    return _map(gather, tree)


def replicate(mesh: Mesh, obj):
    """Every rank takes rank 0's copy of `obj` and returns it: a module's
    parameters and buffers; for a train state (train/step.py::TrainState)
    also its optimizer's and schedule's state and its step count, which
    rank 0 may hold alone (a restored checkpoint). JAX's
    `device_put(..., P())` of params, batch stats and optimizer state."""
    if isinstance(obj, torch.nn.Module):
        for t in list(obj.parameters()) + list(obj.buffers()):
            dist.broadcast(t.detach(), src=0, group=mesh.group)
        return obj
    replicate(mesh, obj.model)
    state = [None]
    if mesh.rank == 0:
        # on the CPU: a pickled CUDA tensor would unpickle onto rank 0's card
        opt = obj.optimizer.state_dict()
        state = [{"optimizer": {
            "state": {k: {n: v.cpu() if torch.is_tensor(v) else v
                          for n, v in s.items()}
                      for k, s in opt["state"].items()},
            "param_groups": opt["param_groups"]},
            "scheduler": obj.scheduler.state_dict(), "step": obj.step}]
    dist.broadcast_object_list(state, src=0, group=mesh.group)
    if mesh.rank != 0:
        obj.optimizer.load_state_dict(state[0]["optimizer"])
        obj.scheduler.load_state_dict(state[0]["scheduler"])
        obj.step = state[0]["step"]
    return obj


def all_reduce_mean_(mesh: Mesh, tensors) -> None:
    """Each tensor replaced, on every rank, by its mean over the ranks: one
    all-reduce of all of them flattened into one bucket, divided by dp
    (JAX's `lax.pmean`; equal shards make the mean of the ranks' local
    means the mean over every stream)."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.dp)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


@contextlib.contextmanager
def count_collectives():
    """Count, by name, the torch.distributed collectives called inside the
    block (each of `COLLECTIVES` wrapped while it runs): how the tests and
    chip_smoke.py pin the two all-reduces of a train frame step and the
    none of an eval step."""
    counts: Counter = Counter()
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted
    try:
        for name, fn in saved.items():
            setattr(dist, name, wrap(name, fn))
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
