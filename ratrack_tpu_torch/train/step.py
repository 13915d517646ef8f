"""Train and eval steps over B streams x T frames.

Counterpart of `ratrack_tpu/train/step.py`. The JAX scans' vmap over
streams is the batch dimension here and `lax.scan` is a Python loop over T.

Train (`make_train_step`, `make_scan_train_step`, :128-203): one optimizer
step per frame on the mean over streams of the per-stream loss, with the
recurrent state detached between frames (Track4D detaches it). Batch norm
statistics are per stream and the running averages the mean over streams
of the per-stream updates (models/layers.py). The optimizer is torch Adam
with weight decay added to the gradient before the moments (optax
add_decayed_weights -> adam, :48-62) and a staircase StepLR stepped once
per optimizer step. With a mesh (parallel/mesh.py) each rank steps its
own shard of the streams and the frame step averages the gradients and
the BN running statistics over the ranks: JAX's shard_map over 'dp' with
its two pmeans (:104-126, :145-205).

Eval (`make_scan_eval_step_cached`, :406-462): frame t's pc2 is frame
t-1's pc1 in a contiguous stream, and in eval the PNHead is a pure
function of the cloud: the pc2 head is computed once at block entry and
each frame's f1 is carried as the next frame's f2. `make_eval_step` and
`make_scan_eval_step` (:206-216, :380-403) are the uncached forms: both
heads every frame, as serving runs it. `make_pipelined_eval_step`
(:219-365) runs every stage that depends on no earlier frame once over the
whole (B, T) block and only the GRU and the ID inheritance frame by frame.

FLOT (`make_scan_flow_step_cached`, the port's own): the same carry as the
cached eval scan, pc1's features of frame t serving as pc2's of frame
t + 1, so a frame step computes one cloud's graph and features.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.frames import FrameBatch
from ..device import resolve_device
from ..parallel.mesh import all_reduce_mean_
from ..trace import span
from ..tracker.association import MatchStructure, assign_ids, match_structure
from ..tracker.state import TrackState
from .losses import track4d_loss

KEEP = ("cls", "warp", "labels", "track_id", "conf", "n")


def chain_contiguous(frame_numbers, new_seq) -> bool:
    """True iff, within the block, each frame's pc2 is the previous
    frame's pc1: frame numbers strictly consecutive and no sequence reset
    after the first frame (the block-entry pc2 head is always fresh)."""
    fno = np.asarray(frame_numbers)
    ns = np.asarray(new_seq)
    return bool(np.all(np.diff(fno) == 1) and not np.any(ns[1:]))


def frame_at(frames: FrameBatch, t: int) -> FrameBatch:
    """Frame t of a (B, T, ...) block as contiguous (B, ...) tensors."""
    return FrameBatch(*[x[:, t].contiguous() for x in frames])


def make_eval_step(model):
    """-> eval_step(track_state, frame (B, ...)) -> (outputs, new_state):
    one uncached model step over B streams, no gradient."""

    @torch.inference_mode()
    def eval_step(track_state: TrackState, frame: FrameBatch):
        return model(frame, track_state)

    return eval_step


def make_scan_eval_step(model, mesh=None):
    """-> scan_eval(track_state, frames (B, T, ...)) -> (new_state,
    {key: (B, T, ...)} for the keys in KEEP): the uncached step frame by
    frame. Equal to `make_scan_eval_step_cached` where `chain_contiguous`
    holds.

    With `mesh` the caller passes this rank's shard (`shard_clips`) and
    gets its outputs, still sharded. Streams are independent, so the
    sharded step is the unsharded one and issues no collective (JAX
    `_shard_eval`, step.py:367-377): `mesh` is taken for the JAX
    signature and changes nothing."""
    del mesh

    @torch.inference_mode()
    def scan_eval(track_state: TrackState, frames: FrameBatch):
        outs = {k: [] for k in KEEP}
        for t in range(frames.pc1.shape[1]):
            out, track_state = model(frame_at(frames, t), track_state)
            for k in KEEP:
                outs[k].append(out[k])
        return track_state, {k: torch.stack(v, dim=1)
                             for k, v in outs.items()}

    return scan_eval


def make_scan_eval_step_cached(model, mesh=None):
    """-> scan_eval(track_state, frames (B, T, ...)) ->
    (new_state, {key: (B, T, ...)} for the keys in KEEP). `mesh` as in
    `make_scan_eval_step`: the shard in, its outputs out, no collective."""
    del mesh

    @torch.inference_mode()
    def scan_eval(track_state: TrackState, frames: FrameBatch):
        f0 = frame_at(frames, 0)
        f2 = model.head_stage(f0.pc2, f0.ft2, f0.mask2)
        outs = {k: [] for k in KEEP}
        for t in range(frames.pc1.shape[1]):
            out, track_state, f2 = model.step_cached(frame_at(frames, t),
                                                     track_state, f2)
            for k in KEEP:
                outs[k].append(out[k])
        return track_state, {k: torch.stack(v, dim=1)
                             for k, v in outs.items()}

    return scan_eval


def make_scan_flow_step_cached(model):
    """-> scan_flow(frames (B, T, ...)) -> {"flow", "ot_flow"}: (B, T, n,
    3) each, FLOT's refined flow and its transport's flow, frame by frame.
    A frame step builds pc1's graph, runs pc1's features, the transport
    against the carried features of pc2 (the previous step's pc1) and the
    refinement on pc1's graph; a block's first frame computes pc2's
    features too. Valid where `chain_contiguous` holds, as the cached eval
    scan. Every point of every cloud must be valid (models/flot.py): one
    host sync a block checks the masks."""

    @torch.inference_mode()
    def scan_flow(frames: FrameBatch):
        model.check_full(frames.mask1, frames.mask2)
        pc2 = frames.pc2[:, 0].contiguous()
        f2 = model.features(pc2, model.graph(pc2))
        flows, ot_flows = [], []
        for t in range(frames.pc1.shape[1]):
            pc1 = frames.pc1[:, t].contiguous()
            pc2 = frames.pc2[:, t].contiguous()
            graph = model.graph(pc1)
            f1 = model.features(pc1, graph)
            ot_flow = model.transport(f1, f2, pc1, pc2)
            flows.append(model.refine(ot_flow, graph))
            ot_flows.append(ot_flow)
            f2 = f1
        return {"flow": torch.stack(flows, dim=1),
                "ot_flow": torch.stack(ot_flows, dim=1)}

    return scan_flow


def make_pipelined_eval_step(model):
    """-> step(track_state (B), frames (B, T, ...)) -> (new_state, outputs
    {key: (B, T, ...)}): the eval step in four phases (JAX
    `make_pipelined_eval_step`, step.py:219-365).

    The per-frame step depends on earlier frames only through the GRU
    carry and the track-id inheritance. Everything else (both heads, cost
    volume, flow MLP, DBSCAN, descriptors, GT match, affinity, Sinkhorn
    matching) depends on the frame pair alone, so it runs once over all
    B * T frames of the block, one call each:
      A. `frame_stage` over the B * T frames;
      B. the GRU over T, h zeroed at `new_seq`;
      C. `output_stage` with each frame's frame index (0 at `new_seq`, else
         the carried count plus one), the previous frame's descriptors,
         validity and GT ids (the block-entry state at t = 0, the frame
         before after it, cleared at `new_seq`), `affinity_stage` and
         `match_structure`;
      D. `assign_ids` over T, the previous ids -1 at `new_seq`; next_id
         carries on without reset.
    In eval each stage is a pure function of its inputs, so the results
    are the sequential scan's (`make_scan_eval_step`), `new_seq` resets
    included. The outputs are the per-frame step's keys without `feats`,
    which the JAX function leaves out too: flow, warp, cls, labels,
    track_id, conf, aff, m, n, sizes, prev_gt_id, prev_valid, curr_gt_id,
    curr_valid. The new state is frame T - 1's. Each kernel of the frame
    step launches once a block, whatever T. Eval only: it raises in train
    mode, as `Track4D.step_cached` does."""

    @torch.inference_mode()
    def step(track_state: TrackState, frames: FrameBatch):
        if model.training:
            raise RuntimeError("the pipelined step is eval only: in "
                               "training the frames of a block do not share "
                               "one set of weights")
        ns = frames.new_seq                                     # (B, T)
        b, t = ns.shape
        k = model.k_max
        fi, fis = track_state.frame_idx, []
        for s in range(t):
            fi = torch.where(ns[:, s], torch.zeros_like(fi), fi)
            fis.append(fi)
            fi = fi + 1
        flat = FrameBatch(*[x.reshape((b * t,) + x.shape[2:])
                            for x in frames])

        # A: both heads, cost volume and decoder before the GRU, B * T
        cls, prop, gin = model.frame_stage(flat)

        # B: the GRU over T
        gin = gin.reshape(b, t, -1)
        h, gouts = track_state.h, []
        for s in range(t):
            h = torch.where(ns[:, s, None, None], torch.zeros_like(h), h)
            gout, h = model.gru_stage(gin[:, s], h)
            gouts.append(gout)
        gout = torch.stack(gouts, dim=1).reshape(b * t, -1)

        # C: outputs, the previous frame's objects, affinity, matching
        o = model.output_stage(flat, cls, prop, gout,
                               torch.stack(fis, dim=1).reshape(-1))
        desc = o["desc"].reshape(b, t, k, -1)
        valid = o["curr_valid"].reshape(b, t, k)
        curr_gt = o["curr_gt"].reshape(b, t, k)

        def prev(entry, x, clear):
            p = torch.cat([entry.unsqueeze(1), x[:, :-1]], dim=1)
            sel = ns.reshape(b, t, *([1] * (p.dim() - 2)))
            return torch.where(sel, torch.full_like(p, clear), p)
        prev_desc = prev(track_state.desc, desc, 0.0)
        prev_valid = prev(track_state.valid, valid, False)
        prev_gt = prev(track_state.gt_id, curr_gt, -1)
        aff = model.affinity_stage(prev_desc.reshape(b * t, k, -1),
                                   o["desc"])
        m = prev_valid.sum(dim=-1).to(torch.int32)              # (B, T)
        ms = match_structure(aff, m.reshape(-1), o["n"],
                             model.sinkhorn_alpha, model.sinkhorn_iters,
                             model.sinkhorn_tol,
                             use_fused_kernel=model.sinkhorn_kernel)
        ms = MatchStructure(*[x.reshape(b, t, k) for x in ms])
        aff = aff.reshape(b, t, k, k)

        # D: id inheritance over T
        tid, next_id = track_state.track_id, track_state.next_id
        tids, confs = [], []
        for s in range(t):
            tid = torch.where(ns[:, s, None], torch.full_like(tid, -1), tid)
            res = assign_ids(MatchStructure(*[x[:, s] for x in ms]), tid,
                             next_id, aff[:, s], model.match_conf_thres)
            tid, next_id = res.track_id, res.next_id
            tids.append(tid)
            confs.append(res.conf)

        new_state = TrackState(
            h=h, desc=desc[:, -1], valid=valid[:, -1], track_id=tid,
            gt_id=curr_gt[:, -1], next_id=next_id, frame_idx=fi)

        def bt(x):
            return x.reshape((b, t) + x.shape[1:])
        outputs = dict(
            flow=bt(o["flow"]), warp=bt(o["warp"]), cls=bt(cls),
            labels=bt(o["labels"]), track_id=torch.stack(tids, dim=1),
            conf=torch.stack(confs, dim=1), aff=aff, m=m, n=bt(o["n"]),
            sizes=bt(o["sizes"]), prev_gt_id=prev_gt, prev_valid=prev_valid,
            curr_gt_id=curr_gt, curr_valid=valid)
        return new_state, outputs

    return step


@dataclass
class TrainConfig:
    """The optimizer settings of the JAX package's Config (config.py:23-26,
    reference main.py:61-62); any object with these attributes will do."""
    lr: float = 1e-3
    weight_decay: float = 1e-10
    decay_epochs: int = 1
    decay_rate: float = 0.97


@dataclass
class TrainState:
    """The model (in train mode), its optimizer, the LR schedule and the
    count of optimizer steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def make_optimizer(params, cfg, steps_per_epoch: int):
    """Adam(lr, weight_decay) + StepLR(steps_per_epoch * decay_epochs,
    decay_rate), the scheduler stepped once per optimizer step: the
    staircase `optax.exponential_decay` of the JAX package. torch's Adam
    adds weight_decay * p to the gradient before the moments, as
    optax.add_decayed_weights placed before adam does."""
    opt = torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.StepLR(
        opt, step_size=max(1, steps_per_epoch * cfg.decay_epochs),
        gamma=cfg.decay_rate)
    return opt, sched


def create_train_state(model, cfg, steps_per_epoch: int,
                       device=None) -> TrainState:
    """Turn `model` to training (train mode, gradients on) on `device`
    (None: the card, `default_device()`) and give it an optimizer and
    schedule."""
    model.to(resolve_device(device))
    model.train()
    model.requires_grad_(True)
    opt, sched = make_optimizer(list(model.parameters()), cfg,
                                steps_per_epoch)
    return TrainState(model, opt, sched)


def _fill_missing_grads(ts: TrainState) -> None:
    for group in ts.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


@span("optimizer")
def optimizer_step(ts: TrainState) -> None:
    """One optimizer and schedule step on the gradients in .grad.

    Parity with optax: optax moves every parameter every step, so a leaf
    with no gradient (bin_score, which nothing uses) still decays and keeps
    its moments moving. torch's Adam skips a parameter whose .grad is None,
    so such grads are filled with zeros first."""
    _fill_missing_grads(ts)
    ts.optimizer.step()
    ts.scheduler.step()
    ts.step += 1


@span("allreduce")
def _reduce_over_mesh(ts: TrainState, mesh) -> None:
    """JAX's pmean of the gradients and of the BN statistics over 'dp'
    (step.py:121-122): the missing gradients filled with zeros first (so
    every rank contributes every leaf, whatever its shard reached), then
    one all-reduce of every gradient in one bucket and one of every batch
    norm running statistic, each divided by dp."""
    _fill_missing_grads(ts)
    all_reduce_mean_(mesh, [p.grad for g in ts.optimizer.param_groups
                            for p in g["params"]])
    all_reduce_mean_(mesh, [b for n, b in ts.model.named_buffers()
                            if n.endswith(("running_mean", "running_var"))])


def make_train_step(ts: TrainState, mesh=None):
    """-> train_step(track_states, frame (B, ...), pretrain) ->
    (track_states', items {name: (B,)}): forward, backward of the mean over
    streams of the loss, `optimizer_step`. After the call each parameter's
    .grad holds that step's gradient. A bfloat16 model (`Track4D(dtype=
    torch.bfloat16)`) computes in bfloat16 with float32 parameters, so its
    gradients and the optimizer's state are float32, as optax's on flax's
    float32 params.

    With `mesh` (parallel/mesh.py) the step runs this rank's shard of the
    streams (`shard_clips`) on a model that every rank holds alike
    (`replicate`), and between the backward and the optimizer step
    averages the gradients and the batch norm running statistics over the
    ranks: exactly two all-reduces a frame, none in the forward. Equal
    shards make that the unsharded step's update, to the order of float
    sums. Not DistributedDataParallel: its `broadcast_buffers` would copy
    rank 0's statistics where JAX averages them, and its buckets would hide
    how many collectives a frame issues."""

    def train_step(track_state: TrackState, frame: FrameBatch, pretrain
                   ) -> Tuple[TrackState, Dict[str, torch.Tensor]]:
        with span("optimizer"):
            ts.optimizer.zero_grad(set_to_none=True)
        with span("forward"):
            out, new_state = ts.model(frame, track_state)
        with span("loss"):
            total, items = track4d_loss(out, frame, pretrain)
        with span("backward"):
            total.mean().backward()
        if mesh is not None:
            _reduce_over_mesh(ts, mesh)
        optimizer_step(ts)
        return new_state, {k: v.detach() for k, v in items.items()}

    return train_step


def make_scan_train_step(ts: TrainState, mesh=None):
    """-> scan_train(track_states, frames (B, T, ...), pretrain) ->
    (track_states', items {name: (T, B)}): T sequential train steps, one
    optimizer step per frame (JAX make_scan_train_step, :145). With `mesh`
    each frame step is `make_train_step`'s sharded one: B is this rank's
    shard and so are the returned states and items (`gather_clips` joins
    them)."""
    train_step = make_train_step(ts, mesh)

    def scan_train(track_state: TrackState, frames: FrameBatch, pretrain):
        per_frame = []
        for t in range(frames.pc1.shape[1]):
            track_state, items = train_step(track_state, frame_at(frames, t),
                                            pretrain)
            per_frame.append(items)
        return track_state, {k: torch.stack([it[k] for it in per_frame])
                             for k in per_frame[0]}

    return scan_train
