"""The comparison that decides `correct`.

The reference (reference/) runs once the window has closed and the
program's state is freed, on the frames the program was judged on, from
the benchmark's own weights. The numbers compared:

eval (the first F frames of a block that starts a clip, every stream):
  cls_gap          max |cls - cls_ref| over valid points
  warp_gap         max |warp - warp_ref| (metres) over valid points
  label_mismatch   share of (stream, frame) whose DBSCAN labels differ
  track_mismatch   share of (stream, frame) whose association differs:
                   which slot of the frame before each slot continues
                   (the same track id), or that it starts a new track.
                   Ids themselves are not compared: the program's id
                   counter carries over from earlier clips, the
                   reference's starts at 0, and one different match
                   would shift every later id of the stream
  unclustered      share of (stream, frame) in which the reference
                   clusters no point: there the two mismatches compare
                   empty outputs, and DBSCAN, the descriptors and the
                   association go unchecked (the eval cells shift the
                   motion head's bias so that points score above the
                   threshold: weights.place_motion_threshold)
  conf_gap         max |conf - conf_ref| over slots that inherit an id on
                   both sides, in streams whose labels agree up to that
                   frame (reported, not compared: under the control few
                   such slots remain, so it separates nothing)
train (the first three Adam steps of the set-up):
  loss_gap_step1   |L - L_ref| / |L_ref| at the first step, L the mean
                   over streams of the loss
  grad_gap         worst leaf of | |g| - |g_ref| | / max(|g_ref|, median
                   leaf |g_ref|), g the first gradient as Adam took it
  change_gap_median  the median leaf of the same of each parameter's and
                   batch norm statistic's change over the three steps
  rank_gap         (several cards) the largest difference of any
                   parameter or statistic between a rank and rank 0 after
                   the window: the ranks hold one model
  Leaves whose reference gradient is under a thousandth of the median
  leaf's (moved by round-off alone under Adam) are left out of both.
  The loss of steps 2-3 (loss_gap_steps) and the worst leaf's change
  (change_gap_worst) are reported beside them and not compared: Adam's
  first steps move each weight by about lr x the sign of its gradient,
  so a weight whose gradient is nought to rounding moves either way, and
  a reference moved by one rounding reads as far from itself as the
  program does (PERF.md).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .reference import losses as ref_losses
from .reference.control import tf32_products
from .reference.model import Track4D
from .traffic import frame_at

ZERO_GRAD = 1e-3


@contextlib.contextmanager
def reference_precision(control: bool):
    """The reference's precision: float32 products with TF32 off, or the
    control's TF32 products."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with tf32_products() if control else contextlib.nullcontext():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_model(cell, weights, device):
    model = Track4D(**cell.config["model"]).to(device)
    model.load_state_dict(weights)
    return model


def reference_eval(cell, weights, frames, control=False):
    """The reference over frames (B, F, ...) from a fresh state -> host
    outputs {key: (B, F, ...)}."""
    dev = frames.pc1.device
    model = reference_model(cell, weights, dev).eval()
    state = model.fresh_state(frames.pc1.shape[0], dev)
    keys = ("cls", "warp", "labels", "track_id", "conf")
    outs = {k: [] for k in keys}
    with torch.no_grad(), reference_precision(control):
        for t in range(frames.pc1.shape[1]):
            out, state = model(frame_at(frames, t), state)
            for k in keys:
                outs[k].append(out[k].cpu())
    return {k: torch.stack(v, dim=1) for k, v in outs.items()}


def reference_train(cell, weights, frames, control=False, streams=None):
    """The reference's first steps over frames (B, S, ...) from a fresh
    state -> {loss (S, B), grad {name}, after {name}} on the device.
    streams: the loss of the mean over the first `streams` streams only
    (a fault's reading)."""
    dev = frames.pc1.device
    model = reference_model(cell, weights, dev).train()
    opt_cfg = cell.config["optimizer"]
    opt = torch.optim.Adam(model.parameters(), lr=opt_cfg["lr"],
                           weight_decay=opt_cfg["weight_decay"])
    pretrain = cell.workload["pretrain"]
    state = model.fresh_state(frames.pc1.shape[0], dev)
    losses, grad = [], None
    with reference_precision(control):
        for t in range(frames.pc1.shape[1]):
            opt.zero_grad(set_to_none=True)
            fr = frame_at(frames, t)
            out, state = model(fr, state)
            total = ref_losses.loss(out, fr, pretrain)
            losses.append(total.detach())
            total[:streams].mean().backward()
            # the optimizer moves every parameter every step, as optax
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if t == 0:
                grad = {n: p.grad + opt_cfg["weight_decay"] * p.detach()
                        for n, p in model.named_parameters()}
            opt.step()
    after = {n: t.detach().clone() for n, t in model.state_dict().items()}
    return dict(loss=torch.stack(losses), grad=grad, after=after)


def associations(ids: torch.Tensor) -> torch.Tensor:
    """(B, F, K) track ids -> (B, F, K) the slot of the frame before
    whose id each slot carries, -1 for a new track (every track at the
    first frame), -2 for an empty slot."""
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    same = (ids.unsqueeze(-1) == prev.unsqueeze(-2)) & (
        ids.unsqueeze(-1) >= 0)                                # (B, F, K, K)
    slot = torch.where(same.any(-1), same.float().argmax(-1),
                       torch.full_like(ids, -1))
    return torch.where(ids >= 0, slot, torch.full_like(ids, -2))


def eval_numbers(prog: dict, ref: dict, mask: torch.Tensor) -> dict:
    """The eval numbers of the program's (or the control's) outputs
    against the reference's; mask (B, F, N) the valid points."""
    mask = mask.cpu()
    cls_gap = (prog["cls"] - ref["cls"]).abs()[mask].max()
    warp_gap = (prog["warp"] - ref["warp"]).abs().amax(-1)[mask].max()
    lab_ok = torch.where(mask, prog["labels"] == ref["labels"],
                         torch.ones_like(mask)).all(dim=-1)      # (B, F)
    tid_ok = (associations(prog["track_id"])
              == associations(ref["track_id"])).all(dim=-1)
    agree = torch.cumprod(lab_ok.to(torch.int32), dim=1).bool()
    both = (prog["conf"] > 0) & (ref["conf"] > 0) & agree.unsqueeze(-1)
    conf = (prog["conf"] - ref["conf"]).abs()[both]
    clustered = ((ref["labels"] >= 0) & mask).any(dim=-1)     # (B, F)
    return dict(cls_gap=float(cls_gap), warp_gap=float(warp_gap),
                label_mismatch=float(1.0 - lab_ok.float().mean()),
                track_mismatch=float(1.0 - tid_ok.float().mean()),
                conf_gap=float(conf.max()) if conf.numel() else 0.0,
                unclustered=float(1.0 - clustered.float().mean()))


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items() if v.is_floating_point()}


def _leaf_gaps(got: dict, want: dict, keep) -> np.ndarray:
    """| |got| - |want| | / max(|want|, median leaf |want|) per kept
    leaf."""
    g, w = _norms(got), _norms(want)
    names = [k for k in w if keep(k)]
    med = float(np.median([w[k] for k in names]))
    return np.array([abs(g[k] - w[k]) / max(w[k], med) for k in names])


def train_numbers(prog: dict, ref: dict, weights: dict) -> dict:
    """The train numbers of the program's (or a control's) readings
    against the reference's; weights: the parameters before step 1."""
    rg = _norms(ref["grad"])
    med = float(np.median(list(rg.values())))
    moved = {k for k, v in rg.items() if v >= ZERO_GRAD * med}

    def keep(name):            # parameters the gradient moves, statistics
        return name in moved or name not in rg

    def change(after):
        return {k: after[k].double() - weights[k].double() for k in after
                if weights[k].is_floating_point()}
    lp = prog["loss"].to(torch.float64).mean(dim=1).cpu()
    lr = ref["loss"].to(torch.float64).mean(dim=1).cpu()
    loss = ((lp - lr).abs() / lr.abs()).numpy()
    grad = _leaf_gaps(prog["grad"], ref["grad"], keep)
    moved = _leaf_gaps(change(prog["after"]), change(ref["after"]), keep)
    ranks = {"rank_gap": prog["rank_gap"]} if "rank_gap" in prog else {}
    return dict(**ranks, loss_gap_step1=float(loss[0]),
                grad_gap=float(grad.max()),
                change_gap_median=float(np.median(moved)),
                loss_gap_steps=float(loss.max()),
                grad_gap_median=float(np.median(grad)),
                change_gap_worst=float(moved.max()))


def verdict(values: dict, limits: dict):
    """-> (correct, [(name, value, limit)]): every number at or under its
    limit."""
    rows = [(k, values[k], limits[k]) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
