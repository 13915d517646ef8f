"""Family `ratrack`: RaTrack's Track4D (arXiv:2309.09737), the model of
every configuration whose file says "family": "ratrack".

Binds the family's interface (spec.py) to RaTrack's code in weights.py,
check.py and work.py, which no other file of the harness calls.
"""

from __future__ import annotations

import contextlib
import re

import torch

from perfbench import check, traffic, work
from perfbench import weights as seeded

# the keys of a configuration's "model" block: Track4D's arguments
MODEL_KEYS = ("npoint", "k_max", "feat_dim", "gru_layers", "min_obj_points",
              "dbscan_eps", "dbscan_max_iters", "sinkhorn_iters",
              "sinkhorn_alpha", "match_conf_thres", "mov_thres",
              "mov_budget", "exact_fps", "sinkhorn_kernel")
# clouds above this many points take the program's split correlator (kernels
# B5 and B4; its models/correlator.py::SPLIT_ABOVE)
SPLIT_ABOVE = 4096
# the kernels of a layer of slice_work, by the names the trace gives them
# (the port's csrc/*.cu), keyed "<layer>.<kind>": the time side of its
# roofline (readers.roofline)
KERNELS = {
    "set_abstraction.eval": re.compile(r"(^|[^A-Za-z_])sa_kernel\b"),
    "cost_volume.eval": re.compile(
        r"(^|[^A-Za-z_])(knn_staged_kernel|aggregate_kernel|"
        r"knn_prep_kernel|knn_select_kernel)\b"),
    "set_abstraction.train": re.compile(
        r"(^|[^A-Za-z_])(select_kernel|fwd_cluster_kernel|"
        r"bwd_cluster_kernel)\b|finish_kernel.*ScalePair"),
    "cost_volume.train": re.compile(
        r"(^|[^A-Za-z_])(knn_staged_kernel|aggregate_kernel|bwd_head_kernel|"
        r"pair_layer_kernel|bwd_tail_kernel)\b|"
        r"finish_kernel(?!.*ScalePair)"),
}


def make_weights(cell, seed: int, device) -> dict:
    return seeded.make_state_dict(cell.config["model"], seed, device)


def prepare(cell, weights: dict, pool, device) -> dict:
    """Where the workload asks for a `moving_share`, the motion head's
    bias shifted so that share of the first frame's points move."""
    if "moving_share" not in cell.workload:
        return weights
    weights = seeded.place_motion_threshold(
        cell.config["model"], weights, traffic.frame_at(pool, 0),
        cell.workload["moving_share"])
    if device.type == "cuda":   # the peak is the program's, not the probe's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return weights


def reference(kind: str, cell, weights, frames, control=False):
    """The plain reference's outputs (eval) or readings (train) on the
    compared frames, from the benchmark's weights; `control`: with TF32
    products (the control)."""
    if kind == "eval":
        return check.reference_eval(cell, weights, frames, control=control)
    return check.reference_train(cell, weights, frames, control=control)


def compare(kind: str, got, ref, weights, frames) -> dict:
    """The check's numbers of `got` (the program's or a control's)
    against the reference's `ref` -> {name: value}."""
    if kind == "eval":
        return check.eval_numbers(got, ref, frames.mask1)
    return check.train_numbers(got, ref, weights)


def fault_readings(kind: str, cell, weights, frames, ref, seed: int,
                   exchange=None) -> dict:
    """calibrate.py's readings of training's faults on one seed: the
    reference's loss over half the streams, the mean taken over the
    rest; the reference from weights moved by about one float32
    rounding, a witness of the numbers' own noise; `exchange`: the
    program's readings with the exchange between the ranks left out.
    Eval has none."""
    if kind == "eval":
        return {}
    half = check.reference_train(cell, weights, frames,
                                 streams=cell.traffic["streams"] // 2)
    row = {"half_batch": check.train_numbers(half, ref, weights)}
    if exchange is not None:
        row["exchange_left_out"] = check.train_numbers(exchange, ref,
                                                       weights)
    dev = frames.pc1.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    nudged = {k: v * (1 + 6e-8 * torch.randn(
        v.shape, generator=gen, device=dev))
        if v.is_floating_point() else v
        for k, v in weights.items()}
    moved = check.reference_train(cell, nudged, frames)
    row["rounding"] = check.train_numbers(moved, ref, nudged)
    return row


@contextlib.contextmanager
def exchange_left_out():
    """The program's train step with its all-reduce between the ranks
    left out."""
    import ratrack_tpu_torch.train.step as step
    saved, step.all_reduce_mean_ = (step.all_reduce_mean_,
                                    lambda mesh, tensors: None)
    try:
        yield
    finally:
        step.all_reduce_mean_ = saved


def _state_unchanged(monkeypatch, kind):
    """The frame step returns the tracker's state it was given (eval);
    the train step leaves every parameter as it was."""
    from ratrack_tpu_torch.models.track4d import Track4D
    from ratrack_tpu_torch.train import step
    if kind == "train":
        monkeypatch.setattr(step, "optimizer_step",
                            lambda ts: setattr(ts, "step", ts.step + 1))
        return
    orig = Track4D.step_cached

    def stale(self, frame, state, f2):
        out, _, f1 = orig(self, frame, state, f2)
        return out, state, f1
    monkeypatch.setattr(Track4D, "step_cached", stale)


def _broken_outputs(monkeypatch, kind, fault):
    """Eval: the scan's outputs with the second half of the streams
    replaced by the first's, or one answer altered. Train: the loss's
    mean over the first half of the streams, or its value altered."""
    from ratrack_tpu_torch.train import step
    if kind == "train":
        orig = step.track4d_loss

        def broken(out, frame, pretrain):
            total, items = orig(out, frame, pretrain)
            if fault == "half_batch":
                return total[:total.shape[0] // 2], items
            return total, dict(items, Loss=items["Loss"] * 1.01)
        monkeypatch.setattr(step, "track4d_loss", broken)
        return
    orig_make = step.make_scan_eval_step_cached

    def make(model, mesh=None):
        scan = orig_make(model, mesh)

        def broken(state, frames):
            state, out = scan(state, frames)
            out = {k: v.clone() for k, v in out.items()}
            if fault == "half_batch":
                h = out["cls"].shape[0] // 2
                for v in out.values():
                    v[h:] = v[:h]
            else:
                out["cls"][0, 0, 0] += 0.05
            return state, out
        return broken
    monkeypatch.setattr(step, "make_scan_eval_step_cached", make)


# the faults a cell of the family can have, each planted in the program
# by plant(monkeypatch, kind) (the benchmark's tests: each comes out not
# correct)
FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_batch": lambda mp, kind: _broken_outputs(mp, kind, "half_batch"),
    "answer_altered": lambda mp, kind: _broken_outputs(mp, kind,
                                                       "answer_altered"),
}


def slice_work(cell, pool, j, frames, kind):
    """The kernel work of the slice's frame steps (the first `frames` of
    block j), by layer, from the frames themselves with the reference's
    selections."""
    args = cell.config["model"]
    npoint, exact = args["npoint"], args.get("exact_fps", False)
    split = cell.traffic["n_max"] > SPLIT_ABOVE
    out = {"set_abstraction": [], "cost_volume": []}
    fr = traffic.block(pool, j, cell.traffic["block_frames"])
    with torch.no_grad():
        for s in range(frames):
            f = traffic.frame_at(fr, s)
            pc1 = work.level_clouds(f.pc1, f.mask1, npoint, exact)
            pc2 = work.level_clouds(f.pc2, f.mask2, npoint, exact)
            if kind == "eval":
                # the pc1 head and the embedding head; the cached scan
                # computes the pc2 head at the block's first frame only
                heads = [pc1, pc1] + ([pc2] if s == 0 else [])
                calls, corr = work.sa_eval_calls, (
                    work.corr_split_calls if split else work.corr_eval_calls)
            else:
                heads = [pc1, pc2, pc1]
                calls, corr = work.sa_train_calls, work.corr_train_calls
            for h in heads:
                out["set_abstraction"] += calls(h)
            out["cost_volume"] += corr(f.pc1, f.mask1, f.mask2)
    return out


def flops_per_frame(cell, kind: str) -> int:
    return work.model_flops_per_frame(cell.config["model"],
                                      cell.traffic["n_max"], kind == "train")


def tiny(cell):
    """The cell cut to a size the CPU runs in seconds: two streams,
    4-frame blocks that each start a clip, the check over 3 frames;
    clouds of 128 points (60 static) and 128 centers where the cell's
    centers are its points, else of 256 points (150 static), 64
    farthest-point centers and DBSCAN over the 32 best. Every other
    setting, the limits included, is the cell's."""
    model = cell.config["model"]
    cell.traffic.update(streams=2, block_frames=4, clip_frames=4, clips=2)
    if model["npoint"] == cell.traffic["n_max"]:
        cell.traffic.update(n_max=128, n_static=60)
        model.update(npoint=128)
    else:
        cell.traffic.update(n_max=256, n_static=150)
        model.update(npoint=64, mov_budget=min(model["mov_budget"], 32))
    if "frames" in cell.workload["check"]:
        cell.workload["check"]["frames"] = 3
    return cell
