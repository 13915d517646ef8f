"""Training / evaluation CLI.

Usage (the JAX package's `python -m ratrack_tpu.main`, on the same
configs; the reference's `python main.py --config configs.yaml`,
src/main.py:153-169):

    python -m ratrack_tpu_torch.main --config configs/default.yaml
    python -m ratrack_tpu_torch.main --config configs/eval.yaml
    python -m ratrack_tpu_torch.main --config configs/smoke.yaml --cpu

Counterpart of `ratrack_tpu/main.py`, behaviour for behaviour: the
checkpoint tree checkpoints/<exp>/models with last / last<ep> / best (here
`<name>.pt` files of train/checkpoint.py), tee logging to run.log,
pretrain gating, loss_history.csv, per-epoch seg / flow metric means, the
cleared results tree and per-frame result export in eval, the BEV PNG of
each eval frame under `vis_dir` (utils/vis.py, matplotlib on the host,
from the host copies the loop makes anyway), and the MOT table after it.

Port-side choices: the CLI runs on the card (`default_device()`, which
raises where there is none) unless `--cpu` is given; `cfg.dp` streams are
the batch dimension on that one device (no mesh); `profile_dir` records a
torch.profiler trace of the run. Each block's loss items and each chunk's
outputs reach the host in one transfer, after the block, so no frame of a
block waits for the host. `main` returns what `_run` measured (frames/s
per epoch, the eval's metric means and MOT metrics).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import time
from typing import Dict, List

import numpy as np
import torch


class Tee:
    """Print + append to run.log (reference IOStream, main.py:18-28)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.f = open(path, "a")

    def print(self, text: str):
        print(text)
        self.f.write(text + "\n")
        self.f.flush()


class _SynthStream:
    """Synthetic-dataset stand-in with the VodTrackStream interface.

    cfg.synth_clips clips of cfg.synth_frames frames; train clips use
    seeds [0, n) and the val split uses disjoint seeds [n, n + n//2).
    """

    def __init__(self, cfg, clips=None, split="train"):
        self.cfg = cfg
        if clips is not None:
            self.clips = clips
        elif split == "train":
            self.clips = [f"synth_{i}" for i in range(cfg.synth_clips)]
        else:
            self.clips = [f"synth_{i}" for i in
                          range(cfg.synth_clips,
                                cfg.synth_clips + max(1,
                                                      cfg.synth_clips // 2))]
        self.skipped = []

    def __len__(self):
        return len(self.clips) * self.cfg.synth_frames

    def __iter__(self):
        from .data.synthetic import synthetic_clip
        for clip in self.clips:
            ci = int(clip.split("_")[1])
            # static-clutter density scales with the pad budget so the
            # stretch configs actually fill their clouds
            n_static = min(self.cfg.n_max - 64,
                           max(60, self.cfg.n_max * 3 // 5))
            for rec in synthetic_clip(
                    ci, self.cfg.synth_frames, n_max=self.cfg.n_max,
                    g_max=self.cfg.g_max, n_static=n_static):
                yield clip, rec


def _build_stream(cfg, split):
    if cfg.dataset == "vod":
        from .data.pipeline import VodTrackStream
        return VodTrackStream(cfg, split=split)
    if cfg.dataset == "synthetic":
        return _SynthStream(cfg, split=split)
    raise ValueError(f"dataset not supported: {cfg.dataset}")


def _stream_factory(cfg, split):
    """(make_stream, clips, per-clip record-count estimates) for batching."""
    if cfg.dataset == "vod":
        from .data.pipeline import VodTrackStream
        base = VodTrackStream(cfg, split=split)
        lengths = [max(0, len(base.clip_frames(c)) - 1) for c in base.clips]
        return (lambda clips: VodTrackStream(cfg, split=split, clips=clips),
                list(base.clips), lengths)
    if cfg.dataset == "synthetic":
        base = _SynthStream(cfg, split=split)
        return (lambda clips: _SynthStream(cfg, clips=clips),
                list(base.clips), [cfg.synth_frames] * len(base.clips))
    raise ValueError(f"dataset not supported: {cfg.dataset}")


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {name: numpy array} with one wait for the device:
    every copy is queued without blocking, then the stream is waited on
    once. bfloat16 outputs (a bfloat16 model's cls, flow, conf) arrive as
    float32, which holds them exactly."""
    host = {k: v.detach().to("cpu", non_blocking=True)
            for k, v in tensors.items()}
    devices = {v.device for v in tensors.values() if v.is_cuda}
    for d in devices:
        torch.cuda.current_stream(d).synchronize()
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in host.items()}


def _timed(iterable, waited: List[float]):
    """Yield from `iterable`, adding the seconds spent waiting for each
    item to waited[0]: around a Prefetcher, the consumer's wait on the
    data pipeline; inside it, the host time that building the items
    took on the producer thread."""
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        waited[0] += time.perf_counter() - t0
        yield item


def _stats(frames: int, seconds: float, waited: float,
           built: float) -> Dict[str, float]:
    """An epoch's numbers: frames, seconds, frames/s, the seconds the loop
    waited for the data pipeline and those the pipeline spent building
    the records (overlapped with the device where a Prefetcher runs)."""
    return {"frames": frames, "seconds": seconds,
            "fps": frames / max(seconds, 1e-9), "data_wait_s": waited,
            "data_build_s": built}


def _score_frame(cfg, clip, rec, o, seg_tot, flow_tot, results_dir):
    """One eval frame's metrics into the running sums, and its result file
    (JAX main.py:200-214, :293-307)."""
    from .eval.export import format_frame_results, write_frame_results
    from .train.metrics import eval_motion_seg, eval_scene_flow

    valid = np.asarray(rec.mask1)
    seg = eval_motion_seg((o["cls"] > cfg.mov_thres).astype(float),
                          np.asarray(rec.gt_cls).astype(float), valid)
    flow = eval_scene_flow(np.asarray(rec.pc1), o["warp"],
                           np.asarray(rec.gt_flow), o["cls"], valid)
    for k, v in seg.items():
        seg_tot[k] = seg_tot.get(k, 0.0) + v
    for k, v in flow.items():
        flow_tot[k] = flow_tot.get(k, 0.0) + v
    if results_dir is not None:
        text = format_frame_results(o["labels"], o["track_id"], o["conf"],
                                    int(o["n"]), np.asarray(rec.pc1))
        write_frame_results(results_dir, clip, int(rec.frame_number), text)


def _render_frame(cfg, clip, rec, o, flow):
    """One eval frame's BEV picture, cfg.vis_dir/<clip>/<frame:05d>.png
    (JAX main.py:215-222, :308-319), from the host copies `o` of the
    frame's outputs."""
    from .utils.vis import plot_frame_bev
    fn = int(rec.frame_number)
    plot_frame_bev(os.path.join(cfg.vis_dir, clip, f"{fn:05d}.png"),
                   np.asarray(rec.pc1), np.asarray(rec.mask1), o["cls"],
                   o["labels"], o["track_id"], flow, cfg.mov_thres,
                   title=f"{clip} frame {fn}")


def run_train_epoch_batched(cfg, ts, scan_train, split, ep: int, log: Tee,
                            device):
    """One epoch of dp x scan_frames training (JAX main.py:101).

    Clips are balance-partitioned into cfg.dp parallel streams, the batch
    dimension on one device; each block runs scan_frames sequential
    per-frame optimizer steps over all streams at once
    (train/step.py::make_scan_train_step). Returns (ts, epoch means,
    `_stats`)."""
    from .data.frames import to_tensors
    from .data.pipeline import (Prefetcher, batched_blocks,
                                split_clips_balanced)
    from .tracker.state import init_state

    make_stream, clips, lengths = _stream_factory(cfg, split)
    groups = split_clips_balanced(clips, lengths, cfg.dp)
    group_lengths = [sum(lengths[clips.index(c)] for c in g) if g else 0
                     for g in groups]
    t = max(1, cfg.scan_frames)
    pretrain = ep < cfg.pretrain_epochs
    tstates = init_state(cfg.dp, cfg.k_max, cfg.gru_layers, cfg.feat_dim,
                         device=device)

    totals: Dict[str, float] = {}
    count = 0
    waited, built = [0.0], [0.0]
    t0 = time.time()
    blocks = Prefetcher(_timed(batched_blocks(make_stream, groups,
                                              group_lengths, t, cfg.n_max,
                                              cfg.g_max), built),
                        depth=cfg.prefetch_depth)
    for block in _timed(blocks, waited):
        tstates, items = scan_train(tstates, to_tensors(block, device),
                                    pretrain)
        count += t * cfg.dp
        for k, v in _to_host(items).items():            # (T, B) each
            totals[k] = totals.get(k, 0.0) + float(
                np.sum(np.mean(v, axis=1))) / t
    stats = _stats(count, time.time() - t0, waited[0], built[0])
    mean_items = {k: totals[k] / max(count // (t * cfg.dp), 1)
                  for k in sorted(totals)}
    log.print(f"[train/batched] epoch {ep}: {count} frame-steps in "
              f"{stats['seconds']:.1f}s ({stats['fps']:.1f} fps) "
              + " ".join(f"{k}={v:.4f}" for k, v in mean_items.items())
              + f" data wait {waited[0]:.2f}s")
    return ts, mean_items, stats


def run_epoch(cfg, model, ts, step_fns, stream, mode: str, ep: int,
              log: Tee, device, results_dir: str | None = None):
    """One per-frame pass over the stream (JAX main.py:157). Returns
    (ts, mean items, seg means, flow means, `_stats`)."""
    from .data.frames import FrameBatch, to_tensors
    from .tracker.state import init_state
    from .train.losses import track4d_loss
    from .train.step import KEEP

    train_step, eval_step = step_fns
    pretrain = ep < cfg.pretrain_epochs
    tstate = init_state(1, cfg.k_max, cfg.gru_layers, cfg.feat_dim,
                        device=device)
    totals: Dict[str, float] = {}
    seg_tot: Dict[str, float] = {}
    flow_tot: Dict[str, float] = {}
    count = 0
    waited = [0.0]
    t0 = time.time()
    for clip, rec in _timed(stream, waited):
        frame = to_tensors(FrameBatch(*[np.asarray(x)[None] for x in rec]),
                           device)
        if mode == "train":
            tstate, items = train_step(tstate, frame, pretrain)
            host = _to_host(items)
        else:
            with torch.inference_mode():
                out, tstate = eval_step(tstate, frame)
                _, items = track4d_loss(out, frame, pretrain)
            keep = KEEP + ("flow",) if cfg.vis_dir else KEEP
            host = _to_host({**items, **{k: out[k][0] for k in keep}})
        count += 1
        for k in sorted(items):
            totals[k] = totals.get(k, 0.0) + float(np.mean(host[k]))
        if mode != "train":
            _score_frame(cfg, clip, rec, host, seg_tot, flow_tot,
                         results_dir)
            if cfg.vis_dir:
                _render_frame(cfg, clip, rec, host, host["flow"])

    stats = _stats(count, time.time() - t0, waited[0], waited[0])
    mean_items = {k: v / max(count, 1) for k, v in totals.items()}
    seg_m = {k: v / max(count, 1) for k, v in seg_tot.items()}
    flow_m = {k: v / max(count, 1) for k, v in flow_tot.items()}
    log.print(f"[{mode}] epoch {ep}: {count} frames in "
              f"{stats['seconds']:.1f}s ({stats['fps']:.1f} fps) "
              + " ".join(f"{k}={v:.4f}" for k, v in mean_items.items()))
    if seg_m:
        log.print(f"segmentation: {seg_m}")
        log.print(f"scene flow: {flow_m}")
    if stream.skipped:
        log.print(f"skipped {len(stream.skipped)} frames: "
                  f"{stream.skipped[:5]}...")
    return ts, mean_items, seg_m, flow_m, stats


def run_eval_epoch_scan(cfg, model, stream, log: Tee, device,
                        results_dir: str | None):
    """Scan-fused eval: T frames per call, per-clip sequential (JAX
    main.py:240).

    Chunks of cfg.scan_frames records per clip run through
    make_scan_eval_step_cached where `chain_contiguous` holds for the
    chunk's real records, else make_scan_eval_step; the tail chunk pads by
    repeating its last record (padded outputs are discarded; the next
    clip's first record carries new_seq=True, which resets the state
    inside the model). Exports and metrics happen on the host after each
    chunk. Returns (seg means, flow means, `_stats` with the count of
    chunks and of those that took the cached scan)."""
    from .data.frames import FrameBatch, to_tensors
    from .data.pipeline import Prefetcher
    from .data.synthetic import stack_frames
    from .tracker.state import init_state
    from .train.step import (KEEP, chain_contiguous, make_scan_eval_step,
                             make_scan_eval_step_cached)

    scan_eval = make_scan_eval_step(model)
    scan_eval_cached = make_scan_eval_step_cached(model)
    t = max(1, cfg.scan_frames)
    tstate = init_state(1, cfg.k_max, cfg.gru_layers, cfg.feat_dim,
                        device=device)
    seg_tot: Dict[str, float] = {}
    flow_tot: Dict[str, float] = {}
    count = 0
    chunks = {"chunks": 0, "cached_chunks": 0}
    waited, built = [0.0], [0.0]
    t0 = time.time()

    def flush(clip, chunk, tstate):
        nonlocal count
        real = len(chunk)
        contiguous = chain_contiguous(
            [int(r.frame_number) for r in chunk],
            [bool(r.new_seq) for r in chunk])
        chunk = chunk + [chunk[-1]] * (t - real)        # tail repeat-pad
        block = FrameBatch(*[x[None] for x in stack_frames(chunk)])
        step_fn = scan_eval_cached if contiguous else scan_eval
        chunks["chunks"] += 1
        chunks["cached_chunks"] += int(contiguous)
        tstate, outs = step_fn(tstate, to_tensors(block, device))
        outs = _to_host({k: outs[k][0] for k in KEEP})
        for i in range(real):
            o = {k: v[i] for k, v in outs.items()}
            _score_frame(cfg, clip, chunk[i], o, seg_tot, flow_tot,
                         results_dir)
            if cfg.vis_dir:
                # the scan returns warp, not flow (JAX main.py:308-319)
                _render_frame(cfg, clip, chunk[i], o,
                              o["warp"] - np.asarray(chunk[i].pc1))
            count += 1
        return tstate

    cur_clip, chunk = None, []
    for clip, rec in _timed(Prefetcher(_timed(stream, built),
                                       depth=cfg.prefetch_depth), waited):
        if clip != cur_clip and chunk:
            tstate = flush(cur_clip, chunk, tstate)
            chunk = []
        cur_clip = clip
        chunk.append(rec)
        if len(chunk) == t:
            tstate = flush(cur_clip, chunk, tstate)
            chunk = []
    if chunk:
        flush(cur_clip, chunk, tstate)

    stats = {**_stats(count, time.time() - t0, waited[0], built[0]),
             **chunks}
    seg_m = {k: v / max(count, 1) for k, v in seg_tot.items()}
    flow_m = {k: v / max(count, 1) for k, v in flow_tot.items()}
    log.print(f"[eval/scan] {count} frames in {stats['seconds']:.1f}s "
              f"({stats['fps']:.1f} fps)")
    log.print(f"segmentation: {seg_m}")
    log.print(f"scene flow: {flow_m}")
    return seg_m, flow_m, stats


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="RaTrack PyTorch train / eval CLI")
    parser.add_argument("--config", type=str, default="configs/default.yaml")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA device; "
                             "without one the CLI raises)")
    args = parser.parse_args(argv)

    from .config import load_config
    from .device import default_device
    cfg = load_config(args.config)
    device = torch.device("cpu") if args.cpu else default_device()

    exp_dir = os.path.join(cfg.checkpoints_dir, cfg.exp_name)
    models_dir = os.path.join(exp_dir, "models")
    os.makedirs(models_dir, exist_ok=True)
    log = Tee(os.path.join(exp_dir, "run.log"))
    log.print(str(cfg))
    log.print(f"device: {device}" + (
        f" ({torch.cuda.get_device_name(device)})"
        if device.type == "cuda" else ""))

    profiler = contextlib.nullcontext()
    if cfg.profile_dir:
        # torch.profiler trace of the whole run (chrome://tracing,
        # Perfetto); the reference has no profiling story at all
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        log.print(f"profiling to {cfg.profile_dir}")
    try:
        with profiler:
            return _run(cfg, log, models_dir, exp_dir, device)
    finally:
        if cfg.profile_dir:
            os.makedirs(cfg.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(cfg.profile_dir, "trace.json"))


def _restore(cfg, log, models_dir, model, ts):
    """The checkpoint resolution of JAX main.py:405-433: `continue_model`
    resumes `last`; in eval, or with `load_checkpoint`, `model_path` (or
    `best`) names a checkpoint of models_dir or a `.t7` / `.pt` file. A
    `.pt` file that holds a train checkpoint of this package restores as
    one; any other goes through the reference-checkpoint loader. In eval
    only the model's weights are restored."""
    from .train import checkpoint as ckpt
    from .utils.convert import load_reference_checkpoint

    def restore(root, name):
        if ts is None:
            ckpt.restore_model(root, name, model)
        else:
            ckpt.restore_train_state(root, name, ts)

    if cfg.continue_model and ckpt.latest_exists(models_dir, "last"):
        restore(models_dir, "last")
        log.print("restored checkpoint: last")
        return
    if not (cfg.eval or cfg.load_checkpoint):
        return
    name = cfg.model_path or "best"
    if name.endswith((".t7", ".pt")) and os.path.isfile(name):
        if name.endswith(".pt") and ckpt.is_train_checkpoint(name):
            path = os.path.abspath(name)
            restore(os.path.dirname(path), os.path.basename(path)[:-3])
            log.print(f"restored checkpoint: {name}")
            return
        # the reference's own eval flow points model_path at a torch .t7
        # file (src/models/model.py:28-37, configs_eval.yaml)
        sd, leftover = load_reference_checkpoint(name)
        own = model.state_dict()
        if set(sd) == set(own) and all(sd[k].shape == own[k].shape
                                       for k in sd):
            model.load_state_dict(sd)
            log.print(f"converted reference checkpoint: {name} "
                      f"({len(leftover)} dead-module keys ignored)")
        else:
            log.print(f"WARNING: reference checkpoint '{name}' does "
                      "not match the model, using fresh init")
    elif ckpt.latest_exists(models_dir, name):
        restore(models_dir, name)
        log.print(f"restored checkpoint: {name}")
    else:
        log.print(f"WARNING: checkpoint '{name}' not found, "
                  "using fresh init")


def _run(cfg, log, models_dir, exp_dir, device):
    np.random.seed(cfg.seed)

    from .models import model_from_config
    from .train import checkpoint as ckpt
    from .train.step import (create_train_state, make_eval_step,
                             make_scan_train_step, make_train_step)

    model = model_from_config(
        cfg, generator=torch.Generator().manual_seed(cfg.seed),
        device=device)
    stream = _build_stream(cfg, "val" if cfg.eval else "train")
    steps_per_epoch = len(stream)
    # in batched mode one optimizer step covers dp frames, so the LR
    # schedule's per-epoch transition count shrinks accordingly
    opt_steps_per_epoch = max(1, steps_per_epoch // max(1, cfg.dp))
    ts = None if cfg.eval else create_train_state(
        model, cfg, opt_steps_per_epoch, device=device)
    _restore(cfg, log, models_dir, model, ts)

    if cfg.eval:
        # a fresh eval owns its results tree: stale files from previous
        # runs would silently mix into the MOT scoring below
        if cfg.results_dir and os.path.isdir(cfg.results_dir):
            shutil.rmtree(cfg.results_dir)
            log.print(f"cleared previous results at {cfg.results_dir}")
        if cfg.scan_frames > 0:
            seg_m, flow_m, stats = run_eval_epoch_scan(
                cfg, model, stream, log, device, cfg.results_dir)
        else:
            _, _, seg_m, flow_m, stats = run_epoch(
                cfg, model, None, (None, make_eval_step(model)), stream,
                "eval", 10 ** 6, log, device,
                results_dir=cfg.results_dir)
        # offline MOT scoring over the exported results
        from .eval.run import (evaluate_results, evaluate_results_stream,
                               format_table)
        if cfg.dataset == "vod":
            m = evaluate_results(cfg.results_dir, cfg.dataset_path,
                                 split="val",
                                 min_obj_points=cfg.min_obj_points)
        else:
            m = evaluate_results_stream(_build_stream(cfg, "val"),
                                        cfg.results_dir)
        log.print(format_table(m))
        log.print("FINISH")
        return {"eval": {**stats, "seg": seg_m, "flow": flow_m, "mot": m}}

    batched = cfg.dp > 1 or cfg.scan_frames > 0
    if batched:
        scan_train = make_scan_train_step(ts)
        if cfg.dp > 1:
            log.print(f"dp={cfg.dp} streams: the batch dimension on one "
                      f"{device.type} device (no mesh)")
    step_fns = (make_train_step(ts), None)

    best = np.inf
    history: List[Dict[str, float]] = []
    epochs = []
    for ep in range(cfg.epochs):
        if batched:
            ts, items, stats = run_train_epoch_batched(
                cfg, ts, scan_train, "train", ep, log, device)
        else:
            stream = _build_stream(cfg, "train")
            ts, items, _, _, stats = run_epoch(cfg, model, ts, step_fns,
                                               stream, "train", ep, log,
                                               device)
        history.append(items)
        epochs.append({**stats, **items})
        ckpt.save_train_state(models_dir, "last", ts)
        ckpt.save_train_state(models_dir, f"last{ep}", ts)
        if items["Loss"] <= best:
            best = items["Loss"]
            ckpt.save_train_state(models_dir, "best", ts)
            log.print(f"best train loss till now: {best:.6f}")
        with open(os.path.join(exp_dir, "loss_history.csv"), "w") as f:
            keys = list(history[0])
            f.write(",".join(["epoch"] + keys) + "\n")
            for i, h in enumerate(history):
                f.write(",".join([str(i)] + [f"{h[k]:.6f}" for k in keys])
                        + "\n")
    log.print("FINISH")
    return {"train": epochs}


if __name__ == "__main__":
    main()
