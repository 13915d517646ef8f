"""Online serving: a stateful multi-stream radar tracking service.

Counterpart of `ratrack_tpu/serve.py`, same names and semantics:

  * `max_streams` independent input streams (vehicles, sensors), each with
    its own recurrent state (GRU h, track slots, id counter) held on the
    model's device;
  * `submit(stream, scan)` stages one raw radar scan; `step()` runs one
    batched model step for every staged stream, over the smallest
    power-of-two bucket that covers them (`last_bucket`);
  * `track(stream, scan)` = submit + step for one stream at low latency;
  * raw scans in, tracks out: padding, masking and frame pairing happen
    here; no GT and no files.

The previous scan of a stream is paired on the host (pc1 = the new scan,
pc2 = the previous one, the reference's (t+1, t) order); the first scan of
a stream returns None. Streams with nothing staged are inactive in a step:
their state is selected back unchanged, byte for byte, so irregular
producers cannot disturb each other. The step is the uncached model step
(both heads every frame, as the JAX service's), under `torch.no_grad()`.

Transfers: one packed upload and one packed download a step. The upload
is one float32 buffer [B x N x 12 cloud lanes | B x 2 flags | B stream
slots bitcast from int32], staged in pinned host memory and copied without
blocking; the download is one float32 buffer [warp | cls | conf | labels
and track ids bitcast from int32] followed by the step's only
synchronisation. The full (max_streams, ...) state is updated in place
(`index_copy_`); JAX's functional scatter has no counterpart to keep.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .data.frames import FrameBatch
from .tracker.state import TrackState, init_state

LANES = 12   # pc1 3 | pc2 3 | ft1 2 | ft2 2 | mask1 | mask2


class TrackOutput(NamedTuple):
    """Per-frame tracking result for one stream (host numpy)."""
    labels: np.ndarray          # (N,) per-point cluster slot, -1 noise/static
    point_track_id: np.ndarray  # (N,) persistent track id per point, -1
    track_id: np.ndarray        # (K,) persistent id per object slot, -1
    conf: np.ndarray            # (K,) association confidence per slot
    moving: np.ndarray          # (N,) bool moving-point mask
    flow: np.ndarray            # (N, 3) scene flow per point
    n_points: int               # valid points in the padded cloud
    n_objects: int              # live object slots


def _check_scan(scan) -> np.ndarray:
    scan = np.asarray(scan, np.float32)
    if scan.ndim != 2 or scan.shape[1] < 5:
        raise ValueError(f"scan must be (M, >=5) [x y z RCS v_r ...]; got "
                         f"{scan.shape}")
    return scan


class RadarTracker:
    """Multi-stream online tracker over the batched Track4D step.

    `model` is a `Track4D` in eval mode; the service runs on the device
    that holds its parameters. Thread-safe staging; one model step per
    `step()` over all staged streams."""

    def __init__(self, model, n_max: int = 512, max_streams: int = 8):
        if model.training:
            raise ValueError("serving needs the model in eval mode")
        self.model = model
        self.n_max = n_max
        self.k_max = model.k_max
        self.max_streams = max_streams
        self.device = next(model.parameters()).device
        self.last_bucket = 0
        self._lock = threading.Lock()
        self._states = init_state(max_streams, model.k_max, model.gru_layers,
                                  model.feat_dim, device=self.device)
        self._open: List[bool] = [False] * max_streams
        self._prev: List[Optional[np.ndarray]] = [None] * max_streams
        self._staged: List[Optional[np.ndarray]] = [None] * max_streams
        self._fresh: List[bool] = [False] * max_streams   # new_seq pending
        self._buffers: Dict[int, tuple] = {}   # bucket -> (upload, download)

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_root: str, name: str = "last", *,
                        device=None, **kw):
        """Serve the model of a train checkpoint (`train/checkpoint.py`):
        `cfg` a `config.Config`, the weights from <ckpt_root>/<name>.pt."""
        from .models.track4d import model_from_config
        from .train.checkpoint import restore_model
        model = restore_model(ckpt_root, name,
                              model_from_config(cfg, device=device))
        return cls(model, n_max=cfg.n_max, **kw)

    # -- stream lifecycle --------------------------------------------------
    def open_stream(self) -> int:
        """Allocate a stream slot; the next pair on it resets its state."""
        with self._lock:
            for sid in range(self.max_streams):
                if not self._open[sid]:
                    self._open[sid] = True
                    self._prev[sid] = None
                    self._staged[sid] = None
                    self._fresh[sid] = True
                    return sid
        raise RuntimeError(f"all {self.max_streams} stream slots busy")

    def close_stream(self, sid: int) -> None:
        with self._lock:
            self._check(sid)
            self._open[sid] = False
            self._prev[sid] = None
            self._staged[sid] = None

    def _check(self, sid: int) -> None:
        if not (0 <= sid < self.max_streams and self._open[sid]):
            raise KeyError(f"stream {sid} is not open")

    # -- data path ---------------------------------------------------------
    def _pad_scan(self, scan: np.ndarray, lanes: np.ndarray, pc: int,
                  ft: int, mask: int) -> int:
        """Write an (M, >=5) scan [x y z RCS v_r ...] into the lane columns
        of one (n_max, LANES) row block; an over-budget scan keeps its
        first n_max points. Returns the points kept."""
        m = min(scan.shape[0], self.n_max)
        lanes[:m, pc:pc + 3] = scan[:m, :3]
        lanes[:m, ft:ft + 2] = scan[:m, 3:5]
        lanes[:m, mask] = 1.0
        return m

    def submit(self, sid: int, scan: np.ndarray) -> bool:
        """Stage one scan on a stream. Returns True when a frame pair is
        ready for the next step() (False for the stream's first scan)."""
        with self._lock:
            return self._submit_locked(sid, scan)

    def _submit_locked(self, sid: int, scan: np.ndarray) -> bool:
        self._check(sid)
        if self._staged[sid] is not None:
            raise RuntimeError(
                f"stream {sid} already has a staged scan; call step()")
        scan = _check_scan(scan)
        if self._prev[sid] is None:
            self._prev[sid] = scan
            return False
        self._staged[sid] = scan
        return True

    def step(self) -> Dict[int, TrackOutput]:
        """One model step over every stream with a staged pair."""
        with self._lock:
            return self._step_locked()

    def _bucket_buffers(self, b: int):
        """Host staging buffers of bucket b (pinned where the model is on
        a card), made once per bucket size."""
        if b not in self._buffers:
            n, k = self.n_max, self.k_max
            pin = self.device.type == "cuda"
            up = torch.zeros(b * n * LANES + 3 * b, pin_memory=pin)
            down = torch.zeros((b, 5 * n + 2 * k), pin_memory=pin)
            self._buffers[b] = (up, down)
        return self._buffers[b]

    @torch.no_grad()
    def _device_step(self, up: torch.Tensor, b: int) -> torch.Tensor:
        """Unpack the upload, run the model over the bucket's streams,
        write their states back, pack the download (b, 5 N + 2 K)."""
        n = self.n_max
        packed = up[:b * n * LANES].view(b, n, LANES)
        flags = up[b * n * LANES:b * n * LANES + 2 * b].view(b, 2)
        sids = up[b * n * LANES + 2 * b:].view(torch.int32).long()
        zb3 = torch.zeros((b, n, 3), device=up.device)
        none = torch.zeros((b, n), dtype=torch.bool, device=up.device)
        i32 = dict(dtype=torch.int32, device=up.device)
        frame = FrameBatch(
            pc1=packed[..., 0:3].contiguous(),
            pc2=packed[..., 3:6].contiguous(),
            ft1=packed[..., 6:8].contiguous(),
            ft2=packed[..., 8:10].contiguous(),
            mask1=packed[..., 10] > 0.5, mask2=packed[..., 11] > 0.5,
            pc1_comp=zb3, gt_cls=none, gt_flow=zb3,
            gt_dense=torch.full((b, n), -1, **i32),
            gt_label_ids=torch.full((b, self.k_max), -1, **i32),
            gt_valid=torch.zeros((b, self.k_max), dtype=torch.bool,
                                 device=up.device),
            new_seq=flags[:, 1] > 0.5,
            frame_number=torch.zeros((b,), **i32))
        active = flags[:, 0] > 0.5
        states = TrackState(*[x.index_select(0, sids) for x in self._states])
        outs, new_states = self.model(frame, states)
        for full, new, old in zip(self._states, new_states, states):
            sel = active.reshape((-1,) + (1,) * (new.dim() - 1))
            # inactive rows keep their state byte for byte; padding rows
            # carry distinct un-staged slots, so the write-back is exact
            full.index_copy_(0, sids, torch.where(sel, new.to(old.dtype),
                                                  old))
        ints = torch.cat([outs["labels"].to(torch.int32),
                          outs["track_id"].to(torch.int32)], dim=1)
        return torch.cat([outs["warp"].reshape(b, -1), outs["cls"],
                          outs["conf"],
                          ints.contiguous().view(torch.float32)], dim=1)

    def _step_locked(self) -> Dict[int, TrackOutput]:
        staged = [(sid, self._staged[sid]) for sid in range(self.max_streams)
                  if self._staged[sid] is not None]
        if not staged:
            return {}
        n, k = self.n_max, self.k_max
        # smallest power-of-two bucket covering the staged streams: a lone
        # producer runs a one-stream step, not a max_streams one
        b = 1
        while b < len(staged):
            b *= 2
        b = min(b, self.max_streams)
        self.last_bucket = b
        sids = [sid for sid, _ in staged]
        pad_pool = [s for s in range(self.max_streams) if s not in sids]
        sids_full = sids + pad_pool[:b - len(sids)]

        up, down = self._bucket_buffers(b)
        host = up.numpy()
        host[:] = 0.0
        lanes = host[:b * n * LANES].reshape(b, n, LANES)
        flags = host[b * n * LANES:b * n * LANES + 2 * b].reshape(b, 2)
        host[b * n * LANES + 2 * b:].view(np.int32)[:] = sids_full
        n_pts = []
        for row, (sid, scan) in enumerate(staged):
            n_pts.append(self._pad_scan(scan, lanes[row], 0, 6, 10))
            self._pad_scan(self._prev[sid], lanes[row], 3, 8, 11)
            flags[row] = (1.0, float(self._fresh[sid]))

        out = self._device_step(up.to(self.device, non_blocking=True), b)
        if self.device.type == "cuda":
            down.copy_(out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            out = down
        out = out.numpy()
        warp = out[:, :3 * n].reshape(b, n, 3)
        cls = out[:, 3 * n:4 * n]
        conf_all = out[:, 4 * n:4 * n + k]
        ints = out[:, 4 * n + k:].view(np.int32)
        labels_all, tid_all = ints[:, :n], ints[:, n:n + k]

        results: Dict[int, TrackOutput] = {}
        for row, (sid, scan) in enumerate(staged):
            labels, tid = labels_all[row].copy(), tid_all[row].copy()
            pt_tid = np.where(labels >= 0, tid[np.clip(labels, 0, k - 1)],
                              -1)
            results[sid] = TrackOutput(
                labels=labels,
                point_track_id=pt_tid.astype(np.int32),
                track_id=tid,
                conf=conf_all[row].copy(),
                moving=(cls[row] > self.model.mov_thres)
                & (np.arange(n) < n_pts[row]),
                flow=warp[row] - lanes[row, :, 0:3],
                n_points=n_pts[row],
                n_objects=int(np.sum(tid >= 0)))
            self._prev[sid] = scan
            self._staged[sid] = None
            self._fresh[sid] = False
        return results

    def track(self, sid: int, scan: np.ndarray) -> Optional[TrackOutput]:
        """Low-latency single-stream convenience: submit + step.

        Returns None for the stream's first scan (no pair yet). Holds one
        critical section across submit and step, so a concurrent caller's
        step() cannot drain this stream's pair from under it. The step
        still drains every other staged stream too: with several producers
        prefer a coordinator that submits for all of them and then calls
        one step(), so that no staged result is dropped here."""
        with self._lock:
            if not self._submit_locked(sid, scan):
                return None
            return self._step_locked()[sid]
