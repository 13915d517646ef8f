"""Entry `eval_scan`: `make_scan_eval_step_cached` over (streams, block)
blocks, the path of offline evaluation over many recorded clips.

A block's `KEEP` outputs come back to the host inside the window, as the
eval CLI brings them back. The check compares the first `check.frames`
frames of a block that starts a clip (every stream's first frame carries
new_seq there), drawn from the seed among the window's blocks."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from perfbench import traffic


class Entry:
    kind = "eval"

    def __init__(self, cell, weights, pool, device, mesh=None):
        from ratrack_tpu_torch.data.frames import FrameBatch
        from ratrack_tpu_torch.models.track4d import Track4D
        from ratrack_tpu_torch.tracker.state import init_state
        from ratrack_tpu_torch.train.step import make_scan_eval_step_cached
        wl, args = cell.workload, cell.config["model"]
        mix = cell.traffic
        self.FrameBatch = FrameBatch
        self.pool, self.t = pool, mix["block_frames"]
        self.streams = pool.pc1.shape[0]
        self.blocks_per_clip = mix["clip_frames"] // self.t
        self.check_frames = wl["check"]["frames"]
        self.model = Track4D(**args, device=device)
        self.model.load_state_dict(weights)
        self.scan = make_scan_eval_step_cached(self.model, mesh)
        self.state = init_state(self.streams, args["k_max"],
                                args["gru_layers"], args["feat_dim"],
                                device=device)
        self.kept = {}

    def warm_up(self):
        self.run_block(0)

    def run_block(self, j: int, frames: int | None = None) -> int:
        """Block j, or its first `frames` frames (the traced slice) ->
        the frames completed."""
        fr = traffic.block(self.pool, j, self.t)
        frames = self.t if frames is None else frames
        fr = self.FrameBatch(*[x[:, :frames] for x in fr])
        with record_function("bench.dispatch"):
            state, out = self.scan(self.state, fr)
        with record_function("bench.host_copy"):
            host = {k: v.cpu() for k, v in out.items()}
        with record_function("bench.bookkeeping"):
            self.state = state
            if j % self.blocks_per_clip == 0 and frames == self.t:
                self.kept[j] = {k: v[:, :self.check_frames]
                                for k, v in host.items()}
        return self.streams * frames

    def sample(self, rng):
        """-> (frames (B, F) of the compared block, the program's outputs
        of them), the block drawn by rng among those of the window that
        start a clip."""
        window = [j for j in sorted(self.kept) if j > 0]
        if not window:
            raise RuntimeError("the window completed no block that starts "
                               "a clip: nothing to compare")
        j = window[int(rng.integers(len(window)))]
        fr = traffic.block(self.pool, j, self.t)
        return (traffic.FrameBatch(*[x[:, :self.check_frames] for x in fr]),
                self.kept[j])

    def release(self):
        del self.model, self.scan, self.state
