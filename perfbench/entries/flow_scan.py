"""Entry `flow_scan`: FLOT's `make_scan_flow_step_cached` over (streams,
block) blocks, the path of offline scene-flow estimation over recorded
drives.

A block's flow and ot_flow come back to the host inside the window. The
check compares the first `check.frames` frames of a block drawn from the
seed among the window's blocks: FLOT carries no state between frame
pairs beyond the features of pc2, which a block computes at its first
frame, so any block compares from its start."""

from __future__ import annotations

from torch.profiler import record_function

from perfbench import traffic


class Entry:
    kind = "eval"

    def __init__(self, cell, weights, pool, device, mesh=None):
        from ratrack_tpu_torch.data.frames import FrameBatch
        from ratrack_tpu_torch.models.flot import FLOT
        from ratrack_tpu_torch.train import step
        self.FrameBatch = FrameBatch
        self.pool, self.t = pool, cell.traffic["block_frames"]
        self.streams = pool.pc1.shape[0]
        self.check_frames = cell.workload["check"]["frames"]
        self.model = FLOT(**cell.config["model"], device=device)
        self.model.load_state_dict(weights)
        self.scan = step.make_scan_flow_step_cached(self.model)
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
            out = self.scan(fr)
        with record_function("bench.host_copy"):
            host = {k: v.cpu() for k, v in out.items()}
        with record_function("bench.bookkeeping"):
            if frames == self.t:
                self.kept[j] = {k: v[:, :self.check_frames].clone()
                                for k, v in host.items()}
        return self.streams * frames

    def sample(self, rng):
        """-> (frames (B, F) of the compared block, the program's outputs
        of them), the block drawn by rng among those of the window."""
        window = [j for j in sorted(self.kept) if j > 0]
        if not window:
            raise RuntimeError("the window completed no block: nothing to "
                               "compare")
        j = window[int(rng.integers(len(window)))]
        fr = traffic.block(self.pool, j, self.t)
        return (traffic.FrameBatch(*[x[:, :self.check_frames] for x in fr]),
                self.kept[j])

    def release(self):
        del self.model, self.scan
