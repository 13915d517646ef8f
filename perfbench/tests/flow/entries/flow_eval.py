"""Entry `flow_eval` of the test-only family `flow`: the program's model
(../program.py) over (streams, block) blocks, frame by frame. The check
compares the first `check.frames` frames of a block drawn from the seed
among the window's blocks."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from perfbench import traffic


class Entry:
    kind = "eval"

    def __init__(self, cell, weights, pool, device, mesh=None):
        from perfbench.tests.flow.program import FlowModel
        self.model = FlowModel(weights, **cell.config["model"])
        self.pool, self.t = pool, cell.traffic["block_frames"]
        self.streams = pool.pc1.shape[0]
        self.check_frames = cell.workload["check"]["frames"]
        self.kept = {}

    def warm_up(self):
        self.run_block(0)

    def run_block(self, j: int, frames: int | None = None) -> int:
        fr = traffic.block(self.pool, j, self.t)
        frames = self.t if frames is None else frames
        with record_function("bench.dispatch"), torch.no_grad():
            flow = torch.stack([self.model(fr.pc1[:, s], fr.pc2[:, s],
                                           fr.mask1[:, s], fr.mask2[:, s])
                                for s in range(frames)], dim=1)
        if frames == self.t:
            self.kept[j] = flow[:, :self.check_frames].cpu()
        return self.streams * frames

    def sample(self, rng):
        window = [j for j in sorted(self.kept) if j > 0]
        if not window:
            raise RuntimeError("the window completed no block: nothing to "
                               "compare")
        j = window[int(rng.integers(len(window)))]
        fr = traffic.block(self.pool, j, self.t)
        return (traffic.FrameBatch(*[x[:, :self.check_frames] for x in fr]),
                {"flow": self.kept[j]})

    def release(self):
        del self.model
