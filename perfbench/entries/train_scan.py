"""Entry `train_scan`: `make_scan_train_step(create_train_state(...))`
over (streams, block) blocks, one Adam step a frame; with a mesh, one
rank's shard of the streams.

Set-up drives the one train state through the window's own call on the
first block in three calls, frames [0, 1), [1, 3) and [3, block), and
reads what the check needs between them: each step's loss, the first
gradient as Adam took it (its first moment after one step over 1 -
beta1) and every parameter and batch norm statistic after three steps.
A block's loss items come back to the host inside the window."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from perfbench import traffic


class Entry:
    kind = "train"

    def __init__(self, cell, weights, pool, device, mesh=None):
        from ratrack_tpu_torch.data.frames import FrameBatch
        from ratrack_tpu_torch.models.track4d import Track4D
        from ratrack_tpu_torch.tracker.state import init_state
        from ratrack_tpu_torch.train.step import (TrainConfig,
                                                  create_train_state,
                                                  make_scan_train_step)
        wl, args = cell.workload, cell.config["model"]
        opt = dict(cell.config["optimizer"])
        steps = opt.pop("steps_per_epoch")
        self.FrameBatch = FrameBatch
        self.pool, self.t = pool, cell.traffic["block_frames"]
        self.streams = pool.pc1.shape[0]
        self.pretrain = wl["pretrain"]
        model = Track4D(**args, device=device)
        model.load_state_dict(weights)
        self.ts = create_train_state(model, TrainConfig(**opt), steps,
                                     device=device)
        self.scan = make_scan_train_step(self.ts, mesh)
        self.state = init_state(self.streams, args["k_max"],
                                args["gru_layers"], args["feat_dim"],
                                device=device)
        # frames a window block completes, over every rank
        self.frames_per_block = self.t * self.streams * (
            1 if mesh is None else mesh.dp)
        self.readings = {}

    def _steps(self, frames):
        with record_function("bench.dispatch"):
            self.state, items = self.scan(
                self.state, self.FrameBatch(*frames), self.pretrain)
        with record_function("bench.host_copy"):
            return items["Loss"].cpu()

    def warm_up(self):
        fr = traffic.block(self.pool, 0, self.t)

        def span(a, b):
            return [x[:, a:b] for x in fr]
        model, opt = self.ts.model, self.ts.optimizer
        losses = [self._steps(span(0, 1))]
        beta1 = opt.param_groups[0]["betas"][0]
        # a parameter that the optimizer did not step has no moment
        grad = {n: opt.state[p].get("exp_avg", torch.zeros_like(p))
                / (1.0 - beta1) for n, p in model.named_parameters()}
        losses.append(self._steps(span(1, 3)))
        after = {n: t.detach().clone()
                 for n, t in model.state_dict().items()}
        self._steps(span(3, self.t))
        self.readings = dict(loss=torch.cat(losses), grad=grad, after=after)

    def run_block(self, j: int, frames: int | None = None) -> int:
        """Block j, or its first `frames` frames (the traced slice) ->
        the frames completed over every rank."""
        frames = self.t if frames is None else frames
        self._steps([x[:, :frames]
                     for x in traffic.block(self.pool, j, self.t)])
        return self.frames_per_block * frames // self.t

    def sample(self, rng):
        """-> (the first block's frames (B, 3): the steps the check
        follows, the program's readings of them)."""
        del rng
        fr = traffic.block(self.pool, 0, self.t)
        return traffic.FrameBatch(*[x[:, :3] for x in fr]), self.readings

    def release(self):
        del self.ts, self.scan, self.state
