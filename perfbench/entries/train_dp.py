"""Entry `train_dp`: the train scan of `train_scan` on one shard of the
streams a card, through `ratrack_tpu_torch.parallel.mesh`: rank 0's model
replicated to every rank, and the per-frame all-reduce of the gradients
and the batch norm statistics inside the step.

The check follows every rank's streams: the first three steps' losses
are gathered from the ranks, and the ranks' parameters and statistics,
which must be one model, are held to rank 0's after the window."""

from __future__ import annotations

import torch
import torch.distributed as dist

from perfbench.entries import train_scan


class Entry(train_scan.Entry):

    def __init__(self, cell, weights, pool, device, mesh):
        from ratrack_tpu_torch.parallel.mesh import replicate
        super().__init__(cell, weights, pool, device, mesh)
        self.mesh = mesh
        replicate(mesh, self.ts)

    def sample(self, rng):
        """-> (the shard's frames (the harness takes every stream's), the
        readings, the losses of every stream and the rank gap)."""
        from ratrack_tpu_torch.parallel.mesh import gather_clips
        frames, readings = super().sample(rng)
        loss = gather_clips(self.mesh, readings["loss"].t().to(
            self.mesh.device)).t()
        gap = torch.zeros((), dtype=torch.float64, device=self.mesh.device)
        for t in self.ts.model.state_dict().values():
            ref = t.detach().clone()
            dist.broadcast(ref, src=0, group=self.mesh.group)
            if t.is_floating_point():
                gap = torch.maximum(gap, (t - ref).abs().max().double())
            elif not torch.equal(t, ref):
                gap = torch.full_like(gap, float("inf"))
        dist.all_reduce(gap, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return frames, dict(readings, loss=loss.cpu(), rank_gap=gap.item())
