"""The program under test of the test-only family `flow`: a small
scene-flow model after FLOT (arXiv:2007.11142), batched over streams.

Per point a two-layer feature MLP; the cost of a pair is 1 - the cosine
of their features, and pairs farther apart than `max_dist` pay a penalty
that leaves them no mass; an entropic Sinkhorn over the masked (B, N, M)
plan in the log domain; each point of pc1 moves to the plan's mean of
pc2 over its row, and a linear layer refines the flow.
"""

from __future__ import annotations

import math

import torch

FAR = 1e3       # the cost of a pair beyond max_dist


class FlowModel:

    def __init__(self, weights: dict, width: int, sinkhorn_iters: int,
                 epsilon: float, max_dist: float):
        del width
        self.w = weights
        self.iters, self.eps, self.max_dist = (sinkhorn_iters, epsilon,
                                               max_dist)

    def features(self, pc):
        w = self.w
        h = torch.relu(pc @ w["w1"] + w["b1"])
        return torch.nn.functional.normalize(h @ w["w2"] + w["b2"], dim=-1)

    def __call__(self, pc1, pc2, mask1, mask2):
        """(B, N, 3) clouds and (B, N) masks -> the flow (B, N, 3) of
        pc1's points, 0 where mask1 is false."""
        cost = 1.0 - self.features(pc1) @ self.features(pc2).transpose(1, 2)
        cost = cost + FAR * (torch.cdist(pc1, pc2) > self.max_dist)
        ninf = torch.tensor(-math.inf, device=pc1.device)
        logk = torch.where(mask2[:, None, :], -cost / self.eps, ninf)
        a = -torch.log(mask1.sum(-1, keepdim=True).float())
        b = -torch.log(mask2.sum(-1, keepdim=True).float())
        g = torch.zeros_like(b).expand_as(mask2)
        for _ in range(self.iters):
            f = torch.where(mask1, a - torch.logsumexp(
                logk + g[:, None, :], dim=2), ninf)
            g = torch.where(mask2, b - torch.logsumexp(
                logk + f[:, :, None], dim=1), ninf)
        plan = torch.softmax(logk + g[:, None, :], dim=2)
        flow = plan @ pc2 - pc1
        flow = flow + flow @ self.w["wr"] + self.w["br"]
        return torch.where(mask1[..., None], flow, torch.zeros_like(flow))
