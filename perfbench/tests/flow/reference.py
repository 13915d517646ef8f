"""The plain reference of the test-only family `flow`: the model of
program.py, one stream and one frame at a time over its valid points
alone (no masks), from the benchmark's weights. Imports nothing of the
program."""

from __future__ import annotations

import torch


def features(w, pc):
    h = torch.relu(pc @ w["w1"] + w["b1"])
    f = h @ w["w2"] + w["b2"]
    return f / f.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def frame_flow(w, p1, p2, iters, eps, max_dist):
    """(n, 3) and (m, 3) valid points -> the flow (n, 3) of p1's."""
    cost = 1.0 - features(w, p1) @ features(w, p2).T
    far = ((p1[:, None, :] - p2[None, :, :]) ** 2).sum(-1) > max_dist ** 2
    logk = -(cost + 1e3 * far) / eps
    a = -torch.log(torch.tensor(float(len(p1))))
    b = -torch.log(torch.tensor(float(len(p2))))
    g = torch.zeros(len(p2), dtype=p1.dtype, device=p1.device)
    for _ in range(iters):
        f = a - torch.logsumexp(logk + g[None, :], dim=1)
        g = b - torch.logsumexp(logk + f[:, None], dim=0)
    plan = torch.softmax(logk + g[None, :], dim=1)
    flow = plan @ p2 - p1
    return flow + flow @ w["wr"] + w["br"]


def flow(w: dict, frames, model: dict) -> torch.Tensor:
    """frames (B, F, ...) -> the flow (B, F, N, 3) on the host, 0 at
    points that are not valid."""
    b_, f_, n = frames.mask1.shape
    out = torch.zeros(b_, f_, n, 3)
    for b in range(b_):
        for t in range(f_):
            m1, m2 = frames.mask1[b, t], frames.mask2[b, t]
            out[b, t, m1.cpu()] = frame_flow(
                w, frames.pc1[b, t][m1], frames.pc2[b, t][m2],
                model["sinkhorn_iters"], model["epsilon"],
                model["max_dist"]).cpu()
    return out
