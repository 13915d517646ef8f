"""The plain reference of FLOT (Puy, Boulch, Marlet, ECCV 2020,
arXiv:2007.11142; github.com/valeoai/FLOT): its forward pass in float32
torch, one stream and one frame pair at a time, from a state dict with the
port's parameter names (models/flot.py). It imports nothing of either
package, holds no kernel, cache or batching, and builds each stream's
dense n x m plan whole.

Departures from the published code, each noted where it is made:
  - the kNN graph's squared distance is FLOT's expanded form spelled one
    rounded elementwise op at a time, max((|q|^2 + |x|^2) - 2 (q0 x0 +
    q1 x1 + q2 x2), 0), and equal distances go to the lowest index (FLOT:
    the same form through a batched product and an argsort, whose ties
    are unspecified), so that every implementation selects the same
    neighbours;
  - the 10 m support's squared distance is the difference form ((dx dx +
    dy dy) + dz dz, FLOT: the expanded form through a batched product),
    exact to a rounding, so every implementation decides the boundary
    alike;
  - the 1x1 convolutions are products with (out, in) weights, the same
    arithmetic as FLOT's Conv2d(in, out, 1);
  - recalled, not read from the code (no copy of FLOT is in the
    repository): the SetConv's three layers with the 2c middle width, and
    nb_iter = 1 of the published commands.
"""

from __future__ import annotations

import torch

NORM_EPS = 1e-5
SLOPE = 0.1


def tf32_off() -> None:
    """Float32 products: TF32 off for both of torch's switches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def knn_graph(pc: torch.Tensor, k: int) -> torch.Tensor:
    """pc (n, 3) -> idx (n, k), the k nearest points of each, itself
    included, ascending, ties to the lowest index."""
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    sq = x * x + y * y + z * z
    prod = (x[:, None] * x[None, :] + y[:, None] * y[None, :]
            + z[:, None] * z[None, :])
    d = torch.clamp_min((sq[:, None] + sq[None, :]) - 2.0 * prod, 0.0)
    return torch.sort(d, dim=-1, stable=True).indices[:, :k]


def set_conv(w: dict, name: str, signal: torch.Tensor, pc: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """SetConv `name` on one cloud: signal (n, c_in), pc (n, 3), idx (n,
    k) -> (n, c)."""
    x = torch.cat([signal[idx], pc[idx] - pc[:, None, :]], dim=-1)
    for layer in (1, 2, 3):
        x = torch.matmul(x, w[f"{name}.fc{layer}.weight"].T)
        mean = x.mean(dim=(0, 1))
        var = ((x - mean) ** 2).mean(dim=(0, 1))
        x = ((x - mean) / torch.sqrt(var + NORM_EPS)
             * w[f"{name}.bn{layer}.weight"] + w[f"{name}.bn{layer}.bias"])
        x = torch.nn.functional.leaky_relu(x, SLOPE)
    return x.max(dim=1).values


def features(w: dict, prefix: str, signal, pc, idx) -> torch.Tensor:
    for i in (1, 2, 3):
        signal = set_conv(w, f"{prefix}{i}", signal, pc, idx)
    return signal


def transport_flow(f1, f2, p1, p2, eps, gamma, iters: int,
                   support: float) -> torch.Tensor:
    """FLOT's ot.sinkhorn and the flow of its plan on one frame pair:
    features (n, C), (m, C), clouds (n, 3), (m, 3) -> ot_flow (n, 3)."""
    f1 = f1 / torch.sqrt(torch.sum(f1 ** 2, -1, keepdim=True) + 1e-8)
    f2 = f2 / torch.sqrt(torch.sum(f2 ** 2, -1, keepdim=True) + 1e-8)
    dx = p1[:, None, 0] - p2[None, :, 0]
    dy = p1[:, None, 1] - p2[None, :, 1]
    dz = p1[:, None, 2] - p2[None, :, 2]
    near = (dx * dx + dy * dy + dz * dz < support ** 2).to(f1.dtype)
    cost = 1.0 - torch.matmul(f1, f2.T)
    kmat = torch.exp(-cost / eps) * near
    power = gamma / (gamma + eps)
    n, m = kmat.shape
    a = torch.ones(n, 1, dtype=f1.dtype, device=f1.device) / n
    prob1 = torch.ones(n, 1, dtype=f1.dtype, device=f1.device) / n
    prob2 = torch.ones(m, 1, dtype=f1.dtype, device=f1.device) / m
    for _ in range(iters):
        b = (prob2 / (torch.matmul(kmat.T, a) + 1e-8)) ** power
        a = (prob1 / (torch.matmul(kmat, b) + 1e-8)) ** power
    plan = a * kmat * b.T
    return (torch.matmul(plan, p2) / (plan.sum(-1, keepdim=True) + 1e-8)
            - p1)


def frame(w: dict, p1, p2, model: dict) -> dict:
    """One frame pair of one stream: p1 (n, 3), p2 (m, 3) -> {"flow",
    "ot_flow"} (n, 3). model: nb_neighbors, nb_iter, support_m."""
    tf32_off()
    k = model["nb_neighbors"]
    idx1, idx2 = knn_graph(p1, k), knn_graph(p2, k)
    f1 = features(w, "feat_conv", p1, p1, idx1)
    f2 = features(w, "feat_conv", p2, p2, idx2)
    eps = torch.exp(w["epsilon"]) + 0.03
    ot_flow = transport_flow(f1, f2, p1, p2, eps, torch.exp(w["gamma"]),
                             model["nb_iter"], model["support_m"])
    x = features(w, "ref_conv", ot_flow, p1, idx1)
    flow = ot_flow + torch.matmul(x, w["fc.weight"].T) + w["fc.bias"]
    return {"flow": flow, "ot_flow": ot_flow}
