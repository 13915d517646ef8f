"""FLOT: scene flow between two point clouds guided by optimal transport
(Puy, Boulch, Marlet, ECCV 2020, arXiv:2007.11142; github.com/valeoai/FLOT),
batched over streams. The JAX package has no counterpart.

Per cloud a kNN graph (`nb_neighbors` = 32, the point itself included)
whose edges carry p_j - p_i. A SetConv(c_in -> c) takes each edge's
[f_j, p_j - p_i] through three 1x1 layers without bias (c_in + 3 -> c ->
2c -> c), each followed by an affine instance norm (per stream and
channel over all n k edges, eps 1e-5, biased variance) and LeakyReLU(0.1),
then a max over the k neighbours. The feature net g is SetConv(3 -> 32),
SetConv(32 -> 64), SetConv(64 -> 128) on the coordinates; the transport
(`tracker.sinkhorn.unbalanced_transport_flow`: cost 1 - the normalised
features' products, no mass beyond `support_m` metres, `nb_iter`
unbalanced Sinkhorn iterations with eps = exp(epsilon) + 0.03 and gamma =
exp(gamma)) gives ot_flow, and the refinement adds
Linear(128 -> 3)(SetConv(64 -> 128)(SetConv(32 -> 64)(SetConv(3 -> 32)(
ot_flow)))) on pc1's graph. The parameter names are FLOT's (feat_conv*,
ref_conv*, fc, epsilon, gamma; a SetConv's fc1-3 and bn1-3), its 1x1
convolutions held as Linear weights (out, in).

The products and instance norms run as torch ops (float32; the port
leaves TF32 off); the graph goes through `ops.neighborhood.knn_auto`
(kernel B5 at k = 32 above 4 M pairs), the transport through kernel B11
on the card. Clouds hold exactly n valid points, as FLOT samples them: a
mask with an invalid point raises. The module is built for eval
(requires_grad off); FLOT's training is not ported.

Spans (trace.py): `graph`, `setconv` (the feature net), `transport` and
`refine` partition a frame step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.neighborhood import knn_auto
from ..trace import span
from ..tracker.sinkhorn import unbalanced_transport_flow
from .layers import init_parameters

NORM_EPS = 1e-5
SLOPE = 0.1
WIDTHS = (32, 64, 128)     # the SetConvs' output widths (n = 32, 2n, 4n)


class Graph(NamedTuple):
    """A cloud's kNN graph: `flat` (B n k,) the neighbours' rows of the
    (B n, C) flattened cloud, `offsets` (B, n, k, 3) p_j - p_i."""
    flat: torch.Tensor
    offsets: torch.Tensor


class InstanceNorm(nn.Module):
    """The affine parameters of one instance norm (InstanceNorm2d(c,
    affine=True) in FLOT)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, E, c) -> LeakyReLU(0.1) of the affine instance norm over
        the E edges of each stream and channel: the statistics in one
        pass, then x s + (bias - mean s) with s = weight / sqrt(var +
        eps), one pass that writes, and the activation in place."""
        var, mean = torch.var_mean(x, dim=1, correction=0, keepdim=True)
        scale = self.weight / torch.sqrt(var + NORM_EPS)
        y = torch.addcmul(self.bias - mean * scale, x, scale)
        return F.leaky_relu_(y, SLOPE)


class SetConv(nn.Module):
    def __init__(self, c_in: int, c: int):
        super().__init__()
        self.fc1 = nn.Linear(c_in + 3, c, bias=False)
        self.bn1 = InstanceNorm(c)
        self.fc2 = nn.Linear(c, 2 * c, bias=False)
        self.bn2 = InstanceNorm(2 * c)
        self.fc3 = nn.Linear(2 * c, c, bias=False)
        self.bn3 = InstanceNorm(c)

    def forward(self, signal: torch.Tensor, graph: Graph) -> torch.Tensor:
        """signal (B, n, c_in) on the graph's points -> (B, n, c)."""
        b, n, k, _ = graph.offsets.shape
        nbr = signal.reshape(b * n, -1).index_select(0, graph.flat)
        x = torch.cat([nbr.reshape(b, n * k, -1),
                       graph.offsets.reshape(b, n * k, 3)], dim=-1)
        for fc, bn in ((self.fc1, self.bn1), (self.fc2, self.bn2),
                       (self.fc3, self.bn3)):
            x = bn(F.linear(x, fc.weight))
        return x.reshape(b, n, k, -1).amax(dim=2)


def _set_convs(c_in: int) -> nn.ModuleList:
    widths = (c_in,) + WIDTHS
    return nn.ModuleList(SetConv(a, c) for a, c in zip(widths[:-1],
                                                        widths[1:]))


class FLOT(nn.Module):
    def __init__(self, nb_neighbors: int = 32, nb_iter: int = 1,
                 support_m: float = 10.0,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if nb_iter < 1:
            raise ValueError(f"nb_iter={nb_iter}: FLOT runs at least one "
                             f"Sinkhorn iteration")
        device = resolve_device(device)
        self.nb_neighbors, self.nb_iter = nb_neighbors, nb_iter
        self.support_m = support_m
        self.feat_conv1, self.feat_conv2, self.feat_conv3 = _set_convs(3)
        self.ref_conv1, self.ref_conv2, self.ref_conv3 = _set_convs(3)
        self.fc = nn.Linear(WIDTHS[-1], 3)
        self.epsilon = nn.Parameter(torch.zeros(1))
        self.gamma = nn.Parameter(torch.zeros(1))
        if generator is not None:
            init_parameters(self, generator)
        self.requires_grad_(False)
        self.eval()
        self.to(device)

    @span("graph")
    def graph(self, pc: torch.Tensor) -> Graph:
        """pc (B, n, 3) -> its kNN graph, nb_neighbors a point, the point
        itself first unless another lies on it with a lower index."""
        b, n, _ = pc.shape
        _, idx = knn_auto(self.nb_neighbors, pc, pc)
        base = torch.arange(b, device=pc.device).reshape(b, 1, 1) * n
        flat = (idx + base).reshape(-1)
        nbr = pc.reshape(b * n, 3).index_select(0, flat)
        return Graph(flat, nbr.reshape(b, n, -1, 3) - pc.unsqueeze(2))

    @span("setconv")
    def features(self, pc: torch.Tensor, graph: Graph) -> torch.Tensor:
        """The feature net g: (B, n, 3) -> (B, n, 128)."""
        x = self.feat_conv1(pc, graph)
        x = self.feat_conv2(x, graph)
        return self.feat_conv3(x, graph)

    def transport(self, f1, f2, pc1, pc2) -> torch.Tensor:
        """ot_flow (B, n, 3) of pc1's points from the features of both."""
        eps = torch.exp(self.epsilon) + 0.03
        return unbalanced_transport_flow(f1, f2, pc1, pc2, eps,
                                         torch.exp(self.gamma), self.nb_iter,
                                         self.support_m)

    @span("refine")
    def refine(self, flow: torch.Tensor, graph: Graph) -> torch.Tensor:
        x = self.ref_conv1(flow, graph)
        x = self.ref_conv2(x, graph)
        x = self.ref_conv3(x, graph)
        return flow + self.fc(x)

    @staticmethod
    def check_full(*masks) -> None:
        """Raise unless every point of every mask is valid (one host sync)."""
        if not all(bool(m.all()) for m in masks):
            raise ValueError("FLOT takes clouds of exactly n valid points; "
                             "a mask holds an invalid point")

    def forward(self, pc1, pc2, mask1=None, mask2=None):
        """One frame pair, both clouds' features: (B, n, 3), (B, m, 3) ->
        {"flow", "ot_flow"} (B, n, 3)."""
        self.check_full(*[m for m in (mask1, mask2) if m is not None])
        graph = self.graph(pc1)
        f1 = self.features(pc1, graph)
        f2 = self.features(pc2, self.graph(pc2))
        ot_flow = self.transport(f1, f2, pc1, pc2)
        return {"flow": self.refine(ot_flow, graph), "ot_flow": ot_flow}
