"""Core building blocks: eval-mode batch norm, pointwise MLPs, WeightNet,
GRU stack. Counterpart of `ratrack_tpu/models/layers.py`.

Parameter names mirror the flax tree (`dense_0.weight`, `bn_0.running_mean`,
`cell_0.ih.weight`, ...) so `utils/convert.py` is a flatten plus a Dense
kernel transpose. Linear weights are torch's (out, in); the kernels take
the x @ W layout (in, out), which `PointwiseMLP.folded` and the modules
that call kernels produce.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_sa import fold_bn_params


class MaskedBatchNorm(nn.Module):
    """Batch norm over the channel axis with running statistics (eval).

    The JAX module's train mode (masked batch moments, running-stat
    updates, override_stats) waits for the train-path port.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * inv + self.bias


class PointwiseMLP(nn.Module):
    """Stack of Linear (+BN) (+act) over the channel axis (reference
    SharedMLP: Conv2d 1x1 without bias when BN follows, BN, ReLU)."""

    def __init__(self, in_dim: int, features: Sequence[int], bn: bool = True,
                 act: str = "relu", last_act: bool = True):
        super().__init__()
        if act not in ("relu", "leaky_relu"):
            raise ValueError(f"unknown activation {act!r}")
        self.features = tuple(features)
        self.bn, self.act, self.last_act = bn, act, last_act
        prev = in_dim
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", nn.Linear(prev, f, bias=not bn))
            if bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(f))
            prev = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_layers = len(self.features)
        for i in range(n_layers):
            x = getattr(self, f"dense_{i}")(x)
            if self.bn:
                x = getattr(self, f"bn_{i}")(x)
            if self.last_act or i < n_layers - 1:
                x = (torch.relu(x) if self.act == "relu"
                     else F.leaky_relu(x, 0.1))
        return x

    def folded(self):
        """BN folded into the weights: ([W (in, out)], [b]) per layer, so
        relu(BN(x @ W)) == relu(x @ W' + b')."""
        if not self.bn:
            raise ValueError("folding needs batch norm layers")
        layers = range(len(self.features))
        dense = [getattr(self, f"dense_{i}") for i in layers]
        bns = [getattr(self, f"bn_{i}") for i in layers]
        return fold_bn_params([d.weight.t() for d in dense],
                              [b.weight for b in bns], [b.bias for b in bns],
                              [b.running_mean for b in bns],
                              [b.running_var for b in bns],
                              eps=bns[0].eps)


class WeightNet(nn.Module):
    """Direction -> aggregation weights: 3 -> 8 -> 8 -> out, ReLU after
    every layer (reference WeightNet, bn=False)."""

    def __init__(self, out_dim: int, hidden: Sequence[int] = (8, 8)):
        super().__init__()
        self.dense_0 = nn.Linear(3, hidden[0])
        self.dense_1 = nn.Linear(hidden[0], hidden[1])
        self.dense_out = nn.Linear(hidden[1], out_dim)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        d = torch.relu(self.dense_0(d))
        d = torch.relu(self.dense_1(d))
        return torch.relu(self.dense_out(d))

    def kernel_params(self):
        """([W (in, out)] x 3, [b] x 3) for the correlator kernel."""
        layers = (self.dense_0, self.dense_1, self.dense_out)
        return ([lay.weight.t().contiguous() for lay in layers],
                [lay.bias for lay in layers])


class GRUCell(nn.Module):
    """GRU cell with torch gate order r | z | n:
    r = sig(W_ir x + b_ir + W_hr h + b_hr), z likewise,
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), h' = (1 - z) n + z h."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.ih = nn.Linear(in_dim, 3 * hidden)
        self.hh = nn.Linear(hidden, 3 * hidden)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = self.ih(x).chunk(3, dim=-1)
        h_r, h_z, h_n = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class StackedGRU(nn.Module):
    """`num_layers` stacked GRU cells for one time step (reference
    nn.GRU(128, 128, num_layers=5) driven with seq_len=1)."""

    def __init__(self, hidden: int, num_layers: int = 5):
        super().__init__()
        self.num_layers = num_layers
        for layer in range(num_layers):
            self.add_module(f"cell_{layer}", GRUCell(hidden, hidden))

    def forward(self, x: torch.Tensor, h: torch.Tensor):
        """x (B, H), h (B, layers, H) -> (top output (B, H), h')."""
        outs = []
        inp = x
        for layer in range(self.num_layers):
            inp = getattr(self, f"cell_{layer}")(inp, h[:, layer])
            outs.append(inp)
        return inp, torch.stack(outs, dim=1)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: Linear weights N(0, 1/fan_in) (flax's lecun scale),
    biases 0, batch norm at identity statistics. Everything is drawn from
    `generator`, so a seed gives the same weights on every machine."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Linear):
                w = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(w / mod.weight.shape[1] ** 0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, MaskedBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
