"""Core building blocks: masked batch norm, pointwise MLPs, WeightNet, GRU
stack. Counterpart of `ratrack_tpu/models/layers.py`.

Parameter names mirror the flax tree (`dense_0.weight`, `bn_0.running_mean`,
`cell_0.ih.weight`, ...) so `utils/convert.py` is a flatten plus a Dense
kernel transpose. Linear weights are torch's (out, in); the kernels take
the x @ W layout (in, out), which `PointwiseMLP.folded` and the modules
that call kernels produce.

Batch norm in train mode (`self.training`) takes its moments PER STREAM:
the JAX train step vmaps the model over clip streams (train/step.py:88-100),
so a (B, ..., C) tensor reduces over every axis but B and C. The running
statistics then take the mean over streams of the per-stream updates
(step.py:98-99).

Compute dtype (`dtype`, float32 or bfloat16), as the flax modules' `dtype`
(layers.py:64, :89-91, :116, :147-148, :165-166): parameters stay
float32; a `Dense` casts its input, weight and bias to `dtype`, rounds the
product to `dtype` and then adds the bias in `dtype` (flax's two roundings);
batch norm computes in float32 and returns `dtype`. With dtype float32
nothing is cast: every op is the float32 module's, and a module converted
to float64 (the CPU yardsticks) computes in float64.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_sa import fold_bn_params


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A kernel's output in the module's compute dtype (the JAX modules'
    out.astype(self.dtype)): cast for bfloat16; with float32 x keeps its
    dtype, so a float64 run stays float64."""
    return x if dtype == torch.float32 else x.to(dtype)


class Dense(nn.Linear):
    """nn.Linear that computes in `dtype` (flax `Dense(dtype=)`): float32
    parameters, input and weight cast to `dtype`, the product rounded to
    `dtype`, then the bias added in `dtype`. float32 is nn.Linear itself."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:    # the parameters' dtype (float64 runs too)
            return super().forward(x)
        y = x.to(dt) @ self.weight.to(dt).t()
        return y if self.bias is None else y + self.bias.to(dt)


class MaskedBatchNorm(nn.Module):
    """Batch norm over the channel axis with an optional validity mask.

    Eval: running statistics. Train: per-stream masked moments (count
    max(sum(mask), 1); the variance two-pass, mean((x - mu)^2), which is
    the JAX max(E[x^2] - mu^2, 0) without its cancellation) normalise the
    input, and the running statistics move by momentum 0.1 towards them,
    with the unbiased factor count / max(count - 1, 1) on the variance."""

    MOMENTUM = 0.1

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, ..., C), mask (B, ...) bool or None; computed in at least
        float32, returned in the module's dtype (bfloat16) or x's."""
        out_dtype = x.dtype if self.dtype == torch.float32 else self.dtype
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            red = tuple(range(1, x.dim() - 1))
            shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
            if mask is None:
                count = torch.full((x.shape[0],), float(x[0, ..., 0].numel()),
                                   device=x.device)
                mean = x.mean(dim=red)
                var = torch.square(x - mean.reshape(shape)).mean(dim=red)
            else:
                m = mask.to(x.dtype).unsqueeze(-1)
                count = torch.clamp_min(m.sum(dim=red)[:, 0], 1.0)
                mean = (x * m).sum(dim=red) / count[:, None]
                var = (torch.square(x - mean.reshape(shape)) * m).sum(
                    dim=red) / count[:, None]
            self.update_running_stats(mean, var, count)
            mean, var = mean.reshape(shape), var.reshape(shape)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * inv + self.bias).to(out_dtype)

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor,
                             count) -> None:
        """Running averages from per-stream batch statistics mean, var
        (B, C) over count rows (a number or a (B,) tensor): the mean over
        streams of the per-stream momentum updates. The torch form of the
        JAX module's `override_stats` (layers.py:52-62), which a train
        kernel that computes the statistics itself feeds."""
        count = torch.as_tensor(count, dtype=torch.float32,
                                device=mean.device)
        count = count.reshape(-1, 1) if count.dim() else count
        unbias = count / torch.clamp_min(count - 1.0, 1.0)
        mo = self.MOMENTUM
        self.running_mean.copy_(((1 - mo) * self.running_mean
                                 + mo * mean.detach()).mean(dim=0))
        self.running_var.copy_(((1 - mo) * self.running_var
                                + mo * var.detach() * unbias).mean(dim=0))


class PointwiseMLP(nn.Module):
    """Stack of Linear (+BN) (+act) over the channel axis (reference
    SharedMLP: Conv2d 1x1 without bias when BN follows, BN, ReLU)."""

    def __init__(self, in_dim: int, features: Sequence[int], bn: bool = True,
                 act: str = "relu", last_act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if act not in ("relu", "leaky_relu"):
            raise ValueError(f"unknown activation {act!r}")
        self.features = tuple(features)
        self.bn, self.act, self.last_act = bn, act, last_act
        prev = in_dim
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", Dense(prev, f, bias=not bn,
                                                dtype=dtype))
            if bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(f, dtype=dtype))
            prev = f

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, ..., C_in); mask (B, ...) selects the rows that count in
        the train-mode batch statistics (None: every row)."""
        n_layers = len(self.features)
        for i in range(n_layers):
            x = getattr(self, f"dense_{i}")(x)
            if self.bn:
                x = getattr(self, f"bn_{i}")(x, mask)
            if self.last_act or i < n_layers - 1:
                x = (torch.relu(x) if self.act == "relu"
                     else F.leaky_relu(x, 0.1))
        return x

    def train_params(self):
        """([W (in, out)], [BN weight], [BN bias]) per layer for the train
        kernel, which computes the batch statistics itself."""
        layers = range(len(self.features))
        return ([getattr(self, f"dense_{i}").weight.t().contiguous()
                 for i in layers],
                [getattr(self, f"bn_{i}").weight for i in layers],
                [getattr(self, f"bn_{i}").bias for i in layers])

    def update_running_stats(self, means, variances, count) -> None:
        """Each batch norm's running averages from per-stream (B, C)
        statistics a train kernel returned (see MaskedBatchNorm)."""
        for i, (mu, var) in enumerate(zip(means, variances)):
            getattr(self, f"bn_{i}").update_running_stats(mu, var, count)

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

    def __init__(self, out_dim: int, hidden: Sequence[int] = (8, 8),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense_0 = Dense(3, hidden[0], dtype=dtype)
        self.dense_1 = Dense(hidden[0], hidden[1], dtype=dtype)
        self.dense_out = Dense(hidden[1], out_dim, dtype=dtype)

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
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), h' = (1 - z) n + z h.
    The gates run in `dtype`; h' takes the dtype (1 - z) n and z h promote
    to, float32 where h is float32 (layers.py:165-172)."""

    def __init__(self, in_dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ih = Dense(in_dim, 3 * hidden, dtype=dtype)
        self.hh = Dense(hidden, 3 * hidden, dtype=dtype)

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

    def __init__(self, hidden: int, num_layers: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for layer in range(num_layers):
            self.add_module(f"cell_{layer}",
                            GRUCell(hidden, hidden, dtype=dtype))

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
