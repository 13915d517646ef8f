"""Flow decoder: motion classification, embedding propagation, GRU, flow.
Counterpart of `ratrack_tpu/models/decoder.py`. In train mode the
predictors' batch norms count only the valid points of pc1 (mask1,
decoder.py:31-33, 43-44).

Channel flow (fc_inch = 256):
  cls        = ClsPredictor(cor 256) -> (B, N) moving probability
  embeddings = [ft1 (2) | pc1_feats (256) | cor (256)] = 514 -> PNHead -> 128
  gfeat      = masked max over points (128) -> 5-layer GRU(128) -> 128
  flow       = FlowPredictor([prop | gfeat] = 256) -> (B, N, 3)

In bfloat16 (`dtype`) cls, prop and flow are bfloat16; the embeddings and
[prop | gfeat] are float32, as the concatenations promote them in JAX
(ft1 and the GRU output are float32), and the GRU output is float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..trace import span
from .layers import Dense, PointwiseMLP, StackedGRU
from .pnhead import PNHead


def masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over valid rows of (B, N, C) -> (B, C); 0 where no row is valid
    (the NaN guard of track4d.py:34-45)."""
    v = torch.where(mask.unsqueeze(-1), x,
                    torch.full_like(x, float("-inf"))).amax(dim=1)
    return torch.where(mask.any(dim=1, keepdim=True), v,
                       torch.zeros_like(v))


class FlowPredictor(nn.Module):
    """MLP [128, 64, 32] (BN + ReLU) -> Linear(-> 3, no bias)."""

    def __init__(self, c_in: int = 256, mlp: Sequence[int] = (128, 64, 32),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = PointwiseMLP(c_in, mlp, bn=True, dtype=dtype)
        self.out = Dense(mlp[-1], 3, bias=False, dtype=dtype)

    def forward(self, feat, mask=None):
        return self.out(self.mlp(feat, mask))


class ClsPredictor(nn.Module):
    """MLP -> Linear(-> 3, no bias) -> Linear(3 -> 1) -> sigmoid."""

    def __init__(self, c_in: int = 256, mlp: Sequence[int] = (128, 64, 32),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = PointwiseMLP(c_in, mlp, bn=True, dtype=dtype)
        self.conv_out = Dense(mlp[-1], 3, bias=False, dtype=dtype)
        self.linear = Dense(3, 1, dtype=dtype)

    def forward(self, feat, mask=None):
        h = self.linear(self.conv_out(self.mlp(feat, mask)))
        return torch.sigmoid(h)[..., 0]


class FlowDecoder(nn.Module):
    """Reference FlowDecoder.forward split into the per-frame stages
    `pre_gru` / `post_gru` and the serial `gru_apply`."""

    def __init__(self, npoint: int, feat_dim: int = 128, gru_layers: int = 5,
                 exact_fps: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feat_dim = feat_dim
        self.cp = ClsPredictor(dtype=dtype)
        self.mse = PNHead(npoint, 2 + 256 + 256, exact_fps, dtype=dtype)
        self.gru = StackedGRU(feat_dim, gru_layers, dtype=dtype)
        self.fp = FlowPredictor(dtype=dtype)

    @span("decoder")
    def pre_gru(self, pc1, ft1, pc1_feats, cor_feats, mask1):
        """-> (cls (B, N), prop (B, N, 128), gfeat_in (B, 128))."""
        cls = self.cp(cor_feats, mask1)
        emb = torch.cat([ft1, pc1_feats, cor_feats], dim=-1)
        _, prop = self.mse(pc1, emb, mask1)
        return cls, prop, masked_max(prop, mask1)

    @span("decoder")
    def gru_apply(self, gfeat_in, h):
        """(B, 128), (B, layers, 128) -> (B, 128), (B, layers, 128)."""
        return self.gru(gfeat_in, h)

    @span("decoder")
    def post_gru(self, prop, gfeat_out, mask1=None):
        g = gfeat_out.unsqueeze(1).expand(-1, prop.shape[1], -1)
        return self.fp(torch.cat([prop, g], dim=-1), mask1)
