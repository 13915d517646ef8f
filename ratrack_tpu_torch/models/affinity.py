"""Affinity MLP over object-descriptor differences: Linear chain
141 -> 564 -> 282 -> 70 -> 35 -> 1 with ReLU, sigmoid output.
Counterpart of `ratrack_tpu/models/affinity.py`; computes in `dtype`
(layers.Dense)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Dense


class Affinity(nn.Module):
    def __init__(self, emb_dims: int = 141,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        e = emb_dims
        dims = [e, e * 4, e * 2, e // 2, e // 4]
        for i in range(4):
            self.add_module(f"dense_{i}",
                            Dense(dims[i], dims[i + 1], dtype=dtype))
        self.dense_out = Dense(dims[-1], 1, dtype=dtype)

    def forward(self, diff: torch.Tensor) -> torch.Tensor:
        """diff (..., 141) -> (...,) affinity in (0, 1)."""
        x = diff
        for i in range(4):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
        return torch.sigmoid(self.dense_out(x))[..., 0]
