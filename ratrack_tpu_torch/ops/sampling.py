"""Identity sampling and row gathers, batched.

Counterpart of `ratrack_tpu/ops/sampling.py` for the path where
npoint == N (the live 512-point config): farthest point sampling then picks
every valid point, and `identity_sample` stands in for it. The JAX
package's TPU gather workarounds (one-hot matmuls, bf16 splits, the
select trick of `identity_gather`) become plain indexed loads here.
"""

from __future__ import annotations

import torch


def first_valid(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B,) index of the first True (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def identity_sample(n: int, npoint: int,
                    mask: torch.Tensor | None = None,
                    batch: int = 1, device=None) -> torch.Tensor:
    """arange(npoint) % n, with slots past the valid count redirected to
    the first valid index (JAX `identity_sample`, :72-85). -> (B, npoint)."""
    if mask is not None:
        batch, device = mask.shape[0], mask.device
    idx = (torch.arange(npoint, device=device) % n).expand(batch, npoint)
    if mask is None:
        return idx
    n_valid = mask.sum(dim=-1, keepdim=True)
    return torch.where(idx < n_valid, idx, first_valid(mask)[:, None])


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather (B, N, C) x (B, M) -> (B, M, C)."""
    return torch.gather(
        points, 1, idx.unsqueeze(-1).expand(-1, -1, points.shape[-1]))


def identity_gather(points: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """gather(points, identity_sample(n, n, mask)): rows past the valid
    count take the first valid point's row."""
    if mask is None:
        return points
    return gather(points, identity_sample(points.shape[1], points.shape[1],
                                          mask))
