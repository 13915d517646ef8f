"""Morton (Z-order) spatial sort, batched over streams.

Counterpart of `ratrack_tpu/ops/morton.py`. The split correlator sorts
both clouds along a Z-curve before the tiled kNN (kernel B5), so that a
tile of queries and a chunk of candidates are each spatially compact;
per-row results do not depend on the order, only kNN ties do (they go to
the lowest SORTED index).

Coordinates are clipped to +-`extent` metres and quantised to 10 bits an
axis, a 30-bit code. All of it is integer arithmetic on the same float32
products, so codes and permutations equal the JAX functions' element for
element.
"""

from __future__ import annotations

import torch

INVALID_KEY = 0x7FFFFFFF


def _spread10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 v: bit i -> bit 3i."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_code(xyz: torch.Tensor, extent: float = 512.0) -> torch.Tensor:
    """(..., N, 3) float coordinates -> (..., N) int32 30-bit Z-order codes."""
    q = torch.clamp((xyz.to(torch.float32) + extent)
                    * (1024.0 / (2.0 * extent)), 0.0, 1023.0)
    q = q.to(torch.int32)
    return ((_spread10(q[..., 0]) << 2) | (_spread10(q[..., 1]) << 1)
            | _spread10(q[..., 2]))


def morton_perm(xyz: torch.Tensor, mask: torch.Tensor | None = None,
                extent: float = 512.0) -> torch.Tensor:
    """(B, N, 3) -> (B, N) int64 `perm`: gathering rows by it orders each
    stream along the Z-curve, masked-out rows last. A stable sort, so equal
    codes keep their index order (as `jnp.argsort`)."""
    key = morton_code(xyz, extent)
    if mask is not None:
        key = torch.where(mask, key, torch.full_like(key, INVALID_KEY))
    return torch.sort(key, dim=-1, stable=True).indices


def invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[b, perm[b, i]] = i (the unsort gather indices)."""
    ar = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, ar)
