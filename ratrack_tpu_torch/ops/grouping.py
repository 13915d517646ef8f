"""Group gathers and 3-NN inverse-distance interpolation, batched.

Counterpart of `ratrack_tpu/ops/grouping.py` (and of `group` in its
sampling.py).
"""

from __future__ import annotations

import torch

# operand types of the eval kernels (`compute_dtype`), as the JAX kernels'
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def bf16_operands(compute_dtype: torch.dtype) -> bool:
    """True for bfloat16 operands, False for float32; raises on another
    dtype."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype}: one of "
                         f"{COMPUTE_DTYPES}")
    return compute_dtype == torch.bfloat16


def operand(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """x as a `compute_dtype` operand of a float32-accumulated product
    carries it (the JAX kernels' x.astype(compute_dtype) under
    preferred_element_type=float32): for bfloat16 rounded to bfloat16 and
    held in x's dtype; for float32 x itself (a float64 run stays
    float64)."""
    if not bf16_operands(compute_dtype):
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Group gather (B, N, C) x (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    flat = torch.gather(
        points, 1, idx.reshape(b, m * s, 1).expand(-1, -1, points.shape[-1]))
    return flat.reshape(b, m, s, points.shape[-1])


def three_interpolate_weights(dist: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights 1/(d + 1e-8), normalised over the 3 slots."""
    recip = 1.0 / (dist + 1e-8)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B, M, C) x (B, N, 3) x (B, N, 3) -> (B, N, C)."""
    return torch.sum(group(features, idx) * weight.unsqueeze(-1), dim=2)
