"""Masked neighborhood queries over padded point clouds, batched.

Counterpart of `ratrack_tpu/ops/neighborhood.py`. Every function takes a
leading stream dimension: points (B, N, 3), masks (B, N). Invalid
(padding) points are excluded through masks, as in the JAX package.

Two distance forms:
  * `square_distance` is the matmul form of the JAX function
    (-2 x.y + |x|^2 + |y|^2, clamped at 0); DBSCAN uses it on 8-d
    clustering features.
  * `point_distance` is the elementwise expanded form the kernels use,
    max((|c|^2 + |x|^2) - 2 (c0 x0 + c1 x1 + c2 x2), 0), one rounded op at a
    time. The CUDA kernels spell the same ops with __fmul_rn/__fadd_rn, so
    the plain versions here select exactly the indices the kernels select.
"""

from __future__ import annotations

import torch

BIG = 1e10


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., N, C) x (..., M, C) -> (..., N, M) squared distances >= 0."""
    d = -2.0 * torch.matmul(src, dst.transpose(-1, -2))
    d = d + torch.sum(src * src, dim=-1, keepdim=True)
    d = d + torch.sum(dst * dst, dim=-1).unsqueeze(-2)
    return torch.clamp_min(d, 0.0)


def _sq_norm3(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def point_distance(query: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M), the kernels' op order."""
    q = query.unsqueeze(-2)                    # (..., N, 1, 3)
    p = points.unsqueeze(-3)                   # (..., 1, M, 3)
    prod = (q[..., 0] * p[..., 0] + q[..., 1] * p[..., 1]
            + q[..., 2] * p[..., 2])
    sq = _sq_norm3(query).unsqueeze(-1) + _sq_norm3(points).unsqueeze(-2)
    return torch.clamp_min(sq - 2.0 * prod, 0.0)


def knn(k: int, query: torch.Tensor, points: torch.Tensor,
        points_mask: torch.Tensor | None = None):
    """k nearest valid `points` of each `query`, ascending, lowest index on
    ties. Fewer than k valid points: trailing slots repeat the nearest
    valid neighbor; no valid point at all: index 0 (JAX `knn`, :182-195).

    Returns (dist2 (B, N, k) float32, idx (B, N, k) int64).
    """
    d = point_distance(query, points)
    if points_mask is not None:
        d = torch.where(points_mask.unsqueeze(-2), d, torch.full_like(d, BIG))
    dist2, idx = torch.sort(d, dim=-1, stable=True)
    dist2, idx = dist2[..., :k], idx[..., :k]
    if points_mask is not None:
        nbr_valid = dist2 < BIG
        fallback = torch.where(nbr_valid[..., :1], idx[..., :1],
                               torch.zeros_like(idx[..., :1]))
        idx = torch.where(nbr_valid, idx, fallback)
        dist2 = torch.where(nbr_valid, dist2,
                            torch.gather(d, -1, fallback).expand_as(dist2))
    return dist2, idx


def ball_query(radius: float, nsample: int, points: torch.Tensor,
               centers: torch.Tensor,
               points_mask: torch.Tensor | None = None, *,
               return_hit: bool = False):
    """First `nsample` valid points with d^2 < r^2 in index order; trailing
    slots repeat the first hit; no hit at all -> index 0 (CUDA
    ball_query_gpu.cu:28-44, JAX `ball_query` :198-234).

    points (B, N, 3), centers (B, M, 3) -> (B, M, nsample) int64
    [, (B, M) bool: the center has a hit, with return_hit].
    """
    n = points.shape[-2]
    hit = point_distance(centers, points) < radius * radius
    if points_mask is not None:
        hit = hit & points_mask.unsqueeze(-2)
    cols = torch.arange(n, device=points.device)
    keys = torch.where(hit, cols, torch.full_like(cols, n))
    first = torch.sort(keys, dim=-1).values[..., :nsample]
    found = first < n
    pad = torch.where(found[..., :1], first[..., :1],
                      torch.zeros_like(first[..., :1]))
    idx = torch.where(found, first, pad)
    return (idx, found[..., 0]) if return_hit else idx


# pairs (N * M per stream) above which `knn_auto` leaves the dense matrix
KNN_DENSE_LIMIT = 4 * 1024 * 1024


def knn_auto(k: int, query: torch.Tensor, points: torch.Tensor,
             points_mask: torch.Tensor | None = None):
    """`knn` by size (JAX `knn_auto`, :297-308): above KNN_DENSE_LIMIT
    pairs the tiled selection (kernel B5, `ops.fused_knn.knn_tiled`), which
    never holds the (N, M) matrix, where its top-k list is deep enough;
    the dense `knn` otherwise. Both select the same indices."""
    from .fused_knn import KERNEL_K_MAX, knn_tiled
    if (query.shape[-2] * points.shape[-2] > KNN_DENSE_LIMIT
            and k <= KERNEL_K_MAX):
        return knn_tiled(k, query, points, points_mask)
    return knn(k, query, points, points_mask)


def three_nn(query: torch.Tensor, points: torch.Tensor,
             points_mask: torch.Tensor | None = None):
    """3 nearest neighbors with euclidean (sqrt) distances; stretch shapes
    route through `knn_auto`."""
    dist2, idx = knn_auto(3, query, points, points_mask)
    return torch.sqrt(dist2), idx
