"""Tiled k-nearest-neighbour selection for large clouds: kernel B5 and its
plain twin.

Replaces `ratrack_tpu/ops/pallas_knn.py::_knn_kernel` (`knn_indices_tiled`,
`knn_tiled`). The CUDA kernel is `csrc/knn_tiled.cu`; its header says what
bounds it on the H100 and how its design answers that. Neither version
holds the (N, M) distance matrix in device memory.

  knn_indices_tiled            the kernel wrapper: CUDA tensors launch the
                               kernel (or raise), CPU tensors take
  knn_indices_tiled_reference  the plain version, a chunk of queries at a
                               time;
  knn_tiled                    (dist2, idx) like `ops.neighborhood.knn`.

Selection rules, both versions: the k nearest valid candidates of each
query in ascending order of the kernels' expanded-form distance
(`ops.neighborhood.point_distance`), equal distances to the lowest index;
slots past the valid count keep the key -1e10 and repeat the nearest valid
index (index 0 with no valid candidate), the first-hit padding of
`ops.neighborhood.knn`. Range contract of the JAX function: every valid
pair has d^2 < 5e9, so a slot is valid iff its key is above -5e9.
"""

from __future__ import annotations

import torch

from ..kernels import build as kb
from .neighborhood import BIG, point_distance

KERNEL_K_MAX = 32        # csrc/knn_tiled.cu keeps a top-32 per query
HALF_WARP_K_MAX = 16     # k up to this on half a warp a query, beyond on a warp
# Launch shapes of csrc/knn_tiled.cu: queries a block and candidates a
# chunk (the defaults read off `kernels/tune.py --knn`); a list deeper than
# HALF_WARP_K_MAX is built at 8 queries a block only
KERNEL_QUERIES = (8, 16, 32)
KERNEL_CHUNKS = (128, 256, 512)
KERNEL_SHAPE = (8, 256)
REFERENCE_CHUNK = 1024   # queries a step in the plain version


def knn_indices_tiled_reference(query, points, points_mask=None, *, k: int):
    """Plain version -> (idx (B, N, k) int64, keys (B, N, k) float32 = -d^2
    or -1e10, valid (B, N, k) bool).

    Ties must go to the lowest index, which `torch.topk` does not promise:
    the float32 distance (>= +0, so its bit pattern orders as the value)
    and the candidate's index are packed into one int64 key, all distinct,
    and the k smallest keys are taken. (Float64 clouds, a CPU yardstick's,
    take a stable sort of the distances instead.)"""
    b, n, m = query.shape[0], query.shape[1], points.shape[1]
    if k > m:
        raise ValueError(f"k={k} exceeds the {m} candidates")
    ar = torch.arange(m, device=query.device, dtype=torch.int64)
    idx_out, d_out = [], []
    for q0 in range(0, n, REFERENCE_CHUNK):
        d = point_distance(query[:, q0:q0 + REFERENCE_CHUNK], points) + 0.0
        if points_mask is not None:
            d = torch.where(points_mask.unsqueeze(1), d,
                            torch.full_like(d, BIG))
        if d.dtype != torch.float32:
            top_d, top_i = torch.sort(d, dim=-1, stable=True)
            idx_out.append(top_i[..., :k])
            d_out.append(top_d[..., :k])
            continue
        packed = (d.contiguous().view(torch.int32).to(torch.int64) << 32) | ar
        top = torch.topk(packed, k, dim=-1, largest=False, sorted=True).values
        idx_out.append(top & 0xFFFFFFFF)
        d_out.append((top >> 32).to(torch.int32).view(torch.float32))
    idx, d = torch.cat(idx_out, dim=1), torch.cat(d_out, dim=1)
    valid = d < BIG
    keys = torch.where(valid, -d, torch.full_like(d, -BIG))
    fallback = torch.where(valid[..., :1], idx[..., :1],
                           torch.zeros_like(idx[..., :1]))
    return torch.where(valid, idx, fallback), keys, valid


def knn_indices_tiled(query, points, points_mask=None, *, k: int,
                      return_keys: bool = False,
                      shape: tuple[int, int] | None = None):
    """Kernel B5: query (B, N, 3), points (B, M, 3), points_mask (B, M)
    bool or None -> idx (B, N, k) int64 [, keys (B, N, k) float32, valid
    (B, N, k) bool].

    shape = (queries a block, candidates a chunk) forces the kernel's
    launch shape, for measuring; it changes no result."""
    if not query.is_cuda:
        idx, keys, valid = knn_indices_tiled_reference(query, points,
                                                       points_mask, k=k)
        return (idx, keys, valid) if return_keys else idx

    dev = query.device
    b, n, m = query.shape[0], query.shape[1], points.shape[1]
    kb.require(query, "query", (b, n, 3), dev)
    kb.require(points, "points", (b, m, 3), dev)
    if points_mask is not None:
        kb.require(points_mask, "points_mask", (b, m), dev, torch.bool)
    if not 1 <= k <= min(KERNEL_K_MAX, m):
        raise ValueError(f"the kernel takes 1 <= k <= {KERNEL_K_MAX} and "
                         f"k <= M; got k={k}, M={m}")
    queries, chunk = KERNEL_SHAPE if shape is None else shape
    if queries not in KERNEL_QUERIES or chunk not in KERNEL_CHUNKS:
        raise ValueError(f"shape {shape}: the kernel takes queries in "
                         f"{KERNEL_QUERIES}, chunks in {KERNEL_CHUNKS}")
    if k > HALF_WARP_K_MAX and queries != 8:
        raise ValueError(f"shape {shape}: a list deeper than "
                         f"{HALF_WARP_K_MAX} takes 8 queries a block")
    idx = torch.empty((b, n, k), device=dev, dtype=torch.int32)
    keys = torch.empty((b, n, k), device=dev, dtype=torch.float32)
    # the packed candidates and each chunk's box (csrc/knn_tiled.cu)
    n_chunks = -(-m // chunk)
    scratch = torch.empty((b * n_chunks * (4 * chunk + 8),), device=dev,
                          dtype=torch.float32)
    with torch.cuda.device(dev):
        code = kb.load().ratrack_knn_tiled(
            kb.ptr(query), kb.ptr(points), kb.ptr(points_mask), b, n, m, k,
            queries, chunk, kb.ptr(scratch), kb.ptr(idx), kb.ptr(keys),
            kb.stream_of(query))
    kb.check(code, "knn_tiled")
    knn_indices_tiled.launches += 1
    idx = idx.long()
    return (idx, keys, keys > -BIG / 2) if return_keys else idx


knn_indices_tiled.launches = 0


def knn_tiled(k: int, query, points, points_mask=None):
    """(dist2 (B, N, k), idx (B, N, k) int64) like `ops.neighborhood.knn`:
    the selection by kernel B5, the distances recomputed from the gathered
    neighbours (a padded slot reports its fallback's distance)."""
    idx = knn_indices_tiled(query.detach(), points.detach(), points_mask,
                            k=k)
    b, n = idx.shape[0], idx.shape[1]
    nbr = torch.gather(points, 1, idx.reshape(b, n * k, 1).expand(-1, -1, 3))
    d = query.unsqueeze(2) - nbr.reshape(b, n, k, 3)
    return torch.sum(d * d, dim=-1), idx
