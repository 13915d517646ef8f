"""Point-cloud operations of the reference, batched over streams.

Every selection (ball query, kNN, 3-NN, farthest point sampling) takes the
first index among equal distances and computes the squared distance in
the expanded form max((|c|^2 + |x|^2) - 2 c.x, 0), one rounded float32 op
at a time: the selection rules of the reference CUDA ops, which pick the
same points from the same coordinates whatever implements them.
"""

from __future__ import annotations

import torch

BIG = 1e10


def _sq_norm3(x):
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def point_distance(query, points):
    """(B, N, 3) x (B, M, 3) -> (B, N, M) squared distances."""
    q = query.unsqueeze(-2)
    p = points.unsqueeze(-3)
    prod = q[..., 0] * p[..., 0] + q[..., 1] * p[..., 1] + q[..., 2] * p[..., 2]
    sq = _sq_norm3(query).unsqueeze(-1) + _sq_norm3(points).unsqueeze(-2)
    return torch.clamp_min(sq - 2.0 * prod, 0.0)


def square_distance(src, dst):
    """(B, N, C) x (B, M, C) -> (B, N, M), the matmul form."""
    d = -2.0 * torch.matmul(src, dst.transpose(-1, -2))
    d = d + torch.sum(src * src, dim=-1, keepdim=True)
    d = d + torch.sum(dst * dst, dim=-1).unsqueeze(-2)
    return torch.clamp_min(d, 0.0)


def gather(points, idx):
    """(B, N, C) x (B, M) -> (B, M, C)."""
    return torch.gather(points, 1,
                        idx.unsqueeze(-1).expand(-1, -1, points.shape[-1]))


def group(points, idx):
    """(B, N, C) x (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    flat = torch.gather(points, 1, idx.reshape(b, m * s, 1).expand(
        -1, -1, points.shape[-1]))
    return flat.reshape(b, m, s, points.shape[-1])


def first_valid(mask):
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def identity_sample(n, npoint, mask):
    """arange(npoint) % n; slots past the valid count take the first valid
    index -> (B, npoint)."""
    idx = (torch.arange(npoint, device=mask.device) % n).expand(
        mask.shape[0], npoint)
    n_valid = mask.sum(dim=-1, keepdim=True)
    return torch.where(idx < n_valid, idx, first_valid(mask)[:, None])


def farthest_point_sample(xyz, npoint, mask=None):
    """Iterative farthest point sampling seeded at the first valid point;
    invalid points are never taken while a valid one is left -> (B, npoint)
    int64."""
    b, n, _ = xyz.shape
    xs, ys, zs = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    temp = torch.where(mask, 1e10, -1.0).to(torch.float32)
    old = first_valid(mask).unsqueeze(1)
    out = [old]
    for _ in range(1, npoint):
        dx = xs - torch.gather(xs, 1, old)
        dy = ys - torch.gather(ys, 1, old)
        dz = zs - torch.gather(zs, 1, old)
        d = dx * dx + dy * dy + dz * dz
        temp = torch.where(mask, torch.minimum(temp, d),
                           torch.full_like(temp, -1.0))
        old = torch.argmax(temp, dim=1, keepdim=True)
        out.append(old)
    return torch.cat(out, dim=1)


def ball_query(radius, nsample, points, centers, mask=None):
    """First `nsample` valid points with d^2 < r^2 in index order; slots
    past the hits repeat the first hit; no hit gives index 0 ->
    (B, M, nsample)."""
    n = points.shape[-2]
    hit = point_distance(centers, points) < radius * radius
    if mask is not None:
        hit = hit & mask.unsqueeze(-2)
    cols = torch.arange(n, device=points.device)
    keys = torch.where(hit, cols, torch.full_like(cols, n))
    first = torch.sort(keys, dim=-1).values[..., :nsample]
    found = first < n
    pad = torch.where(found[..., :1], first[..., :1],
                      torch.zeros_like(first[..., :1]))
    return torch.where(found, first, pad)


KNN_CHUNK = 1024   # queries a step: no (N, M) matrix of a large cloud


def knn(k, query, points, mask=None):
    """k nearest valid points, ascending, lowest index on ties; slots past
    the valid count repeat the nearest (index 0 with none valid) ->
    (dist2 (B, N, k), idx (B, N, k) int64)."""
    ds, ids = [], []
    for q0 in range(0, query.shape[1], KNN_CHUNK):
        d = point_distance(query[:, q0:q0 + KNN_CHUNK], points)
        if mask is not None:
            d = torch.where(mask.unsqueeze(-2), d, torch.full_like(d, BIG))
        dist2, idx = torch.sort(d, dim=-1, stable=True)
        dist2, idx = dist2[..., :k], idx[..., :k]
        if mask is not None:
            ok = dist2 < BIG
            fb = torch.where(ok[..., :1], idx[..., :1],
                             torch.zeros_like(idx[..., :1]))
            idx = torch.where(ok, idx, fb)
            dist2 = torch.where(ok, dist2,
                                torch.gather(d, -1, fb).expand_as(dist2))
        ds.append(dist2)
        ids.append(idx)
    return torch.cat(ds, dim=1), torch.cat(ids, dim=1)


def _spread10(v):
    """Spread the low 10 bits of int32 v: bit i -> bit 3i."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_perm(xyz, mask, extent=512.0):
    """(B, N) int64: the permutation that orders each cloud along a
    Z-curve (coordinates clipped to +-extent, 10 bits an axis), invalid
    points last, equal codes in index order."""
    q = torch.clamp((xyz + extent) * (1024.0 / (2.0 * extent)), 0.0,
                    1023.0).to(torch.int32)
    key = ((_spread10(q[..., 0]) << 2) | (_spread10(q[..., 1]) << 1)
           | _spread10(q[..., 2]))
    key = torch.where(mask, key, torch.full_like(key, 0x7FFFFFFF))
    return torch.sort(key, dim=-1, stable=True).indices


def knn_sorted(k, query, qmask, points, pmask):
    """`knn` with equal distances going to the lowest index along both
    clouds' Z-curves (the split correlator's rule above 4096 points) ->
    idx (B, N, k) into the unsorted points."""
    qp, pp = morton_perm(query, qmask), morton_perm(points, pmask)
    _, idx = knn(k, gather(query, qp), gather(points, pp),
                 torch.gather(pmask, 1, pp))
    idx = torch.gather(pp, 1, idx.flatten(1)).view(idx.shape)
    inv = torch.empty_like(qp).scatter_(
        1, qp, torch.arange(qp.shape[1], device=qp.device).expand_as(qp))
    return torch.gather(idx, 1, inv.unsqueeze(-1).expand(-1, -1, k))


def three_interpolate(unknown, known, feats):
    """Inverse-distance interpolation of `feats` of the 3 nearest known
    points at `unknown` -> (B, N, C)."""
    dist2, idx = knn(3, unknown, known)
    w = 1.0 / (torch.sqrt(dist2) + 1e-8)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.sum(group(feats, idx) * w.unsqueeze(-1), dim=2)
