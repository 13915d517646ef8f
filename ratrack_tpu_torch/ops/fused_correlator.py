"""Cost-volume correlator stage: kernels B3 and B4 and their plain twins.

B3 replaces `ratrack_tpu/ops/pallas_correlator.py::_corr_kernel`
(`fused_knn_weight_aggregate`), for clouds of at most 4096 points: a kNN
selection launch and a fused gather + pair MLP + WeightNet + slot-sum
launch. B4 replaces `_apply_kernel` (`knn_gather_apply`), the split
formulation for larger clouds: the same fused launch over indices the
caller selected (the tiled kNN, kernel B5). The TPU kernel takes rows
gathered outside it; here the gather is inside the kernel, by index. The
CUDA kernels are in `csrc/correlator.cu`; its header says what bounds them
on the H100 and how the design answers that.

  fused_knn_weight_aggregate      B3's wrapper: CUDA tensors launch the
                                  kernels (or raise), CPU tensors take
  knn_weight_aggregate_reference  the plain version;
  knn_gather_apply                B4's wrapper, likewise, and
  knn_gather_apply_reference      its plain version.

Stage 1 (pc1 queries in pc2): feats_p = f2 @ W_f2 + pc2 @ W_dir + b1 and
add_q = f1 @ W_f1 - pc1 @ W_dir are the factorised layer 1
(pallas_correlator.py:18-24), then 2 more leaky 256x256 layers.
Stage 2 (pc1 in pc1): feats_p is the stage-1 cost volume, no add_q, no
pair MLP. Weights are in x @ W layout (in, out).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build as kb
from .grouping import group
from .neighborhood import knn

KERNEL_K = 16
KERNEL_C = 256
# queries a block of the kNN selection launch, for `launch_knn(queries=)`
KNN_QUERIES = (8, 32)


def knn_gather_apply_reference(idx, query, points, feats_p, add_q, mlp_ws,
                               mlp_bs, wn_ws, wn_bs):
    """Plain version of B4: pair MLP, WeightNet and slot sum over the rows
    idx (B, N, k) selects -> (B, N, C_out)."""
    h = group(feats_p, idx)                               # (B, N, k, C)
    dirs = group(points, idx) - query.unsqueeze(2)        # (B, N, k, 3)
    if add_q is not None:
        h = F.leaky_relu(h + add_q.unsqueeze(2), 0.1)
    for w, b in zip(mlp_ws, mlp_bs):
        h = F.leaky_relu(h @ w + b, 0.1)
    for w, b in zip(wn_ws, wn_bs):
        dirs = torch.relu(dirs @ w + b)
    return torch.sum(dirs * h, dim=2)


def knn_weight_aggregate_reference(query, points, feats_p, add_q, mask_p,
                                   mlp_ws, mlp_bs, wn_ws, wn_bs, *,
                                   k: int = KERNEL_K):
    """Plain version of B3 -> (out (B, N, C_out), idx (B, N, k))."""
    _, idx = knn(k, query, points, mask_p)
    return knn_gather_apply_reference(idx, query, points, feats_p, add_q,
                                      mlp_ws, mlp_bs, wn_ws, wn_bs), idx


def check_kernel_args(query, points, feats_p, add_q, mask_p, mlp_ws, mlp_bs,
                      wn_ws, wn_bs, k):
    """Raise unless the correlator kernels (eval and train) take these
    CUDA tensors: k = 16, 256 channels, <= 2 pair layers, a 3-layer
    WeightNet, float32, contiguous, 16-byte aligned where read by float4."""
    dev = query.device
    b, n, m, c = query.shape[0], query.shape[1], points.shape[1], KERNEL_C
    if k != KERNEL_K or len(mlp_ws) > 2 or len(wn_ws) != 3:
        raise ValueError(f"the kernel takes k={KERNEL_K}, <= 2 pair layers "
                         f"and a 3-layer WeightNet; got k={k}, "
                         f"{len(mlp_ws)} and {len(wn_ws)}")
    kb.require(query, "query", (b, n, 3), dev)
    kb.require(points, "points", (b, m, 3), dev)
    kb.require(feats_p, "feats_p", (b, m, c), dev, align16=True)
    if add_q is not None:
        kb.require(add_q, "add_q", (b, n, c), dev, align16=True)
    if mask_p is not None:
        kb.require(mask_p, "mask_p", (b, m), dev, torch.bool)
    for i, (w, bias) in enumerate(zip(mlp_ws, mlp_bs)):
        kb.require(w, f"mlp_w{i}", (c, c), dev, align16=True)
        kb.require(bias, f"mlp_b{i}", (c,), dev, align16=True)
    hid = 8
    for i, (w, bias, shape) in enumerate(zip(
            wn_ws, wn_bs, ((3, hid), (hid, hid), (hid, c)))):
        kb.require(w, f"wn_w{i}", shape, dev, align16=True)
        kb.require(bias, f"wn_b{i}", (shape[1],), dev, align16=True)


def launch_knn(query, points, mask_p, k, *, queries: int | None = None):
    """The kNN selection launch -> idx (B, N, k) int32 (CUDA tensors that
    check_kernel_args accepted). queries (a block) forces the launch
    shape, for measuring; it changes no result."""
    if queries is not None and queries not in KNN_QUERIES:
        raise ValueError(f"queries {queries}: the kernel takes {KNN_QUERIES}")
    b, n, m = query.shape[0], query.shape[1], points.shape[1]
    idx = torch.empty((b, n, k), device=query.device, dtype=torch.int32)
    code = kb.load().ratrack_knn(kb.ptr(query), kb.ptr(points),
                                 kb.ptr(mask_p), b, n, m, k, queries or 0,
                                 kb.ptr(idx), kb.stream_of(query))
    kb.check(code, "knn")
    return idx


def fused_knn_weight_aggregate(query, points, feats_p, add_q, mask_p,
                               mlp_ws, mlp_bs, wn_ws, wn_bs, *,
                               k: int = KERNEL_K,
                               return_indices: bool = False):
    """Kernel B3 over (B, N, 3) queries and (B, M, 3) candidates."""
    if not query.is_cuda:
        out, idx = knn_weight_aggregate_reference(
            query, points, feats_p, add_q, mask_p, mlp_ws, mlp_bs, wn_ws,
            wn_bs, k=k)
        return (out, idx) if return_indices else out

    dev = query.device
    b, n, m, c = query.shape[0], query.shape[1], points.shape[1], KERNEL_C
    check_kernel_args(query, points, feats_p, add_q, mask_p, mlp_ws, mlp_bs,
                      wn_ws, wn_bs, k)
    out = torch.empty((b, n, c), device=dev, dtype=torch.float32)
    lib = kb.load()
    stream = kb.stream_of(query)
    with torch.cuda.device(dev):
        idx = launch_knn(query, points, mask_p, k)
        wn = [kb.ptr(t) for pair in zip(wn_ws, wn_bs) for t in pair]
        code = lib.ratrack_corr_aggregate(
            kb.ptr(query), kb.ptr(points), kb.ptr(idx), b, n, m,
            kb.ptr(feats_p), kb.ptr(add_q), kb.ptr_array(list(mlp_ws)),
            kb.ptr_array(list(mlp_bs)), len(mlp_ws), *wn, kb.ptr(out), stream)
    kb.check(code, "corr_aggregate")
    fused_knn_weight_aggregate.launches += 1
    return (out, idx) if return_indices else out


fused_knn_weight_aggregate.launches = 0


def knn_gather_apply(idx, query, points, feats_p, add_q, mlp_ws, mlp_bs,
                     wn_ws, wn_bs, *, k: int = KERNEL_K,
                     block_rows: int | None = None):
    """Kernel B4: one correlator stage over precomputed neighbour indices
    idx (B, N, k) into the (B, M, ...) candidates (fallback-padded, from
    `ops.fused_knn.knn_indices_tiled`) -> (B, N, C_out). N need not equal
    M. block_rows: by default the kernel picks its block shape by stage;
    64 or 128 pair rows a block forces one, for measuring the shapes
    against each other."""
    if not query.is_cuda:
        return knn_gather_apply_reference(idx, query, points, feats_p, add_q,
                                          mlp_ws, mlp_bs, wn_ws, wn_bs)
    dev = query.device
    b, n, m = query.shape[0], query.shape[1], points.shape[1]
    check_kernel_args(query, points, feats_p, add_q, None, mlp_ws, mlp_bs,
                      wn_ws, wn_bs, k)
    if idx.device != dev or tuple(idx.shape) != (b, n, k):
        raise ValueError(f"idx: shape {tuple(idx.shape)} on {idx.device}, "
                         f"expected {(b, n, k)} on {dev}")
    if block_rows not in (None, 64, 128):
        raise ValueError(f"block_rows: 64 or 128, got {block_rows}")
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty((b, n, KERNEL_C), device=dev, dtype=torch.float32)
    wn = [kb.ptr(t) for pair in zip(wn_ws, wn_bs) for t in pair]
    lib = kb.load()
    args = (kb.ptr(query), kb.ptr(points), kb.ptr(idx), b, n, m,
            kb.ptr(feats_p), kb.ptr(add_q), kb.ptr_array(list(mlp_ws)),
            kb.ptr_array(list(mlp_bs)), len(mlp_ws), *wn)
    with torch.cuda.device(dev):
        if block_rows is None:
            code = lib.ratrack_corr_apply(*args, kb.ptr(out),
                                          kb.stream_of(query))
        else:
            code = lib.ratrack_corr_apply_rows(*args, block_rows, kb.ptr(out),
                                               kb.stream_of(query))
    kb.check(code, "corr_apply")
    knn_gather_apply.launches += 1
    return out


knn_gather_apply.launches = 0
