"""Cost-volume correlator stage, train mode: kernel B10 and its plain twin.

Replaces `ratrack_tpu/ops/pallas_correlator_train.py::_fwd_kernel` and
`_bwd_kernel` (`fused_knn_weight_aggregate_train`). The forward is the
aggregate kernel of `csrc/correlator.cu` with `dir @ W_dir` added to layer
1 and its activations stashed; the backward is `csrc/correlator_train.cu`,
whose header says what bounds it on the H100 and how the design answers
that.

  fused_knn_weight_aggregate_train      the kernel wrapper: CUDA tensors
                                        run `KnnWeightAggregateTrainFunction`
                                        (or raise), CPU tensors take
  knn_weight_aggregate_train_reference  the plain version, differentiated
                                        by autograd.

Stage 1 (pc1 queries in pc2): the train hoists are add_q = f1 @ W_f1 and
feats_p = f2 @ W_f2 + b1, and the coordinate term dir @ W_dir is added in
the stage from the exact directions (pallas_correlator_train.py:153-163);
then 2 leaky 256x256 layers. Stage 2 (pc1 in pc1): the raw slots. Both
weigh the slots by WeightNet(dir) and sum them. Gradients reach feats_p,
add_q, W_dir, every MLP and WeightNet weight and bias, and the query and
point positions (through the directions); the selection gets none.

Above `ops.neighborhood.KNN_DENSE_LIMIT` pairs a stream (the 8192 /
16384-point stretch clouds) the selection is the tiled kNN, kernel B5
(`ops.fused_knn`), in one pass over the candidates where the in-kernel
selection takes 16; both take the k nearest valid candidates with ties to
the lowest index, so the stage's result does not depend on the route. This
is the routing of the JAX train path, which above 1024 points selects
through `knn_auto` (models/correlator.py:178-195); unlike it the port
keeps kernel B10 for the stage itself at every size (the JAX gate is the
fast-memory limit of the TPU kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build as kb
from .fused_correlator import (KERNEL_C, KERNEL_K, check_kernel_args,
                               launch_knn)
from .fused_knn import knn_indices_tiled
from .grouping import group
from . import neighborhood
from .neighborhood import knn_auto

WN_HIDDEN = 8
# csrc/correlator_train.cu: WeightNet gradient block layout (kWnGrad) and
# the rows of a split-K dW chunk (kDwChunk), for sizing the scratch the
# kernel takes
_WN_SHAPES = ((3, WN_HIDDEN), (WN_HIDDEN,), (WN_HIDDEN, WN_HIDDEN),
              (WN_HIDDEN,), (WN_HIDDEN, KERNEL_C), (KERNEL_C,))
_WN_GRAD = sum(int(torch.Size(s).numel()) for s in _WN_SHAPES)
_DW_CHUNK = 1024


def _wn_ptrs(wn):
    """(w0, w1, w2, b0, b1, b2) -> the C order w0, b0, w1, b1, w2, b2."""
    return [kb.ptr(t) for pair in zip(wn[:3], wn[3:]) for t in pair]


# launches of the forward and backward kernels (CPU calls do not count)
knn_weight_aggregate_train_fwd = kb.Counter()
knn_weight_aggregate_train_bwd = kb.Counter()


def knn_weight_aggregate_train_reference(query, points, feats_p, add_q,
                                         mask_p, mlp_ws, mlp_bs, wn_ws,
                                         wn_bs, *, w_dir=None,
                                         k: int = KERNEL_K):
    """Plain version -> (out (B, N, C_out), idx (B, N, k)); JAX
    `knn_weight_aggregate_reference` (pallas_correlator_train.py:669)."""
    _, idx = knn_auto(k, query.detach(), points.detach(), mask_p)
    h = group(feats_p, idx)                               # (B, N, k, C)
    dirs = group(points, idx) - query.unsqueeze(2)        # (B, N, k, 3)
    if add_q is not None:
        h = h + add_q.unsqueeze(2)
        if w_dir is not None:
            h = h + dirs @ w_dir
        h = F.leaky_relu(h, 0.1)
    for w, b in zip(mlp_ws, mlp_bs):
        h = F.leaky_relu(h @ w + b, 0.1)
    d = dirs
    for w, b in zip(wn_ws, wn_bs):
        d = torch.relu(d @ w + b)
    return torch.sum(h * d, dim=2), idx


class KnnWeightAggregateTrainFunction(torch.autograd.Function):
    """Kernel B10: kNN + train forward launches, and the backward launch.

    apply(query, points, feats_p, add_q, w_dir, mask_p, *mlp_ws, *mlp_bs,
    *wn_ws, *wn_bs) -> (out (B, N, C), idx (B, N, 16) int32, no grad);
    add_q, w_dir and mask_p may be None."""

    @staticmethod
    def forward(ctx, query, points, feats_p, add_q, w_dir, mask_p, *params):
        n_mlp = (len(params) - 6) // 2
        mlp_ws, mlp_bs = params[:n_mlp], params[n_mlp:2 * n_mlp]
        wn = params[2 * n_mlp:]
        dev = query.device
        b, n, m, c = query.shape[0], query.shape[1], points.shape[1], KERNEL_C
        rows = b * n * KERNEL_K
        stash = [torch.empty((rows, c), device=dev)
                 if (l > 0 or n_mlp > 0 or add_q is not None) else None
                 for l in range(n_mlp + 1)]
        out = torch.empty((b, n, c), device=dev)
        lib = kb.load()
        with torch.cuda.device(dev):
            if n * m > neighborhood.KNN_DENSE_LIMIT:
                idx = knn_indices_tiled(query, points, mask_p,
                                        k=KERNEL_K).to(torch.int32)
            else:
                idx = launch_knn(query, points, mask_p, KERNEL_K)
            code = lib.ratrack_corr_train_fwd(
                kb.ptr(query), kb.ptr(points), kb.ptr(idx), b, n, m,
                kb.ptr(feats_p), kb.ptr(add_q), kb.ptr(w_dir),
                kb.ptr_array(list(mlp_ws)), kb.ptr_array(list(mlp_bs)),
                n_mlp, *_wn_ptrs(wn), kb.ptr_array(stash),
                kb.ptr(out), kb.stream_of(query))
        kb.check(code, "corr_train_fwd")
        knn_weight_aggregate_train_fwd.launches += 1
        ctx.n_mlp = n_mlp
        ctx.has_add = add_q is not None
        ctx.has_wdir = w_dir is not None
        ctx.has_stash = [s is not None for s in stash]
        ctx.save_for_backward(query, points, feats_p, w_dir, idx, *params,
                              *[s for s in stash if s is not None])
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, dout, _didx):
        n_mlp = ctx.n_mlp
        saved = ctx.saved_tensors
        query, points, feats_p, w_dir, idx = saved[:5]
        params = saved[5:5 + 2 * n_mlp + 6]
        it = iter(saved[5 + 2 * n_mlp + 6:])
        stash = [next(it) if has else None for has in ctx.has_stash]
        mlp_ws = params[:n_mlp]
        wn = params[2 * n_mlp:]
        dev = query.device
        b, n, m, c = query.shape[0], query.shape[1], points.shape[1], KERNEL_C
        rows = b * n * KERNEL_K
        blocks = -(-b * n // 4)
        chunks = -(-rows // _DW_CHUNK)
        d_feats_p = torch.zeros((b, m, c), device=dev)
        d_points = torch.zeros((b, m, 3), device=dev)
        d_query = torch.empty((b, n, 3), device=dev)
        d_add_q = torch.empty((b, n, c), device=dev) if ctx.has_add else None
        d_wdir = torch.empty((3, c), device=dev) if ctx.has_wdir else None
        d_mlp_w = [torch.empty((c, c), device=dev) for _ in range(n_mlp)]
        d_mlp_b = [torch.empty(c, device=dev) for _ in range(n_mlp)]
        d_wn = torch.empty(_WN_GRAD, device=dev)
        dout = dout.contiguous()
        dz = [torch.empty((rows, c), device=dev)
              for _ in range(2 if n_mlp else 1)]
        ddir = torch.empty((rows, 3), device=dev)
        # per-block WeightNet and W_dir partials, per-chunk dW and db
        # partials of every pair layer
        part = torch.empty(blocks * (_WN_GRAD + 3 * c)
                           + n_mlp * chunks * (c * c + c), device=dev)
        lib = kb.load()
        with torch.cuda.device(dev):
            code = lib.ratrack_corr_train_bwd(
                kb.ptr(query), kb.ptr(points), kb.ptr(idx), b, n, m,
                kb.ptr(feats_p), int(ctx.has_add), kb.ptr(w_dir),
                kb.ptr_array(list(mlp_ws)), n_mlp, kb.ptr_array(stash),
                *_wn_ptrs(wn), kb.ptr(dout),
                kb.ptr(d_feats_p), kb.ptr(d_add_q), kb.ptr(d_query),
                kb.ptr(d_points), kb.ptr(d_wdir), kb.ptr_array(d_mlp_w),
                kb.ptr_array(d_mlp_b), kb.ptr(d_wn), kb.ptr(dz[0]),
                kb.ptr(dz[-1]), kb.ptr(ddir), kb.ptr(part),
                kb.stream_of(query))
        kb.check(code, "corr_train_bwd")
        knn_weight_aggregate_train_bwd.launches += 1
        sizes = [int(torch.Size(s).numel()) for s in _WN_SHAPES]
        g = [x.view(s) for x, s in zip(torch.split(d_wn, sizes), _WN_SHAPES)]
        d_wn_ws, d_wn_bs = [g[0], g[2], g[4]], [g[1], g[3], g[5]]
        return (d_query, d_points, d_feats_p, d_add_q, d_wdir, None,
                *d_mlp_w, *d_mlp_b, *d_wn_ws, *d_wn_bs)


def fused_knn_weight_aggregate_train(query, points, feats_p, add_q, mask_p,
                                     mlp_ws, mlp_bs, wn_ws, wn_bs, *,
                                     w_dir=None, k: int = KERNEL_K,
                                     return_indices: bool = False):
    """Kernel B10 over (B, N, 3) queries and (B, M, 3) candidates (JAX
    `fused_knn_weight_aggregate_train`, pallas_correlator_train.py:622).
    Weights in x @ W layout; w_dir (3, C) only with add_q."""
    if w_dir is not None and add_q is None:
        raise ValueError("w_dir is the coordinate part of layer 1 and needs "
                         "add_q")
    if not query.is_cuda:
        out, idx = knn_weight_aggregate_train_reference(
            query, points, feats_p, add_q, mask_p, mlp_ws, mlp_bs, wn_ws,
            wn_bs, w_dir=w_dir, k=k)
        return (out, idx) if return_indices else out

    check_kernel_args(query, points, feats_p, add_q, mask_p, mlp_ws, mlp_bs,
                      wn_ws, wn_bs, k)
    if w_dir is not None:
        kb.require(w_dir, "w_dir", (3, KERNEL_C), query.device, align16=True)
    out, idx = KnnWeightAggregateTrainFunction.apply(
        query, points, feats_p, add_q, w_dir, mask_p, *mlp_ws, *mlp_bs,
        *wn_ws, *wn_bs)
    return (out, idx) if return_indices else out
