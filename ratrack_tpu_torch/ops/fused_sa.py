"""Set abstraction at both radii of a level: kernel B1 and its plain twin.

Replaces `ratrack_tpu/ops/pallas_sa.py::_sa_pair_kernel` (`fused_sa_pair`).
The CUDA kernel is `csrc/sa_pair.cu`; its header says what bounds it on
the H100 and how its design answers that.

  fused_sa_pair   public entry: hoists layer 1 (two torch matmuls, as the
                  JAX package leaves them to XLA), then `sa_pair`.
  sa_pair         the kernel wrapper: CUDA tensors launch the kernel (or
                  raise), CPU tensors take `sa_pair_reference`.
  sa_pair_reference  the plain PyTorch version of the kernel's function.

Layer 1 of each scale's shared MLP factorises through the pair structure
(pallas_sa.py:26-30): W1 @ [x_j - c_i, f_j] = P1_j - CW_i with
P1 = xyz @ W_xyz + F @ W_feat + b1 and CW = centers @ W_xyz.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import build as kb
from .grouping import group
from .neighborhood import ball_query


def fold_bn_params(weights, scales, biases, means, variances,
                   eps: float = 1e-5):
    """relu(BN(x @ W)) with running stats == relu(x @ (W k) + (b - m k)),
    k = scale / sqrt(var + eps) (pallas_sa.py::fold_bn_params).
    Weights in x @ W layout (in, out)."""
    ws, bs = [], []
    for w, sc, b, mu, var in zip(weights, scales, biases, means, variances):
        k = sc * torch.rsqrt(var + eps)
        ws.append((w * k[None, :]).contiguous())
        bs.append((b - mu * k).contiguous())
    return ws, bs


def hoist_layer1(xyz, centers, features, w1, b1):
    """(P1 (B, N, C1), CW (B, M, C1)) of the factorised layer 1."""
    w_xyz, w_feat = w1[:3], w1[3:]
    p1 = xyz @ w_xyz + b1
    if features is not None:
        p1 = p1 + features @ w_feat
    return p1.contiguous(), (centers @ w_xyz).contiguous()


def sa_pair_reference(xyz, centers, mask, p1a, cwa, rest_a, p1b, cwb,
                      rest_b, *, radius_a: float, radius_b: float,
                      nsample_a: int, nsample_b: int):
    """Plain version of the kernel: ball query with CUDA padding, pair
    layer 1, folded layers, max over slots. Returns
    (out_a, out_b, idx_a, idx_b); idx are the (B, M, ns) slot indices."""
    res = []
    for p1, cw, rest, r, ns in ((p1a, cwa, rest_a, radius_a, nsample_a),
                                (p1b, cwb, rest_b, radius_b, nsample_b)):
        idx = ball_query(r, ns, xyz, centers, mask)
        h = torch.relu(group(p1, idx) - cw.unsqueeze(2))
        for w, b in rest:
            h = torch.relu(h @ w + b)
        res.append((h.amax(dim=2), idx))
    (out_a, idx_a), (out_b, idx_b) = res
    return out_a, out_b, idx_a, idx_b


def sa_pair(xyz, centers, mask, p1a, cwa, rest_a, p1b, cwb, rest_b, *,
            radius_a: float, radius_b: float, nsample_a: int, nsample_b: int,
            return_indices: bool = False):
    """Kernel B1 over (B, N, 3) points and (B, M, 3) centers.

    rest_a / rest_b: [(W (C_l, C_{l+1}), b (C_{l+1},)), ...] folded layers
    after layer 1. Returns (out_a, out_b) [+ (idx_a, idx_b) int].
    """
    kw = dict(radius_a=radius_a, radius_b=radius_b, nsample_a=nsample_a,
              nsample_b=nsample_b)
    if not xyz.is_cuda:
        oa, ob, ia, ib = sa_pair_reference(xyz, centers, mask, p1a, cwa,
                                           rest_a, p1b, cwb, rest_b, **kw)
        return (oa, ob, ia, ib) if return_indices else (oa, ob)

    dev = xyz.device
    b, n, m = xyz.shape[0], xyz.shape[1], centers.shape[1]
    kb.require(xyz, "xyz", (b, n, 3), dev)
    kb.require(centers, "centers", (b, m, 3), dev)
    if mask is not None:
        kb.require(mask, "mask", (b, n), dev, torch.bool)
    scales = []
    for tag, p1, cw, rest, ns in (("a", p1a, cwa, rest_a, nsample_a),
                                  ("b", p1b, cwb, rest_b, nsample_b)):
        c1 = p1.shape[-1]
        kb.require(p1, f"p1{tag}", (b, n, c1), dev)
        kb.require(cw, f"cw{tag}", (b, m, c1), dev)
        dims = [c1]
        for li, (w, bias) in enumerate(rest):
            kb.require(w, f"w{tag}{li}", (dims[-1], None), dev)
            kb.require(bias, f"b{tag}{li}", (w.shape[1],), dev)
            dims.append(w.shape[1])
        if len(rest) > 2 or max(dims) > 64 or not 1 <= ns <= 32:
            raise ValueError(f"scale {tag}: the kernel takes <= 2 layers "
                             f"after layer 1, widths <= 64 and nsample <= "
                             f"32; got widths {dims}, nsample {ns}")
        out = torch.empty((b, m, dims[-1]), device=dev, dtype=torch.float32)
        idx = (torch.empty((b, m, ns), device=dev, dtype=torch.int32)
               if return_indices else None)
        scales.append((p1, cw, [w for w, _ in rest], [x for _, x in rest],
                       dims, ns, out, idx))

    lib = kb.load()
    args = []
    for (p1, cw, ws, bs, dims, ns, out, idx), r in zip(
            scales, (radius_a, radius_b)):
        args += [kb.ptr(p1), kb.ptr(cw), kb.ptr_array(ws), kb.ptr_array(bs),
                 kb.int_array(dims), len(ws), float(r) ** 2, ns,
                 kb.ptr(out), kb.ptr(idx)]
    with torch.cuda.device(dev):
        code = lib.ratrack_sa_pair(kb.ptr(xyz), kb.ptr(centers),
                                   kb.ptr(mask), b, n, m, *args,
                                   kb.stream_of(xyz))
    kb.check(code, "sa_pair")
    sa_pair.launches += 1
    out_a, out_b = scales[0][6], scales[1][6]
    if return_indices:
        return out_a, out_b, scales[0][7], scales[1][7]
    return out_a, out_b


sa_pair.launches = 0


def fused_sa_pair(xyz, centers, features, mask,
                  ws_a: Sequence[torch.Tensor], bs_a: Sequence[torch.Tensor],
                  ws_b: Sequence[torch.Tensor], bs_b: Sequence[torch.Tensor],
                  *, radius_a: float, radius_b: float, nsample_a: int,
                  nsample_b: int):
    """Both radius scales of one MSG level (JAX `fused_sa_pair`).

    ws/bs: folded MLP parameters per scale, x @ W layout; ws[0] is
    (3 + C, C1) with the xyz rows first.
    """
    p1a, cwa = hoist_layer1(xyz, centers, features, ws_a[0], bs_a[0])
    p1b, cwb = hoist_layer1(xyz, centers, features, ws_b[0], bs_b[0])
    rest_a = list(zip(ws_a[1:], bs_a[1:]))
    rest_b = list(zip(ws_b[1:], bs_b[1:]))
    return sa_pair(xyz, centers, mask, p1a, cwa, rest_a, p1b, cwb, rest_b,
                   radius_a=radius_a, radius_b=radius_b, nsample_a=nsample_a,
                   nsample_b=nsample_b)
