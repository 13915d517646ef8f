"""Set abstraction at both radii of a level, or at one: kernels B1 and B1'
and their plain twins.

Replaces `ratrack_tpu/ops/pallas_sa.py::_sa_pair_kernel` (`fused_sa_pair`)
and `::_sa_kernel` (`fused_sa_scale`). The CUDA kernel is `csrc/sa_pair.cu`,
one template instantiated for two scales and for one; its header says what
bounds it on the H100 and how its design answers that.

  fused_sa_pair   public entry: hoists layer 1 (two torch matmuls, as the
                  JAX package leaves them to XLA), then `sa_pair`.
  sa_pair         the kernel wrapper: CUDA tensors launch the kernel (or
                  raise), CPU tensors take `sa_pair_reference`.
  sa_pair_reference  the plain PyTorch version of the kernel's function.
  fused_sa_scale, sa_scale, sa_scale_reference   the same three for one
                  scale (a level that is not a pair). A pair equals two
                  one-scale calls bit for bit.

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

KERNEL_TILES = (8, 16, 32)   # centers a block, for `tile=`; None: its own


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


def sa_scale_reference(xyz, centers, mask, p1, cw, rest, *, radius: float,
                       nsample: int):
    """Plain version of the one-scale kernel: ball query with CUDA padding,
    pair layer 1, folded layers, max over slots. Returns (out, idx); idx
    are the (B, M, ns) slot indices."""
    idx = ball_query(radius, nsample, xyz, centers, mask)
    h = torch.relu(group(p1, idx) - cw.unsqueeze(2))
    for w, b in rest:
        h = torch.relu(h @ w + b)
    return h.amax(dim=2), idx


def sa_pair_reference(xyz, centers, mask, p1a, cwa, rest_a, p1b, cwb,
                      rest_b, *, radius_a: float, radius_b: float,
                      nsample_a: int, nsample_b: int):
    """Plain version of the pair kernel: `sa_scale_reference` at both
    radii. Returns (out_a, out_b, idx_a, idx_b)."""
    out_a, idx_a = sa_scale_reference(xyz, centers, mask, p1a, cwa, rest_a,
                                      radius=radius_a, nsample=nsample_a)
    out_b, idx_b = sa_scale_reference(xyz, centers, mask, p1b, cwb, rest_b,
                                      radius=radius_b, nsample=nsample_b)
    return out_a, out_b, idx_a, idx_b


def _check_clouds(xyz, centers, mask):
    dev = xyz.device
    b, n, m = xyz.shape[0], xyz.shape[1], centers.shape[1]
    kb.require(xyz, "xyz", (b, n, 3), dev)
    kb.require(centers, "centers", (b, m, 3), dev)
    if mask is not None:
        kb.require(mask, "mask", (b, n), dev, torch.bool)
    return b, n, m


def _kernel_scale(tag, xyz, centers, p1, cw, rest, radius, ns,
                  return_indices):
    """Check one scale's tensors, allocate its outputs -> (C arguments of
    the scale, out, idx or None)."""
    dev = xyz.device
    b, n, m = xyz.shape[0], xyz.shape[1], centers.shape[1]
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
    ws, bs = [w for w, _ in rest], [x for _, x in rest]
    args = [kb.ptr(p1), kb.ptr(cw), kb.ptr_array(ws), kb.ptr_array(bs),
            kb.int_array(dims), len(ws), float(radius) ** 2, ns,
            kb.ptr(out), kb.ptr(idx)]
    return args, out, idx


def _tile_arg(tile):
    """The tile C argument; 0 lets the kernel choose."""
    if tile is not None and tile not in KERNEL_TILES:
        raise ValueError(f"tile {tile}: the kernel takes {KERNEL_TILES}")
    return tile or 0


def sa_pair(xyz, centers, mask, p1a, cwa, rest_a, p1b, cwb, rest_b, *,
            radius_a: float, radius_b: float, nsample_a: int, nsample_b: int,
            return_indices: bool = False, tile: int | None = None):
    """Kernel B1 over (B, N, 3) points and (B, M, 3) centers.

    rest_a / rest_b: [(W (C_l, C_{l+1}), b (C_{l+1},)), ...] folded layers
    after layer 1. Returns (out_a, out_b) [+ (idx_a, idx_b) int].
    tile (centers a block) forces the kernel's launch shape, for
    measuring; it changes no result.
    """
    if not xyz.is_cuda:
        oa, ob, ia, ib = sa_pair_reference(
            xyz, centers, mask, p1a, cwa, rest_a, p1b, cwb, rest_b,
            radius_a=radius_a, radius_b=radius_b, nsample_a=nsample_a,
            nsample_b=nsample_b)
        return (oa, ob, ia, ib) if return_indices else (oa, ob)

    b, n, m = _check_clouds(xyz, centers, mask)
    args_a, out_a, idx_a = _kernel_scale(
        "a", xyz, centers, p1a, cwa, rest_a, radius_a, nsample_a,
        return_indices)
    args_b, out_b, idx_b = _kernel_scale(
        "b", xyz, centers, p1b, cwb, rest_b, radius_b, nsample_b,
        return_indices)
    lib = kb.load()
    with torch.cuda.device(xyz.device):
        code = lib.ratrack_sa_pair(kb.ptr(xyz), kb.ptr(centers),
                                   kb.ptr(mask), b, n, m, *args_a, *args_b,
                                   _tile_arg(tile), kb.stream_of(xyz))
    kb.check(code, "sa_pair")
    sa_pair.launches += 1
    if return_indices:
        return out_a, out_b, idx_a, idx_b
    return out_a, out_b


sa_pair.launches = 0


def sa_scale(xyz, centers, mask, p1, cw, rest, *, radius: float,
             nsample: int, return_indices: bool = False,
             tile: int | None = None):
    """Kernel B1' over (B, N, 3) points and (B, M, 3) centers: one scale,
    arguments as one scale of `sa_pair`. Returns out [, idx int]."""
    if not xyz.is_cuda:
        out, idx = sa_scale_reference(xyz, centers, mask, p1, cw, rest,
                                      radius=radius, nsample=nsample)
        return (out, idx) if return_indices else out

    b, n, m = _check_clouds(xyz, centers, mask)
    args, out, idx = _kernel_scale("", xyz, centers, p1, cw, rest, radius,
                                   nsample, return_indices)
    lib = kb.load()
    with torch.cuda.device(xyz.device):
        code = lib.ratrack_sa_scale(kb.ptr(xyz), kb.ptr(centers),
                                    kb.ptr(mask), b, n, m, *args,
                                    _tile_arg(tile), kb.stream_of(xyz))
    kb.check(code, "sa_scale")
    sa_scale.launches += 1
    return (out, idx) if return_indices else out


sa_scale.launches = 0


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


def fused_sa_scale(xyz, centers, features, mask,
                   ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], *,
                   radius: float, nsample: int):
    """One radius scale of an MSG level (JAX `fused_sa_scale`): ws / bs as
    one scale of `fused_sa_pair`. Returns (B, M, C_last)."""
    p1, cw = hoist_layer1(xyz, centers, features, ws[0], bs[0])
    return sa_scale(xyz, centers, mask, p1, cw, list(zip(ws[1:], bs[1:])),
                    radius=radius, nsample=nsample)
