"""Set abstraction in train mode at both radii of a level, or at one:
kernels B9 and B8 and their plain twins.

Replaces `ratrack_tpu/ops/pallas_sa_train.py::_pair_fwd_kernel_pk` and
`_pair_bwd_kernel_pk` (`fused_sa_pair_train`) and `::_fwd_kernel` and
`_bwd_kernel` with their `_pk` twins (`fused_sa_scale_train`). The CUDA
kernels are in `csrc/sa_pair_train.cu`; its header says what bounds them on
the H100 and how the design answers that.

  fused_sa_pair_train   public entry (the JAX signature): hoists the
                        feature term of layer 1 (a torch matmul, as the JAX
                        package leaves it to XLA), then `sa_pair_train`.
  sa_pair_train         the kernel wrapper: CUDA tensors run
                        `SATrainFunction` (the forward and backward
                        kernels, or raise), CPU tensors take
  sa_pair_train_reference  the plain version, differentiated by autograd.
  fused_sa_scale_train, sa_scale_train, sa_scale_train_reference
                        the same three for one scale (a level that is not
                        a pair of equal depth).

The kernels take no compute dtype, as the JAX train kernels take none: the
public entries cast bfloat16 features to float32 before the hoist and the
kernels run in float32 whatever the model's dtype.

Per scale: ball query with CUDA padding (slots past the hit count repeat
the first hit, no hit gives point 0), layer 1
z = group(PF) + (group(xyz) - centers) @ W1[:3] with PF = F @ W1[3:] (no
bias: batch norm follows), then per layer train-mode batch norm with
statistics per stream over all M * ns rows, ReLU, the next Dense, and the
max over slots. The batch statistics are returned for the running
averages and carry no gradient (the JAX VJP drops their cotangents).
Gradients reach the features (through PF), every Dense weight and every
batch norm scale and bias. The coordinates get none: no parameter depends
on them (the model's clouds are inputs and its centers are samples of
them), and the kernels compute none.

Unlike the JAX kernel (pallas_sa_train.py:1041-1049, 1729-1739) the
coordinate part of layer 1 is not hoisted as xyz @ W1[:3] - centers @
W1[:3]: that difference of absolute terms cancels most of float32's digits
at radar ranges (csrc/sa_pair_train.cu says how much); the kernel takes the
relative coordinates itself, as the JAX correlator train kernel does. The
batch variance is the JAX max(E[h^2] - mu^2, 0) on both sides (the
kernel adds its sums in float64).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..kernels import build as kb
from .grouping import group
from .neighborhood import ball_query

MAX_LAYERS = 3
MAX_WIDTH = 64
MAX_NSAMPLE = 32
# shapes of csrc/sa_pair_train.cu (kCluster, kGradLen), for sizing the
# backward's scratch
_CLUSTER = 8
_GRAD_LEN = (MAX_LAYERS - 1) * MAX_WIDTH * MAX_WIDTH + 3 * MAX_WIDTH
_ALIGN = 256     # bytes: every carved view starts on a 256-byte boundary

_P = ctypes.c_void_p

# launches of the forward and backward kernels (CPU calls do not count)
sa_pair_train_fwd = kb.Counter()
sa_pair_train_bwd = kb.Counter()
sa_scale_train_fwd = kb.Counter()
sa_scale_train_bwd = kb.Counter()


class _Scale(ctypes.Structure):
    """ctypes mirror of `TrainScale` in csrc/sa_pair_train.cu."""
    _fields_ = [("pf", _P), ("wxyz", _P), ("w", _P * 3), ("gamma", _P * 3),
                ("beta", _P * 3), ("dims", ctypes.c_int * 3),
                ("n_layers", ctypes.c_int), ("ns", ctypes.c_int),
                ("r2", ctypes.c_float), ("idx", _P), ("z", _P * 3),
                ("mu", _P * 3), ("var", _P * 3), ("pooled", _P),
                ("dpooled", _P), ("dy", _P * 2), ("dpf", _P), ("dwxyz", _P),
                ("dw", _P * 3), ("dgamma", _P * 3), ("dbeta", _P * 3)]


def at_least_f32(x):
    """x in float32 where its dtype is narrower (bfloat16 features, as the
    JAX wrappers' astype(float32) before the hoist); a float64 run stays
    float64; None stays None. Under autograd the gradient returns in x's
    dtype."""
    if x is None:
        return None
    return x.to(torch.promote_types(x.dtype, torch.float32))


def hoist_layer1_train(features, w1):
    """(PF (B, N, C1) or None, W_xyz (3, C1)): the hoisted feature term
    F @ W1[3:] of layer 1 (no bias) and its coordinate rows."""
    pf = None if features is None else (features @ w1[3:]).contiguous()
    return pf, w1[:3].contiguous()


def sa_scale_train_reference(xyz, centers, mask, pf, wxyz, ws, gammas,
                             betas, *, radius: float, nsample: int,
                             eps: float = 1e-5):
    """Plain version of the one-scale kernels. pf / wxyz: layer 1 as
    hoist_layer1_train gives it; ws: the layers after layer 1 [W_2 .. W_L]
    (in, out); gammas / betas: the L batch norms. Returns (pooled, mus,
    vars, idx), mus / vars lists of (B, C_l) per-stream batch statistics,
    idx the (B, M, ns) selected points. `torch.amax` splits the max's
    cotangent evenly over ties, as `jnp.max` does (duplicate padding slots
    tie)."""
    idx = ball_query(radius, nsample, xyz, centers, mask)
    h = (group(xyz, idx) - centers.unsqueeze(2)) @ wxyz   # (B, M, ns, C1)
    if pf is not None:
        h = group(pf, idx) + h
    mus, vrs = [], []
    for li, (g, b) in enumerate(zip(gammas, betas)):
        if li > 0:
            h = h @ ws[li - 1]
        mu = h.mean(dim=(1, 2))
        var = torch.clamp_min((h * h).mean(dim=(1, 2)) - mu * mu, 0.0)
        mus.append(mu.detach())
        vrs.append(var.detach())
        inv = torch.rsqrt(var + eps)[:, None, None]
        h = torch.relu((h - mu[:, None, None]) * inv * g + b)
    return torch.amax(h, dim=2), mus, vrs, idx


def sa_pair_train_reference(xyz, centers, mask, pfa, wxyz_a, ws_a, gammas_a,
                            betas_a, pfb, wxyz_b, ws_b, gammas_b, betas_b, *,
                            radius_a: float, radius_b: float, nsample_a: int,
                            nsample_b: int, eps: float = 1e-5):
    """Plain version of the pair kernels: `sa_scale_train_reference` at
    both radii -> ((pooled_a, mus_a, vars_a, idx_a), (pooled_b, ...))."""
    return (sa_scale_train_reference(
                xyz, centers, mask, pfa, wxyz_a, ws_a, gammas_a, betas_a,
                radius=radius_a, nsample=nsample_a, eps=eps),
            sa_scale_train_reference(
                xyz, centers, mask, pfb, wxyz_b, ws_b, gammas_b, betas_b,
                radius=radius_b, nsample=nsample_b, eps=eps))


def _ptrs(tensors, n=MAX_LAYERS):
    vals = [kb.ptr(t) for t in tensors]
    return (_P * n)(*(vals + [None] * (n - len(vals))))


class SATrainFunction(torch.autograd.Function):
    """Kernels B9 (two scales) and B8 (one): the forward and backward
    launches of csrc/sa_pair_train.cu.

    apply(cfg, xyz, centers, mask, *flat) with cfg = (eps, ((n_layers,
    radius, nsample), ...)) of one or two scales and flat = per scale pf,
    wxyz, *ws[1:], *gammas, *betas. Returns the scales' pooled tensors, then
    per scale idx, *mus, *vars (these carry no gradient)."""

    @staticmethod
    def forward(ctx, cfg, xyz, centers, mask, *flat):
        eps, metas = cfg
        b, n, m = xyz.shape[0], xyz.shape[1], centers.shape[1]
        dev = xyz.device
        scales, at = [], 0
        for n_layers, r, ns in metas:
            pf, wx = flat[at:at + 2]
            prm = flat[at + 2:at + 1 + 3 * n_layers]
            at += 1 + 3 * n_layers
            ws = list(prm[:n_layers - 1])
            dims = [wx.shape[1]] + [w.shape[1] for w in ws]
            scales.append(dict(
                ws=ws, gam=list(prm[n_layers - 1:2 * n_layers - 1]),
                bet=list(prm[2 * n_layers - 1:]), dims=dims, ns=ns, r=r,
                pf=pf, wx=wx,
                z=[torch.empty((b, m * ns, c), device=dev) for c in dims],
                mus=[torch.empty((b, c), device=dev) for c in dims],
                vrs=[torch.empty((b, c), device=dev) for c in dims],
                idx=torch.empty((b, m, ns), device=dev, dtype=torch.int32),
                pooled=torch.empty((b, m, dims[-1]), device=dev)))
        structs = [_scale_struct(sc) for sc in scales]
        lib = kb.load()
        pair = len(scales) == 2
        with torch.cuda.device(dev):
            entry = (lib.ratrack_sa_train_fwd if pair
                     else lib.ratrack_sa_scale_train_fwd)
            code = entry(kb.ptr(xyz), kb.ptr(centers), kb.ptr(mask), b, n, m,
                         eps, *[ctypes.addressof(st) for st in structs],
                         kb.stream_of(xyz))
        kb.check(code, "sa_pair_train_fwd" if pair else "sa_scale_train_fwd")
        (sa_pair_train_fwd if pair else sa_scale_train_fwd).launches += 1
        ctx.cfg = cfg
        ctx.dims = [sc["dims"] for sc in scales]
        stash = [t for sc in scales
                 for t in (sc["idx"], sc["pooled"], *sc["z"], *sc["mus"],
                           *sc["vrs"])]
        ctx.save_for_backward(xyz, centers, *flat, *stash)
        outs = tuple(t for sc in scales
                     for t in (sc["idx"], *sc["mus"], *sc["vrs"]))
        ctx.mark_non_differentiable(*outs)
        return tuple(sc["pooled"] for sc in scales) + outs

    @staticmethod
    def backward(ctx, *douts):
        eps, metas = ctx.cfg
        saved = list(ctx.saved_tensors)
        xyz, centers = saved[:2]
        n_flat = sum(1 + 3 * L for L, _, _ in metas)
        flat, stash = saved[2:2 + n_flat], saved[2 + n_flat:]
        b, n, m = xyz.shape[0], xyz.shape[1], centers.shape[1]
        dev = xyz.device
        # one allocation for the scratch (dy of both parities per scale,
        # the per-stream sums, the per-block weight-gradient partials) and
        # one for the small gradient leaves, carved into views
        n_sc = len(metas)
        dy_shapes = [(b, m * ns, MAX_WIDTH) for _, _, ns in metas
                     for _ in range(2)]
        scratch = _carve(dev, [(sh, torch.float32) for sh in dy_shapes] + [
            ((n_sc, MAX_LAYERS, b, 2, MAX_WIDTH), torch.float64),
            ((n_sc, b * _CLUSTER, _GRAD_LEN), torch.float32)])
        ssum, pdw = scratch[-2:]
        leaf_shapes = []
        for (L, _, _), dims in zip(metas, ctx.dims):
            leaf_shapes += ([(3, dims[0])]
                            + [(i, o) for i, o in zip(dims[:-1], dims[1:])]
                            + [(c,) for c in dims] * 2)
        leaves = _carve(dev, [(sh, torch.float32) for sh in leaf_shapes])
        grads, structs, at, st_at = [], [], 0, 0
        for k, ((L, r, ns), dims, dp) in enumerate(zip(metas, ctx.dims,
                                                       douts)):
            pf, wx = flat[at:at + 2]
            prm = flat[at + 2:at + 1 + 3 * L]
            at += 1 + 3 * L
            idx, pooled = stash[st_at:st_at + 2]
            rest = stash[st_at + 2:st_at + 2 + 3 * L]
            st_at += 2 + 3 * L
            mine, leaves = leaves[:3 * L], leaves[3 * L:]
            sc = dict(ws=list(prm[:L - 1]), gam=list(prm[L - 1:2 * L - 1]),
                      bet=list(prm[2 * L - 1:]), dims=dims, ns=ns, r=r,
                      z=list(rest[:L]), mus=list(rest[L:2 * L]),
                      vrs=list(rest[2 * L:]), pf=pf, wx=wx,
                      idx=idx, pooled=pooled,
                      dpooled=(torch.zeros_like(pooled) if dp is None
                               else dp.contiguous()),
                      dy=scratch[2 * k:2 * k + 2],
                      dpf=None if pf is None else torch.zeros_like(pf),
                      dwx=mine[0], dw=[None] + mine[1:L],
                      dgam=mine[L:2 * L], dbet=mine[2 * L:])
            grads.append(sc)
            structs.append(_scale_struct(sc))
        lib = kb.load()
        pair = len(grads) == 2
        with torch.cuda.device(dev):
            entry = (lib.ratrack_sa_train_bwd if pair
                     else lib.ratrack_sa_scale_train_bwd)
            code = entry(kb.ptr(xyz), kb.ptr(centers), b, n, m, eps,
                         *[ctypes.addressof(st) for st in structs],
                         kb.ptr(ssum), kb.ptr(pdw), kb.stream_of(xyz))
        kb.check(code, "sa_pair_train_bwd" if pair else "sa_scale_train_bwd")
        (sa_pair_train_bwd if pair else sa_scale_train_bwd).launches += 1
        dflat = []
        for g in grads:
            dflat += [g["dpf"], g["dwx"]] + g["dw"][1:] + g["dgam"] + g["dbet"]
        return (None, None, None, None, *dflat)


def _carve(device, specs):
    """One uninitialised allocation cut into a tensor per (shape, dtype) of
    `specs`, each on an _ALIGN-byte boundary."""
    nbytes = [math.prod(shape) * dtype.itemsize for shape, dtype in specs]
    starts = [0]
    for size in nbytes:
        starts.append(starts[-1] + -(-size // _ALIGN) * _ALIGN)
    buf = torch.empty(starts[-1], device=device, dtype=torch.uint8)
    return [buf[at:at + size].view(dtype).view(shape)
            for (shape, dtype), at, size in zip(specs, starts, nbytes)]


def _scale_struct(sc) -> _Scale:
    """The C struct of one scale (the dict keeps its tensors alive)."""
    s = _Scale()
    s.pf, s.wxyz = kb.ptr(sc["pf"]), kb.ptr(sc["wx"])
    s.w = _ptrs([None] + sc["ws"])
    s.gamma, s.beta = _ptrs(sc["gam"]), _ptrs(sc["bet"])
    s.dims = (ctypes.c_int * 3)(*(sc["dims"] + [0] * (3 - len(sc["dims"]))))
    s.n_layers, s.ns, s.r2 = len(sc["dims"]), sc["ns"], float(sc["r"]) ** 2
    s.idx, s.pooled = kb.ptr(sc["idx"]), kb.ptr(sc["pooled"])
    s.z, s.mu, s.var = _ptrs(sc["z"]), _ptrs(sc["mus"]), _ptrs(sc["vrs"])
    if "dpooled" in sc:
        s.dpooled = kb.ptr(sc["dpooled"])
        s.dy = _ptrs(sc["dy"], 2)
        s.dpf, s.dwxyz = kb.ptr(sc["dpf"]), kb.ptr(sc["dwx"])
        s.dw = _ptrs(sc["dw"])
        s.dgamma, s.dbeta = _ptrs(sc["dgam"]), _ptrs(sc["dbet"])
    return s


def _check_scale(tag, xyz, pf, wxyz, ws, gammas, betas, ns):
    b, n, dev = xyz.shape[0], xyz.shape[1], xyz.device
    c1 = wxyz.shape[-1]
    kb.require(wxyz, f"wxyz_{tag}", (3, c1), dev)
    if pf is not None:
        kb.require(pf, f"pf{tag}", (b, n, c1), dev)
    dims = [c1]
    for li, w in enumerate(ws):
        kb.require(w, f"w{tag}{li + 2}", (dims[-1], None), dev)
        dims.append(w.shape[1])
    for li, (g, bt) in enumerate(zip(gammas, betas)):
        kb.require(g, f"gamma{tag}{li + 1}", (dims[li],), dev)
        kb.require(bt, f"beta{tag}{li + 1}", (dims[li],), dev)
    if (len(dims) > MAX_LAYERS or len(gammas) != len(dims)
            or len(betas) != len(dims) or max(dims) > MAX_WIDTH
            or not 1 <= ns <= MAX_NSAMPLE):
        raise ValueError(f"scale {tag}: the kernel takes 1-{MAX_LAYERS} "
                         f"layers with a batch norm each, widths <= "
                         f"{MAX_WIDTH} and nsample <= {MAX_NSAMPLE}; got "
                         f"widths {dims}, {len(gammas)} norms, nsample {ns}")


def _apply(xyz, centers, mask, eps, scales):
    """Check the clouds and each scale (tag, pf, wxyz, ws, gammas, betas,
    radius, nsample) and run SATrainFunction -> [(pooled, mus, vars, idx)]
    per scale."""
    dev = xyz.device
    b, n, m = xyz.shape[0], xyz.shape[1], centers.shape[1]
    kb.require(xyz, "xyz", (b, n, 3), dev)
    kb.require(centers, "centers", (b, m, 3), dev)
    if mask is not None:
        kb.require(mask, "mask", (b, n), dev, torch.bool)
    metas, flat = [], []
    for tag, pf, wxyz, ws, gammas, betas, radius, ns in scales:
        _check_scale(tag, xyz, pf, wxyz, ws, gammas, betas, ns)
        metas.append((len(gammas), float(radius), int(ns)))
        flat += [pf, wxyz, *ws, *gammas, *betas]
    out = SATrainFunction.apply((float(eps), tuple(metas)), xyz, centers,
                                mask, *flat)
    pooled, rest, res = out[:len(scales)], out[len(scales):], []
    for p, (L, _, _) in zip(pooled, metas):
        res.append((p, list(rest[1:1 + L]), list(rest[1 + L:1 + 2 * L]),
                    rest[0]))
        rest = rest[1 + 2 * L:]
    return res


def sa_pair_train(xyz, centers, mask, pfa, wxyz_a, ws_a, gammas_a, betas_a,
                  pfb, wxyz_b, ws_b, gammas_b, betas_b, *, radius_a: float,
                  radius_b: float, nsample_a: int, nsample_b: int,
                  eps: float = 1e-5):
    """Kernel B9 over (B, N, 3) points and (B, M, 3) centers; arguments and
    returns as `sa_pair_train_reference`. The two scales have equal depth
    (a level whose depths differ runs `sa_scale_train` per scale)."""
    if not xyz.is_cuda:
        return sa_pair_train_reference(
            xyz, centers, mask, pfa, wxyz_a, ws_a, gammas_a, betas_a, pfb,
            wxyz_b, ws_b, gammas_b, betas_b, radius_a=radius_a,
            radius_b=radius_b, nsample_a=nsample_a, nsample_b=nsample_b,
            eps=eps)
    if len(gammas_a) != len(gammas_b):
        raise ValueError(f"the pair kernel takes scales of equal depth; got "
                         f"{len(gammas_a)} and {len(gammas_b)} layers")
    ra, rb = _apply(xyz, centers, mask, eps, [
        ("a", pfa, wxyz_a, ws_a, gammas_a, betas_a, radius_a, nsample_a),
        ("b", pfb, wxyz_b, ws_b, gammas_b, betas_b, radius_b, nsample_b)])
    return ra, rb


def sa_scale_train(xyz, centers, mask, pf, wxyz, ws, gammas, betas, *,
                   radius: float, nsample: int, eps: float = 1e-5):
    """Kernel B8 over (B, N, 3) points and (B, M, 3) centers; arguments and
    returns as `sa_scale_train_reference`."""
    if not xyz.is_cuda:
        return sa_scale_train_reference(xyz, centers, mask, pf, wxyz, ws,
                                        gammas, betas, radius=radius,
                                        nsample=nsample, eps=eps)
    return _apply(xyz, centers, mask, eps, [
        ("", pf, wxyz, ws, gammas, betas, radius, nsample)])[0]


def fused_sa_pair_train(xyz, centers, features, mask,
                        ws_a: Sequence[torch.Tensor],
                        scales_a: Sequence[torch.Tensor],
                        biases_a: Sequence[torch.Tensor],
                        ws_b: Sequence[torch.Tensor],
                        scales_b: Sequence[torch.Tensor],
                        biases_b: Sequence[torch.Tensor], *,
                        radius_a: float, nsample_a: int, radius_b: float,
                        nsample_b: int, eps: float = 1e-5):
    """Both scales of one train-mode SA-MSG level (JAX
    `fused_sa_pair_train`, pallas_sa_train.py:1711).

    ws_*: the Dense weights per scale in x @ W layout, ws[0] (3 + C, C1)
    with the xyz rows first; scales / biases: the batch norms' weight and
    bias. Returns ((pooled_a, mus_a, vars_a), (pooled_b, mus_b, vars_b)),
    all float32. The points, centers and features enter in float32 (a
    bfloat16 model's features are cast, as the JAX wrapper casts them,
    pallas_sa_train.py:1725-1733); the features' gradient returns in
    their dtype.
    """
    xyz, centers, features = (at_least_f32(x) for x in (xyz, centers,
                                                        features))
    pfa, wxyz_a = hoist_layer1_train(features, ws_a[0])
    pfb, wxyz_b = hoist_layer1_train(features, ws_b[0])
    ra, rb = sa_pair_train(
        xyz, centers, mask, pfa, wxyz_a, list(ws_a[1:]), list(scales_a),
        list(biases_a), pfb, wxyz_b, list(ws_b[1:]), list(scales_b),
        list(biases_b), radius_a=radius_a, radius_b=radius_b,
        nsample_a=nsample_a, nsample_b=nsample_b, eps=eps)
    return ra[:3], rb[:3]


def fused_sa_scale_train(xyz, centers, features, mask,
                         ws: Sequence[torch.Tensor],
                         scales: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], *, radius: float,
                         nsample: int, eps: float = 1e-5):
    """One scale of a train-mode SA-MSG level (JAX `fused_sa_scale_train`,
    pallas_sa_train.py:1017); arguments as one scale of
    `fused_sa_pair_train`. Returns (pooled, mus, vars)."""
    xyz, centers, features = (at_least_f32(x) for x in (xyz, centers,
                                                        features))
    pf, wxyz = hoist_layer1_train(features, ws[0])
    return sa_scale_train(xyz, centers, mask, pf, wxyz, list(ws[1:]),
                          list(scales), list(biases), radius=radius,
                          nsample=nsample, eps=eps)[:3]
