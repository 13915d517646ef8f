"""Seeded inputs for each kernel at the model's widths.

One case per kernel call the eval step makes, built from synthetic radar
clouds (data/synthetic.py) and random weights, all drawn from a seed:

  SA pair  sa1/sa2/sa3 for the pn_head (sa1 features: 2 channels) and the
           decoder's mse head (sa1 features: 2 + 256 + 256 = 514);
  FP       fp3/fp2/fp1 (known features 64 / 128 / 128);
  corr     stage 1 (pc1 in pc2, add_q, 2 pair layers) and stage 2 (pc1 in
           pc1, no pair MLP).

Train kernels: `sa_train_case` (B9, the same six level configs with batch
norm scales and biases in place of the folded biases) and
`corr_train_case` (B10, stage 1 with W_dir, stage 2); `sa_train_run` /
`corr_train_run` run a kernel wrapper or its plain version forward and
backward against a seeded cotangent, and `compare_train` holds the two
runs against each other.

One-scale kernels B1' and B8: `GENERAL_LEVELS` (a one-scale level, a
three-scale level and a pair of unequal depth, at the live widths) with
`sa_scale_cases` / `sa_scale_train_cases` (one case per scale), and
`split_sa_case` / `split_sa_train_case`, which cut a pair case into the two
one-scale cases it must equal.

Stretch kernels (clouds of 8192 / 16384 points, 512 centers):
`knn_tiled_case` (B5, both clouds Z-sorted as the split correlator sorts
them), `apply_case` (B4), `fps_case` (B6), `sinkhorn_case` (B7), and
`sa_case` / `fp_case` with `npoint` centers sampled from the cloud.

Partition cases (numpy, shared by the CPU tests against the JAX package
and the card tests against the kernels): `fp_partition_case` (B2: known
counts around its lane groups, duplicated known points, few valid) and
`select_partition_case` (B3's selection launch: candidate counts around
its 16-lane batches and 4096-point pieces, few valid, exact ties across
lanes), both on a 1/16 grid so that every distance is exact in both
packages.

`*_work` functions count the bytes a kernel call must move (every tensor
of the case read once, every output written once) and the float32
operations it needs on these inputs, the matrix products' (every x @ W
multiply-add, 2 K N a row) apart from the rest, for the roofline bound.
`transport_flow_work` counts B11's (FLOT's transport) likewise.
`bf16_case` turns an eval kernel's case into its bfloat16 instantiation's
(compute_dtype, and B2's known features in bfloat16, as the bfloat16 model
passes them), so the bytes count each tensor at its own width; the
products then have bfloat16 operands.

Used by chip_smoke.py and tests/test_torch_port_cuda.py to hold every
kernel against its plain version on the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.synthetic import stack_frames, synthetic_clip
from ..ops.fused_knn import knn_indices_tiled_reference
from ..ops.fused_sa import hoist_layer1
from ..ops.fused_sa_train import hoist_layer1_train
from ..ops.morton import morton_perm
from ..ops.sampling import (furthest_point_sample_reference, gather,
                            identity_gather)
from ..tracker.sinkhorn import transport_problem

# name: (radii, nsamples, per-scale MLP widths, feature channels by head)
SA_LEVELS = {
    "sa1": ((2.0, 4.0), (4, 8), ((16, 16, 32), (16, 16, 32)),
            {"pn_head": 2, "mse": 514}),
    "sa2": ((4.0, 8.0), (8, 16), ((32, 32), (32, 64)),
            {"pn_head": 32, "mse": 32}),
    "sa3": ((8.0, 16.0), (16, 32), ((64, 64), (64, 64)),
            {"pn_head": 64, "mse": 64}),
}
# levels that are not a same-depth pair, which run one kernel B1' / B8 per
# scale: name -> (radii, nsamples, per-scale MLP widths, feature channels)
GENERAL_LEVELS = {
    "one_scale": ((4.0,), (16,), ((32, 32, 64),), 32),
    "three_scales": ((2.0, 4.0, 8.0), (4, 8, 16),
                     ((16, 16, 32), (32, 32), (32, 64)), 32),
    "mixed_depth": ((4.0, 8.0), (8, 16), ((32, 32), (32, 32, 64)), 32),
}
FP_LEVELS = {"fp3": 64, "fp2": 128, "fp1": 128}
CORR_C = 256


def clouds(seed: int, batch: int, n: int = 512, n_static: int = 300,
           n_objects: int = 5):
    """(pc1, mask1, pc2, mask2) of the first frame of `batch` synthetic
    streams, as (B, n, 3) / (B, n) CPU tensors."""
    frames = stack_frames([synthetic_clip(seed + s, 1, n_max=n,
                                          n_static=n_static,
                                          n_objects=n_objects)[0]
                           for s in range(batch)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return t(frames.pc1), t(frames.mask1), t(frames.pc2), t(frames.mask2)


def _weights(gen, dims):
    ws, bs = [], []
    for i, o in zip(dims[:-1], dims[1:]):
        ws.append(torch.randn((i, o), generator=gen) / i ** 0.5)
        bs.append(0.1 * torch.randn((o,), generator=gen))
    return ws, bs


def stretch_static_points(n: int) -> int:
    """Static points of a stretch scenario's synthetic clip at n_max = n."""
    return min(4000, max(60, n * 3 // 5))


def stretch_clouds(seed: int, n: int):
    """`clouds` of one stream as the stretch scenarios make them: 5 objects
    and `stretch_static_points(n)` static points in n_max = n."""
    return clouds(seed, 1, n, n_static=stretch_static_points(n), n_objects=5)


def fps_centers(xyz, mask, npoint: int):
    """npoint farthest point samples of xyz (B, N, 3) -> (B, npoint, 3)."""
    return gather(xyz, furthest_point_sample_reference(xyz, npoint, mask))


def sa_case(level: str, head: str, pc, mask, gen: torch.Generator,
            npoint: int | None = None):
    """Keyword arguments of ops.fused_sa.sa_pair / sa_pair_reference.
    npoint: that many farthest point samples as centers (sa1 of a stretch
    cloud); by default the identity sample, one center a point."""
    radii, nsamples, mlps, c_feat = SA_LEVELS[level]
    b, n, _ = pc.shape
    if level == "sa1":
        xyz, m = pc, mask
    else:   # deeper levels run over the identity-gathered centers, no mask
        xyz, m = identity_gather(pc, mask), None
    centers = (identity_gather(xyz, m) if npoint is None
               else fps_centers(xyz, m, npoint))
    feats = torch.randn((b, n, c_feat[head]), generator=gen)
    kw = dict(xyz=xyz.contiguous(), centers=centers.contiguous(), mask=m)
    for tag, widths in zip("ab", mlps):
        ws, bs = _weights(gen, (3 + c_feat[head],) + tuple(widths))
        p1, cw = hoist_layer1(xyz, centers, feats, ws[0], bs[0])
        kw[f"p1{tag}"], kw[f"cw{tag}"] = p1, cw
        kw[f"rest_{tag}"] = list(zip(ws[1:], bs[1:]))
    kw.update(radius_a=radii[0], radius_b=radii[1], nsample_a=nsamples[0],
              nsample_b=nsamples[1])
    return kw


def split_sa_case(kw: dict):
    """The two `sa_scale` cases that a `sa_pair` case must equal."""
    return [dict(xyz=kw["xyz"], centers=kw["centers"], mask=kw["mask"],
                 p1=kw[f"p1{t}"], cw=kw[f"cw{t}"], rest=kw[f"rest_{t}"],
                 radius=kw[f"radius_{t}"], nsample=kw[f"nsample_{t}"])
            for t in "ab"]


def sa_scale_cases(level: str, pc, mask, gen: torch.Generator,
                   npoint: int | None = None):
    """Keyword arguments of ops.fused_sa.sa_scale / sa_scale_reference, one
    per scale of a GENERAL_LEVELS level over the masked cloud; centers as
    `sa_case`."""
    radii, nsamples, mlps, c_feat = GENERAL_LEVELS[level]
    b, n, _ = pc.shape
    centers = (identity_gather(pc, mask) if npoint is None
               else fps_centers(pc, mask, npoint)).contiguous()
    feats = torch.randn((b, n, c_feat), generator=gen)
    out = []
    for r, ns, widths in zip(radii, nsamples, mlps):
        ws, bs = _weights(gen, (3 + c_feat,) + tuple(widths))
        p1, cw = hoist_layer1(pc, centers, feats, ws[0], bs[0])
        out.append(dict(xyz=pc.contiguous(), centers=centers, mask=mask,
                        p1=p1, cw=cw, rest=list(zip(ws[1:], bs[1:])),
                        radius=r, nsample=ns))
    return out


def fp_case(level: str, pc, mask, gen: torch.Generator,
            npoint: int | None = None):
    """Arguments of ops.fused_fp.fused_three_interpolate (no known mask,
    as on the model's path). npoint: that many farthest point samples as
    the known points (fp1 of a stretch cloud)."""
    b, n, _ = pc.shape
    known = (identity_gather(pc, mask) if npoint is None
             else fps_centers(pc, mask, npoint))
    unknown = pc if level == "fp1" else known
    feats = torch.randn((b, known.shape[1], FP_LEVELS[level]), generator=gen)
    return dict(unknown=unknown.contiguous(), known=known.contiguous(),
                feats=feats)


def corr_case(stage: int, pc1, mask1, pc2, mask2, gen: torch.Generator):
    """Arguments of ops.fused_correlator.fused_knn_weight_aggregate."""
    b, n, _ = pc1.shape
    c = CORR_C
    wn_ws, wn_bs = _weights(gen, (3, 8, 8, c))
    feats_p = torch.randn((b, n, c), generator=gen)
    if stage == 1:
        mlp_ws, mlp_bs = _weights(gen, (c, c, c))
        return dict(query=pc1, points=pc2, feats_p=feats_p,
                    add_q=torch.randn((b, n, c), generator=gen),
                    mask_p=mask2, mlp_ws=mlp_ws, mlp_bs=mlp_bs,
                    wn_ws=wn_ws, wn_bs=wn_bs)
    return dict(query=pc1, points=pc1, feats_p=feats_p, add_q=None,
                mask_p=mask1, mlp_ws=[], mlp_bs=[], wn_ws=wn_ws,
                wn_bs=wn_bs)


# Known counts of B2 and candidate counts of B3's selection around the
# kernels' partitions (lane groups of 8 to 32, batches of 16, pieces of
# 4096 points), as the CPU and the card tests take them.
FP_PARTITION_KNOWN = (1, 2, 3, 33, 100, 1000)
SELECT_PARTITION_CANDIDATES = (17, 33, 513, 4096)


def grid_points(rng, n: int, scale: float = 8.0):
    """(n, 3) float32 points on a 1/16 grid, |x| < 60: every expanded-form
    and matmul-form distance between two of them is exact in float32."""
    x = np.clip(scale * rng.randn(n, 3), -59, 59)
    return (np.round(16 * x) / 16).astype(np.float32)


def _near(rng, points, n: int):
    """n grid points, each a step or two of the grid from one of
    `points`: most have close neighbours and several at equal range."""
    pick = points[rng.randint(0, len(points), n)]
    return (pick + rng.randint(-2, 3, (n, 3)) / 16).astype(np.float32)


def _repeat_earlier(rng, points, offsets):
    """Copy points over later ones at the given index offsets (for a third
    of the indices), so that equal distances fall on other lanes."""
    out = points.copy()
    m = len(out)
    for j in range(m):
        off = offsets[j % len(offsets)]
        if j >= off and rng.rand() < 1 / 3:
            out[j] = out[j - off]
    return out


def _valid_mask(rng, m: int, n_valid):
    if n_valid is None:
        return None
    mask = np.zeros(m, bool)
    mask[rng.permutation(m)[:n_valid]] = True
    return mask


def fp_partition_case(m: int, n: int = 128, c: int = 64, n_valid=None,
                      duplicates: bool = False, seed: int = 0):
    """One stream for B2 -> (unknown (n, 3), known (m, 3), feats (m, c),
    known mask (m,) or None). duplicates: known points repeated 1, 3 and
    5 places later (other lanes of every lane group). n_valid: that many
    valid known points at random places."""
    rng = np.random.RandomState(seed)
    known = grid_points(rng, m)
    if duplicates:
        known = _repeat_earlier(rng, known, (1, 3, 5))
    unknown = _near(rng, known, n)
    feats = rng.randn(m, c).astype(np.float32)
    return unknown, known, feats, _valid_mask(rng, m, n_valid)


def select_partition_case(m: int, n: int = 64, n_valid=None,
                          ties: bool = False, seed: int = 0):
    """One stream for B3's selection -> (query (n, 3), points (m, 3), mask
    (m,) bool). ties: points repeated 1, 5 and 17 places later (another
    lane, another batch). n_valid: that many valid points at random
    places (all valid by default)."""
    rng = np.random.RandomState(seed)
    points = grid_points(rng, m)
    if ties:
        points = _repeat_earlier(rng, points, (1, 5, 17))
    query = _near(rng, points, n)
    mask = _valid_mask(rng, m, m if n_valid is None else n_valid)
    return query, points, mask


def _zsorted(pc, mask):
    perm = morton_perm(pc, mask)
    return gather(pc, perm).contiguous(), torch.gather(mask, 1, perm)


def knn_tiled_case(stage: int, pc1, mask1, pc2, mask2):
    """Arguments of ops.fused_knn.knn_indices_tiled for one stage of the
    split correlator: pc1 in pc2 (stage 1) or in itself (stage 2), both
    clouds Z-sorted with their padding last."""
    query, qmask = _zsorted(pc1, mask1)
    points, pmask = _zsorted(pc2, mask2) if stage == 1 else (query, qmask)
    return dict(query=query, points=points, points_mask=pmask, k=16)


def apply_case(stage: int, pc1, mask1, pc2, mask2, gen: torch.Generator):
    """Arguments of ops.fused_correlator.knn_gather_apply: `corr_case` over
    the Z-sorted clouds with the plain tiled selection's indices."""
    sel = knn_tiled_case(stage, pc1, mask1, pc2, mask2)
    kw = corr_case(stage, sel["query"], None, sel["points"], None, gen)
    del kw["mask_p"]
    kw["idx"] = knn_indices_tiled_reference(
        sel["query"], sel["points"], sel["points_mask"], k=16)[0]
    return kw


def apply_products(kw: dict, idx):
    """The two pair-layer products of one stage-1 call of the aggregate
    kernel (B4, B3's aggregate launch, B10's forward: h_1 = h_0 W_1 and
    h_2 = h_1 W_2 over the B N 16 pair rows) as torch.matmul, a callable
    for timing beside the kernel: a yardstick, used nowhere in the port.
    h_0 is the gathered rows feats_p[idx] + add_q; the outputs are written
    into tensors allocated here."""
    b, n = kw["query"].shape[:2]
    h0 = (gather(kw["feats_p"], idx.long().reshape(b, -1)).reshape(
        b, n, -1, CORR_C) + kw["add_q"].unsqueeze(2)).reshape(-1, CORR_C)
    h1, h2 = torch.empty_like(h0), torch.empty_like(h0)
    w1, w2 = kw["mlp_ws"]
    return lambda: (torch.matmul(h0, w1, out=h1), torch.matmul(h1, w2, out=h2))


def fps_case(pc, mask, npoint: int = 512):
    """Arguments of ops.sampling.furthest_point_sample."""
    return dict(xyz=pc.contiguous(), npoint=npoint, mask=mask)


def sinkhorn_case(seed: int, batch: int = 8, k: int = 32,
                  iters: int = 500, alpha: float = 0.9):
    """Sigmoid affinities (batch, k, k) with valid counts m, n drawn from
    0..k (stream 0 has no row, stream 1 no column) -> (arguments of
    ops.fused_sinkhorn.sinkhorn_uv, dict(scores, m, n, norm))."""
    rng = np.random.RandomState(seed)
    scores = torch.from_numpy(
        (1.0 / (1.0 + np.exp(-rng.randn(batch, k, k)))).astype(np.float32))
    m = rng.randint(0, k + 1, batch).astype(np.int32)
    n = rng.randint(0, k + 1, batch).astype(np.int32)
    m[0], n[1 % batch] = 0, 0
    m, n = torch.from_numpy(m), torch.from_numpy(n)
    c, log_mu, log_nu, norm = transport_problem(scores, m, n, alpha)
    return (dict(c=c, log_mu=log_mu, log_nu=log_nu, iters=iters),
            dict(scores=scores, m=m, n=n, norm=norm))


def bf16_case(kw: dict) -> dict:
    """The case `kw` of an eval kernel (sa_case, sa_scale_cases, fp_case,
    corr_case, apply_case) for its bfloat16 instantiation: compute_dtype
    bfloat16 and the known features of B2 in bfloat16. The other inputs
    stay float32, as the bfloat16 model passes them (the layer-1 hoists
    and the coordinates)."""
    out = dict(kw, compute_dtype=torch.bfloat16)
    if "feats" in out:
        out["feats"] = out["feats"].to(torch.bfloat16)
    return out


def to_device(case: dict, device) -> dict:
    """Every tensor of a case (lists and pairs included) on `device`."""
    def move(x):
        if torch.is_tensor(x):
            return x.to(device).contiguous()
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        return x
    return {k: move(v) for k, v in case.items()}


def sa_train_case(level: str, head: str, pc, mask, gen: torch.Generator,
                  centers=None):
    """Keyword arguments of ops.fused_sa_train.sa_pair_train /
    sa_pair_train_reference at one level config. centers: by default the
    identity sample of the level's points, as on the model's path."""
    radii, nsamples, mlps, c_feat = SA_LEVELS[level]
    b, n, _ = pc.shape
    if level == "sa1":
        xyz, m = pc, mask
    else:
        xyz, m = identity_gather(pc, mask), None
    if centers is None:
        centers = identity_gather(xyz, m)
    feats = torch.randn((b, n, c_feat[head]), generator=gen)
    kw = dict(xyz=xyz.contiguous(), centers=centers.contiguous(), mask=m)
    for tag, widths in zip("ab", mlps):
        dims = (3 + c_feat[head],) + tuple(widths)
        ws = [torch.randn((i, o), generator=gen) / i ** 0.5
              for i, o in zip(dims[:-1], dims[1:])]
        kw[f"pf{tag}"], kw[f"wxyz_{tag}"] = hoist_layer1_train(feats, ws[0])
        kw[f"ws_{tag}"] = ws[1:]
        kw[f"gammas_{tag}"] = [0.5 + torch.rand((c,), generator=gen)
                               for c in widths]
        kw[f"betas_{tag}"] = [0.1 * torch.randn((c,), generator=gen)
                              for c in widths]
    kw.update(radius_a=radii[0], radius_b=radii[1], nsample_a=nsamples[0],
              nsample_b=nsamples[1])
    return kw


def split_sa_train_case(kw: dict):
    """The two `sa_scale_train` cases that a `sa_pair_train` case must
    equal."""
    return [dict(xyz=kw["xyz"], centers=kw["centers"], mask=kw["mask"],
                 pf=kw[f"pf{t}"], wxyz=kw[f"wxyz_{t}"], ws=kw[f"ws_{t}"],
                 gammas=kw[f"gammas_{t}"], betas=kw[f"betas_{t}"],
                 radius=kw[f"radius_{t}"], nsample=kw[f"nsample_{t}"])
            for t in "ab"]


def pair_key(key: str, tag: str) -> str:
    """The name a one-scale case's tensor (an output or gradient of
    `sa_scale_train_run`) has in the pair case's run, scale `tag` ("a" or
    "b"): mu0 -> mu_a0, ws1 -> ws_a1, wxyz -> wxyz_a, pf -> pfa."""
    stem = key.rstrip("0123456789")
    return f"pf{tag}" if stem == "pf" else f"{stem}_{tag}{key[len(stem):]}"


def sa_scale_train_cases(level: str, pc, mask, gen: torch.Generator,
                         centers=None):
    """Keyword arguments of ops.fused_sa_train.sa_scale_train /
    sa_scale_train_reference, one per scale of a GENERAL_LEVELS level over
    the masked cloud; centers: by default the identity sample."""
    radii, nsamples, mlps, c_feat = GENERAL_LEVELS[level]
    b, n, _ = pc.shape
    centers = (identity_gather(pc, mask) if centers is None
               else centers).contiguous()
    feats = torch.randn((b, n, c_feat), generator=gen)
    out = []
    for r, ns, widths in zip(radii, nsamples, mlps):
        dims = (3 + c_feat,) + tuple(widths)
        ws = [torch.randn((i, o), generator=gen) / i ** 0.5
              for i, o in zip(dims[:-1], dims[1:])]
        pf, wxyz = hoist_layer1_train(feats, ws[0])
        out.append(dict(
            xyz=pc.contiguous(), centers=centers, mask=mask, pf=pf,
            wxyz=wxyz, ws=ws[1:],
            gammas=[0.5 + torch.rand((c,), generator=gen) for c in widths],
            betas=[0.1 * torch.randn((c,), generator=gen) for c in widths],
            radius=r, nsample=ns))
    return out


def corr_train_case(stage: int, pc1, mask1, pc2, mask2,
                    gen: torch.Generator):
    """Keyword arguments of ops.fused_correlator_train.
    fused_knn_weight_aggregate_train (stage 1 with w_dir)."""
    kw = corr_case(stage, pc1, mask1, pc2, mask2, gen)
    kw["w_dir"] = (0.05 * torch.randn((3, CORR_C), generator=gen)
                   if stage == 1 else None)
    return kw


def _leaf(x):
    return x.detach().clone().requires_grad_(True)


def _leaves(kw, names):
    """kw with the named tensors (and lists of tensors) replaced by fresh
    leaves that require grad, and those leaves by name."""
    kw = dict(kw)
    for key in names:
        kw[key] = ([_leaf(t) for t in kw[key]] if isinstance(kw[key], list)
                   else _leaf(kw[key]))
    return kw, {key: kw[key] for key in names}


def flat_leaves(leaves: dict):
    """{name: tensor or [tensors]} -> [(flat name, tensor)]."""
    out = []
    for key, val in leaves.items():
        if isinstance(val, list):
            out += [(f"{key}{i}", t) for i, t in enumerate(val)]
        else:
            out.append((key, val))
    return out


def _cotangent(shape, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device)


def sa_train_loss(fn, kw: dict, seed: int = 0):
    """fn(**kw) forward -> (sum(pooled * G) with G seeded normal, outputs
    {name: tensor}, leaves {name: leaf}). fn is ops.fused_sa_train.
    sa_pair_train or sa_pair_train_reference."""
    names = [f"{k}{tag}" for tag in "ab" for k in ("pf", "wxyz_")] + [
        f"{k}_{tag}" for tag in "ab" for k in ("ws", "gammas", "betas")]
    kw, leaves = _leaves(kw, names)
    loss, outs = 0.0, {}
    for k, (tag, (pooled, mus, vrs, idx)) in enumerate(zip("ab", fn(**kw))):
        loss = loss + (pooled * _cotangent(pooled.shape, seed + k,
                                           pooled.device)).sum()
        outs[f"pooled_{tag}"] = pooled.detach()
        outs[f"idx_{tag}"] = idx
        for li, (mu, var) in enumerate(zip(mus, vrs)):
            outs[f"mu_{tag}{li}"] = mu.detach()
            outs[f"var_{tag}{li}"] = var.detach()
    return loss, outs, leaves


def sa_scale_train_loss(fn, kw: dict, seed: int = 0):
    """As sa_train_loss for ops.fused_sa_train.sa_scale_train or
    sa_scale_train_reference."""
    kw, leaves = _leaves(kw, ["pf", "wxyz", "ws", "gammas", "betas"])
    pooled, mus, vrs, idx = fn(**kw)
    loss = (pooled * _cotangent(pooled.shape, seed, pooled.device)).sum()
    outs = {"pooled": pooled.detach(), "idx": idx}
    for li, (mu, var) in enumerate(zip(mus, vrs)):
        outs[f"mu{li}"], outs[f"var{li}"] = mu.detach(), var.detach()
    return loss, outs, leaves


def corr_train_loss(fn, kw: dict, seed: int = 0):
    """As sa_train_loss for ops.fused_correlator_train.
    fused_knn_weight_aggregate_train (return_indices=True) or
    knn_weight_aggregate_train_reference; the leaves include the query
    and point positions (one leaf when they are one cloud)."""
    names = [k for k in ("query", "points", "feats_p", "add_q", "w_dir")
             if kw[k] is not None] + ["mlp_ws", "mlp_bs", "wn_ws", "wn_bs"]
    one_cloud = kw["points"] is kw["query"]       # stage 2: pc1 in pc1
    if one_cloud:
        names.remove("points")
    kw, leaves = _leaves(kw, names)
    if one_cloud:
        kw["points"] = kw["query"]
    out, idx = fn(**kw)
    loss = (out * _cotangent(out.shape, seed, out.device)).sum()
    return loss, {"out": out.detach(), "idx": idx}, leaves


def _run(loss_fn, fn, kw, seed):
    loss, outs, leaves = loss_fn(fn, kw, seed)
    loss.backward()
    return outs, {name: torch.zeros_like(t) if t.grad is None else t.grad
                  for name, t in flat_leaves(leaves)}


def sa_train_run(fn, kw: dict, seed: int = 0):
    """sa_train_loss forward and backward -> (outputs, gradients by
    name)."""
    return _run(sa_train_loss, fn, kw, seed)


def sa_scale_train_run(fn, kw: dict, seed: int = 0):
    """sa_scale_train_loss forward and backward -> (outputs, gradients)."""
    return _run(sa_scale_train_loss, fn, kw, seed)


def corr_train_run(fn, kw: dict, seed: int = 0):
    """corr_train_loss forward and backward -> (outputs, gradients)."""
    return _run(corr_train_loss, fn, kw, seed)


def corr_train_products(fn, kw: dict):
    """The four pair-layer products of B10's stage-1 backward (dW_2 = h_1^T
    dz_2, dh_1 = dz_2 W_2^T, dW_1 = h_0^T dz_1, dh_0 = dz_1 W_1^T) as
    torch.matmul, a callable for timing beside the kernel: a yardstick,
    used nowhere in the port. fn, the kernel wrapper (return_indices=True)
    on CUDA tensors, runs the forward once for its stash (h_0, h_1, h_2),
    which also stands in for dz_2 and dz_1 (the same shapes)."""
    out, _ = fn(**dict(kw, feats_p=_leaf(kw["feats_p"])))
    h0, h1, h2 = out.grad_fn.saved_tensors[-3:]
    w1, w2 = kw["mlp_ws"]
    return lambda: (h1.t() @ h2, h2 @ w2.t(), h0.t() @ h1, h1 @ w1.t())


def to_float64(case: dict) -> dict:
    """Every floating tensor of a case (lists included) in float64."""
    def cast(x):
        if torch.is_tensor(x):
            return x.double() if x.is_floating_point() else x
        if isinstance(x, list):
            return [cast(v) for v in x]
        return x
    return {k: cast(v) for k, v in case.items()}


def compare_train(got, want, want64=None, cancelling=None):
    """Kernel run vs plain run (each (outputs, gradients)) -> a list of
    failures (empty when they agree) and a dict of each entry's max abs
    error against the plain run.

    Outputs and batch statistics: max abs error <= 1e-4 * max|plain| +
    1e-5; selected indices identical; everything finite.
    Gradients: cosine with the plain run >= 0.9999, and in norm
    |g - g64| <= 1e-3 |g64| + 2 |g_plain - g64| + 1e-5, g64 the plain
    version run in float64 on the same inputs (want64; without it, the
    float32 plain run stands in and the bound is 1e-3 |g_plain|): the
    kernel's float32 error at most twice the plain version's. The
    float64 yardstick is needed because the max-pools make the gradient
    ill-conditioned: where two different slots of a center come within
    float32 rounding of each other, either run may route the cotangent to
    the other one. At 8 streams x 512 centers the plain version in float32
    is itself 1.9e-3 (in norm) and 1.9 (max abs, against a 0.37 bound of
    the max-abs kind) from its float64 run (sa2, scale b, dW_xyz).

    cancelling {gradient: other gradient}: a gradient that is a sum of
    terms cancelling to 0 in exact arithmetic (dPF when every slot of a
    stream is one point: a batch norm's input gradients sum to 0 over its
    rows) is rounding noise on every side; it is held to 1e-3 * max|plain|
    of the other gradient, a sum of the same terms weighted by relative
    coordinates, and has no cosine."""
    cancelling = cancelling or {}
    bad, errs = [], {}
    for key, w in want[0].items():
        g = got[0][key]
        if key.startswith("idx"):
            if not torch.equal(g.long(), w.long()):
                bad.append(f"{key}: indices differ")
            continue
        g, w = g.double(), w.double()
        errs[key] = err = (g - w).abs().max().item()
        tol = 1e-4 * w.abs().max().item() + 1e-5
        if not bool(torch.isfinite(g).all()):
            bad.append(f"{key}: not finite")
        if err > tol:
            bad.append(f"{key}: max abs err {err:.3g} > tol {tol:.3g}")
    for key, w in want[1].items():
        g, w = got[1][key].double(), w.double()
        if not bool(torch.isfinite(g).all()):
            bad.append(f"{key}: not finite")
        if key in cancelling:
            errs[key] = err = (g - w).abs().max().item()
            tol = 1e-3 * want[1][cancelling[key]].abs().max().item() + 1e-5
            if err > tol:
                bad.append(f"{key}: max abs err {err:.3g} > tol {tol:.3g}")
            continue
        errs[key] = (g - w).abs().max().item()
        w64 = w if want64 is None else want64[1][key].double()
        err = (g - w64).norm().item()
        tol = (1e-3 * w64.norm().item() + 2.0 * (w - w64).norm().item()
               + 1e-5)
        if err > tol:
            bad.append(f"{key}: error {err:.3g} in norm > {tol:.3g}")
        ng, nw = g.norm().item(), w.norm().item()
        if nw > 1e-12 or ng > 1e-12:
            cos = (g * w).sum().item() / max(ng * nw, 1e-30)
            if cos < 0.9999:
                bad.append(f"{key}: cosine {cos:.6f} < 0.9999")
    return bad, errs


# ---- roofline work: bytes moved and float32 operations needed ----------
# Each *_work returns (bytes, product operations, other operations).

DIST_OPS = 10   # one expanded-form distance and its comparison


def case_bytes(*trees) -> int:
    """Bytes of every tensor in the given cases / outputs (dicts, lists,
    tuples, tensors; anything else counts 0): each read or written once."""
    total = 0
    for tree in trees:
        if torch.is_tensor(tree):
            total += tree.numel() * tree.element_size()
        elif isinstance(tree, dict):
            total += case_bytes(*tree.values())
        elif isinstance(tree, (list, tuple)):
            total += case_bytes(*tree)
    return total


def _filled(idx):
    """Filled slots per center of a ball query's (B, M, ns) indices
    (padding slots repeat slot 0)."""
    return (idx != idx[..., :1]).sum(-1) + 1


def _slot_ops(c1: int, rest):
    """(Product, other) operations of the folded MLP on one filled slot."""
    return (sum(2 * w.shape[0] * w.shape[1] for w, _ in rest),
            2 * c1 + sum(2 * w.shape[1] for w, _ in rest))


def sa_pair_work(kw: dict, out_a, out_b, idx_a, idx_b):
    """B1 -> (bytes, product ops, other ops). Operations: the scan of each
    center up to where both slot lists are full (the whole cloud
    otherwise), and the folded MLP over the filled slots only."""
    n = kw["xyz"].shape[1]
    mm, ops, full, last = 0, 0, [], []
    for tag, idx, ns in (("a", idx_a, kw["nsample_a"]),
                         ("b", idx_b, kw["nsample_b"])):
        filled = int(_filled(idx).sum())
        slot_mm, slot_ops = _slot_ops(kw[f"p1{tag}"].shape[-1],
                                      kw[f"rest_{tag}"])
        mm += filled * slot_mm
        ops += filled * slot_ops
        full.append(_filled(idx) >= ns)
        last.append(idx.amax(-1) + 1)
    scanned = torch.where(full[0] & full[1], torch.maximum(*last),
                          torch.full_like(last[0], n))
    ops += DIST_OPS * int(scanned.sum())
    return case_bytes(kw, out_a, out_b), mm, ops


def sa_scale_work(kw: dict, out, idx):
    """B1' -> (bytes, product ops, other ops), counted as `sa_pair_work`
    counts one scale."""
    n = kw["xyz"].shape[1]
    filled = _filled(idx)
    scanned = torch.where(filled >= kw["nsample"], idx.amax(-1) + 1,
                          torch.full_like(filled, n))
    slot_mm, slot_ops = _slot_ops(kw["p1"].shape[-1], kw["rest"])
    return (case_bytes(kw, out), int(filled.sum()) * slot_mm,
            int(filled.sum()) * slot_ops + DIST_OPS * int(scanned.sum()))


def three_interpolate_work(kw: dict, out):
    """B2 -> (bytes, 0, operations): every unknown x known distance, then
    3 weighted rows."""
    b, n, _ = kw["unknown"].shape
    m, c = kw["feats"].shape[1], kw["feats"].shape[2]
    return case_bytes(kw, out), 0, b * n * (DIST_OPS * m + 6 * c + 12)


def knn_select_work(query, points, mask, idx):
    """B3's selection launch -> (bytes, 0, operations): one distance and
    comparison per query and candidate."""
    b, n, _ = query.shape
    return (case_bytes(query, points, mask, idx), 0,
            DIST_OPS * b * n * points.shape[1])


def _pair_ops(kw: dict):
    """(Product, other) operations per (query, slot) pair of a correlator
    stage."""
    c = CORR_C
    mm = 2 * (3 * 8 + 8 * 8 + 8 * c)                  # WeightNet
    ops = 2 * c                                       # the slot sum
    mm += sum(2 * w.shape[0] * w.shape[1] for w in kw["mlp_ws"])
    ops += sum(2 * w.shape[1] for w in kw["mlp_ws"])
    if kw["add_q"] is not None:
        ops += 2 * c
    if kw.get("w_dir") is not None:
        mm += 2 * 3 * c
    return mm, ops


def corr_work(kw: dict, out, select: bool = True):
    """B3 (select=True: with the kNN's one pass of distances), B4 or B10's
    forward -> (bytes, product ops, other ops)."""
    b, n, _ = kw["query"].shape
    m = kw["points"].shape[1]
    mm, ops = _pair_ops(kw)
    ops *= b * n * 16
    if select:
        ops += DIST_OPS * b * n * m
    return case_bytes(kw, out), b * n * 16 * mm, ops


def corr_train_bwd_work(kw: dict, out):
    """B10's backward -> (bytes, product ops, other ops): per pair layer a
    dW and a dh product; it reads the forward's inputs, the cotangent and
    the stashed activations ((n_mlp + 1) x (B N 16, 256) for stage 1) and
    writes a gradient per input."""
    b, n, _ = kw["query"].shape
    rows = b * n * 16
    n_mlp = len(kw["mlp_ws"])
    stash = (n_mlp + 1) * rows * CORR_C * 4 if kw["add_q"] is not None else 0
    mm, ops = _pair_ops(kw)
    return (2 * case_bytes(kw) + case_bytes(out) + stash, 2 * rows * mm,
            2 * rows * ops)


def _train_slot_ops(widths):
    """(Product, other) operations of the train-mode MLP on one slot: layer
    1's coordinate term and the Dense layers; batch norm, ReLU and max per
    channel."""
    return (2 * 3 * widths[0]
            + sum(2 * i * o for i, o in zip(widths[:-1], widths[1:])),
            sum(6 * w for w in widths))


def sa_train_work(kw: dict, outs: dict):
    """B9 -> (forward (bytes, product ops, other ops), backward (...)).
    Train-mode batch norm counts every slot, padding included, so the MLP
    runs over all M x nsample slots; the backward is a dW and a dh product
    per layer."""
    b, n, _ = kw["xyz"].shape
    m = kw["centers"].shape[1]
    mm = ops = 0
    for tag in "ab":
        widths = [kw[f"wxyz_{tag}"].shape[1]] + [w.shape[1]
                                                 for w in kw[f"ws_{tag}"]]
        slot_mm, slot_ops = _train_slot_ops(widths)
        mm += b * m * kw[f"nsample_{tag}"] * slot_mm
        ops += b * m * kw[f"nsample_{tag}"] * slot_ops
    fwd_bytes = case_bytes(kw, outs)
    return ((fwd_bytes, mm, ops + DIST_OPS * b * m * n),
            (2 * fwd_bytes, 2 * mm, 2 * ops))


def sa_scale_train_work(kw: dict, outs: dict):
    """B8 -> (forward, backward) as `sa_train_work`, for one scale."""
    b, n, _ = kw["xyz"].shape
    m = kw["centers"].shape[1]
    widths = [kw["wxyz"].shape[1]] + [w.shape[1] for w in kw["ws"]]
    slot_mm, slot_ops = _train_slot_ops(widths)
    mm = b * m * kw["nsample"] * slot_mm
    ops = b * m * kw["nsample"] * slot_ops
    fwd_bytes = case_bytes(kw, outs)
    return ((fwd_bytes, mm, ops + DIST_OPS * b * m * n),
            (2 * fwd_bytes, 2 * mm, 2 * ops))


def knn_tiled_work(kw: dict, idx, keys):
    """B5 -> (bytes, 0, operations): one distance and comparison per query
    and valid candidate."""
    b, n, _ = kw["query"].shape
    valid = (int(kw["points_mask"].sum()) if kw["points_mask"] is not None
             else b * kw["points"].shape[1])
    return case_bytes(kw, idx, keys), 0, DIST_OPS * n * valid


def transport_flow_work(kw: dict, flow):
    """B11 -> (bytes, product operations, other operations), counting the
    dense n x m algorithm: the cost's and the distances' products, 4 n m
    operations an iteration, 8 n m for the plan's flow and row sums; the
    features, clouds and flow in and out."""
    b, n, c = kw["f"].shape
    m = kw["g"].shape[1]
    nbytes = case_bytes(kw["f"], kw["g"], kw["p"], kw["q"], flow)
    return (nbytes, b * 2 * n * m * (c + 3),
            b * n * m * (4 * kw["iters"] + 8))


def fps_work(kw: dict, out):
    """B6 -> (bytes, 0, operations): 9 operations a point and step."""
    b, n, _ = kw["xyz"].shape
    return case_bytes(kw, out), 0, 9 * b * n * (kw["npoint"] - 1)


def sinkhorn_work(kw: dict, u, v):
    """B7 -> (bytes, 0, operations): an add, an exp and an add per matrix
    entry and half-step."""
    b, k1 = kw["log_mu"].shape
    return case_bytes(kw, u, v), 0, 3 * 2 * kw["iters"] * b * k1 * k1
