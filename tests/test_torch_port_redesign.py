"""CPU parity tests for the shapes that the Hopper designs of kernels B9 /
B8 (backward) and B6 partition: the port's plain versions (what the CPU
runs; the kernels are held against them on the card, see
tests/test_torch_port_cuda.py) against the JAX package on the same numpy
inputs.

B9 / B8: a thread-block cluster of 8 blocks shares a stream's centers and
each block walks its rows in 64-row tiles, so the cases have a center count
that 8 does not divide, M * nsample that is no multiple of 8 x 64, fewer
centers than points and one stream, against the JAX unfused
`sa_scale_train_reference` per stream. Outputs and batch statistics: 1e-4 x
max|jax|. Gradients: every leaf within 1e-2 of the whole gradient's norm
and cosine >= 0.99 (the classes ROADMAP.md names for the train kernels;
near-ties in the max-pools keep a float32 gradient from being tighter).

B6: a block's threads own strided slices of the cloud and a cluster's
blocks slices of those, so the cases have N that 32 does not divide,
N = npoint with no mask, exact ties, one valid point, none, and npoint
above the valid count, against JAX `furthest_point_sample` index for index.

B10 (backward): the pair-layer products run over 128-row tiles and split-K
chunks of 1,024 pair rows (B * N * 16 of them), so the cases have row
counts that fill neither, one stream, a stream with fewer valid candidates
than k = 16, and both stages, against the JAX
`knn_weight_aggregate_reference` per stream: output 1e-4 x max|jax|, every
gradient leaf within 1e-2 of the whole gradient's norm and cosine >= 0.99.
Coordinates lie on a 1/16 grid, so every distance is exact in both
packages and the selections agree.

B1 / B1' (eval): a block owns a tile of 8-32 centers and packs their
filled slots into row chunks, so the cases have 33, 100 and 513 centers
(tiles that end part-full), N != M, every slot filled, one filled and none,
against the JAX `sa_scale_reference` (any shape; it has no no-hit rule, so
every center there keeps a hit) and the JAX kernel in interpret mode (its
shapes are multiples of 128): 1e-4 x max|jax|, the port's output through
its plain version.

B5: the kernel walks candidate chunks of 128-512 from the tile's own place
in the cloud and skips chunks by a bound, so the cases put exact ties in
different chunks (grid-snapped duplicates 128 and 256 places apart), a
ragged last chunk, k below 16, fewer valid candidates than k, and an
unsorted clustered cloud, against the JAX `knn_indices_tiled` in interpret
mode with 128-candidate chunks: indices equal, keys within 1e-4 x max.

B2: a block stages the known cloud and G = 8 to 32 lanes share an
unknown, each lane a strided share of the known points, merged by three
(d^2, index) argmins over the group; so the cases have known counts 1, 2,
3, 33, 100 and 1000 (fewer than 3; groups part-filled), 128 and 256
unknowns, known points repeated 1, 3 and 5 places later (equal distances
on other lanes of a group) and 0, 1 or 2 valid known points, against the
JAX `fused_three_interpolate` in interpret mode in float32: values within
1e-5 x max|jax|, indices equal to JAX `knn(3, ...)` where M >= 3.

B3's selection: one pass over the staged cloud, 16 lanes a query taking
batches of 16 candidates, so the cases have 17, 33, 513 and 4096
candidates, 0, 1, 15, 16 and 17 valid, and points repeated 1, 5 and 17
places later (ties across lanes and batches), against JAX `knn(16, ...)`:
indices equal, squared distances within 1e-5 relative. Both sets of
cases come from kernels/cases.py (`fp_partition_case`,
`select_partition_case`), on a 1/16 grid so that every distance is exact
in both packages; the card tests hold the kernels to the plain versions
at the same cases.

The measuring builds that kernels/tune.py times B1, B2, B3's selection
and B5 with (the skeleton, the gate off) are keyed apart from the port's
own build.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu.ops import pallas_sa
from ratrack_tpu.ops.neighborhood import knn as j_knn
from ratrack_tpu.ops.pallas_fp import fused_three_interpolate as j_fp
from ratrack_tpu.ops.pallas_correlator_train import \
    knn_weight_aggregate_reference as jcorr_reference
from ratrack_tpu.ops.pallas_knn import knn_indices_tiled as j_knn_tiled
from ratrack_tpu.ops.pallas_sa_train import sa_scale_train_reference
from ratrack_tpu.ops.sampling import furthest_point_sample as j_fps
from ratrack_tpu_torch.kernels import build as kb
from ratrack_tpu_torch.kernels import cases
from ratrack_tpu_torch.ops.fused_correlator_train import \
    fused_knn_weight_aggregate_train
from ratrack_tpu_torch.ops.fused_fp import three_interpolate_reference
from ratrack_tpu_torch.ops.fused_knn import knn_indices_tiled
from ratrack_tpu_torch.ops.fused_sa import fused_sa_pair, fused_sa_scale
from ratrack_tpu_torch.ops.fused_sa_train import (fused_sa_pair_train,
                                                  fused_sa_scale_train)
from ratrack_tpu_torch.ops.neighborhood import knn
from ratrack_tpu_torch.ops.sampling import (furthest_point_sample,
                                            furthest_point_sample_reference)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _scale_params(rng, c_in, widths):
    dims = (c_in,) + tuple(widths)
    return ([(rng.randn(i, o) / np.sqrt(i)).astype(np.float32)
             for i, o in zip(dims[:-1], dims[1:])],
            [rng.uniform(0.5, 1.5, o).astype(np.float32) for o in widths],
            [(0.1 * rng.randn(o)).astype(np.float32) for o in widths])


# name: (streams, points, centers, channels, (radius, nsample, widths) x 2)
SA_SHAPES = {
    # M * ns = 400 / 800: neither fills 8 blocks x 64-row tiles
    "one_stream_100_centers": (1, 160, 100, 5, ((3.0, 4, (16, 16, 32)),
                                                (6.0, 8, (16, 16, 32)))),
    # 8 does not divide 37 centers: the blocks' shares are ragged
    "two_streams_37_centers": (2, 150, 37, 8, ((4.0, 8, (32, 32)),
                                               (8.0, 16, (32, 64)))),
    # 12 centers in shares of 2: two of a cluster's 8 blocks own none
    "twelve_centers": (2, 96, 12, 3, ((4.0, 8, (16, 32)),
                                      (8.0, 16, (16, 32)))),
}


def _sa_case(name):
    b, n, m, c, scales = SA_SHAPES[name]
    rng = np.random.RandomState(len(name))
    xyz = (rng.randn(b, n, 3) * 4.0).astype(np.float32)
    mask = rng.rand(b, n) > 0.25
    mask[:, 0] = True
    # the centers are valid points of the cloud, as samples of it are
    centers = np.stack([xyz[s][np.flatnonzero(mask[s])[:m]]
                        for s in range(b)])
    assert centers.shape == (b, m, 3)
    feats = rng.randn(b, n, c).astype(np.float32)
    prm = [_scale_params(rng, 3 + c, w) for _, _, w in scales]
    cot = [rng.randn(b, m, w[-1]).astype(np.float32) for _, _, w in scales]
    return xyz, centers, mask, feats, prm, cot, scales


def _jax_scale(xyz, centers, mask, feats, prm, cot, radius, nsample):
    """The JAX reference stream by stream -> (outputs stacked over the
    streams, gradients: d feats stacked, the parameters' summed)."""
    def loss(f, p, x, cc, mb, g):
        o = sa_scale_train_reference(x, cc, f, mb, *p, radius=radius,
                                     nsample=nsample)
        return jnp.sum(o[0] * g), o
    run = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))
    per = [run(feats[s], prm, xyz[s], centers[s], mask[s], cot[s])
           for s in range(xyz.shape[0])]
    outs = [np.stack([np.asarray(leaf) for leaf in leaves]) for leaves in
            zip(*[[o[0]] + list(o[1]) + list(o[2]) for _, o in per])]
    d_prm = [sum(np.asarray(leaf, np.float64) for leaf in leaves).astype(
        np.float32) for leaves in
        zip(*[jax.tree_util.tree_leaves(g[1]) for g, _ in per])]
    return outs, [np.stack([np.asarray(g[0]) for g, _ in per])] + d_prm


def _assert_sa_match(outs, grads, j_outs, j_grads):
    for a, b in zip(outs, j_outs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    assert len(grads) == len(j_grads)
    want = [np.asarray(w) for w in j_grads]
    total = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum())
                        for w in want))
    for g, w in zip(grads, want):
        g = g.numpy()
        assert np.linalg.norm(g - w) <= 1e-2 * total
        if np.linalg.norm(w) > 1e-6 * total:
            cos = float(g.ravel() @ w.ravel()
                        / (np.linalg.norm(g) * np.linalg.norm(w)))
            assert cos >= 0.99, cos


@pytest.mark.parametrize("name", sorted(SA_SHAPES))
def test_sa_pair_train_reference_ragged_shapes_match_jax(name):
    xyz, centers, mask, feats, prm, cot, scales = _sa_case(name)
    f_t = _t(feats).requires_grad_(True)
    p_t = [[[_t(a).requires_grad_(True) for a in group] for group in sc]
           for sc in prm]
    (ra, na, rb, nb) = (scales[0][0], scales[0][1], scales[1][0],
                        scales[1][1])
    res = fused_sa_pair_train(_t(xyz), _t(centers), f_t, _t(mask), *p_t[0],
                              *p_t[1], radius_a=ra, nsample_a=na,
                              radius_b=rb, nsample_b=nb)
    sum((r[0] * _t(c)).sum() for r, c in zip(res, cot)).backward()
    j = [_jax_scale(xyz, centers, mask, feats, prm[s], cot[s], scales[s][0],
                    scales[s][1]) for s in range(2)]
    # the features' gradient sums over both scales
    j_df = np.asarray(j[0][1][0]) + np.asarray(j[1][1][0])
    _assert_sa_match(
        [t for r in res for t in [r[0]] + list(r[1]) + list(r[2])],
        [f_t.grad] + [a.grad for sc in p_t for group in sc for a in group],
        j[0][0] + j[1][0], [j_df] + j[0][1][1:] + j[1][1][1:])


@pytest.mark.parametrize("scale", [0, 1])
@pytest.mark.parametrize("name", sorted(SA_SHAPES))
def test_sa_scale_train_reference_ragged_shapes_match_jax(name, scale):
    xyz, centers, mask, feats, prm, cot, scales = _sa_case(name)
    radius, nsample, _ = scales[scale]
    f_t = _t(feats).requires_grad_(True)
    p_t = [[_t(a).requires_grad_(True) for a in group]
           for group in prm[scale]]
    pooled, mus, vrs = fused_sa_scale_train(
        _t(xyz), _t(centers), f_t, _t(mask), *p_t, radius=radius,
        nsample=nsample)
    (pooled * _t(cot[scale])).sum().backward()
    _assert_sa_match(
        [pooled] + list(mus) + list(vrs),
        [f_t.grad] + [a.grad for group in p_t for a in group],
        *_jax_scale(xyz, centers, mask, feats, prm[scale], cot[scale],
                    radius, nsample))


# name: (points, samples, valid count per stream (None: no mask), on a grid)
FPS_SHAPES = {
    "n500_not_a_multiple_of_32": (500, 64, (500, 300, 33), False),
    "n512_all_sampled_no_mask": (512, 512, None, False),
    "n500_exact_ties": (500, 200, (500, 260, 100), True),
    "one_valid_and_none_valid": (500, 16, (1, 0, 2), False),
    "samples_above_the_valid_count": (330, 96, (40, 7, 95), False),
    "n33_one_point_past_a_warp": (33, 33, (33, 20, 1), True),
}


@pytest.mark.parametrize("name", sorted(FPS_SHAPES))
def test_fps_reference_partition_shapes_match_jax(name):
    n, npoint, valid, grid = FPS_SHAPES[name]
    rng = np.random.RandomState(n + npoint)
    b = 3
    xyz = (rng.randn(b, n, 3) * 20).astype(np.float32)
    if grid:     # coincident points and exactly equal distances
        xyz = np.round(xyz / 10.0).astype(np.float32)
    mask = None
    if valid is not None:
        mask = np.zeros((b, n), bool)
        for s in range(b):
            mask[s, rng.permutation(n)[:valid[s]]] = True
    got = furthest_point_sample(_t(xyz), npoint,
                                None if mask is None else _t(mask))
    ref = furthest_point_sample_reference(
        _t(xyz), npoint, None if mask is None else _t(mask))
    assert got.shape == (b, npoint) and got.dtype == torch.int64
    assert torch.equal(got, ref)
    for s in range(b):
        m = None if mask is None else jnp.asarray(mask[s])
        want = np.asarray(j_fps(jnp.asarray(xyz[s]), npoint, m))
        np.testing.assert_array_equal(got[s].numpy(), want)
        if valid is not None and valid[s] == 0:
            assert not got[s].any()
        if valid is None and npoint == n:
            assert sorted(got[s].tolist()) == list(range(n))


# name: (streams, queries, candidates (stage 1), valid candidates per stream
# (None: all))
CORR_SHAPES = {
    # 592 pair rows: a ragged 128-row tile and one part-filled dW chunk
    "one_stream_37_queries": (1, 37, 50, None),
    # 2,240 pair rows: two full 1,024-row chunks and a ragged third
    "two_streams_past_a_chunk": (2, 70, 90, None),
    # a stream with 9 valid candidates: slots past them repeat the nearest
    "fewer_valid_than_k": (2, 20, 40, (40, 9)),
}


def _corr_case(name, stage):
    b, n, m, valid = CORR_SHAPES[name]
    rng = np.random.RandomState(100 + 7 * stage + len(name))
    grid = lambda *shape: (np.round(rng.randn(*shape) * 64) / 16).astype(
        np.float32)  # noqa: E731
    q = grid(b, n, 3)
    p = grid(b, m, 3) if stage == 1 else q
    mask = np.ones(p.shape[:2], bool)
    for s, v in enumerate(valid or ()):
        mask[s, v:] = False
    c = 256
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    n_mlp = 2 if stage == 1 else 0
    diff = dict(
        q=q, fp=f32(rng.randn(b, p.shape[1], c)),
        mlp=([f32(rng.randn(c, c) / 16) for _ in range(n_mlp)],
             [f32(0.1 * rng.randn(c)) for _ in range(n_mlp)]),
        wn=([f32(rng.randn(3, 8)), f32(0.3 * rng.randn(8, 8)),
             f32(0.3 * rng.randn(8, c))],
            [f32(0.1 * rng.randn(w)) for w in (8, 8, c)]))
    if stage == 1:
        diff.update(p=p, aq=f32(rng.randn(b, n, c)),
                    wdir=f32(0.05 * rng.randn(3, c)))
    return diff, mask, f32(rng.randn(b, n, c))


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("name", sorted(CORR_SHAPES))
def test_correlator_train_ragged_shapes_match_jax(name, stage):
    diff, mask, cot = _corr_case(name, stage)

    def jax_loss(d):
        def one(qb, pb, fb, ab, mb):
            return jcorr_reference(qb, pb, fb, ab, mb, *d["mlp"], *d["wn"],
                                   w_dir=d.get("wdir"))
        pts = d["p"] if stage == 1 else d["q"]
        ab = d["aq"] if stage == 1 else jnp.zeros((mask.shape[0], 1))
        out = jax.vmap(lambda qb, pb, fb, a, mb: one(
            qb, pb, fb, a if stage == 1 else None, mb))(
            d["q"], pts, d["fp"], ab, mask)
        return jnp.sum(out * cot), out
    jgrad, jout = jax.jit(jax.grad(jax_loss, has_aux=True))(diff)

    t = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True), diff)
    out = fused_knn_weight_aggregate_train(
        t["q"], t["p"] if stage == 1 else t["q"], t["fp"], t.get("aq"),
        _t(mask), *t["mlp"], *t["wn"], w_dir=t.get("wdir"))
    (out * _t(cot)).sum().backward()
    want = np.asarray(jout)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda a: a.grad.numpy(), t))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrad)]
    assert len(got) == len(want)
    total = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum())
                        for w in want))
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) <= 1e-2 * total
        if np.linalg.norm(w) > 1e-6 * total:
            cos = float(g.ravel() @ w.ravel()
                        / (np.linalg.norm(g) * np.linalg.norm(w)))
            assert cos >= 0.99, cos


# ---- B1 / B1' (eval) at the center tiles' edges -------------------------

def _folded(rng, dims):
    ws = [(rng.randn(i, o) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.randn(o)).astype(np.float32) for o in dims[1:]]
    return ws, bs


def _eval_sa_cloud(seed, n, m, c, n_valid, spread=3.0):
    """One stream: n points (the first n_valid valid), m centers next to
    valid points (each keeps at least one hit), c feature channels."""
    rng = np.random.RandomState(seed)
    xyz = (spread * rng.randn(n, 3)).astype(np.float32)
    mask = np.arange(n) < n_valid
    pick = rng.randint(0, n_valid, m)
    centers = (xyz[pick] + 0.05 * rng.randn(m, 3)).astype(np.float32)
    return rng, xyz, centers, mask, rng.randn(n, c).astype(np.float32)


def _tl(xs):
    return [_t(x) for x in xs]


_j_sa_reference = jax.jit(pallas_sa.sa_scale_reference,
                          static_argnames=("radius", "nsample"))


@pytest.mark.parametrize("m", [33, 100, 513])
def test_sa_eval_plain_at_ragged_center_tiles_matches_jax(m):
    """Both scales of every SA_LEVELS level (pn_head widths) at m centers
    over 600 points, 450 valid, against the JAX reference; sa3's radii
    fill all 16 + 32 slots of most centers."""
    for level, (radii, nsamples, mlps, c_feat) in cases.SA_LEVELS.items():
        c = c_feat["pn_head"]
        rng, xyz, centers, mask, feats = _eval_sa_cloud(m, 600, m, c, 450)
        prm = [_folded(rng, (3 + c,) + w) for w in mlps]
        got = fused_sa_pair(_t(xyz)[None], _t(centers)[None],
                            _t(feats)[None], _t(mask)[None],
                            _tl(prm[0][0]), _tl(prm[0][1]), _tl(prm[1][0]),
                            _tl(prm[1][1]), radius_a=radii[0],
                            radius_b=radii[1], nsample_a=nsamples[0],
                            nsample_b=nsamples[1])
        for t in range(2):
            want = np.asarray(_j_sa_reference(
                jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(feats),
                jnp.asarray(mask), *prm[t], radius=radii[t],
                nsample=nsamples[t]))
            np.testing.assert_allclose(got[t][0].numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n_valid", [0, 1, 384])
def test_sa_eval_plain_fewer_centers_than_points_matches_jax_kernel(n_valid):
    """128 centers over 384 points (N != M), the JAX kernels in interpret
    mode: the pair at sa3 (no hit, one filled slot, every slot filled)
    and one scale of the one-scale level."""
    radii, nsamples, mlps, c_feat = cases.SA_LEVELS["sa3"]
    c = c_feat["pn_head"]
    rng, xyz, centers, mask, feats = _eval_sa_cloud(
        90 + n_valid, 384, 128, c, max(n_valid, 1), spread=1.0)
    mask = np.arange(384) < n_valid
    (wa, ba), (wb, bb) = [_folded(rng, (3 + c,) + w) for w in mlps]
    kw = dict(radius_a=radii[0], radius_b=radii[1], nsample_a=nsamples[0],
              nsample_b=nsamples[1])
    oa, ob = fused_sa_pair(_t(xyz)[None], _t(centers)[None], _t(feats)[None],
                           _t(mask)[None], _tl(wa), _tl(ba), _tl(wb),
                           _tl(bb), **kw)
    j = jnp.asarray
    ja, jb = pallas_sa.fused_sa_pair(
        j(xyz), j(centers), j(feats), j(mask), wa, ba, wb, bb,
        compute_dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST,
        interpret=True, **kw)
    for got, want in ((oa, ja), (ob, jb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    (r,), (ns,), (widths,), c1 = cases.GENERAL_LEVELS["one_scale"]
    f1 = rng.randn(384, c1).astype(np.float32)
    ws, bs = _folded(rng, (3 + c1,) + widths)
    got = fused_sa_scale(_t(xyz)[None], _t(centers)[None], _t(f1)[None],
                         _t(mask)[None], _tl(ws), _tl(bs), radius=r,
                         nsample=ns)
    want = np.asarray(pallas_sa.fused_sa_scale(
        j(xyz), j(centers), j(f1), j(mask), ws, bs, radius=r, nsample=ns,
        compute_dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST,
        interpret=True))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# ---- B5 across candidate chunks -----------------------------------------

def _assert_knn_matches_jax(q, p, mask, k):
    w_idx, w_keys, w_valid = j_knn_tiled(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask), k=k, tq=64,
        tp=128, interpret=True, return_keys=True)
    idx, keys, valid = knn_indices_tiled(_t(q)[None], _t(p)[None],
                                         _t(mask)[None], k=k,
                                         return_keys=True)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(w_valid))
    w_keys = np.asarray(w_keys)
    np.testing.assert_allclose(keys[0].numpy(), w_keys, rtol=0,
                               atol=1e-4 * np.abs(w_keys).max())
    return valid


@pytest.mark.parametrize("k", [5, 16])
def test_knn_plain_ties_split_across_chunks_matches_jax(k):
    """Grid-snapped candidates, each repeated every 128 places (in
    another chunk of every chunk size), 600 of them (a ragged last chunk
    of 128), 70 queries (a ragged tile): ties go to the lowest index."""
    rng = np.random.RandomState(95)
    base = np.round(2 * rng.randn(128, 3)).astype(np.float32)
    p = np.tile(base, (5, 1))[:600]
    mask = rng.rand(600) > 0.2
    q = np.round(2 * rng.randn(70, 3)).astype(np.float32)
    _assert_knn_matches_jax(q, p, mask, k)


def test_knn_plain_unsorted_clusters_and_few_valid_match_jax():
    """An unsorted cloud of five tight clusters far apart (a query tile
    spans clusters; most chunks hold points of every cluster), then the
    same with only 9 valid candidates (fewer than k = 16). Off a grid the
    two packages may order near-ties differently (the JAX kernel's
    rounding freedom, pallas_knn.py:134-137): the coordinates are
    snapped."""
    rng = np.random.RandomState(96)
    ctr = np.clip(20 * rng.randn(5, 3), -55, 55)
    # on a 1/16 grid and under 60 m: every distance exact in both packages
    snap = lambda x: (np.round(16 * x) / 16).astype(np.float32)  # noqa: E731
    p = snap(ctr[rng.randint(0, 5, 700)] + 0.5 * rng.randn(700, 3))
    q = snap(ctr[rng.randint(0, 5, 150)] + 0.5 * rng.randn(150, 3))
    _assert_knn_matches_jax(q, p, np.ones(700, bool), 16)
    few = np.zeros(700, bool)
    few[rng.permutation(700)[:9]] = True
    valid = _assert_knn_matches_jax(q, p, few, 16)
    assert int(valid.sum()) == 150 * 9


# ---- B2 over lane groups, B3's selection in one pass --------------------

def _jnp_or_none(x):
    return None if x is None else jnp.asarray(x)


def _t1(x):
    """A numpy array of one stream as a (1, ...) tensor; None stays."""
    return None if x is None else _t(x)[None]


def _assert_fp_matches_jax(unknown, known, feats, mask):
    want = np.asarray(j_fp(
        jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats),
        _jnp_or_none(mask), compute_dtype=jnp.float32,
        precision=jax.lax.Precision.HIGHEST, interpret=True))
    got, idx = three_interpolate_reference(_t1(unknown), _t1(known),
                                           _t1(feats), _t1(mask))
    assert idx.shape == (1, len(unknown), 3)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if len(known) >= 3:
        _, w_idx = j_knn(3, jnp.asarray(unknown), jnp.asarray(known),
                         _jnp_or_none(mask))
        np.testing.assert_array_equal(idx[0].numpy(), np.asarray(w_idx))
    return idx[0]


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("m", cases.FP_PARTITION_KNOWN)
def test_fp_plain_at_lane_group_shapes_matches_jax(m, n):
    """Known counts below 3 (the nearest repeated), and 33, 100, 1000,
    which leave lane groups of 4 and 8 part-filled."""
    idx = _assert_fp_matches_jax(*cases.fp_partition_case(m, n, seed=m + n))
    if m < 3:
        assert bool((idx[:, m:] == idx[:, :1]).all())


def test_fp_plain_duplicated_known_points_match_jax():
    """Known points repeated 1, 3 and 5 places later: equal distances on
    other lanes of a group go to the lowest index."""
    _assert_fp_matches_jax(*cases.fp_partition_case(100, 256, c=128,
                                                     duplicates=True,
                                                     seed=97))


@pytest.mark.parametrize("n_valid", [0, 1, 2])
def test_fp_plain_few_valid_known_points_match_jax(n_valid):
    """0, 1 or 2 valid known points of 33: slots past them repeat the
    nearest; none valid gives index 0 with uniform weights."""
    unknown, known, feats, mask = cases.fp_partition_case(
        33, 128, n_valid=n_valid, seed=98 + n_valid)
    idx = _assert_fp_matches_jax(unknown, known, feats, mask)
    if n_valid == 0:
        assert not bool(idx.any())
    else:
        assert bool(mask[idx.numpy()].all())
        assert bool((idx[:, n_valid:] == idx[:, :1]).all())


def _assert_select_matches_jax(query, points, mask, k=16):
    w_d, w_idx = j_knn(k, jnp.asarray(query), jnp.asarray(points),
                       jnp.asarray(mask))
    d, idx = knn(k, _t1(query), _t1(points), _t1(mask))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(d[0].numpy(), np.asarray(w_d), rtol=1e-5,
                               atol=0)
    return idx[0]


@pytest.mark.parametrize("m", cases.SELECT_PARTITION_CANDIDATES)
def test_knn_plain_at_select_batch_shapes_matches_jax(m):
    """17, 33, 513 candidates (a part-filled last batch of 16) and 4096
    (one whole staged piece), all valid."""
    _assert_select_matches_jax(*cases.select_partition_case(m, seed=m))


@pytest.mark.parametrize("n_valid", [0, 1, 15, 16, 17])
def test_knn_plain_few_valid_candidates_matches_jax(n_valid):
    """Around k = 16 valid of 513: slots past the valid count repeat the
    nearest; none valid gives index 0."""
    idx = _assert_select_matches_jax(*cases.select_partition_case(
        513, n_valid=n_valid, seed=100 + n_valid))
    if n_valid < 16:
        assert bool((idx[:, max(n_valid, 1):] == idx[:, :1]).all())
    if n_valid == 0:
        assert not bool(idx.any())


@pytest.mark.parametrize("m", [33, 4096])
def test_knn_plain_ties_across_lanes_matches_jax(m):
    """Points repeated 1, 5 and 17 places later (another lane of the
    query's half warp, another batch): ties go to the lowest index."""
    _assert_select_matches_jax(*cases.select_partition_case(
        m, ties=True, seed=120 + m))


# ---- measuring builds ----------------------------------------------------

def test_measuring_macros_build_apart_from_the_port():
    """A measuring macro keys a library of its own (the port's hash is its
    flags' alone), an unknown macro raises, and the port's build is
    restored when the block ends, also when it raises."""
    skeleton = kb.source_hash(("RATRACK_SKELETON",))
    assert kb.source_hash() != skeleton
    assert kb.source_hash(("RATRACK_KNN_NO_GATE",)) not in (
        kb.source_hash(), skeleton)
    with pytest.raises(ValueError, match="RATRACK_FAST"):
        with kb.measuring("RATRACK_FAST"):
            pass
    with pytest.raises(RuntimeError):
        with kb.measuring("RATRACK_SKELETON"):
            assert kb._macros == ("RATRACK_SKELETON",)
            raise RuntimeError
    assert kb._macros == ()
