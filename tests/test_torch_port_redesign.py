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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu.ops.pallas_correlator_train import \
    knn_weight_aggregate_reference as jcorr_reference
from ratrack_tpu.ops.pallas_sa_train import sa_scale_train_reference
from ratrack_tpu.ops.sampling import furthest_point_sample as j_fps
from ratrack_tpu_torch.ops.fused_correlator_train import \
    fused_knn_weight_aggregate_train
from ratrack_tpu_torch.ops.fused_sa_train import (fused_sa_pair_train,
                                                  fused_sa_scale_train)
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
