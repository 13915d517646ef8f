"""CPU parity: the port's point ops, kernel plain versions, layers and
synthetic data against the JAX package on the same numpy inputs.

The port (ratrack_tpu_torch) runs its plain PyTorch versions here (CPU
tensors); the JAX side runs its Pallas kernels in interpret mode with
compute_dtype=float32 and precision=HIGHEST, as tests/test_pallas_fused.py
does. Coordinates of selection tests are snapped to a 1/16 grid: every
expanded-form squared distance is then exact in float32 whatever the op
order (|x| < 128 keeps |c|^2 + |x|^2 under 2^24 / 256), so radius and kNN
boundaries cannot flip between the two packages.

Tolerances: indices exact; values 1e-4 absolute and relative (float32
sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu import ops as jops
from ratrack_tpu.data import synthetic as jsynth
from ratrack_tpu.models import layers as jlayers
from ratrack_tpu.ops import pallas_correlator, pallas_fp, pallas_sa
from ratrack_tpu_torch.data import synthetic as tsynth
from ratrack_tpu_torch.kernels import cases
from ratrack_tpu_torch.models import layers as tlayers
from ratrack_tpu_torch.ops import (fused_correlator, fused_fp, fused_sa,
                                   grouping, neighborhood, sampling)
from ratrack_tpu_torch.utils import from_flax_variables
from reference_impls import np_ball_query

HI = jax.lax.Precision.HIGHEST
TOL = dict(atol=1e-4, rtol=1e-4)
B, N = 2, 128


def _snap(x):
    return np.round(np.asarray(x, np.float32) * 16.0) / 16.0


def _cloud(seed, n=N, scale=4.0):
    rng = np.random.RandomState(seed)
    return _snap(rng.randn(B, n, 3) * scale).astype(np.float32)


def _mask(kind, n=N):
    base = {"none": None, "partial": np.arange(n) < 100,
            "few": np.arange(n) < 5, "zero": np.zeros(n, bool)}[kind]
    return None if base is None else np.broadcast_to(base, (B, n)).copy()


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x, b):
    return None if x is None else jnp.asarray(x[b])


MASKS = ["none", "partial", "few", "zero"]


# ---- data ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seed=3, n_frames=4, n_max=128, g_max=8, n_static=60, n_objects=3),
    dict(seed=11, n_frames=2, n_max=512, g_max=32, n_static=300,
         n_objects=5),
])
def test_synthetic_clip_identical_to_jax_package(kw):
    want = jsynth.stack_frames(jsynth.synthetic_clip(**kw))
    got = tsynth.stack_frames(tsynth.synthetic_clip(**kw))
    assert got._fields == want._fields
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


# ---- point ops ----------------------------------------------------------

def test_square_distance_and_point_distance():
    q, p = _cloud(0), _cloud(1)
    want = np.stack([np.asarray(jops.square_distance(_j(q, b), _j(p, b)))
                     for b in range(B)])
    np.testing.assert_allclose(
        neighborhood.square_distance(_t(q), _t(p)).numpy(), want, **TOL)
    # on the grid the kernels' elementwise form is exact too
    np.testing.assert_array_equal(
        neighborhood.point_distance(_t(q), _t(p)).numpy(), want)


@pytest.mark.parametrize("mask", MASKS)
def test_knn_matches_jax(mask):
    q, p, m = _cloud(2), _cloud(3), _mask(mask)
    d_t, i_t = neighborhood.knn(16, _t(q), _t(p), _t(m))
    for b in range(B):
        d_j, i_j = jops.knn(16, _j(q, b), _j(p, b), _j(m, b))
        np.testing.assert_array_equal(i_t[b].numpy(), np.asarray(i_j))
        np.testing.assert_allclose(d_t[b].numpy(), np.asarray(d_j), **TOL)


@pytest.mark.parametrize("mask", MASKS)
def test_ball_query_matches_jax_and_numpy_oracle(mask):
    p, m = _cloud(4), _mask(mask)
    c = p[:, ::2].copy()
    got = neighborhood.ball_query(2.0, 8, _t(p), _t(c), _t(m)).numpy()
    for b in range(B):
        want = np.asarray(jops.ball_query(2.0, 8, _j(p, b), _j(c, b),
                                          _j(m, b)))
        np.testing.assert_array_equal(got[b], want)
        if m is None:
            np.testing.assert_array_equal(
                got[b], np_ball_query(2.0, 8, p[b], c[b]))


@pytest.mark.parametrize("mask", MASKS)
def test_three_nn_matches_jax(mask):
    q, p, m = _cloud(5), _cloud(6), _mask(mask)
    d_t, i_t = neighborhood.three_nn(_t(q), _t(p), _t(m))
    for b in range(B):
        d_j, i_j = jops.three_nn(_j(q, b), _j(p, b), _j(m, b))
        np.testing.assert_array_equal(i_t[b].numpy(), np.asarray(i_j))
        np.testing.assert_allclose(d_t[b].numpy(), np.asarray(d_j), **TOL)


@pytest.mark.parametrize("mask", MASKS)
def test_identity_sample_and_gather_match_jax(mask):
    p = _cloud(7)
    m = _mask(mask)
    if m is not None:      # a non-prefix mask: the first valid point is 3
        m = m.copy()
        m[:, :3] = False
    idx = sampling.identity_sample(N, N, _t(m), batch=B)
    rows = sampling.identity_gather(_t(p), _t(m))
    for b in range(B):
        np.testing.assert_array_equal(
            idx[b].numpy(), np.asarray(jops.identity_sample(N, N, _j(m, b))))
        np.testing.assert_array_equal(
            rows[b].numpy(),
            np.asarray(jops.identity_gather(_j(p, b), _j(m, b))))


def test_group_and_three_interpolate_match_jax():
    rng = np.random.RandomState(8)
    f = rng.randn(B, N, 32).astype(np.float32)
    idx = rng.randint(0, N, (B, N, 3)).astype(np.int64)
    w = rng.rand(B, N, 3).astype(np.float32)
    g = grouping.group(_t(f), _t(idx)).numpy()
    out = grouping.three_interpolate(_t(f), _t(idx), _t(w)).numpy()
    d = rng.rand(B, N, 3).astype(np.float32)
    ws = grouping.three_interpolate_weights(_t(d)).numpy()
    for b in range(B):
        np.testing.assert_array_equal(
            g[b], np.asarray(jops.group(jnp.asarray(f[b]),
                                        jnp.asarray(idx[b]))))
        np.testing.assert_allclose(out[b], np.asarray(jops.three_interpolate(
            jnp.asarray(f[b]), jnp.asarray(idx[b]), jnp.asarray(w[b]))),
            **TOL)
        np.testing.assert_allclose(ws[b], np.asarray(
            jops.three_interpolate_weights(jnp.asarray(d[b]))), **TOL)


# ---- kernel plain versions vs the JAX kernels ---------------------------

def _folded(rng, dims):
    ws = [(rng.randn(i, o) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [0.1 * rng.randn(o).astype(np.float32) for o in dims[1:]]
    return ws, bs


@pytest.mark.parametrize("mask", ["partial", "few", "zero"])
@pytest.mark.parametrize("level", list(cases.SA_LEVELS))
def test_sa_pair_plain_matches_jax_kernel(level, mask):
    radii, nsamples, mlps, c_feat = cases.SA_LEVELS[level]
    c = c_feat["pn_head"]
    rng = np.random.RandomState(9)
    xyz, m = _cloud(10, scale=3.0), _mask(mask)
    feats = rng.randn(B, N, c).astype(np.float32)
    (wa, ba), (wb, bb) = [_folded(rng, (3 + c,) + w) for w in mlps]
    kw = dict(radius_a=radii[0], radius_b=radii[1], nsample_a=nsamples[0],
              nsample_b=nsamples[1])
    oa, ob = fused_sa.fused_sa_pair(
        _t(xyz), _t(xyz), _t(feats), _t(m), [_t(w) for w in wa],
        [_t(x) for x in ba], [_t(w) for w in wb], [_t(x) for x in bb], **kw)
    for b in range(B):
        ja, jb = pallas_sa.fused_sa_pair(
            _j(xyz, b), _j(xyz, b), _j(feats, b), _j(m, b), wa, ba, wb, bb,
            compute_dtype=jnp.float32, precision=HI, interpret=True, **kw)
        np.testing.assert_allclose(oa[b].numpy(), np.asarray(ja), **TOL)
        np.testing.assert_allclose(ob[b].numpy(), np.asarray(jb), **TOL)
        ref = pallas_sa.sa_scale_reference(
            _j(xyz, b), _j(xyz, b), _j(feats, b), _j(m, b), wa, ba,
            radius=radii[0], nsample=nsamples[0])
        if m is None or m[b].any():   # the reference has no no-hit rule
            np.testing.assert_allclose(oa[b].numpy(), np.asarray(ref),
                                       **TOL)


@pytest.mark.parametrize("mask", ["partial", "few", "zero"])
@pytest.mark.parametrize("level", sorted(cases.GENERAL_LEVELS))
def test_sa_scale_plain_matches_jax_kernel(level, mask):
    """Kernel B1's one-scale form: `fused_sa_scale` of the port (plain
    version) against the JAX kernel in interpret mode, every scale of a
    one-scale level, a three-scale level and a pair of unequal depth, over
    a masked cloud, a nearly empty one (no-hit centers pool the pair
    (i, point 0)) and an empty one; 1e-4."""
    radii, nsamples, mlps, c = cases.GENERAL_LEVELS[level]
    rng = np.random.RandomState(30)
    xyz, m = _cloud(31, scale=3.0), _mask(mask)
    feats = rng.randn(B, N, c).astype(np.float32)
    for r, ns, widths in zip(radii, nsamples, mlps):
        ws, bs = _folded(rng, (3 + c,) + widths)
        got = fused_sa.fused_sa_scale(
            _t(xyz), _t(xyz), _t(feats), _t(m), [_t(w) for w in ws],
            [_t(x) for x in bs], radius=r, nsample=ns)
        assert got.shape == (B, N, widths[-1])
        for b in range(B):
            want = pallas_sa.fused_sa_scale(
                _j(xyz, b), _j(xyz, b), _j(feats, b), _j(m, b), ws, bs,
                radius=r, nsample=ns, compute_dtype=jnp.float32,
                precision=HI, interpret=True)
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                       **TOL)


@pytest.mark.parametrize("level", sorted(cases.GENERAL_LEVELS))
def test_sa_scale_plain_matches_jax_kernel_fewer_centers(level):
    """N != M: 256 points (a mask on them), 128 centers drawn from the
    valid ones, no features on the first scale's twin call; and a pair call
    equals the two one-scale calls bit for bit."""
    radii, nsamples, mlps, c = cases.GENERAL_LEVELS[level]
    n, m_c = 256, 128
    rng = np.random.RandomState(32)
    xyz = _cloud(33, n=n, scale=3.0)
    mask = np.broadcast_to(np.arange(n) < 200, (B, n)).copy()
    centers = np.stack([xyz[b][rng.permutation(200)[:m_c]] for b in range(B)])
    feats = rng.randn(B, n, c).astype(np.float32)
    outs, params = [], []
    for r, ns, widths in zip(radii, nsamples, mlps):
        ws, bs = _folded(rng, (3 + c,) + widths)
        params.append(([_t(w) for w in ws], [_t(x) for x in bs]))
        got = fused_sa.fused_sa_scale(
            _t(xyz), _t(centers), _t(feats), _t(mask), *params[-1], radius=r,
            nsample=ns)
        outs.append(got)
        for b in range(B):
            want = pallas_sa.fused_sa_scale(
                _j(xyz, b), _j(centers, b), _j(feats, b), _j(mask, b), ws,
                bs, radius=r, nsample=ns, compute_dtype=jnp.float32,
                precision=HI, interpret=True)
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                       **TOL)
    if len(radii) >= 2:
        oa, ob = fused_sa.fused_sa_pair(
            _t(xyz), _t(centers), _t(feats), _t(mask), *params[0],
            *params[1], radius_a=radii[0], radius_b=radii[1],
            nsample_a=nsamples[0], nsample_b=nsamples[1])
        assert torch.equal(oa, outs[0]) and torch.equal(ob, outs[1])
    w0, b0 = params[0]
    bare = fused_sa.fused_sa_scale(
        _t(xyz), _t(centers), None, _t(mask), [w0[0][:3]] + w0[1:], b0,
        radius=radii[0], nsample=nsamples[0])
    want = pallas_sa.fused_sa_scale(
        _j(xyz, 0), _j(centers, 0), None, _j(mask, 0),
        [w0[0][:3].numpy()] + [w.numpy() for w in w0[1:]],
        [x.numpy() for x in b0], radius=radii[0], nsample=nsamples[0],
        compute_dtype=jnp.float32, precision=HI, interpret=True)
    np.testing.assert_allclose(bare[0].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask", MASKS)
def test_three_interpolate_plain_matches_jax_kernel(mask):
    u, k, m = _cloud(11), _cloud(12), _mask(mask)
    f = np.random.RandomState(13).randn(B, N, 64).astype(np.float32)
    got, idx = fused_fp.three_interpolate_reference(_t(u), _t(k), _t(f),
                                                    _t(m))
    for b in range(B):
        want = pallas_fp.fused_three_interpolate(
            _j(u, b), _j(k, b), _j(f, b), _j(m, b),
            compute_dtype=jnp.float32, precision=HI, interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("level", list(cases.SA_LEVELS))
def test_sa_pair_plain_matches_jax_kernel_fewer_centers(level):
    """N != M, the stretch shape in small: 256 points (a mask on them), 128
    centers drawn from the valid ones."""
    radii, nsamples, mlps, c_feat = cases.SA_LEVELS[level]
    c, n, m_c = c_feat["pn_head"], 256, 128
    rng = np.random.RandomState(14)
    xyz = _cloud(15, n=n, scale=3.0)
    mask = np.broadcast_to(np.arange(n) < 200, (B, n)).copy()
    centers = np.stack([xyz[b][rng.permutation(200)[:m_c]] for b in range(B)])
    feats = rng.randn(B, n, c).astype(np.float32)
    (wa, ba), (wb, bb) = [_folded(rng, (3 + c,) + w) for w in mlps]
    kw = dict(radius_a=radii[0], radius_b=radii[1], nsample_a=nsamples[0],
              nsample_b=nsamples[1])
    oa, ob = fused_sa.fused_sa_pair(
        _t(xyz), _t(centers), _t(feats), _t(mask), [_t(w) for w in wa],
        [_t(x) for x in ba], [_t(w) for w in wb], [_t(x) for x in bb], **kw)
    assert oa.shape == (B, m_c, mlps[0][-1])
    for b in range(B):
        ja, jb = pallas_sa.fused_sa_pair(
            _j(xyz, b), _j(centers, b), _j(feats, b), _j(mask, b), wa, ba, wb,
            bb, compute_dtype=jnp.float32, precision=HI, interpret=True, **kw)
        np.testing.assert_allclose(oa[b].numpy(), np.asarray(ja), **TOL)
        np.testing.assert_allclose(ob[b].numpy(), np.asarray(jb), **TOL)


def test_three_interpolate_plain_matches_jax_kernel_fewer_known():
    """N != M: 256 unknown points, 128 known ones (no mask, as on the
    model's path)."""
    u, k = _cloud(16, n=256), _cloud(17, n=128)
    f = np.random.RandomState(18).randn(B, 128, 64).astype(np.float32)
    got, idx = fused_fp.three_interpolate_reference(_t(u), _t(k), _t(f))
    assert got.shape == (B, 256, 64) and idx.shape == (B, 256, 3)
    for b in range(B):
        want = pallas_fp.fused_three_interpolate(
            _j(u, b), _j(k, b), _j(f, b), None, compute_dtype=jnp.float32,
            precision=HI, interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask", ["partial", "few", "zero"])
@pytest.mark.parametrize("stage", [1, 2])
def test_knn_weight_aggregate_plain_matches_jax_kernel(stage, mask):
    rng = np.random.RandomState(14)
    q, p, m = _cloud(15), _cloud(16), _mask(mask)
    c = 256
    feats_p = rng.randn(B, N, c).astype(np.float32)
    add_q = rng.randn(B, N, c).astype(np.float32) if stage == 1 else None
    mlp_ws, mlp_bs = _folded(rng, (c, c, c)) if stage == 1 else ([], [])
    wn_ws, wn_bs = _folded(rng, (3, 8, 8, c))
    got = fused_correlator.fused_knn_weight_aggregate(
        _t(q), _t(p), _t(feats_p), _t(add_q), _t(m),
        [_t(w) for w in mlp_ws], [_t(x) for x in mlp_bs],
        [_t(w) for w in wn_ws], [_t(x) for x in wn_bs]).numpy()
    for b in range(B):
        want = np.asarray(pallas_correlator.fused_knn_weight_aggregate(
            _j(q, b), _j(p, b), _j(feats_p, b), _j(add_q, b), _j(m, b),
            mlp_ws, mlp_bs, wn_ws, wn_bs, k=16, compute_dtype=jnp.float32,
            precision=HI, interpret=True))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[b] / scale, want / scale, atol=1e-4)


# ---- layers ----------------------------------------------------------------

def _variables(module, *args, seed=0, **kw):
    """flax init + randomised BN statistics and biases (numpy tree)."""
    v = module.init(jax.random.PRNGKey(seed), *args, **kw)
    rng = np.random.RandomState(seed + 1)

    def perturb(path, x):
        x = np.asarray(x)
        leaf = jax.tree_util.keystr(path)
        if "'mean'" in leaf or "'bias'" in leaf:
            return (x + 0.1 * rng.randn(*x.shape)).astype(np.float32)
        if "'var'" in leaf or "'scale'" in leaf:
            return (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(perturb, dict(v))


def _load(module, variables):
    module.load_state_dict(from_flax_variables(variables), strict=True)
    return module.eval()


@pytest.mark.parametrize("act,last_act,bn", [
    ("relu", True, True), ("leaky_relu", True, False),
    ("relu", False, True)])
def test_pointwise_mlp_matches_jax(act, last_act, bn):
    x = np.random.RandomState(20).randn(B, N, 19).astype(np.float32)
    jm = jlayers.PointwiseMLP((32, 16), bn=bn, act=act, last_act=last_act)
    v = _variables(jm, jnp.asarray(x), train=False)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = _load(tlayers.PointwiseMLP(19, (32, 16), bn=bn, act=act,
                                    last_act=last_act), v)
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(x)).numpy(), want, **TOL)
        if bn:   # folded BN == relu(BN(x @ W)) layer by layer
            ws, bs = tm.folded()
            jws, jbs = pallas_sa.fold_bn_params(v)
            for a, b_ in zip(ws + bs, jws + jbs):
                np.testing.assert_allclose(a.numpy(), np.asarray(b_), **TOL)


def test_weightnet_and_batchnorm_match_jax():
    d = np.random.RandomState(21).randn(B, N, 16, 3).astype(np.float32)
    jm = jlayers.WeightNet(256)
    v = _variables(jm, jnp.asarray(d))
    tm = _load(tlayers.WeightNet(256), v)
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(d)).numpy(),
                                   np.asarray(jm.apply(v, jnp.asarray(d))),
                                   **TOL)
    x = np.random.RandomState(22).randn(B, N, 8).astype(np.float32)
    jbn = jlayers.MaskedBatchNorm()
    vb = _variables(jbn, jnp.asarray(x), use_running_average=True)
    tbn = _load(tlayers.MaskedBatchNorm(8), vb)
    with torch.no_grad():
        np.testing.assert_allclose(
            tbn(_t(x)).numpy(),
            np.asarray(jbn.apply(vb, jnp.asarray(x),
                                 use_running_average=True)), **TOL)


@pytest.mark.parametrize("layers", [1, 5])
def test_stacked_gru_matches_jax(layers):
    rng = np.random.RandomState(23)
    x = rng.randn(B, 128).astype(np.float32)
    h = rng.randn(B, layers, 128).astype(np.float32)
    jm = jlayers.StackedGRU(128, layers)
    v = _variables(jm, jnp.asarray(x[0][None]),
                   jnp.asarray(h[0][:, None]))
    tm = _load(tlayers.StackedGRU(128, layers), v)
    with torch.no_grad():
        out, h_new = tm(_t(x), _t(h))
    for b in range(B):
        jo, jh = jm.apply(v, jnp.asarray(x[b][None]),
                          jnp.asarray(h[b][:, None]))
        np.testing.assert_allclose(out[b].numpy(), np.asarray(jo)[0], **TOL)
        np.testing.assert_allclose(h_new[b].numpy(), np.asarray(jh)[:, 0],
                                   **TOL)


def test_port_imports_no_jax():
    """The port must run where JAX is absent: importing every module of it
    (and chip_smoke.py) pulls in no JAX module. Nor does it pull in
    matplotlib, which the card's machine may lack: the visualisers
    (utils/vis.py, utils/vis3d.py) import it inside their renderers."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, importlib, pkgutil, runpy\n"
        "import ratrack_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'ratrack_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'flax', 'ratrack_tpu.'))]\n"
        "assert not bad, bad\n"
        "for name in ('device', 'ops.morton', 'ops.fused_knn', "
        "'ops.fused_sinkhorn', 'ops.sampling', 'tracker.dbscan', 'serve', "
        "'config', 'main', 'data.pipeline', 'data.native', 'eval.run', "
        "'eval.mot_metrics', 'eval.kalman', 'eval.run_kf', "
        "'eval.detection_ap', 'eval.run_ap', 'train.metrics', "
        "'utils.convert', 'kernels.digest', 'utils.vis', 'utils.vis3d'):\n"
        "    assert 'ratrack_tpu_torch.' + name in sys.modules, name\n"
        "assert 'matplotlib' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   env={**os.environ, "PYTHONPATH": root})
