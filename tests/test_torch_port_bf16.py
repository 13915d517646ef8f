"""CPU parity in bfloat16: the port's compute dtype against the JAX
package's `dtype=jnp.bfloat16`, on one set of flax variables and the same
numpy-seeded inputs.

Kernel level: the plain versions of B1, B1', B2, B3 and B4 with
compute_dtype=bfloat16 against the JAX Pallas kernels in interpret mode at
compute_dtype=jnp.bfloat16 and default precision. Both multiply the same
bfloat16-rounded operands exactly and sum in float32 in another order, so
a value can sit on the other side of a bfloat16 rounding boundary and
carry one bfloat16 step (2^-8 relative) into the next layer. Measured on
the CPU, max error / max|JAX|: B1 6.6e-5, B1' 2.3e-4, B2 2.0e-7, B3 and
B4 4.5e-5; the tests hold KERNEL_TOL = 1e-3.
Indices are exact (coordinates on a 1/16 grid, as in
tests/test_torch_port_ops.py).

Module level: MaskedBatchNorm, PointwiseMLP, StackedGRU and Affinity
against the flax modules (the same roundings; an output a bfloat16 step
apart where the float32 sums round differently: measured 0, 3.4e-3,
4.9e-3 and 5.5e-3 of max|JAX|, held at MODULE_TOL = 1e-2); PNHead and
FeatureCorrelator against the JAX modules through their Pallas kernels
(pallas_sa.FORCE_FUSED_ON_CPU, one stream), where such a step moves the
layers after it: measured 8.1e-3 and 7.8e-4, held at HEAD_TOL = 2e-2.
Every output dtype equals the JAX module's.

Whole model: the frame step and a 3-frame cached scan of Track4D(dtype=
bfloat16) against the JAX model, once through the JAX kernels
(FORCE_FUSED_ON_CPU, one stream) and once unfused (the JAX XLA path, two
streams; its roundings differ from the kernels': x - c and the features
rounded before SA's layer 1, the layer-1 hoist never taken). Each stage
fed the JAX stage's inputs agrees to a bfloat16 step or two (cls 0.004,
the cost volume 1e-6 relative), but the random weights' activations reach
~4,000 in the cost volume, so a few bfloat16 steps in the heads move cls
by up to 0.19 end to end: measured on the CPU over two streams x 3
frames, the port against the JAX kernels 0.189 (flow 0.30 of |flow| <=
7.9), against the unfused path 0.200 (0.50), and the JAX package's own
two paths against each other 0.195 (0.375). The tests hold cls within
CLS_TOL = 0.25 and flow within FLOW_TOL = 0.1 of max|flow|; labels equal
except at valid points whose JAX cls is within CLS_TOL of mov_thres (their
moving flag may flip; counted and printed), track ids equal in every frame
before a stream's first label difference. `feats` is float32. The train
step of a bfloat16 model runs (its parity with the JAX package:
tests/test_torch_port_bf16_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu import ops as jops
from ratrack_tpu.data.frames import FrameBatch as JFrameBatch
from ratrack_tpu.data.synthetic import stack_frames, synthetic_clip
from ratrack_tpu.models import Track4D as JTrack4D
from ratrack_tpu.models import layers as jlayers
from ratrack_tpu.models.affinity import Affinity as JAffinity
from ratrack_tpu.models.correlator import FeatureCorrelator as JCorrelator
from ratrack_tpu.models.pnhead import PNHead as JPNHead
from ratrack_tpu.ops import pallas_correlator, pallas_fp, pallas_sa
from ratrack_tpu.tracker import init_state as jinit_state
from ratrack_tpu.train.step import make_scan_eval_step_cached as jscan
from ratrack_tpu_torch.config import Config
from ratrack_tpu_torch.data import FrameBatch, to_tensors
from ratrack_tpu_torch.kernels import cases
from ratrack_tpu_torch.models import Track4D, model_from_config
from ratrack_tpu_torch.models import layers as tlayers
from ratrack_tpu_torch.models.affinity import Affinity
from ratrack_tpu_torch.models.correlator import FeatureCorrelator
from ratrack_tpu_torch.models.pnhead import PNHead
from ratrack_tpu_torch.ops import fused_correlator, fused_fp, fused_sa
from ratrack_tpu_torch.tracker import init_state
from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                     make_scan_eval_step_cached,
                                     make_scan_train_step)
from ratrack_tpu_torch.utils import from_flax_variables

BF = torch.bfloat16
B, N, K, ITERS, T = 2, 128, 8, 20, 3
KERNEL_TOL = 1e-3
MODULE_TOL = 1e-2
HEAD_TOL = 2e-2
CLS_TOL = 0.25
FLOW_TOL = 0.1


def _snap(x):
    return (np.round(np.asarray(x, np.float32) * 16.0) / 16.0).astype(
        np.float32)


def _cloud(seed, n=N, scale=3.0):
    return _snap(np.random.RandomState(seed).randn(B, n, 3) * scale)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x, b):
    return None if x is None else jnp.asarray(x[b])


def _f32(x):
    return np.asarray(x, np.float32)


def _folded(rng, dims):
    ws = [(rng.randn(i, o) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [0.1 * rng.randn(o).astype(np.float32) for o in dims[1:]]
    return ws, bs


def _close(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max error {err:.3g} of max|JAX| > {tol}"


def _bf16_mask(n_valid):
    return np.broadcast_to(np.arange(N) < n_valid, (B, N)).copy()


# ---- kernels: plain versions against the JAX kernels in interpret mode ----

@pytest.mark.parametrize("level", list(cases.SA_LEVELS))
def test_sa_pair_plain_matches_jax_kernel_bf16(level):
    """B1 at every level config over a masked cloud with no-hit centers
    (the pooled pair (i, point 0) from the unrounded P1 row)."""
    radii, nsamples, mlps, c_feat = cases.SA_LEVELS[level]
    c = c_feat["pn_head"]
    rng = np.random.RandomState(90)
    xyz = _cloud(91, scale=6.0)
    mask = _bf16_mask(100)
    feats = rng.randn(B, N, c).astype(np.float32)
    (wa, ba), (wb, bb) = [_folded(rng, (3 + c,) + w) for w in mlps]
    kw = dict(radius_a=radii[0], radius_b=radii[1], nsample_a=nsamples[0],
              nsample_b=nsamples[1])
    oa, ob, ia, ib = fused_sa.sa_pair(
        _t(xyz), _t(xyz), _t(mask),
        *fused_sa.hoist_layer1(_t(xyz), _t(xyz), _t(feats), _t(wa[0]),
                               _t(ba[0])),
        list(zip(map(_t, wa[1:]), map(_t, ba[1:]))),
        *fused_sa.hoist_layer1(_t(xyz), _t(xyz), _t(feats), _t(wb[0]),
                               _t(bb[0])),
        list(zip(map(_t, wb[1:]), map(_t, bb[1:]))), **kw,
        return_indices=True, compute_dtype=BF)
    assert oa.dtype == torch.float32
    for b in range(B):
        ja, jb = pallas_sa.fused_sa_pair(
            _j(xyz, b), _j(xyz, b), _j(feats, b), _j(mask, b), wa, ba, wb,
            bb, compute_dtype=jnp.bfloat16, interpret=True, **kw)
        _close(oa[b], ja, KERNEL_TOL, f"{level} a")
        _close(ob[b], jb, KERNEL_TOL, f"{level} b")
        for idx, r, ns in ((ia, radii[0], nsamples[0]),
                           (ib, radii[1], nsamples[1])):
            want = jops.ball_query(r, ns, _j(xyz, b), _j(xyz, b),
                                   _j(mask, b))
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("level", sorted(cases.GENERAL_LEVELS))
def test_sa_scale_plain_matches_jax_kernel_bf16(level):
    """B1' on every scale of the one-scale, three-scale and unequal-depth
    levels, bfloat16 features as the model's deeper levels pass them."""
    radii, nsamples, mlps, c = cases.GENERAL_LEVELS[level]
    rng = np.random.RandomState(92)
    xyz, mask = _cloud(93), _bf16_mask(100)
    feats = rng.randn(B, N, c).astype(np.float32)
    feats_bf = _t(feats).to(BF)
    for r, ns, widths in zip(radii, nsamples, mlps):
        ws, bs = _folded(rng, (3 + c,) + widths)
        got = fused_sa.fused_sa_scale(
            _t(xyz), _t(xyz), feats_bf, _t(mask), [_t(w) for w in ws],
            [_t(x) for x in bs], radius=r, nsample=ns, compute_dtype=BF)
        for b in range(B):
            want = pallas_sa.fused_sa_scale(
                _j(xyz, b), _j(xyz, b), jnp.asarray(feats[b], jnp.bfloat16),
                _j(mask, b), ws, bs, radius=r, nsample=ns,
                compute_dtype=jnp.bfloat16, interpret=True)
            _close(got[b], want, KERNEL_TOL, f"{level} r={r}")


@pytest.mark.parametrize("mask", ["none", "few"])
def test_three_interpolate_plain_matches_jax_kernel_bf16(mask):
    """B2 on bfloat16 known features, as the model passes them."""
    u, k = _cloud(94), _cloud(95)
    m = None if mask == "none" else _bf16_mask(2)
    f = np.random.RandomState(96).randn(B, N, 64).astype(np.float32)
    f_bf = _t(f).to(BF)
    got, idx = fused_fp.three_interpolate_reference(
        _t(u), _t(k), f_bf, _t(m), compute_dtype=BF)
    assert got.dtype == torch.float32
    for b in range(B):
        want = pallas_fp.fused_three_interpolate(
            _j(u, b), _j(k, b), jnp.asarray(f[b], jnp.bfloat16), _j(m, b),
            compute_dtype=jnp.bfloat16, interpret=True)
        _close(got[b], want, KERNEL_TOL, "fp")
        if m is None:
            _, jidx = jops.three_nn(_j(u, b), _j(k, b))
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx))


def _corr_args(stage, seed, n=N):
    rng = np.random.RandomState(seed)
    c = 256
    q = _cloud(seed + 1, n, scale=20.0)
    p = _cloud(seed + 2, n, scale=20.0) if stage == 1 else q
    feats_p = rng.randn(B, n, c).astype(np.float32)
    add_q = rng.randn(B, n, c).astype(np.float32) if stage == 1 else None
    mlp_ws, mlp_bs = _folded(rng, (c, c, c)) if stage == 1 else ([], [])
    wn_ws, wn_bs = _folded(rng, (3, 8, 8, c))
    return q, p, feats_p, add_q, mlp_ws, mlp_bs, wn_ws, wn_bs


@pytest.mark.parametrize("stage", [1, 2])
def test_knn_weight_aggregate_plain_matches_jax_kernel_bf16(stage):
    """B3: gathered rows and coordinates rounded to bfloat16 (at |x| up to
    ~60 m, 0.25 m steps), products of bfloat16 operands."""
    q, p, fp_, aq, mw, mb, ww, wb = _corr_args(stage, 97)
    m = _bf16_mask(100)
    got, idx = fused_correlator.fused_knn_weight_aggregate(
        _t(q), _t(p), _t(fp_), _t(aq), _t(m), [_t(w) for w in mw],
        [_t(x) for x in mb], [_t(w) for w in ww], [_t(x) for x in wb],
        return_indices=True, compute_dtype=BF)
    for b in range(B):
        want = pallas_correlator.fused_knn_weight_aggregate(
            _j(q, b), _j(p, b), _j(fp_, b), _j(aq, b), _j(m, b), mw, mb,
            ww, wb, k=16, compute_dtype=jnp.bfloat16, interpret=True)
        _close(got[b], want, KERNEL_TOL, f"stage {stage}")
        _, jidx = jops.knn(16, _j(q, b), _j(p, b), _j(m, b))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx))


@pytest.mark.parametrize("stage", [1, 2])
def test_knn_gather_apply_plain_matches_jax_kernel_bf16(stage):
    """B4: rows gathered in float32, products of bfloat16 operands."""
    q, p, fp_, aq, mw, mb, ww, wb = _corr_args(stage, 98)
    idx = np.stack([np.asarray(jops.knn(16, _j(q, b), _j(p, b))[1])
                    for b in range(B)]).astype(np.int32)
    got = fused_correlator.knn_gather_apply(
        _t(idx).long(), _t(q), _t(p), _t(fp_), _t(aq), [_t(w) for w in mw],
        [_t(x) for x in mb], [_t(w) for w in ww], [_t(x) for x in wb],
        compute_dtype=BF)
    for b in range(B):
        want = pallas_correlator.knn_gather_apply(
            jnp.asarray(idx[b]), _j(q, b), _j(p, b), _j(fp_, b), _j(aq, b),
            mw, mb, ww, wb, k=16, compute_dtype=jnp.bfloat16, interpret=True)
        _close(got[b], want, KERNEL_TOL, f"stage {stage}")


def test_compute_dtype_other_than_f32_bf16_raises():
    q, p, fp_, aq, mw, mb, ww, wb = _corr_args(2, 99)
    with pytest.raises(ValueError):
        fused_correlator.knn_gather_apply(
            torch.zeros((B, N, 16), dtype=torch.long), _t(q), _t(p),
            _t(fp_), None, [], [], [_t(w) for w in ww], [_t(x) for x in wb],
            compute_dtype=torch.float16)


# ---- modules ---------------------------------------------------------------

def _random_tree(shapes, seed):
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        leaf = jax.tree_util.keystr(path)
        if "'kernel'" in leaf:
            x = rng.randn(*sd.shape) / np.sqrt(sd.shape[0])
        elif "'bias'" in leaf or "'mean'" in leaf:
            x = 0.1 * rng.randn(*sd.shape)
        elif "'scale'" in leaf or "'var'" in leaf:
            x = rng.uniform(0.5, 1.5, sd.shape)
        else:
            x = np.ones(sd.shape)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _init(module, seed, *args, **kw):
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw),
                            jax.random.PRNGKey(0))
    return _random_tree(shapes, seed)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def test_small_modules_match_jax_bf16():
    """MaskedBatchNorm (eval), PointwiseMLP (BN, ReLU; no BN, leaky),
    StackedGRU with a float32 state and Affinity: values and output
    dtypes."""
    rng = np.random.RandomState(100)
    x = rng.randn(B, 40, 35).astype(np.float32)
    checks = []
    bn = jlayers.MaskedBatchNorm(dtype=jnp.bfloat16)
    v = _init(bn, 101, jnp.asarray(x[0]), use_running_average=True)
    tbn = tlayers.MaskedBatchNorm(35, dtype=BF).eval()
    tbn.load_state_dict(from_flax_variables(v), strict=True)
    checks.append(("bn", tbn(_t(x).to(BF)),
                   bn.apply(v, jnp.asarray(x, jnp.bfloat16),
                            use_running_average=True)))
    for kw in (dict(bn=True), dict(bn=False, act="leaky_relu")):
        mlp = jlayers.PointwiseMLP((64, 32), dtype=jnp.bfloat16, **kw)
        v = _init(mlp, 102, jnp.asarray(x[0]), train=False)
        tm = tlayers.PointwiseMLP(35, (64, 32), dtype=BF, **kw).eval()
        tm.load_state_dict(from_flax_variables(v), strict=True)
        checks.append((f"mlp {kw}", tm(_t(x)),
                       mlp.apply(v, jnp.asarray(x), train=False)))
    g = rng.randn(B, 128).astype(np.float32)
    h = rng.randn(B, 5, 128).astype(np.float32)
    gru = jlayers.StackedGRU(128, 5, dtype=jnp.bfloat16)
    v = _init(gru, 103, jnp.asarray(g[:1]), jnp.asarray(h[0][:, None]))
    tg = tlayers.StackedGRU(128, 5, dtype=BF)
    tg.load_state_dict(from_flax_variables(v), strict=True)
    g_bf = _t(g).to(BF)
    out, h_new = tg(g_bf, _t(h))
    jout, jh = jax.vmap(lambda a, hh: gru.apply(v, a[None], hh[:, None]))(
        jnp.asarray(g, jnp.bfloat16), jnp.asarray(h))
    checks += [("gru out", out, jout[:, 0]), ("gru h", h_new, jh[:, :, 0])]
    d = rng.randn(B, K, K, 141).astype(np.float32)
    aff = JAffinity(141, jnp.bfloat16)
    v = _init(aff, 104, jnp.asarray(d[0]))
    ta = Affinity(141, dtype=BF)
    ta.load_state_dict(from_flax_variables(v), strict=True)
    checks.append(("affinity", ta(_t(d)), aff.apply(v, jnp.asarray(d))))
    with torch.no_grad():
        for name, got, want in checks:
            assert _dtype_name(got) == str(want.dtype), name
            _close(got.float().numpy(), want, MODULE_TOL, name)


@pytest.fixture
def fused_jax(monkeypatch):
    monkeypatch.setattr(pallas_sa, "FORCE_FUSED_ON_CPU", True)


def test_pnhead_matches_jax_kernels_bf16(fused_jax):
    """The PNHead over one stream, bfloat16 features in and out."""
    xyz = _cloud(110)[:1]
    mask = _bf16_mask(100)[:1]
    ft = np.random.RandomState(111).randn(1, N, 2).astype(np.float32)
    head = JPNHead(N, dtype=jnp.bfloat16)
    v = _init(head, 112, jnp.asarray(xyz[0]), jnp.asarray(ft[0]),
              jnp.asarray(mask[0]), False)
    want_xyz, want = head.apply(v, jnp.asarray(xyz[0]), jnp.asarray(ft[0]),
                                jnp.asarray(mask[0]), False)
    port = PNHead(N, 2, dtype=BF).eval()
    port.load_state_dict(from_flax_variables(v), strict=True)
    with torch.no_grad():
        got_xyz, got = port(_t(xyz), _t(ft), _t(mask))
    assert _dtype_name(got) == str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(got_xyz[0].numpy(), np.asarray(want_xyz))
    _close(got[0].float().numpy(), want, HEAD_TOL, "pnhead")


def test_correlator_matches_jax_kernels_bf16(fused_jax):
    """The FeatureCorrelator over one stream at 30 m coordinates (bfloat16
    directions in 0.125 m steps), bfloat16 head features in."""
    pc1, pc2 = _cloud(113, scale=15.0)[:1], _cloud(114, scale=15.0)[:1]
    m1, m2 = _bf16_mask(110)[:1], _bf16_mask(100)[:1]
    rng = np.random.RandomState(115)
    f1 = rng.randn(1, N, 256).astype(np.float32)
    f2 = rng.randn(1, N, 256).astype(np.float32)
    f1b, f2b = (jnp.asarray(f[0], jnp.bfloat16) for f in (f1, f2))
    mod = JCorrelator(16, (256, 256, 256), jnp.bfloat16)
    args = (jnp.asarray(pc1[0]), jnp.asarray(pc2[0]), f1b, f2b,
            jnp.asarray(m1[0]), jnp.asarray(m2[0]))
    v = _init(mod, 116, *args, train=False)
    want = mod.apply(v, *args, train=False)
    port = FeatureCorrelator(dtype=BF).eval()
    port.load_state_dict(from_flax_variables(v), strict=True)
    with torch.no_grad():
        got = port(_t(pc1), _t(pc2), _t(f1).to(BF), _t(f2).to(BF), _t(m1),
                   _t(m2))
    assert _dtype_name(got) == str(want.dtype) == "bfloat16"
    _close(got[0].float().numpy(), want, HEAD_TOL, "correlator")


# ---- the model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """(JAX bfloat16 model, numpy variables, port bfloat16 model, numpy
    frames (B, T, ...))."""
    clips = [stack_frames(synthetic_clip(s, T, n_max=N, g_max=K,
                                         n_static=60, n_objects=3))
             for s in range(B)]
    frames = JFrameBatch(*[np.stack([getattr(c, f) for c in clips])
                           for f in JFrameBatch._fields])
    frames = frames._replace(pc1=_snap(frames.pc1), pc2=_snap(frames.pc2),
                             pc1_comp=_snap(frames.pc1_comp))
    model = JTrack4D(npoint=N, k_max=K, sinkhorn_iters=ITERS,
                     dtype=jnp.bfloat16)
    f0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0, 0]), frames)
    variables = _init(model, 120, f0, jinit_state(K), train=False)
    port = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, dtype=BF,
                   device="cpu")
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return model, variables, port, frames


def test_bf16_variables_load_like_float32(world):
    """The flax tree of a bfloat16 model has float32 parameters, so both
    packages' bfloat16 models load the variables a float32 model loads."""
    _, v, port, _ = world
    f32 = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu")
    sd = from_flax_variables(v)
    f32.load_state_dict(sd, strict=True)
    assert all(p.dtype == torch.float32 for p in port.state_dict().values()
               if p.is_floating_point())
    for key, val in f32.state_dict().items():
        assert torch.equal(val, port.state_dict()[key]), key


def _compare_run(got, want, frames, name):
    """cls within CLS_TOL and flow within FLOW_TOL x max|flow| of JAX;
    labels equal except at valid points whose JAX cls lies within CLS_TOL
    of mov_thres (their moving flag may flip), track ids equal in every
    frame before a stream's first label difference. Prints the
    near-threshold and mismatching counts."""
    cls_w, cls_g = _f32(want["cls"]), got["cls"].float().numpy()
    err = np.abs(cls_g - cls_w).max()
    assert err <= CLS_TOL, (name, "cls", err)
    flow_w = _f32(want["warp"]) - frames.pc1
    flow_g = got["warp"].numpy() - frames.pc1
    flow_err = np.abs(flow_g - flow_w).max()
    assert flow_err <= FLOW_TOL * np.abs(flow_w).max(), (name, "flow",
                                                          flow_err)
    near = (np.abs(cls_w - 0.5) <= CLS_TOL) & frames.mask1
    differ = got["labels"].numpy() != np.asarray(want["labels"])
    assert not (differ & ~near).any(), (name, "labels")
    # after a stream's first label difference its slots name other clusters
    before = np.cumsum(differ.any(axis=-1), axis=1) == 0
    ids = (got["track_id"].numpy() == np.asarray(want["track_id"])).all(-1)
    assert ids[before].all(), (name, "track ids")
    print(f"{name}: cls err {err:.4g}, flow err {flow_err:.4g}; "
          f"{int(near.sum())} of {int(frames.mask1.sum())} valid points "
          f"within {CLS_TOL} of mov_thres, {int(differ.sum())} labels and "
          f"{int((~ids).sum())} frames' track ids differ")


@pytest.mark.parametrize("path", ["fused", "unfused"])
def test_step_and_cached_scan_match_jax_bf16(world, path, monkeypatch):
    """The frame step (frame 0) and the 3-frame cached scan against the JAX
    bfloat16 model: through its kernels (one stream) and unfused (two)."""
    model, v, port, frames = world
    nb = 1 if path == "fused" else B
    monkeypatch.setattr(pallas_sa, "FORCE_FUSED_ON_CPU", path == "fused")
    frames = JFrameBatch(*[x[:nb] for x in frames])
    ts = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (nb,) + x.shape), jinit_state(K))
    _, want = jscan(model)(v, ts, jax.tree_util.tree_map(jnp.asarray, frames))
    with torch.inference_mode():
        f0 = to_tensors(FrameBatch(*[np.ascontiguousarray(x[:, 0])
                                     for x in frames]), "cpu")
        step, _ = port(f0, init_state(nb, K, device="cpu"))
        _, got = make_scan_eval_step_cached(port)(
            init_state(nb, K, device="cpu"),
            to_tensors(FrameBatch(*frames), "cpu"))
    assert step["feats"].dtype == torch.float32
    assert str(want["cls"].dtype) == _dtype_name(step["cls"]) == "bfloat16"
    for key in ("cls", "labels", "track_id"):
        np.testing.assert_array_equal(step[key].float().numpy(),
                                      got[key][:, 0].float().numpy(), key)
    _compare_run(got, want, frames, f"{path} scan")


def test_serving_a_bf16_model_matches_its_eval_scan(world):
    """`serve.RadarTracker` over the bfloat16 model, on raw scans of one
    clip, against the model's uncached eval scan on the same records:
    labels and track ids equal, conf (bfloat16, widened) equal, flow to
    float32 rounding of warp - pc1."""
    from ratrack_tpu_torch.serve import RadarTracker
    from ratrack_tpu_torch.train import make_scan_eval_step
    _, _, port, _ = world
    s = stack_frames(synthetic_clip(5, T, n_max=N, g_max=K, n_static=60,
                                    n_objects=3))
    s = s._replace(pc1=_snap(s.pc1), pc2=_snap(s.pc2))
    scans = [np.concatenate([s.pc2[0][s.mask2[0]], s.ft2[0][s.mask2[0]]], 1)]
    scans += [np.concatenate([s.pc1[i][s.mask1[i]], s.ft1[i][s.mask1[i]]],
                             1) for i in range(T)]
    frames = to_tensors(FrameBatch(*[np.asarray(x)[None] for x in s]), "cpu")
    _, ref = make_scan_eval_step(port)(init_state(1, K, device="cpu"),
                                       frames)
    svc = RadarTracker(port, n_max=N, max_streams=2)
    sid = svc.open_stream()
    assert svc.track(sid, scans[0]) is None
    for t, scan in enumerate(scans[1:]):
        out = svc.track(sid, scan)
        assert np.array_equal(out.labels, ref["labels"][0, t].numpy())
        assert np.array_equal(out.track_id, ref["track_id"][0, t].numpy())
        assert np.array_equal(out.conf, ref["conf"][0, t].float().numpy())
        pc1 = np.zeros((N, 3), np.float32)
        pc1[:out.n_points] = scan[:, :3]
        np.testing.assert_allclose(
            out.flow, ref["warp"][0, t].numpy() - pc1, atol=1e-5)
    assert (ref["labels"] >= 0).any()


def test_model_from_config_and_train_step_bf16(world):
    """`dtype: bfloat16` builds a bfloat16 Track4D; an unknown dtype is
    refused by the config; the train scan of a bfloat16 model trains it
    (one frame): finite loss items, float32 gradients on the float32
    parameters, which the optimizer moves, and cls in bfloat16."""
    cfg = Config(npoints=N, n_max=N, k_max=K, sinkhorn_iters=ITERS,
                 dtype="bfloat16")
    model = model_from_config(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    assert model.dtype == BF
    assert model.pn_head.linear1.compute_dtype == BF
    with pytest.raises(ValueError):
        Config(dtype="float16")
    ts = create_train_state(model, TrainConfig(), 1, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    frames = to_tensors(FrameBatch(*[x[:, :1] for x in world[3]]), "cpu")
    _, items = make_scan_train_step(ts)(init_state(B, K, device="cpu"),
                                        frames, False)
    assert items["Loss"].shape == (1, B)
    assert all(torch.isfinite(v).all() for v in items.values())
    for p, p0 in zip(model.parameters(), before):
        assert p.dtype == p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()
    assert any(not torch.equal(p, p0)
               for p, p0 in zip(model.parameters(), before))
    out, _ = model(FrameBatch(*[x[:, 0].contiguous() for x in frames]),
                   init_state(B, K, device="cpu"))
    assert out["cls"].dtype == BF


def test_cli_evaluates_a_bf16_config_and_refuses_to_train_it(tmp_path):
    """`python -m ratrack_tpu_torch.main` on a synthetic config with
    `dtype: bfloat16`: the eval (the cached scan over 2-frame chunks)
    finishes with finite metrics; the train run, which raised before the
    bfloat16 train step was ported, now trains an epoch (per frame) with
    finite losses and saves its checkpoints."""
    import math
    import os
    import yaml
    from ratrack_tpu_torch.main import main
    cfg = dict(exp_name="bf16", dataset="synthetic", n_max=96, npoints=96,
               k_max=8, g_max=8, sinkhorn_iters=20, synth_clips=2,
               synth_frames=3, scan_frames=2, dtype="bfloat16", eval=True,
               checkpoints_dir=str(tmp_path / "ckpt"),
               results_dir=str(tmp_path / "results"))
    path = tmp_path / "bf16.yaml"
    path.write_text(yaml.safe_dump(cfg))
    res = main(["--config", str(path), "--cpu"])["eval"]
    assert all(math.isfinite(v) for v in {**res["seg"],
                                           **res["flow"]}.values())
    path.write_text(yaml.safe_dump(dict(cfg, eval=False, epochs=1,
                                        scan_frames=0, synth_clips=1)))
    (epoch,) = main(["--config", str(path), "--cpu"])["train"]
    assert epoch["frames"] == 3
    assert all(math.isfinite(epoch[k]) for k in ("Loss", "SceneFlowLoss",
                                                  "SegLoss", "TrackingLoss"))
    assert os.path.isfile(tmp_path / "ckpt" / "bf16" / "models" / "best.pt")
