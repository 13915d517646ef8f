"""CPU parity of the port's train path against the JAX package.

Small sizes (N = 128 points, 2 streams, k_max 8, 20 Sinkhorn iterations,
full channel widths); inputs from a seed with numpy, point coordinates
snapped to a 1/16 grid so every distance is exact in both packages (see
tests/test_torch_port_ops.py); weights go from the JAX tree to the port
through utils/convert.py::from_flax_variables, and gradient trees through
the same function ({"params": grads}). Off the TPU the JAX train path is
its unfused float32 path (pallas_sa.fused_available() is False) and the
port runs its kernels' plain versions.

Tolerances, each named where it is used:
  BN / MLP train mode, loss items                               1e-5
  SA outputs and statistics, correlator output          1e-5 x max|jax|
  SA and correlator gradients                       1e-4 x max|g_jax|
  full train step: loss items 1e-4 relative; every gradient leaf
    |g - g_jax| <= 1e-3 |G_jax| + 1e-6 in norm (G_jax: the whole gradient,
    see the test) and cosine >= 0.999; running stats 1e-5
  2-frame train scan: per-frame losses 1e-3 relative
  optimizer vs optax                                          1e-6
  JAX's bf16-class fused SA pair kernel (interpret): cosine >= 0.99
  kernel B8, one scale: against the JAX unfused reference as the pair;
    against the JAX fused kernel (interpret) 1e-4 x max and gradients 1e-3
    x max where its bf16 passes are exact (small integers), else its
    pinned class, outputs 3% of max and gradient cosine >= 0.99
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ratrack_tpu.data.frames import FrameBatch as JFrameBatch
from ratrack_tpu.data.synthetic import stack_frames, synthetic_clip
from ratrack_tpu.models import Track4D as JTrack4D
from ratrack_tpu.models.layers import MaskedBatchNorm as JBatchNorm
from ratrack_tpu.models.layers import PointwiseMLP as JPointwiseMLP
from ratrack_tpu.ops.pallas_correlator_train import \
    knn_weight_aggregate_reference as jcorr_reference
from ratrack_tpu.ops.pallas_sa_train import (fused_sa_pair_train as
                                             jfused_sa_pair_train,
                                             fused_sa_scale_train as
                                             jfused_sa_scale_train,
                                             sa_scale_train_reference)
from ratrack_tpu.tracker import init_state as jinit_state
from ratrack_tpu.train.losses import track4d_loss as jtrack4d_loss
from ratrack_tpu.train.step import TrainState as JTrainState
from ratrack_tpu.train.step import _make_loss_fn
from ratrack_tpu.train.step import make_optimizer as jmake_optimizer
from ratrack_tpu.train.step import make_scan_train_step as jscan_train
from ratrack_tpu_torch.data import FrameBatch, to_tensors
from ratrack_tpu_torch.kernels.cases import GENERAL_LEVELS, SA_LEVELS
from ratrack_tpu_torch.models import MaskedBatchNorm, PointwiseMLP, Track4D
from ratrack_tpu_torch.ops.fused_correlator_train import \
    knn_weight_aggregate_train_reference
from ratrack_tpu_torch.ops.fused_sa_train import (fused_sa_pair_train,
                                                  fused_sa_scale_train)
from ratrack_tpu_torch.ops.sampling import identity_gather
from ratrack_tpu_torch.tracker import association, init_state
from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                     make_scan_train_step, make_train_step,
                                     optimizer_step, restore_train_state,
                                     save_train_state, track4d_loss)
from ratrack_tpu_torch.utils import from_flax_variables

N, K, ITERS, B, T = 128, 8, 20, 2, 2
TIGHT = dict(atol=1e-5, rtol=1e-5)


def _snap(x):
    return (np.round(np.asarray(x, np.float32) * 16.0) / 16.0).astype(
        np.float32)


def _random_tree(shapes, seed):
    """numpy leaves for a flax variable tree: Dense kernels N(0, 1/fan_in),
    biases and BN means N(0, 0.1^2), BN scales and variances U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        leaf = jax.tree_util.keystr(path)
        if "'kernel'" in leaf:
            x = rng.randn(*sd.shape) / np.sqrt(sd.shape[0])
        elif "'bias'" in leaf or "'mean'" in leaf:
            x = 0.1 * rng.randn(*sd.shape)
        elif "'scale'" in leaf or "'var'" in leaf:
            x = rng.uniform(0.5, 1.5, sd.shape)
        else:                                   # bin_score
            x = np.ones(sd.shape)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def world():
    """(JAX model, numpy variables, numpy frames (B, T, ...))."""
    clips = [stack_frames(synthetic_clip(s, T, n_max=N, g_max=K,
                                         n_static=60, n_objects=3))
             for s in range(B)]
    frames = JFrameBatch(*[np.stack([getattr(c, f) for c in clips])
                           for f in JFrameBatch._fields])
    frames = frames._replace(pc1=_snap(frames.pc1), pc2=_snap(frames.pc2),
                             pc1_comp=_snap(frames.pc1_comp))
    model = JTrack4D(npoint=N, k_max=K, sinkhorn_iters=ITERS)
    f0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0, 0]), frames)
    shapes = jax.eval_shape(
        lambda k: model.init(k, f0, jinit_state(K), train=False),
        jax.random.PRNGKey(0))
    return model, _random_tree(shapes, 0), frames


def _port(variables):
    port = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu")
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return port


def _frame_t(frames, t):
    return FrameBatch(*[np.ascontiguousarray(x[:, t]) for x in frames])


def _jstates():
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jinit_state(K))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# (a) train-mode batch norm and pointwise MLP ---------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("module", ["bn", "mlp"])
def test_batchnorm_and_mlp_train_mode_match_flax(module, masked):
    """Per-stream batch moments (masked rows excluded), the output, and the
    running statistics as the mean over streams of per-stream updates;
    1e-5."""
    rng = np.random.RandomState(1)
    x = (3.0 * rng.randn(B, 50, 6) + 1.0).astype(np.float32)
    mask = rng.rand(B, 50) > 0.3 if masked else None
    mask_j = mask if masked else np.ones((B, 50), bool)
    if module == "bn":
        jmod, port = JBatchNorm(), MaskedBatchNorm(6)
        sample = jnp.zeros((50, 6))
    else:
        jmod, port = JPointwiseMLP((16, 8)), PointwiseMLP(6, (16, 8))
        sample = jnp.zeros((50, 6))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), sample))
    v = _random_tree(shapes, 2)

    def one(xb, mb):
        m = mb if masked else None
        kw = {} if module == "bn" else {"train": True}
        return jmod.apply(v, xb, mask=m, mutable=["batch_stats"], **kw)
    out, mut = jax.vmap(one)(x, mask_j)
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a).mean(0),
                                   mut["batch_stats"])
    port.load_state_dict(from_flax_variables(v), strict=True)
    port.train()
    got = port(_t(x), _t(mask) if masked else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **TIGHT)
    want_sd = from_flax_variables({"batch_stats": stats})
    for name, val in want_sd.items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                   val.numpy(), **TIGHT, err_msg=name)


# (b) the SA pair train plain version -----------------------------------------

def _sa_inputs(world, level, seed):
    _, _, frames = world
    radii, nsamples, mlps, c_feat = SA_LEVELS[level]
    rng = np.random.RandomState(seed)
    pc = torch.from_numpy(frames.pc1[:, 0])
    mask = torch.from_numpy(frames.mask1[:, 0])
    if level != "sa1":
        pc, mask = identity_gather(pc, mask), None
    centers = identity_gather(pc, mask).numpy()
    c = c_feat["pn_head"]
    feats = rng.randn(B, N, c).astype(np.float32)
    params = []
    for widths in mlps:
        dims = (3 + c,) + tuple(widths)
        params.append((
            [(rng.randn(i, o) / np.sqrt(i)).astype(np.float32)
             for i, o in zip(dims[:-1], dims[1:])],
            [rng.uniform(0.5, 1.5, o).astype(np.float32) for o in widths],
            [(0.1 * rng.randn(o)).astype(np.float32) for o in widths]))
    cot = [rng.randn(B, N, w[-1]).astype(np.float32) for w in mlps]
    return (pc.numpy(), centers, None if mask is None else mask.numpy(),
            feats, params, cot, radii, nsamples)


@pytest.mark.parametrize("level", ["sa1", "sa2", "sa3"])
def test_sa_pair_train_reference_matches_jax(world, level):
    """fused_sa_pair_train on the CPU (the plain version under autograd)
    against two JAX sa_scale_train_reference calls per stream: pooled
    outputs and batch statistics 1e-5 x max|jax|; gradients to the
    features and to every weight, BN scale and bias 1e-4 x max|g_jax|.
    The tolerances scale with the largest value because the hoisted layer
    1, P1[j] - CW[i], rounds at the scale of the coordinates (up to ~60 m
    here), where JAX's reference multiplies [x_j - c_i, f_j] by W1."""
    xyz, centers, mask, feats, params, cot, radii, nss = _sa_inputs(
        world, level, 3)

    def jax_loss(f, prm):
        total, outs = 0.0, []
        for s in range(2):
            def one(x, c, fb, mb):
                return sa_scale_train_reference(
                    x, c, fb, mb, *prm[s], radius=radii[s], nsample=nss[s])
            mb = mask if mask is not None else np.ones((B, N), bool)
            o = jax.vmap(one)(xyz, centers, f, mb)
            total = total + jnp.sum(o[0] * cot[s])
            outs.append(o)
        return total, outs
    jgrad, jouts = jax.jit(jax.grad(jax_loss, argnums=(0, 1), has_aux=True))(
        feats, params)

    f_t = _t(feats).requires_grad_(True)
    p_t = [[[_t(a).requires_grad_(True) for a in group] for group in sc]
           for sc in params]
    res = fused_sa_pair_train(
        _t(xyz), _t(centers), f_t, None if mask is None else _t(mask),
        *p_t[0], *p_t[1], radius_a=radii[0], nsample_a=nss[0],
        radius_b=radii[1], nsample_b=nss[1])
    loss = sum((r[0] * _t(c)).sum() for r, c in zip(res, cot))
    loss.backward()
    for (pooled, mus, vrs), (jp, jm, jv) in zip(res, jouts):
        for a, b in zip([pooled.detach()] + mus + vrs,
                        [jp] + list(jm) + list(jv)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
    got = [f_t.grad] + [a.grad for sc in p_t for group in sc for a in group]
    want = [jgrad[0]] + jax.tree_util.tree_leaves(jgrad[1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_sa_pair_train_reference_vs_jax_fused_kernel(world):
    """One stream of sa2 (N = 128) against the JAX fused pair train kernel
    in interpret mode, whose bf16 matmul passes set the class the JAX
    suite pins (tests/test_pallas_sa_train.py): outputs 3% of max, every
    gradient cosine >= 0.99."""
    xyz, centers, _, feats, params, cot, radii, nss = _sa_inputs(
        world, "sa2", 4)
    kw = dict(radius_a=radii[0], nsample_a=nss[0], radius_b=radii[1],
              nsample_b=nss[1])

    def jax_loss(f, prm):
        (pa, _, _), (pb, _, _) = jfused_sa_pair_train(
            xyz[0], centers[0], f, None, *prm[0], *prm[1], interpret=True,
            **kw)
        return jnp.sum(pa * cot[0][0]) + jnp.sum(pb * cot[1][0]), (pa, pb)
    jgrad, jout = jax.grad(jax_loss, argnums=(0, 1), has_aux=True)(
        feats[0], params)

    f_t = _t(feats[:1]).requires_grad_(True)
    p_t = [[[_t(a).requires_grad_(True) for a in group] for group in sc]
           for sc in params]
    res = fused_sa_pair_train(_t(xyz[:1]), _t(centers[:1]), f_t, None,
                              *p_t[0], *p_t[1], **kw)
    sum((r[0][0] * _t(c[0])).sum() for r, c in zip(res, cot)).backward()
    for r, jp in zip(res, jout):
        scale = float(np.abs(np.asarray(jp)).max())
        assert np.abs(r[0][0].detach().numpy() - np.asarray(jp)).max() \
            <= 0.03 * scale
    got = [f_t.grad[0]] + [a.grad for sc in p_t for g in sc for a in g]
    for g, w in zip(got, [jgrad[0]] + jax.tree_util.tree_leaves(jgrad[1])):
        a, b = g.numpy().ravel(), np.asarray(w).ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        assert cos >= 0.99, cos


# (b') kernel B8: one train-mode SA scale --------------------------------------

def _scale_params(rng, c_in, widths):
    dims = (c_in,) + tuple(widths)
    return ([(rng.randn(i, o) / np.sqrt(i)).astype(np.float32)
             for i, o in zip(dims[:-1], dims[1:])],
            [rng.uniform(0.5, 1.5, o).astype(np.float32) for o in widths],
            [(0.1 * rng.randn(o)).astype(np.float32) for o in widths])


def _port_scale_run(xyz, centers, feats, mask, prm, cot, radius, nsample):
    """The port's fused_sa_scale_train forward and backward on numpy inputs
    -> ((pooled, mus, vars), [d feats, d ws.., d gammas.., d betas..])."""
    f_t = _t(feats).requires_grad_(True)
    p_t = [[_t(a).requires_grad_(True) for a in group] for group in prm]
    pooled, mus, vrs = fused_sa_scale_train(
        _t(xyz), _t(centers), f_t, None if mask is None else _t(mask), *p_t,
        radius=radius, nsample=nsample)
    (pooled * _t(cot)).sum().backward()
    return ((pooled.detach(), mus, vrs),
            [f_t.grad] + [a.grad for group in p_t for a in group])


@pytest.mark.parametrize("level", sorted(GENERAL_LEVELS))
def test_sa_scale_train_reference_matches_jax(world, level):
    """fused_sa_scale_train on the CPU (the plain version under autograd),
    every scale of a one-scale level, a three-scale level and a pair of
    unequal depth over the masked cloud, against the JAX unfused
    sa_scale_train_reference per stream: pooled outputs and batch
    statistics 1e-5 x max|jax|; gradients to the features and to every
    weight, BN scale and bias 1e-4 x max|g_jax| (the classes of the pair
    test above)."""
    _, _, frames = world
    radii, nsamples, mlps, c = GENERAL_LEVELS[level]
    rng = np.random.RandomState(40)
    xyz, mask = frames.pc1[:, 0], frames.mask1[:, 0]
    centers = identity_gather(_t(xyz), _t(mask)).numpy()
    feats = rng.randn(B, N, c).astype(np.float32)
    for r, ns, widths in zip(radii, nsamples, mlps):
        prm = _scale_params(rng, 3 + c, widths)
        cot = rng.randn(B, N, widths[-1]).astype(np.float32)

        def jax_loss(f, p):
            o = jax.vmap(lambda x, cc, fb, mb: sa_scale_train_reference(
                x, cc, fb, mb, *p, radius=r, nsample=ns))(
                    xyz, centers, f, mask)
            return jnp.sum(o[0] * cot), o
        jgrad, jout = jax.jit(jax.grad(jax_loss, argnums=(0, 1),
                                       has_aux=True))(feats, prm)
        (pooled, mus, vrs), got = _port_scale_run(xyz, centers, feats, mask,
                                                  prm, cot, r, ns)
        for a, b in zip([pooled] + mus + vrs,
                        [jout[0]] + list(jout[1]) + list(jout[2])):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
        want = [jgrad[0]] + jax.tree_util.tree_leaves(jgrad[1])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("radius,nsample", [
    (3.0, 4),      # mixed hits and duplicate padding slots
    (0.5, 4),      # mostly no-hit centers (point 0 in every slot)
    (100.0, 8),    # every list full
    (5.0, 32),     # the largest nsample
])
def test_sa_scale_train_matches_jax_kernel_exact_regime(radius, nsample):
    """One stream, one layer, small-integer coordinates, features and
    weights (the setup of tests/test_pallas_sa_train.py, where the JAX
    kernel's bf16 passes are exact) against the JAX fused kernel in
    interpret mode: pooled, mean and variance 1e-4 x max; gradients to the
    features, the weight, gamma and beta 1e-3 x max|g_jax|. The centers are
    all 128 rows, masked points included, so some centers have no hit."""
    rng = np.random.RandomState(2)
    n, c_in, c_out = 128, 2, 16
    xyz = rng.randint(-8, 9, size=(n, 3)).astype(np.float32)
    feats = rng.randint(-4, 5, size=(n, c_in)).astype(np.float32)
    mask = rng.rand(n) < 0.7
    prm = ([rng.randint(-2, 3, size=(3 + c_in, c_out)).astype(np.float32)
            * 0.25],
           [1.0 + 0.25 * rng.randint(-2, 3, size=(c_out,)).astype(
               np.float32)],
           [0.25 * rng.randint(-2, 3, size=(c_out,)).astype(np.float32)])
    cot = rng.randint(-4, 5, size=(n, c_out)).astype(np.float32)

    def jax_loss(f, p):
        o = jfused_sa_scale_train(xyz, xyz, f, mask, *p, radius=radius,
                                  nsample=nsample, interpret=True)
        return jnp.vdot(o[0], cot), o
    jgrad, jout = jax.grad(jax_loss, argnums=(0, 1), has_aux=True)(
        feats, prm)
    (pooled, mus, vrs), got = _port_scale_run(
        xyz[None], xyz[None], feats[None], mask[None], prm, cot[None],
        radius, nsample)
    for a, b in ((pooled[0], jout[0]), (mus[0][0], jout[1][0]),
                 (vrs[0][0], jout[2][0])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1.0))
    got[0] = got[0][0]
    for g, w in zip(got, [jgrad[0]] + jax.tree_util.tree_leaves(jgrad[1])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max() + 1e-6)


@pytest.mark.parametrize("level,scale", [("one_scale", 0),
                                         ("three_scales", 1)])
def test_sa_scale_train_vs_jax_kernel_multilayer(world, level, scale):
    """One stream of a 3-layer and a 2-layer scale at real values against
    the JAX fused kernel in interpret mode, whose bf16 matmul passes set
    the class the JAX suite pins (tests/test_pallas_sa_train.py): pooled 3%
    of max, layer-1 mean 1e-4 (it rides the kernel's exact gather), every
    gradient cosine >= 0.99."""
    _, _, frames = world
    radii, nsamples, mlps, c = GENERAL_LEVELS[level]
    r, ns, widths = radii[scale], nsamples[scale], mlps[scale]
    rng = np.random.RandomState(41)
    xyz = frames.pc1[0, 0]
    centers = identity_gather(_t(xyz[None]), _t(frames.mask1[:1, 0]))[0].numpy()
    mask = frames.mask1[0, 0]
    feats = rng.randn(N, c).astype(np.float32)
    prm = _scale_params(rng, 3 + c, widths)
    cot = rng.randn(N, widths[-1]).astype(np.float32)

    def jax_loss(f, p):
        o = jfused_sa_scale_train(xyz, centers, f, mask, *p, radius=r,
                                  nsample=ns, interpret=True)
        return jnp.sum(o[0] * cot), o
    jgrad, jout = jax.grad(jax_loss, argnums=(0, 1), has_aux=True)(
        feats, prm)
    (pooled, mus, _), got = _port_scale_run(
        xyz[None], centers[None], feats[None], mask[None], prm, cot[None],
        r, ns)
    jp = np.asarray(jout[0])
    assert np.abs(pooled[0].numpy() - jp).max() <= 0.03 * np.abs(jp).max()
    np.testing.assert_allclose(mus[0][0].numpy(), np.asarray(jout[1][0]),
                               atol=1e-4)
    got[0] = got[0][0]
    for g, w in zip(got, [jgrad[0]] + jax.tree_util.tree_leaves(jgrad[1])):
        a, b = g.numpy().ravel(), np.asarray(w).ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        assert cos >= 0.99, cos


# (c) the correlator train plain version --------------------------------------

@pytest.mark.parametrize("stage", [1, 2])
def test_correlator_train_reference_matches_jax(world, stage):
    """knn_weight_aggregate_train_reference against the JAX
    knn_weight_aggregate_reference with w_dir, per stream: output 1e-5 x
    max; gradients to the query and point positions, feats_p, add_q,
    W_dir and every weight and bias 1e-4 x max|g_jax|."""
    _, _, frames = world
    rng = np.random.RandomState(5 + stage)
    c = 256
    q = frames.pc1[:, 1]
    p = frames.pc2[:, 1] if stage == 1 else q
    mask = frames.mask2[:, 1] if stage == 1 else frames.mask1[:, 1]
    fp = rng.randn(B, N, c).astype(np.float32)
    aq = rng.randn(B, N, c).astype(np.float32) if stage == 1 else None
    wdir = (0.05 * rng.randn(3, c)).astype(np.float32) if stage == 1 \
        else None
    n_mlp = 2 if stage == 1 else 0
    mlp = ([(rng.randn(c, c) / 16).astype(np.float32)
            for _ in range(n_mlp)],
           [(0.1 * rng.randn(c)).astype(np.float32) for _ in range(n_mlp)])
    wn = ([rng.randn(3, 8).astype(np.float32),
           (0.3 * rng.randn(8, 8)).astype(np.float32),
           (0.3 * rng.randn(8, c)).astype(np.float32)],
          [(0.1 * rng.randn(n)).astype(np.float32) for n in (8, 8, c)])
    cot = rng.randn(B, N, c).astype(np.float32)
    diff = dict(q=q, fp=fp, mlp=mlp, wn=wn)
    if stage == 1:
        diff.update(p=p, aq=aq, wdir=wdir)

    def jax_loss(d):
        def one(qb, pb, fb, ab, mb):
            return jcorr_reference(qb, pb, fb, ab, mb, *d["mlp"], *d["wn"],
                                   w_dir=d.get("wdir"))
        pts = d["p"] if stage == 1 else d["q"]
        ab = d["aq"] if stage == 1 else jnp.zeros((B, 1))
        out = jax.vmap(lambda qb, pb, fb, a, mb: one(
            qb, pb, fb, a if stage == 1 else None, mb))(
            d["q"], pts, d["fp"], ab, mask)
        return jnp.sum(out * cot), out
    jgrad, jout = jax.jit(jax.grad(jax_loss, has_aux=True))(diff)

    leaves = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True),
                                    diff)
    out, _ = knn_weight_aggregate_train_reference(
        leaves["q"], leaves["p"] if stage == 1 else leaves["q"],
        leaves["fp"], leaves.get("aq"), _t(mask), *leaves["mlp"],
        *leaves["wn"], w_dir=leaves.get("wdir"))
    (out * _t(cot)).sum().backward()
    want_out = np.asarray(jout)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=1e-5 * np.abs(want_out).max())
    got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda a: a.grad.numpy(), leaves))
    want = jax.tree_util.tree_leaves(jgrad)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())


# (d) the loss ----------------------------------------------------------------

@pytest.mark.parametrize("pretrain", [False, True])
def test_track4d_loss_matches_jax(pretrain):
    """Per-stream loss items, with a stream that has no valid point and no
    valid pair; 1e-5."""
    rng = np.random.RandomState(7)
    out = dict(warp=rng.randn(B, N, 3).astype(np.float32),
               cls=rng.uniform(0, 1, (B, N)).astype(np.float32),
               aff=rng.uniform(0, 1, (B, K, K)).astype(np.float32),
               prev_gt_id=rng.randint(0, 4, (B, K)).astype(np.int32),
               prev_valid=rng.rand(B, K) > 0.3,
               curr_gt_id=rng.randint(0, 4, (B, K)).astype(np.int32),
               curr_valid=rng.rand(B, K) > 0.3)
    out["prev_valid"][1] = False
    fr = dict(gt_flow=rng.randn(B, N, 3).astype(np.float32),
              gt_cls=rng.rand(B, N) > 0.5, mask1=rng.rand(B, N) > 0.2)
    fr["mask1"][1] = False

    def one(o, f):
        return jtrack4d_loss(o, types.SimpleNamespace(**f), pretrain)[1]
    want = jax.vmap(one)(out, fr)
    _, got = track4d_loss({k: _t(v) for k, v in out.items()},
                          types.SimpleNamespace(
                              **{k: _t(v) for k, v in fr.items()}),
                          pretrain)
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(val),
                                   **TIGHT, err_msg=key)


# (e) the optimizer -----------------------------------------------------------

def test_optimizer_matches_optax():
    """Adam with weight decay before the moments and a staircase schedule,
    over a decay boundary, against optax; one parameter's gradient is
    always zero (its .grad stays None in torch: optimizer_step must still
    move it, as optax does). 1e-6."""
    cfg = types.SimpleNamespace(lr=1e-2, weight_decay=1e-2, decay_epochs=1,
                                decay_rate=0.5)
    rng = np.random.RandomState(8)
    p0 = {"a": rng.randn(3, 4).astype(np.float32),
          "z": rng.randn(5).astype(np.float32)}
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(5)]
    tx = jmake_optimizer(cfg, steps_per_epoch=2)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = tx.init(jp)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()})
    ts = create_train_state(module, cfg, steps_per_epoch=2, device="cpu")
    for g in grads:
        upd, st = tx.update({"a": jnp.asarray(g), "z": jnp.zeros(5)}, st, jp)
        jp = optax.apply_updates(jp, upd)
        ts.optimizer.zero_grad(set_to_none=True)
        module["a"].grad = _t(g)
        optimizer_step(ts)
        for k in p0:
            np.testing.assert_allclose(module[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=k)
    assert ts.step == 5 and ts.scheduler.get_last_lr()[0] == 1e-2 * 0.25


# (f) one full Track4D train step ---------------------------------------------

def _grads_by_name(model):
    return {n: p.grad for n, p in model.named_parameters()}


def test_track4d_train_step_matches_jax(world):
    """Frame 0 of the block through make_train_step against the JAX loss
    gradient: loss items 1e-4 relative; every parameter gradient leaf
    |g - g_jax| <= 1e-3 |G_jax| + 1e-6 in norm, G_jax the whole gradient,
    and cosine(g, g_jax) >= 0.999 for every leaf above 1e-4 |G_jax|; BN
    running statistics after the step 1e-5.

    The bound is on the whole gradient's norm because the step is
    ill-conditioned leaf by leaf: near-ties in the max-pools and ReLUs
    make a relative change of 1e-7 in the weights move the float64
    gradient by 1.8e-3 of the worst leaf's norm, and JAX's own float32
    gradient is up to 1.2e-3 of a leaf's norm away from a float64 run of
    the port (which the port's float32 run matches to 1.3e-5 overall)."""
    model, v, frames = world
    fr = _frame_t(frames, 0)
    grad_fn = jax.jit(jax.grad(_make_loss_fn(model), has_aux=True))
    jgrads, (_, jitems, jstats) = grad_fn(
        v["params"], v["batch_stats"], _jstates(),
        jax.tree_util.tree_map(jnp.asarray, fr), False)
    port = _port(v)
    ts = create_train_state(port, TrainConfig(), steps_per_epoch=10, device="cpu")
    _, items = make_train_step(ts)(init_state(B, K, device="cpu"), to_tensors(fr, "cpu"), False)
    for key, val in jitems.items():
        np.testing.assert_allclose(items[key].numpy(), np.asarray(val),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    want = from_flax_variables({"params": jgrads})
    got = _grads_by_name(port)
    assert set(got) == set(want)
    norm = torch.linalg.vector_norm
    total = float(norm(torch.cat([w.flatten() for w in want.values()])))
    for name, w in want.items():
        g = got[name]
        err = float(norm(g - w))
        assert err <= 1e-3 * total + 1e-6, (name, err, total)
        if float(norm(w)) > 1e-4 * total:
            cos = float((g * w).sum()) / float(norm(g) * norm(w))
            assert cos >= 0.999, (name, cos)
    stats = from_flax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, jstats)})
    sd = port.state_dict()
    for name, val in stats.items():
        np.testing.assert_allclose(sd[name].numpy(), val.numpy(), **TIGHT,
                                   err_msg=name)


def test_sinkhorn_input_detached_leaves_every_gradient(world, monkeypatch):
    """Two train steps (the second with tracks to match) give every
    parameter the same gradient, by torch.equal, whether the Sinkhorn gets
    the affinities detached (match_structure) or as the affinity MLP gave
    them: its coupling reaches the loss through argmaxes alone."""
    _, v, frames = world
    f0, f1 = (to_tensors(_frame_t(frames, t), "cpu") for t in (0, 1))
    seen = []
    real_ot = association.log_optimal_transport_masked

    def run(undetached: bool):
        ts = create_train_state(_port(v), TrainConfig(), steps_per_epoch=10,
                                device="cpu")
        live = []
        real_aff = ts.model.affinity_stage

        def affinity_stage(*args):
            live.append(real_aff(*args))
            return live[-1]

        def ot(scores, *args, **kw):
            if undetached:
                scores = live[-1]
            seen.append((undetached, scores.requires_grad))
            return real_ot(scores, *args, **kw)

        with monkeypatch.context() as mp:
            mp.setattr(ts.model, "affinity_stage", affinity_stage)
            mp.setattr(association, "log_optimal_transport_masked", ot)
            step = make_train_step(ts)
            state, _ = step(init_state(B, K, device="cpu"), f0, False)
            assert int(state.valid.sum()) > 0
            step(state, f1, False)
        return _grads_by_name(ts.model)

    detached, undetached = run(False), run(True)
    assert seen == [(False, False)] * 2 + [(True, True)] * 2
    for name, g in detached.items():
        assert torch.equal(g, undetached[name]), name


# (g) the train scan over T frames --------------------------------------------

def test_scan_train_matches_jax(world):
    """make_scan_train_step over the 2-frame block (2 optimizer steps)
    against the JAX scan: per-frame loss items 1e-3 relative."""
    model, v, frames = world
    cfg = TrainConfig()
    tx = jmake_optimizer(cfg, 10)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jts = JTrainState(params, jax.tree_util.tree_map(
        jnp.asarray, v["batch_stats"]), tx.init(params),
        jnp.zeros((), jnp.int32))
    _, _, jitems = jscan_train(model, tx)(
        jts, _jstates(), jax.tree_util.tree_map(jnp.asarray, frames),
        jnp.asarray(False))
    ts = create_train_state(_port(v), cfg, steps_per_epoch=10, device="cpu")
    _, items = make_scan_train_step(ts)(init_state(B, K, device="cpu"),
                                        to_tensors(FrameBatch(*frames), "cpu"),
                                        False)
    assert float(np.asarray(jitems["TrackingLoss"])[1].max()) > 0
    for key, val in jitems.items():
        assert items[key].shape == (T, B)
        np.testing.assert_allclose(items[key].numpy(), np.asarray(val),
                                   rtol=1e-3, atol=1e-6, err_msg=key)


# (h) checkpoint round trip ---------------------------------------------------

def test_checkpoint_resume_gives_the_same_next_step(world, tmp_path):
    """Save after one step, take a second step; a fresh model restored from
    the checkpoint takes the same second step bit for bit (parameters,
    BN statistics, Adam state and learning rate)."""
    _, v, frames = world
    f0, f1 = to_tensors(_frame_t(frames, 0), "cpu"), to_tensors(_frame_t(frames, 1), "cpu")
    cfg = types.SimpleNamespace(lr=1e-3, weight_decay=1e-10, decay_epochs=1,
                                decay_rate=0.5)
    ts = create_train_state(_port(v), cfg, steps_per_epoch=1, device="cpu")
    step = make_train_step(ts)
    state1, _ = step(init_state(B, K, device="cpu"), f0, False)
    save_train_state(tmp_path, "last", ts)
    _, items_a = step(state1, f1, False)

    fresh = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS,
                    generator=torch.Generator().manual_seed(1), device="cpu")
    ts_b = restore_train_state(tmp_path, "last",
                               create_train_state(fresh, cfg, 1, device="cpu"))
    assert ts_b.step == 1
    _, items_b = make_train_step(ts_b)(state1, f1, False)
    for key in items_a:
        assert torch.equal(items_a[key], items_b[key]), key
    for (name, a), b in zip(ts.model.state_dict().items(),
                            ts_b.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert ts.scheduler.get_last_lr() == ts_b.scheduler.get_last_lr()
    for sa, sb in zip(ts.optimizer.state.values(),
                      ts_b.optimizer.state.values()):
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
