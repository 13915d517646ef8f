"""CPU parity of the bfloat16 train step: the port's `Track4D(dtype=
torch.bfloat16)` in training against the JAX package's train step at
`dtype=jnp.bfloat16`, on one set of flax variables and numpy-seeded
inputs (N = 128 points, k_max 8, 20 Sinkhorn iterations, full widths).

Where the two differ by design. The JAX train kernels B8-B10 take no
compute dtype, and neither do the port's: the port's run in float32
behind casts. The JAX kernels round their inner products' operands to
bfloat16 in every dtype (pallas_sa_train.py:272-273, :322-323, :480-481,
:583-584; pallas_correlator_train.py:176-177, :240-242), which the
port's float32 kernels do not, and the port adds no kernel variant that
JAX lacks.

Module level (train mode, one stream, the JAX modules through their
kernels: pallas_sa.FORCE_FUSED_ON_CPU, interpret mode). PNHead: the JAX
kernels' inner bfloat16 passes alone put the JAX output 2.5% of its
largest value from the JAX float32 module's, and the port 3.0% from JAX's
(one bfloat16 step, 2^-8 = 0.4%, cannot hold), so the output is held to
the JAX float32 module (unfused) by twice the JAX bfloat16 module's
distance: max|o - o_f32| <= 2^-8 max|o_f32| + 2 max|o_jax,bf16 -
o_f32|, measured 1.8% against 2.5%; each running statistic |s - s_f32|
<= 1e-4 |s_f32| + 2 |s_jax,bf16 - s_f32| in norm. FeatureCorrelator:
within one bfloat16 step (2^-8) of max|JAX|, measured 3.1e-3. Output
dtypes equal JAX's.

Step level. One train step (frame 0) and a 2-frame train scan, through
the JAX kernels (one stream) and unfused (two streams; the 8192-point
case of tests/test_torch_port_bf16_train_stretch.py likewise). The JAX
2-frame scan is its loss function's gradient and its optimizer's update
frame by frame, as its make_scan_train_step computes them. Frame 0's loss
items within LOSS_TOL = 2e-2 relative (measured: 1.1e-2 fused, 1.8e-2
unfused, both on SceneFlowLoss). The gradient of a bfloat16 step is
chaotic at these random weights: max-pool and ReLU near-ties, which
bfloat16 rounding turns into ties or flips, route cotangents elsewhere.
Moving the weights by 1e-7 relative moves the port's bfloat16 gradient
by 28% of its norm (cosine 0.962) and its float32 one by 7e-4 (2 x 512
points); the JAX package's own bfloat16 gradient is 0.46 (kernels) and
0.62 (unfused) of |G| from its float32 one, and its two bfloat16 paths
0.75 from each other (cosine 0.71). Two bfloat16 runs carry independent
noise of that size, so a gate of cosine >= 0.99, or |g - g_jax,bf16| <=
|g_jax,bf16 - g_f32|, holds for no pair of them (the port is 0.67 of |G|
from JAX's bfloat16 gradient, cosine 0.81-0.82). So the port's bfloat16
gradient is held to the float32 one (the JAX package's unfused float32
gradient, which the port's float32 gradient meets to 1e-3 |G|,
tests/test_torch_port_train.py) as chip_smoke.py phase 7 holds the card
to float64: per leaf and over the whole gradient |g - g_f32| <= 1e-2 |G|
+ 2 |g_jax,bf16 - g_f32|, and 1 - cos(g, g_f32) <= 2 (1 - cos(g_jax,bf16,
g_f32)). Measured, whole gradient, port / JAX bfloat16 against float32:
fused 0.58 / 0.46 of |G|, cosine 0.865 / 0.891; unfused 0.53 / 0.62,
0.895 / 0.797; the worst leaf at 0.74 (fused) and 0.58 (unfused) of its
bound. The running statistics likewise (fused 127 / 120, unfused 342 /
526 from float32's, of 1.7e4 and 4.4e4), and frame 1's loss items, after
an Adam step that moves every weight by about lr whatever its gradient's
size: fused 0.090 / 0.133, unfused 0.080 / 0.131 from the float32 scan's.

The saturated loss (item of ROADMAP's reference behaviours): jnp.clip
and torch.clamp round 1 - 1e-7 to 1.0 in bfloat16, so a cls of 0.999 on
a positive point gives a NaN BCE (a 0 loss after nan_to_num, a NaN
gradient there) and on a negative point an infinite one (the largest
float): the port reproduces the loss items and the NaN positions of the
JAX gradient. The CLI trains a bfloat16 synthetic config.
"""

import math
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
from ratrack_tpu.models.correlator import FeatureCorrelator as JCorrelator
from ratrack_tpu.models.pnhead import PNHead as JPNHead
from ratrack_tpu.ops import pallas_sa
from ratrack_tpu.tracker import init_state as jinit_state
from ratrack_tpu.train.losses import track4d_loss as jtrack4d_loss
from ratrack_tpu.train.step import _make_loss_fn
from ratrack_tpu.train.step import make_optimizer as jmake_optimizer
from ratrack_tpu_torch.data import FrameBatch, to_tensors
from ratrack_tpu_torch.models import Track4D
from ratrack_tpu_torch.models.correlator import FeatureCorrelator
from ratrack_tpu_torch.models.pnhead import PNHead
from ratrack_tpu_torch.tracker import init_state
from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                     make_scan_train_step, make_train_step,
                                     track4d_loss)
from ratrack_tpu_torch.utils import from_flax_variables
from test_torch_port_bf16 import (_bf16_mask, _cloud, _dtype_name, _init,
                                  _snap, _t)

BF = torch.bfloat16
N, K, ITERS, T = 128, 8, 20, 2
STEP = 2.0 ** -8
LOSS_TOL = 2e-2


def _rel_max(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


# ---- modules in train mode ---------------------------------------------------

def test_pnhead_train_matches_jax_bf16(monkeypatch):
    """The PNHead in train mode over one stream, bfloat16 output, held to
    the JAX float32 module (unfused) by twice the JAX bfloat16 module's
    (through its kernels) distance: max|o - o_f32| <= 2^-8 max|o_f32| + 2
    max|o_jax,bf16 - o_f32|, each running statistic |s - s_f32| <= 1e-4
    |s_f32| + 2 |s_jax,bf16 - s_f32| in norm. Prints the distance from
    the JAX bfloat16 output."""
    xyz = _cloud(110)[:1]
    mask = _bf16_mask(100)[:1]
    ft = np.random.RandomState(111).randn(1, N, 2).astype(np.float32)
    args = (jnp.asarray(xyz[0]), jnp.asarray(ft[0]), jnp.asarray(mask[0]))
    heads = {dt: JPNHead(N, dtype=dt) for dt in (jnp.bfloat16, jnp.float32)}
    v = _init(heads[jnp.bfloat16], 112, *args, False)
    runs, dtypes = {}, {}
    for dt, head in heads.items():
        monkeypatch.setattr(pallas_sa, "FORCE_FUSED_ON_CPU",
                            dt == jnp.bfloat16)
        (_, out), mut = head.apply(v, *args, True, mutable=["batch_stats"])
        dtypes[dt] = str(out.dtype)
        runs[dt] = (np.asarray(out, np.float32), from_flax_variables(
            {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   mut["batch_stats"])}))
    (want, want_stats), (f32, f32_stats) = runs[jnp.bfloat16], runs[
        jnp.float32]
    port = PNHead(N, 2, dtype=BF).train()
    port.load_state_dict(from_flax_variables(v), strict=True)
    _, got = port(_t(xyz), _t(ft), _t(mask))
    assert _dtype_name(got) == dtypes[jnp.bfloat16] == "bfloat16"
    got = got[0].detach().float().numpy()
    e_port, e_jax = np.abs(got - f32).max(), np.abs(want - f32).max()
    scale = np.abs(f32).max()
    print(f"pnhead train: {e_port / scale:.4g} of max from float32, JAX "
          f"bfloat16 {e_jax / scale:.4g}; {_rel_max(got, want):.4g} from "
          f"JAX bfloat16")
    assert e_port <= STEP * scale + 2 * e_jax, (e_port, e_jax, scale)
    sd = port.state_dict()
    for name, f in f32_stats.items():
        e_port = float((sd[name] - f).norm())
        e_jax = float((want_stats[name] - f).norm())
        assert e_port <= 1e-4 * float(f.norm()) + 2 * e_jax, (
            name, e_port, e_jax)


def test_correlator_train_matches_jax_bf16(monkeypatch):
    """The FeatureCorrelator in train mode over one stream at 30 m
    coordinates, bfloat16 head features in: within 2^-8 of max|JAX|."""
    pc1, pc2 = _cloud(113, scale=15.0)[:1], _cloud(114, scale=15.0)[:1]
    m1, m2 = _bf16_mask(110)[:1], _bf16_mask(100)[:1]
    rng = np.random.RandomState(115)
    f1 = rng.randn(1, N, 256).astype(np.float32)
    f2 = rng.randn(1, N, 256).astype(np.float32)
    mod = JCorrelator(16, (256, 256, 256), jnp.bfloat16)
    args = (jnp.asarray(pc1[0]), jnp.asarray(pc2[0]),
            jnp.asarray(f1[0], jnp.bfloat16), jnp.asarray(f2[0], jnp.bfloat16),
            jnp.asarray(m1[0]), jnp.asarray(m2[0]))
    v = _init(mod, 116, *args, train=False)
    monkeypatch.setattr(pallas_sa, "FORCE_FUSED_ON_CPU", True)
    want = mod.apply(v, *args, train=True)
    port = FeatureCorrelator(dtype=BF).train()
    port.load_state_dict(from_flax_variables(v), strict=True)
    got = port(_t(pc1), _t(pc2), _t(f1).to(BF), _t(f2).to(BF), _t(m1),
               _t(m2))
    assert _dtype_name(got) == str(want.dtype) == "bfloat16"
    err = _rel_max(got[0].detach().float().numpy(), want)
    print(f"correlator train: {err:.4g} of max|JAX|")
    assert err <= STEP, err


# ---- the train step ----------------------------------------------------------

def _world(n_streams, n, frames_t, seed, **model_kw):
    """(JAX bfloat16 and float32 models, numpy variables, numpy frames
    (n_streams, frames_t, ...), port keyword arguments)."""
    n_static = min(n - 64, max(60, n * 3 // 5))
    clips = [stack_frames(synthetic_clip(s, frames_t, n_max=n, g_max=K,
                                         n_static=n_static, n_objects=3))
             for s in range(n_streams)]
    frames = JFrameBatch(*[np.stack([np.asarray(getattr(c, f))
                                     for c in clips])
                           for f in JFrameBatch._fields])
    frames = frames._replace(pc1=_snap(frames.pc1), pc2=_snap(frames.pc2),
                             pc1_comp=_snap(frames.pc1_comp))
    kw = dict(npoint=model_kw.pop("npoint", n), k_max=K,
              sinkhorn_iters=ITERS, **model_kw)
    models = {dt: JTrack4D(dtype=dt, **kw)
              for dt in (jnp.bfloat16, jnp.float32)}
    f0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0, 0]), frames)
    v = _init(models[jnp.bfloat16], seed, f0, jinit_state(K), train=False)
    return models, v, frames, kw


def _jstates(b):
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (b,) + x.shape), jinit_state(K))


def _jax_frames(frames, t):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x[:, t]), frames)


def _jax_train_frames(model, v, frames, n_frames):
    """The JAX package's train steps frame by frame (its loss function's
    gradient, then its optimizer's update, the body of its
    make_scan_train_step) -> (per-frame loss items, the first step's
    gradient as a port state dict, the batch statistics after it)."""
    b = frames.pc1.shape[0]
    tx = jmake_optimizer(TrainConfig(), 10)
    grad_fn = jax.jit(jax.grad(_make_loss_fn(model), has_aux=True))

    @jax.jit
    def update(params, grads, opt_state):
        upd, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state

    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])
    opt_state, states, items = tx.init(params), _jstates(b), []
    for t in range(n_frames):
        g, (states, it, stats) = grad_fn(params, stats, states,
                                         _jax_frames(frames, t), False)
        if t == 0:
            first = (from_flax_variables({"params": g}), from_flax_variables(
                {"batch_stats": jax.tree_util.tree_map(np.asarray, stats)}))
        items.append({k: np.asarray(x) for k, x in it.items()})
        params, opt_state = update(params, g, opt_state)
    return items, first[0], first[1]


def _port(v, kw):
    port = Track4D(dtype=BF, device="cpu", **kw)
    port.load_state_dict(from_flax_variables(v), strict=True)
    return create_train_state(port, TrainConfig(), 10, device="cpu")


def _port_frames(frames, t=None):
    if t is not None:
        frames = FrameBatch(*[np.ascontiguousarray(x[:, t]) for x in frames])
    return to_tensors(FrameBatch(*frames), "cpu")


def assert_grads_like_jax_bf16(got, want_bf16, want_f32, name):
    """The gate of the module docstring: per leaf and over the whole
    gradient |g - g_f32| <= 1e-2 |G| + 2 |g_jax,bf16 - g_f32|, and the
    whole gradient's cosine with g_f32 within twice JAX's distance from
    1. Prints the measured distances (fractions of |G|)."""
    norm = torch.linalg.vector_norm
    assert set(got) == set(want_f32)
    names = sorted(want_f32)
    flat = [torch.cat([d[n].flatten().double() for n in names])
            for d in (got, want_bf16, want_f32)]
    total = float(norm(flat[2]))
    worst = 0.0
    for n in names + [None]:
        g, b, f = flat if n is None else (got[n].double(),
                                          want_bf16[n].double(),
                                          want_f32[n].double())
        assert torch.isfinite(g).all(), n
        e_port, e_jax = float(norm(g - f)), float(norm(b - f))
        ratio = e_port / (1e-2 * total + 2 * e_jax)
        assert ratio <= 1.0, (name, n, e_port / total, e_jax / total)
        worst = max(worst, ratio)

    def cos(a, b):
        return float((a * b).sum() / (norm(a) * norm(b)))
    c_port, c_jax = cos(flat[0], flat[2]), cos(flat[1], flat[2])
    assert 1 - c_port <= 2 * (1 - c_jax), (name, c_port, c_jax)
    print(f"{name}: |g - g_f32| {float(norm(flat[0] - flat[2])) / total:.4g}"
          f" |G|, JAX bf16 {float(norm(flat[1] - flat[2])) / total:.4g}; "
          f"cosine {c_port:.4g} / {c_jax:.4g}; against JAX bf16 "
          f"{float(norm(flat[0] - flat[1])) / total:.4g}, cosine "
          f"{cos(flat[0], flat[1]):.4g}; worst leaf {worst:.3g} of its bound")


def _assert_items_close(got, want, name):
    """Each loss item within LOSS_TOL relative (1e-6 absolute)."""
    for key, val in want.items():
        g, w = got[key].numpy(), np.asarray(val)
        assert np.all(np.abs(g - w) <= LOSS_TOL * np.abs(w) + 1e-6), (
            name, key, g, w)


def assert_step_like_jax_bf16(ts, got, jax_bf16, jax_f32, name):
    """One train step of the port (ts after make_train_step returned the
    loss items `got`) against the JAX package's, jax_* = (loss items,
    gradient, running statistics) of _jax_train_frames' first step: loss
    items within LOSS_TOL, the gradient by assert_grads_like_jax_bf16, all
    running statistics together by its rule, |s - s_f32| <= 1e-4 |s_f32|
    + 2 |s_jax,bf16 - s_f32| in norm."""
    _assert_items_close(got, jax_bf16[0], name)
    assert_grads_like_jax_bf16(
        {n: p.grad for n, p in ts.model.named_parameters()}, jax_bf16[1],
        jax_f32[1], name)
    sd = ts.model.state_dict()
    names = sorted(jax_f32[2])
    s_port, s_jax, s_f32 = (torch.cat([d[n].flatten().double()
                                       for n in names])
                            for d in (sd, jax_bf16[2], jax_f32[2]))
    e_port, e_jax = float((s_port - s_f32).norm()), float(
        (s_jax - s_f32).norm())
    print(f"{name} running statistics: {e_port:.4g} from float32, JAX bf16 "
          f"{e_jax:.4g}, of {float(s_f32.norm()):.4g}")
    assert e_port <= 1e-4 * float(s_f32.norm()) + 2 * e_jax, (e_port, e_jax)


def jax_bf16_and_f32(monkeypatch, models, v, frames, fused, n_frames):
    """_jax_train_frames of the bfloat16 model (through the JAX kernels
    where `fused`) and of the float32 model unfused -> (bf16, f32)."""
    monkeypatch.setattr(pallas_sa, "FORCE_FUSED_ON_CPU", fused)
    bf16 = _jax_train_frames(models[jnp.bfloat16], v, frames, n_frames)
    monkeypatch.setattr(pallas_sa, "FORCE_FUSED_ON_CPU", False)
    return bf16, _jax_train_frames(models[jnp.float32], v, frames, n_frames)


def first_step(run):
    """(loss items, gradient, statistics) of a _jax_train_frames run's
    first step."""
    items, grads, stats = run
    return items[0], grads, stats


@pytest.mark.parametrize("path", ["fused", "unfused"])
def test_train_step_and_scan_match_jax_bf16(path, monkeypatch):
    """Frame 0 through make_train_step (assert_step_like_jax_bf16) and
    the 2-frame make_scan_train_step: frame 0's loss items within
    LOSS_TOL of JAX's, frame 1's (after an Adam step from a bfloat16
    gradient) by the same rule against the JAX float32 scan, all items
    and streams together in norm: |l - l_f32| <= LOSS_TOL |l_f32| + 2
    |l_jax,bf16 - l_f32|; through the JAX kernels over one stream,
    unfused over two."""
    nb = 1 if path == "fused" else 2
    models, v, frames, kw = _world(nb, N, T, 120)
    jax_bf16, jax_f32 = jax_bf16_and_f32(monkeypatch, models, v, frames,
                                         path == "fused", T)
    jax_first = [first_step(run) for run in (jax_bf16, jax_f32)]

    ts = _port(v, kw)
    _, got = make_train_step(ts)(init_state(nb, K, device="cpu"),
                                 _port_frames(frames, 0), False)
    assert_step_like_jax_bf16(ts, got, *jax_first, f"{path} step")

    _, got = make_scan_train_step(_port(v, kw))(
        init_state(nb, K, device="cpu"), _port_frames(frames), False)
    assert got["Loss"].shape == (T, nb)
    _assert_items_close({k: x[0] for k, x in got.items()}, jax_bf16[0][0],
                        f"{path} scan frame 0")
    keys = sorted(got)
    for t in range(1, T):
        f = np.concatenate([jax_f32[0][t][k] for k in keys])
        b = np.concatenate([jax_bf16[0][t][k] for k in keys])
        g = np.concatenate([got[k][t].numpy() for k in keys])
        e_port, e_jax = np.linalg.norm(g - f), np.linalg.norm(b - f)
        print(f"{path} scan frame {t} {keys}: {g} against float32 {f}: "
              f"{e_port:.4g}, JAX bf16 {e_jax:.4g}")
        assert e_port <= LOSS_TOL * np.linalg.norm(f) + 2 * e_jax, (
            e_port, e_jax)


# ---- the loss on saturated bfloat16 probabilities ----------------------------

def test_saturated_bf16_loss_matches_jax():
    """cls of 0.999 in bfloat16 on a positive point (stream 0) and on a
    negative one (stream 1), affinities likewise: the loss items and the
    NaN positions of the gradient with respect to cls and aff equal
    JAX's (the reference behaviour, reproduced on purpose)."""
    cls = np.array([[0.5, 0.999, 0.3, 0.0], [0.5, 0.999, 0.3, 0.0]],
                   np.float32)
    gt_cls = np.array([[True, True, False, False],
                       [True, False, False, True]])
    aff = np.full((2, 2, 2), 0.4, np.float32)
    aff[0, 0, 0], aff[1, 0, 1] = 0.999, 0.999
    out = dict(warp=np.zeros((2, 4, 3), np.float32),
               prev_gt_id=np.array([[1, 2], [1, 2]], np.int32),
               prev_valid=np.ones((2, 2), bool),
               curr_gt_id=np.array([[1, 3], [1, 3]], np.int32),
               curr_valid=np.ones((2, 2), bool))
    fr = dict(gt_flow=np.ones((2, 4, 3), np.float32), gt_cls=gt_cls,
              mask1=np.ones((2, 4), bool))

    def jax_loss(c, a):
        def one(o, f, ci, ai):
            return jtrack4d_loss({**o, "cls": ci, "aff": ai},
                                 types.SimpleNamespace(**f), False)
        totals, items = jax.vmap(one)(out, fr, c, a)
        return jnp.sum(totals), items
    jc, ja = (jnp.asarray(x, jnp.bfloat16) for x in (cls, aff))
    (jg_cls, jg_aff), jitems = jax.grad(jax_loss, argnums=(0, 1),
                                        has_aux=True)(jc, ja)

    tc = _t(cls).to(BF).requires_grad_(True)
    ta = _t(aff).to(BF).requires_grad_(True)
    total, items = track4d_loss(
        {**{k: _t(x) for k, x in out.items()}, "cls": tc, "aff": ta},
        types.SimpleNamespace(**{k: _t(x) for k, x in fr.items()}), False)
    total.sum().backward()
    for key, val in jitems.items():
        np.testing.assert_array_equal(items[key].detach().numpy(),
                                      np.asarray(val, np.float32), key)
    assert items["SegLoss"][0] == 0.0            # NaN -> 0
    assert items["SegLoss"][1] > 1e30            # inf -> the largest float
    for got, want in ((tc.grad, jg_cls), (ta.grad, jg_aff)):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(want).any()
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                                   rtol=1e-2, atol=0)


# ---- the CLI -------------------------------------------------------------------

def test_cli_trains_a_bf16_config(tmp_path):
    """`python -m ratrack_tpu_torch.main --cpu` trains a synthetic config
    with `dtype: bfloat16` for one epoch (one block of 2 streams x 2
    frames): finite losses; its checkpoint restores into a float32
    model."""
    import yaml
    from ratrack_tpu_torch.main import main
    from ratrack_tpu_torch.train import checkpoint
    cfg = dict(exp_name="bf16_train", dataset="synthetic", n_max=96,
               npoints=96, k_max=8, g_max=8, sinkhorn_iters=20,
               synth_clips=2, synth_frames=2, scan_frames=2, dp=2, epochs=1,
               dtype="bfloat16", checkpoints_dir=str(tmp_path / "ckpt"),
               results_dir=str(tmp_path / "results"))
    path = tmp_path / "bf16_train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    (epoch,) = main(["--config", str(path), "--cpu"])["train"]
    assert epoch["frames"] == 4
    assert all(math.isfinite(epoch[k]) for k in
               ("Loss", "SceneFlowLoss", "SegLoss", "TrackingLoss"))
    f32 = Track4D(npoint=96, k_max=8, sinkhorn_iters=20, device="cpu")
    checkpoint.restore_model(str(tmp_path / "ckpt" / "bf16_train" /
                                 "models"), "last", f32)
    assert all(torch.isfinite(p).all() for p in f32.parameters())
