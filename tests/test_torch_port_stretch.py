"""CPU parity of the stretch eval path (8192 / 16384-point clouds, 512
centers, true farthest point sampling, the split correlator, compact
DBSCAN, the Sinkhorn kernel) against the JAX package, at small sizes.

The same numpy inputs go through the JAX function and the port's. The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU; the port runs its kernels' plain versions (the tensors
lie on the CPU). Each test states its tolerance; selections (indices,
labels, matchings) are compared exactly, on grid-snapped coordinates where
a distance tie or a rounding difference could otherwise decide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu.data.frames import FrameBatch as JFrameBatch
from ratrack_tpu.data.synthetic import stack_frames, synthetic_clip
from ratrack_tpu.models import Track4D as JTrack4D
from ratrack_tpu.models.correlator import FeatureCorrelator as JCorrelator
from ratrack_tpu.ops import morton as jmorton
from ratrack_tpu.ops import pallas_sa
from ratrack_tpu.ops.pallas_correlator import \
    knn_gather_apply as j_knn_gather_apply
from ratrack_tpu.ops.pallas_fps_kernel import fps_indices_fused
from ratrack_tpu.ops.pallas_knn import knn_indices_tiled as j_knn_tiled
from ratrack_tpu.ops.sampling import furthest_point_sample as j_fps
from ratrack_tpu.tracker import association as jassoc
from ratrack_tpu.tracker import init_state as jinit_state
from ratrack_tpu.tracker import sinkhorn as jsinkhorn
from ratrack_tpu.tracker.dbscan import compact_dbscan as j_compact_dbscan
from ratrack_tpu.train.step import TrainState as JTrainState
from ratrack_tpu.train.step import _make_loss_fn
from ratrack_tpu.train.step import make_optimizer as jmake_optimizer
from ratrack_tpu.train.step import make_scan_eval_step_cached as jscan
from ratrack_tpu.train.step import make_scan_train_step as jscan_train
from ratrack_tpu.train.step import make_train_step as jmake_train_step
from ratrack_tpu_torch.data import FrameBatch, to_tensors
from ratrack_tpu_torch.models import FeatureCorrelator, Track4D
from ratrack_tpu_torch.ops import morton, neighborhood
from ratrack_tpu_torch.ops.fused_correlator import knn_gather_apply
from ratrack_tpu_torch.ops.fused_knn import knn_indices_tiled, knn_tiled
from ratrack_tpu_torch.ops.fused_sinkhorn import sinkhorn_uv
from ratrack_tpu_torch.ops.sampling import furthest_point_sample
from ratrack_tpu_torch.tracker import (associate, init_state,
                                       log_optimal_transport_masked)
from ratrack_tpu_torch.tracker.dbscan import compact_dbscan
from ratrack_tpu_torch.ops.fused_correlator_train import \
    knn_weight_aggregate_train_reference
from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                     make_scan_eval_step_cached,
                                     make_scan_train_step, make_train_step)
from ratrack_tpu_torch.utils import from_flax_variables


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _snap(x):
    """Coordinates on a 1/16 grid: every distance is exact in both packages."""
    return (np.round(np.asarray(x, np.float32) * 16.0) / 16.0).astype(
        np.float32)


def _variables(model, frame, k_max, seed=0):
    """Random numpy variables for the JAX model's tree (as
    tests/test_torch_port_model.py): Dense kernels N(0, 1/fan_in), biases
    and BN means N(0, 0.1^2), BN scales and variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(
        lambda k: model.init(k, frame, jinit_state(k_max), train=False),
        jax.random.PRNGKey(seed))
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


# ---- Morton sort: integer arithmetic, so equal element for element ----

def test_morton_matches_jax():
    rng = np.random.RandomState(0)
    b, n = 3, 300
    xyz = (rng.randn(b, n, 3) * 40).astype(np.float32)
    xyz[0, :20] *= 30.0                  # beyond the +-512 m extent: clipped
    xyz[1, 50:90] = xyz[1, 10:50]        # equal codes: order by index
    xyz[2] = np.round(xyz[2] / 8.0) * 8.0   # many points a cell
    mask = rng.rand(b, n) > 0.3
    mask[2, :] = False
    mask[2, 5] = True
    code = morton.morton_code(_t(xyz))
    perm = morton.morton_perm(_t(xyz), _t(mask))
    perm_nomask = morton.morton_perm(_t(xyz))
    inv = morton.invert_perm(perm)
    assert code.dtype == torch.int32
    for s in range(b):
        np.testing.assert_array_equal(
            code[s].numpy(), np.asarray(jmorton.morton_code(xyz[s])))
        want = np.asarray(jmorton.morton_perm(jnp.asarray(xyz[s]),
                                              jnp.asarray(mask[s])))
        np.testing.assert_array_equal(perm[s].numpy(), want)
        np.testing.assert_array_equal(
            perm_nomask[s].numpy(),
            np.asarray(jmorton.morton_perm(jnp.asarray(xyz[s]))))
        np.testing.assert_array_equal(
            inv[s].numpy(), np.asarray(jmorton.invert_perm(jnp.asarray(want))))
        # masked rows come last
        assert mask[s][perm[s].numpy()][:mask[s].sum()].all()


# ---- farthest point sampling: indices equal ----

FPS_CASES = {
    # name: (npoint, valid count per stream; None = no mask)
    "below_valid": (64, (200, 150, 100)),
    "above_valid": (64, (40, 5, 64)),
    "one_or_none_valid": (32, (1, 0, 7)),
    "no_mask": (48, None),
    # coordinates on a coarse integer grid: coincident points and exactly
    # equal distances, so the first-maximum rule decides most samples
    "grid_ties": (96, (200, 150, 100)),
}


@pytest.mark.parametrize("n", [256, 640])
@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_matches_jax(n, case):
    npoint, valid = FPS_CASES[case]
    rng = np.random.RandomState(n + len(case))
    b = 3
    xyz = (rng.randn(b, n, 3) * 20).astype(np.float32)
    if case == "grid_ties":
        xyz = np.round(xyz / 10.0)
    if valid is None:
        mask = None
    else:
        mask = np.zeros((b, n), bool)
        mask[0, :valid[0]] = True                    # tail padding
        mask[1, rng.permutation(n)[:valid[1]]] = True   # scattered
        mask[2, n - valid[2]:] = True                # head padding
    got = furthest_point_sample(_t(xyz), npoint,
                                None if mask is None else _t(mask))
    assert got.shape == (b, npoint) and got.dtype == torch.int64
    for s in range(b):
        m = None if mask is None else jnp.asarray(mask[s])
        want = np.asarray(j_fps(jnp.asarray(xyz[s]), npoint, m))
        fused = np.asarray(fps_indices_fused(jnp.asarray(xyz[s]), npoint, m,
                                             interpret=True))
        np.testing.assert_array_equal(got[s].numpy(), want)
        np.testing.assert_array_equal(got[s].numpy(), fused)


def test_fps_of_all_points_is_a_permutation():
    """exact_fps at sa2 / sa3: npoint samples of npoint points, no mask."""
    xyz = (np.random.RandomState(1).randn(2, 128, 3) * 10).astype(np.float32)
    got = furthest_point_sample(_t(xyz), 128).numpy()
    for s in range(2):
        assert sorted(got[s].tolist()) == list(range(128))
        np.testing.assert_array_equal(
            got[s], np.asarray(j_fps(jnp.asarray(xyz[s]), 128)))


# ---- tiled kNN: indices and validity equal, keys within 1e-6 relative ----

def _knn_clouds(seed, n, grid):
    rng = np.random.RandomState(seed)
    q = (rng.randn(n, 3) * 6).astype(np.float32)
    p = (rng.randn(n, 3) * 6).astype(np.float32)
    if grid:   # exact distances and many exact ties
        q, p = np.round(q), np.round(p)
    return q, p


@pytest.mark.parametrize("n_valid", [350, 5, 0])
@pytest.mark.parametrize("zsort", [False, True])
def test_knn_tiled_matches_jax(n_valid, zsort):
    n = 384
    q, p = _knn_clouds(3, n, grid=True)
    mask = np.zeros(n, bool)
    mask[np.random.RandomState(4).permutation(n)[:n_valid]] = True
    if zsort:   # both clouds along the Z-curve, as the split correlator
        q = q[np.asarray(jmorton.morton_perm(jnp.asarray(q)))]
        perm = np.asarray(jmorton.morton_perm(jnp.asarray(p),
                                              jnp.asarray(mask)))
        p, mask = p[perm], mask[perm]
    # tq, tp small: 6 query tiles x 3 candidate chunks in the JAX kernel
    w_idx, w_keys, w_valid = j_knn_tiled(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask), k=16, tq=64,
        tp=128, interpret=True, return_keys=True)
    idx, keys, valid = knn_indices_tiled(_t(q)[None], _t(p)[None],
                                         _t(mask)[None], k=16,
                                         return_keys=True)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(w_valid))
    np.testing.assert_allclose(keys[0].numpy(), np.asarray(w_keys),
                               rtol=1e-6, atol=0)
    assert int(valid.sum()) == n * min(n_valid, 16)


def test_knn_routing_selects_the_same_indices(monkeypatch):
    """Both sides of the dense limit, and a masked 3-NN through the tiled
    route, give the dense `knn`'s indices; off the grid too, since both
    compute the same expanded-form distance."""
    q, p = _knn_clouds(5, 200, grid=False)
    mask = np.random.RandomState(6).rand(2, 200) > 0.4
    mask[1, 2:] = False                      # 2 valid: padded slots
    q, p = _t(np.stack([q, p])), _t(np.stack([p, q]))
    for k in (16, 3):
        d_dense, i_dense = neighborhood.knn(k, q, p, _t(mask))
        d_auto, i_auto = neighborhood.knn_auto(k, q, p, _t(mask))
        assert torch.equal(i_auto, i_dense) and torch.equal(d_auto, d_dense)
        monkeypatch.setattr(neighborhood, "KNN_DENSE_LIMIT", 100)
        d_tiled, i_tiled = neighborhood.knn_auto(k, q, p, _t(mask))
        monkeypatch.undo()
        assert torch.equal(i_tiled, i_dense)
        assert torch.equal(i_tiled, knn_tiled(k, q, p, _t(mask))[1])
        # the tiled route recomputes |q - x|^2 directly: 1e-4 of the scale
        np.testing.assert_allclose(d_tiled.numpy(), d_dense.numpy(),
                                   rtol=1e-4, atol=1e-4)


# ---- knn_gather_apply, both stages: 1e-5 of the maximum ----

@pytest.mark.parametrize("n_valid", [350, 5])
def test_knn_gather_apply_matches_jax(n_valid):
    n, c = 256, 64
    q, p = _knn_clouds(7, n, grid=True)
    rng = np.random.RandomState(11)
    feats_p = rng.randn(n, c).astype(np.float32)
    add_q = rng.randn(n, c).astype(np.float32)
    mlp_ws = [rng.randn(c, c).astype(np.float32) / 8]
    mlp_bs = [rng.randn(c).astype(np.float32)]
    wn_ws = [rng.randn(3, 16).astype(np.float32),
             rng.randn(16, 16).astype(np.float32) / 4,
             rng.randn(16, c).astype(np.float32) / 4]
    wn_bs = [rng.randn(w).astype(np.float32) for w in (16, 16, c)]
    mask = np.arange(n) < n_valid
    j = jnp.asarray
    w_idx = j_knn_tiled(j(q), j(p), j(mask), k=16, interpret=True)
    idx = knn_indices_tiled(_t(q)[None], _t(p)[None], _t(mask)[None], k=16)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(w_idx))
    tl = lambda xs: [_t(x) for x in xs]  # noqa: E731
    for stage_add, ws, bs in ((add_q, mlp_ws, mlp_bs), (None, [], [])):
        want = np.asarray(j_knn_gather_apply(
            w_idx, j(q), j(p), j(feats_p),
            None if stage_add is None else j(stage_add),
            [j(w) for w in ws], [j(x) for x in bs], [j(w) for w in wn_ws],
            [j(x) for x in wn_bs], k=16, interpret=True))
        got = knn_gather_apply(
            idx, _t(q)[None], _t(p)[None], _t(feats_p)[None],
            None if stage_add is None else _t(stage_add)[None], tl(ws),
            tl(bs), tl(wn_ws), tl(wn_bs), k=16)[0].numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


# ---- FeatureCorrelator past 4096 points: 1e-5 of the maximum ----

@pytest.fixture(scope="module")
def split_case():
    n = 4224
    rng = np.random.RandomState(6)
    pc1 = _snap(rng.randn(n, 3) * 5)
    pc2 = _snap(rng.randn(n, 3) * 5)
    f1 = rng.randn(n, 64).astype(np.float32)
    f2 = rng.randn(n, 64).astype(np.float32)
    m1, m2 = np.arange(n) < n - 100, np.arange(n) < n - 50
    mod = JCorrelator(16, (64, 64, 64), jnp.float32, True)
    args = [jnp.asarray(a) for a in (pc1, pc2, f1, f2, m1, m2)]
    variables = jax.tree_util.tree_map(
        np.asarray, mod.init(jax.random.PRNGKey(0), *args, train=False))
    return mod, variables, (pc1, pc2, f1, f2, m1, m2)


@pytest.mark.parametrize("sort", [True, False])
def test_split_correlator_matches_jax(split_case, sort, monkeypatch):
    mod, variables, arrays = split_case
    monkeypatch.setattr(pallas_sa, "FORCE_FUSED_ON_CPU", True)
    monkeypatch.setattr(jmorton, "SPLIT_SPATIAL_SORT", sort)
    want = np.asarray(mod.apply(variables, *[jnp.asarray(a) for a in arrays],
                                train=False))
    port = FeatureCorrelator(16, (64, 64, 64), d1=64, d2=64,
                             spatial_sort=sort).eval()
    port.load_state_dict(from_flax_variables(variables), strict=True)
    with torch.inference_mode():
        got = port(*[_t(a)[None] for a in arrays])[0].numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


# ---- compact DBSCAN: labels equal ----

@pytest.mark.parametrize("n_masked", [40, 100])
def test_compact_dbscan_matches_jax(n_masked):
    """Under (40) and over (100) the budget of 64; scores are quantised so
    that the budget cut falls among equal scores."""
    rng = np.random.RandomState(n_masked)
    b, n, budget = 2, 256, 64
    x = np.concatenate(
        [c + 0.4 * rng.randn(b, 20, 8) for c in rng.uniform(-10, 10,
                                                            (5, 1, 1, 8))]
        + [rng.uniform(-20, 20, (b, n - 100, 8))], axis=1).astype(np.float32)
    mask = np.zeros((b, n), bool)
    for s in range(b):
        mask[s, rng.permutation(n)[:n_masked]] = True
        mask[s, :60] = True                       # the clusters
    scores = (np.round(rng.rand(b, n) * 4) / 4).astype(np.float32)
    got = compact_dbscan(_t(x), _t(mask), _t(scores), budget, 1.5, 2, 64)
    assert got.dtype == torch.int32
    for s in range(b):
        want = j_compact_dbscan(jnp.asarray(x[s]), jnp.asarray(mask[s]),
                                jnp.asarray(scores[s]), budget, 1.5, 2, 64)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))
    assert (got >= 0).any()


# ---- Sinkhorn with the kernel switch: Z within 1e-4, matching equal ----

def test_sinkhorn_kernel_switch_matches_jax(monkeypatch):
    monkeypatch.setattr(jsinkhorn, "FORCE_FUSED_ON_CPU", True)
    monkeypatch.setattr(jsinkhorn, "USE_FUSED_KERNEL", True)
    k, iters = 32, 100
    rng = np.random.RandomState(12)
    ms = np.array([0, 1, 7, 32, 32, 7, 0, 1], np.int32)
    ns = np.array([0, 7, 1, 32, 7, 32, 32, 1], np.int32)
    b = len(ms)
    aff = (1.0 / (1.0 + np.exp(-rng.randn(b, k, k)))).astype(np.float32)
    prev_ids = rng.randint(0, 50, (b, k)).astype(np.int32)
    next_id = np.arange(50, 50 + b, dtype=np.int32)
    z = log_optimal_transport_masked(_t(aff), _t(ms), _t(ns), 0.9, iters,
                                     safe_lse=False,
                                     use_fused_kernel=True).numpy()
    z_loop = log_optimal_transport_masked(_t(aff), _t(ms), _t(ns), 0.9,
                                          iters, safe_lse=False).numpy()
    res = associate(_t(aff), _t(ms), _t(ns), _t(prev_ids), _t(next_id), 0.9,
                    iters, 0.01, use_fused_kernel=True)
    for s in range(b):
        want = np.asarray(jsinkhorn.log_optimal_transport_masked(
            jnp.asarray(aff[s]), jnp.asarray(ms[s]), jnp.asarray(ns[s]),
            jnp.float32(0.9), iters, safe_lse=False))
        rows = list(range(ms[s])) + [k]
        cols = list(range(ns[s])) + [k]
        for mine in (z, z_loop):
            np.testing.assert_allclose(mine[s][np.ix_(rows, cols)],
                                       want[np.ix_(rows, cols)], atol=1e-4,
                                       rtol=0)
        jres = jassoc.associate(
            jnp.asarray(aff[s]), jnp.asarray(ms[s]), jnp.asarray(ns[s]),
            jnp.asarray(prev_ids[s]), jnp.asarray(next_id[s]),
            jnp.float32(0.9), iters, 0.01)
        np.testing.assert_array_equal(res.matched_prev[s].numpy(),
                                      np.asarray(jres.matched_prev))
        np.testing.assert_array_equal(res.track_id[s].numpy(),
                                      np.asarray(jres.track_id))


def test_sinkhorn_kernel_is_primal_only():
    c = torch.zeros((1, 3, 3), requires_grad=True)
    with pytest.raises(RuntimeError, match="primal only"):
        sinkhorn_uv(c, torch.zeros((1, 3)), torch.zeros((1, 3)), 2)


# ---- the whole path: the stretch model through the cached eval scan ----

N, NPOINT, K, ITERS, BUDGET, T = 256, 128, 8, 20, 64, 3
FWD = dict(atol=5e-4, rtol=5e-4)   # the class of test_torch_port_model.py


@pytest.fixture(scope="module")
def stretch_world():
    clip = stack_frames(synthetic_clip(3, T, n_max=N, g_max=K, n_static=150,
                                       n_objects=4))
    frames = JFrameBatch(*[np.asarray(getattr(clip, f))[None]
                           for f in JFrameBatch._fields])
    frames = frames._replace(pc1=_snap(frames.pc1), pc2=_snap(frames.pc2),
                             pc1_comp=_snap(frames.pc1_comp))
    kw = dict(npoint=NPOINT, k_max=K, sinkhorn_iters=ITERS, exact_fps=True,
              mov_budget=BUDGET)
    model = JTrack4D(**kw)
    f0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0, 0]), frames)
    variables = _variables(model, f0, K)
    port = Track4D(**kw, device="cpu")
    # the stretch options add no parameter: the same converted variables
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return model, variables, port, frames


def test_stretch_cached_scan_matches_jax(stretch_world):
    """cls and flow within 5e-4; labels, track ids and the final tracker
    state exact (grid-snapped coordinates)."""
    model, v, port, frames = stretch_world
    ts = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None],
                                jinit_state(K))
    w_state, want = jscan(model)(v, ts,
                                 jax.tree_util.tree_map(jnp.asarray, frames))
    g_state, got = make_scan_eval_step_cached(port)(
        init_state(1, K, device="cpu"), to_tensors(FrameBatch(*frames), "cpu"))
    assert got["cls"].shape == (1, T, N)
    for key in ("cls", "warp"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **FWD)
    for key in ("labels", "track_id", "n"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for name in ("track_id", "next_id", "frame_idx", "gt_id", "valid"):
        np.testing.assert_array_equal(getattr(g_state, name).numpy(),
                                      np.asarray(getattr(w_state, name)),
                                      err_msg=name)
    assert (got["labels"] >= 0).any()      # the frames form clusters


def test_stretch_scan_with_sinkhorn_kernel_switch(stretch_world):
    """sinkhorn_kernel=True changes no label and no track id."""
    _, v, port, frames = stretch_world
    switched = Track4D(npoint=NPOINT, k_max=K, sinkhorn_iters=ITERS,
                       exact_fps=True, mov_budget=BUDGET,
                       sinkhorn_kernel=True, device="cpu")
    switched.load_state_dict(port.state_dict(), strict=True)
    ft = to_tensors(FrameBatch(*frames), "cpu")
    _, a = make_scan_eval_step_cached(port)(init_state(1, K, device="cpu"), ft)
    _, b = make_scan_eval_step_cached(switched)(
        init_state(1, K, device="cpu"), ft)
    for key in ("labels", "track_id"):
        assert torch.equal(a[key], b[key]), key


# ---- the train stretch path in small: 256 points, 128 centers ----------

TB, TT = 2, 2


@pytest.fixture(scope="module")
def train_stretch_world():
    """(JAX stretch model, numpy variables, numpy frames (2, 2, ...)) at
    256 points: true FPS of 128 centers, compact DBSCAN over 64 points."""
    clips = [stack_frames(synthetic_clip(5 + s, TT, n_max=N, g_max=K,
                                         n_static=150, n_objects=4))
             for s in range(TB)]
    frames = JFrameBatch(*[np.stack([np.asarray(getattr(c, f))
                                     for c in clips])
                           for f in JFrameBatch._fields])
    frames = frames._replace(pc1=_snap(frames.pc1), pc2=_snap(frames.pc2),
                             pc1_comp=_snap(frames.pc1_comp))
    model = JTrack4D(npoint=NPOINT, k_max=K, sinkhorn_iters=ITERS,
                     exact_fps=True, mov_budget=BUDGET)
    f0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0, 0]), frames)
    return model, _variables(model, f0, K, seed=1), frames


def _stretch_port(variables):
    port = Track4D(npoint=NPOINT, k_max=K, sinkhorn_iters=ITERS,
                   exact_fps=True, mov_budget=BUDGET, device="cpu")
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return port


def _jstates():
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (TB,) + x.shape), jinit_state(K))


def _f64(tree):
    """Every float32 leaf of a numpy tree as a float64 jax array (inside
    jax.enable_x64)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x), jnp.float64)
        if np.asarray(x).dtype == np.float32 else jnp.asarray(x), tree)


def _jax_model(dtype):
    return JTrack4D(npoint=NPOINT, k_max=K, sinkhorn_iters=ITERS,
                    exact_fps=True, mov_budget=BUDGET, dtype=dtype)


def test_train_stretch_step_matches_jax(train_stretch_world):
    """One train step of the stretch model with N != npoint (FPS under no
    gradient, SA train kernels' plain versions over 128 centers of 256
    points, FP over 256 x 128, compact DBSCAN and the tracker detached)
    against the gradient of the JAX unfused train path.

    The yardstick is the JAX package computing in float64 (its modules
    take a dtype): loss items 1e-5 relative, every gradient leaf
    |g - g_jax64| <= 1e-4 |G_jax64| + 1e-6 in norm (G the whole gradient)
    and cosine >= 0.9999 for every leaf above 1e-4 |G|. Against the JAX
    package's own float32 run the classes of tests/test_torch_port_train.py
    hold for the loss items (1e-4 relative) and the BN running statistics
    after the step (1e-5), and the gradient leaves are held to 5e-3 |G|,
    not the 1e-3 of the 128-point step: on these inputs the JAX float32
    gradient is itself 3.1e-3 |G| from its float64 run (worst leaf
    fc_layer.mlp.dense_0.weight; the mse head's layer 1 sees 256 channels
    that are constant over a stream, so |mean| >> sigma in its batch norm,
    where JAX's E[x^2] - mean^2 loses digits), while the port's float32
    gradient is 6e-6 |G| from it."""
    model, v, frames = train_stretch_world
    fr = FrameBatch(*[np.ascontiguousarray(x[:, 0]) for x in frames])
    grad_fn = jax.jit(jax.grad(_make_loss_fn(model), has_aux=True))
    jgrads, (_, jitems, jstats) = grad_fn(
        v["params"], v["batch_stats"], _jstates(),
        jax.tree_util.tree_map(jnp.asarray, fr), False)
    with jax.enable_x64(True):
        g64, (_, items64, _) = jax.jit(jax.grad(
            _make_loss_fn(_jax_model(jnp.float64)), has_aux=True))(
            _f64(v["params"]), _f64(v["batch_stats"]),
            _f64(jax.tree_util.tree_map(np.asarray, _jstates())), _f64(fr),
            False)
        g64 = jax.tree_util.tree_map(np.asarray, g64)
        items64 = {k: np.asarray(x) for k, x in items64.items()}
    port = _stretch_port(v)
    ts = create_train_state(port, TrainConfig(), steps_per_epoch=10,
                            device="cpu")
    _, items = make_train_step(ts)(init_state(TB, K, device="cpu"),
                                   to_tensors(fr, "cpu"), False)
    for key, val in jitems.items():
        np.testing.assert_allclose(items[key].numpy(), np.asarray(val),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(items[key].numpy(), items64[key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    got = {n: p.grad.double() for n, p in port.named_parameters()}
    norm = torch.linalg.vector_norm
    for want, leaf_tol, cos_min in (
            (from_flax_variables({"params": g64}), 1e-4, 0.9999),
            (from_flax_variables({"params": jgrads}), 5e-3, 0.999)):
        want = {n: w.double() for n, w in want.items()}
        assert set(got) == set(want)
        total = float(norm(torch.cat([w.flatten() for w in want.values()])))
        assert total > 0
        for name, w in want.items():
            err = float(norm(got[name] - w))
            assert err <= leaf_tol * total + 1e-6, (name, err, total)
            if float(norm(w)) > 1e-4 * total:
                cos = float((got[name] * w).sum()) / float(
                    norm(got[name]) * norm(w))
                assert cos >= cos_min, (name, cos)
    stats = from_flax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, jstats)})
    sd = port.state_dict()
    for name, val in stats.items():
        np.testing.assert_allclose(sd[name].numpy(), val.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_train_stretch_scan_matches_jax(train_stretch_world):
    """make_scan_train_step over 2 streams x 2 frames (2 optimizer steps)
    against the JAX scan computing in float64 (see the test above: Adam's
    first update, about lr * sign(g), amplifies the JAX float32 gradient's
    own rounding to 2.5e-3 of the second frame's loss): per-frame loss
    items 1e-3 relative; the first frame's also against the JAX float32
    scan, 1e-4 relative."""
    model, v, frames = train_stretch_world
    cfg = TrainConfig()
    tx = jmake_optimizer(cfg, 10)

    def state0(cast):
        params = cast(v["params"])
        return JTrainState(params, cast(v["batch_stats"]), tx.init(params),
                           jnp.zeros((), jnp.int32))
    as32 = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    _, _, jitems = jscan_train(model, tx)(state0(as32), _jstates(),
                                          as32(frames), jnp.asarray(False))
    items32 = {k: np.asarray(x) for k, x in jitems.items()}
    with jax.enable_x64(True):
        # frame by frame: the scan's carry would have to keep one dtype,
        # and the tracker state mixes float32 descriptors into it
        step = jmake_train_step(_jax_model(jnp.float64), tx)
        jts, states, per_frame = state0(_f64), _f64(
            jax.tree_util.tree_map(np.asarray, _jstates())), []
        for t in range(TT):
            jts, states, it = step(jts, states, _f64(
                JFrameBatch(*[x[:, t] for x in frames])), False)
            per_frame.append({k: np.asarray(x) for k, x in it.items()})
        items64 = {k: np.stack([it[k] for it in per_frame])
                   for k in per_frame[0]}
    ts = create_train_state(_stretch_port(v), cfg, steps_per_epoch=10,
                            device="cpu")
    _, items = make_scan_train_step(ts)(
        init_state(TB, K, device="cpu"),
        to_tensors(FrameBatch(*frames), "cpu"), False)
    for key, val in items64.items():
        assert items[key].shape == (TT, TB)
        np.testing.assert_allclose(items[key].numpy(), val, rtol=1e-3,
                                   atol=1e-6, err_msg=key)
        np.testing.assert_allclose(items[key][0].numpy(), items32[key][0],
                                   rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_train_correlator_selects_through_the_tiled_knn(monkeypatch, dtype):
    """Above KNN_DENSE_LIMIT pairs the train correlator stage selects with
    the tiled kNN (on the card kernel B5, here its plain version, also for
    the float64 clouds of a CPU yardstick): the same indices, hence the
    same output and gradients bit for bit, as the dense selection."""
    rng = np.random.RandomState(60)
    b, n, c = 2, 96, 256
    q = torch.from_numpy(_snap(rng.randn(b, n, 3) * 4)).to(dtype)
    p = torch.from_numpy(_snap(rng.randn(b, n, 3) * 4)).to(dtype)
    mask = torch.from_numpy(rng.rand(b, n) < 0.8)

    def run():
        g = torch.Generator().manual_seed(0)
        leaves = [torch.randn(s, generator=g, dtype=dtype).requires_grad_(True)
                  for s in ((b, n, c), (b, n, c), (3, c), (c, c), (c,),
                            (3, 8), (8, 8), (8, c), (8,), (8,), (c,))]
        fp, aq, wd, w, bias, w0, w1, w2, b0, b1, b2 = leaves
        out, idx = knn_weight_aggregate_train_reference(
            q, p, fp, aq, mask, [w], [bias], [w0, w1, w2], [b0, b1, b2],
            w_dir=wd)
        out.square().sum().backward()
        return out.detach(), idx, [x.grad for x in leaves]
    dense = run()
    monkeypatch.setattr(neighborhood, "KNN_DENSE_LIMIT", 1000)
    tiled = run()
    assert torch.equal(dense[1], tiled[1])
    assert torch.equal(dense[0], tiled[0])
    for a, t in zip(dense[2], tiled[2]):
        assert torch.equal(a, t)


def test_entry_points_default_to_the_card():
    """No `device` means the CUDA device; where there is none the entry
    points raise and do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    from ratrack_tpu_torch.data import empty_frame
    from ratrack_tpu_torch.device import default_device
    for call in (default_device, lambda: Track4D(npoint=16, k_max=2),
                 lambda: init_state(1, 2),
                 lambda: to_tensors(empty_frame(8, 2))):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
