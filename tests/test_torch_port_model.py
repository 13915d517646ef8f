"""CPU parity: the port's modules, tracker and cached eval scan against the
JAX package, on one set of numpy inputs and one set of weights.

One set of random variables for the JAX Track4D (N=128 points, k_max=8,
20 Sinkhorn iterations, full channel widths; BN statistics, BN scales and
biases random too) goes to the port through
utils/convert.py::from_flax_variables. Off the TPU the JAX model runs its
unfused XLA path; the port runs its kernels' plain versions. Point
coordinates are snapped to a 1/16 grid so every distance is exact in both
packages (see tests/test_torch_port_ops.py).

Tolerances: modules 1e-4 abs/rel; cls and flow 5e-4 (the class
tests/test_full_forward_parity.py pins for the full forward); labels,
track ids and indices exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu.data.frames import FrameBatch as JFrameBatch
from ratrack_tpu.data.synthetic import stack_frames, synthetic_clip
from ratrack_tpu.models import Track4D as JTrack4D
from ratrack_tpu.models.affinity import Affinity as JAffinity
from ratrack_tpu.models.correlator import FeatureCorrelator as JCorrelator
from ratrack_tpu.models.decoder import FlowDecoder as JFlowDecoder
from ratrack_tpu.models.pnhead import PNHead as JPNHead
from ratrack_tpu.models.pnhead import SetAbstractionMSG as JSetAbstractionMSG
from ratrack_tpu.ops import pallas_sa
from ratrack_tpu.tracker import association as jassoc
from ratrack_tpu.tracker import dbscan as jdbscan
from ratrack_tpu.tracker import init_state as jinit_state
from ratrack_tpu.tracker import sinkhorn as jsinkhorn
from ratrack_tpu.train.step import make_scan_eval_step_cached as jscan
from ratrack_tpu.utils.convert import (convert_reference_state_dict,
                                       export_reference_state_dict)
from ratrack_tpu_torch.data import FrameBatch, to_tensors
from ratrack_tpu_torch.kernels.cases import GENERAL_LEVELS
from ratrack_tpu_torch.models import SetAbstractionMSG, Track4D
from ratrack_tpu_torch.tracker import (associate, cluster_descriptors,
                                       dbscan, greedy_gt_match, init_state,
                                       log_optimal_transport_masked,
                                       reset_where)
from ratrack_tpu_torch.train import chain_contiguous, make_scan_eval_step_cached
from ratrack_tpu_torch.utils import from_flax_variables

N, K, ITERS, B, T = 128, 8, 20, 2, 3
TOL = dict(atol=1e-4, rtol=1e-4)
FWD = dict(atol=5e-4, rtol=5e-4)


def _snap(x):
    return (np.round(np.asarray(x, np.float32) * 16.0) / 16.0).astype(
        np.float32)


def _variables(model, frame, seed=0):
    """Random numpy variables for the JAX model's tree (traced with
    eval_shape, so no init compile): Dense kernels N(0, 1/fan_in), biases
    and BN means N(0, 0.1^2), BN scales and variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(
        lambda k: model.init(k, frame, jinit_state(K), train=False),
        jax.random.PRNGKey(seed))
    return _random_tree(shapes, seed)


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
        else:                                   # bin_score
            x = np.ones(sd.shape)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def world():
    """(JAX model, numpy variables, port model, numpy frames (B, T, ...))."""
    clips = [stack_frames(synthetic_clip(s, T, n_max=N, g_max=K,
                                         n_static=60, n_objects=3))
             for s in range(B)]
    frames = JFrameBatch(*[np.stack([getattr(c, f) for c in clips])
                           for f in JFrameBatch._fields])
    frames = frames._replace(pc1=_snap(frames.pc1), pc2=_snap(frames.pc2),
                             pc1_comp=_snap(frames.pc1_comp))
    assert np.abs(frames.pc1).max() < 128
    model = JTrack4D(npoint=N, k_max=K, sinkhorn_iters=ITERS)
    f0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0, 0]), frames)
    variables = _variables(model, f0)
    port = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu")
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return model, variables, port, frames


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        tree = variables.get(col, {})
        for p in path:
            tree = tree.get(p, {})
        if tree:
            out[col] = tree
    return out


def _frame_t(frames, t):
    return FrameBatch(*[np.ascontiguousarray(x[:, t]) for x in frames])


def _feats(seed, c=256):
    return np.random.RandomState(seed).randn(B, N, c).astype(np.float32)


def test_pnhead_matches_jax(world):
    _, v, port, frames = world
    fr = _frame_t(frames, 0)
    head = JPNHead(N)
    fn = jax.jit(jax.vmap(lambda x, f, m: head.apply(
        _sub(v, "pn_head"), x, f, m, False)))
    want_xyz, want = fn(fr.pc1, fr.ft1, fr.mask1)
    ft = to_tensors(fr, "cpu")
    got_xyz, got = port.pn_head(ft.pc1, ft.ft1, ft.mask1)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_correlator_matches_jax(world):
    _, v, port, frames = world
    fr = _frame_t(frames, 1)
    f1, f2 = _feats(2), _feats(3)
    mod = JCorrelator(16, (256, 256, 256), jnp.float32)
    fn = jax.jit(jax.vmap(lambda a, b, c, d, m1, m2: mod.apply(
        _sub(v, "fc_layer"), a, b, c, d, m1, m2, train=False)))
    want = np.asarray(fn(fr.pc1, fr.pc2, f1, f2, fr.mask1, fr.mask2))
    ft = to_tensors(fr, "cpu")
    got = port.fc_layer(ft.pc1, ft.pc2, torch.from_numpy(f1),
                        torch.from_numpy(f2), ft.mask1, ft.mask2).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


def test_decoder_stages_match_jax(world):
    _, v, port, frames = world
    fr = _frame_t(frames, 2)
    f1, cor = _feats(4), _feats(5)
    h = np.random.RandomState(6).randn(B, 5, 128).astype(np.float32)
    dec = JFlowDecoder(N)
    sub = _sub(v, "fd_layer")
    pre = jax.jit(jax.vmap(lambda p, f, a, c, m: dec.apply(
        sub, p, f, a, c, m, False, method=JFlowDecoder.pre_gru)))
    cls, prop, gin = pre(fr.pc1, fr.ft1, f1, cor, fr.mask1)
    gout, h_new = jax.vmap(lambda g, hh: dec.apply(
        sub, g, hh, method=JFlowDecoder.gru_apply))(gin, h)
    flow = jax.vmap(lambda p, g, m: dec.apply(
        sub, p, g, m, False, method=JFlowDecoder.post_gru))(
        prop, gout, fr.mask1)
    ft = to_tensors(fr, "cpu")
    t_cls, t_prop, t_gin = port.fd_layer.pre_gru(
        ft.pc1, ft.ft1, torch.from_numpy(f1), torch.from_numpy(cor), ft.mask1)
    t_gout, t_h = port.fd_layer.gru_apply(t_gin, torch.from_numpy(h))
    t_flow = port.fd_layer.post_gru(t_prop, t_gout)
    for got, want in ((t_cls, cls), (t_prop, prop), (t_gin, gin),
                      (t_gout, gout), (t_h, h_new), (t_flow, flow)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_affinity_matches_jax(world):
    _, v, port, _ = world
    diff = np.random.RandomState(7).randn(B, K, K, 141).astype(np.float32)
    want = JAffinity(141).apply(_sub(v, "affinity"), jnp.asarray(diff))
    np.testing.assert_allclose(port.affinity(torch.from_numpy(diff)).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_dbscan_matches_jax(seed):
    rng = np.random.RandomState(seed)
    x = np.concatenate([c + 0.4 * rng.randn(B, 12, 8)
                        for c in rng.uniform(-10, 10, (4, 1, 1, 8))]
                       + [rng.uniform(-20, 20, (B, N - 48, 8))],
                       axis=1).astype(np.float32)
    mask = rng.rand(B, N) > 0.2
    got = dbscan(torch.from_numpy(x), torch.from_numpy(mask), 1.5, 2, 64)
    for b in range(B):
        want = jdbscan(jnp.asarray(x[b]), jnp.asarray(mask[b]), 1.5, 2, 64)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def _assoc_inputs(seed):
    rng = np.random.RandomState(seed)
    aff = rng.rand(B, K, K).astype(np.float32)
    m = np.array([K - 2, 3], np.int32)
    n = np.array([K - 1, 5], np.int32)
    prev_ids = rng.randint(0, 50, (B, K)).astype(np.int32)
    next_id = np.array([50, 60], np.int32)
    return aff, m, n, prev_ids, next_id


def test_sinkhorn_matches_jax():
    aff, m, n, _, _ = _assoc_inputs(8)
    got = log_optimal_transport_masked(
        torch.from_numpy(aff), torch.from_numpy(m), torch.from_numpy(n), 0.9,
        500, safe_lse=False).numpy()
    for b in range(B):
        want = np.asarray(jsinkhorn.log_optimal_transport_masked(
            jnp.asarray(aff[b]), jnp.asarray(m[b]), jnp.asarray(n[b]),
            jnp.float32(0.9), 500, safe_lse=False))
        mb, nb = m[b], n[b]
        rows = list(range(mb)) + [K]
        cols = list(range(nb)) + [K]
        np.testing.assert_allclose(got[b][np.ix_(rows, cols)],
                                   want[np.ix_(rows, cols)], **TOL)


@pytest.mark.parametrize("seed", [9, 10])
def test_associate_matches_jax(seed):
    aff, m, n, prev_ids, next_id = _assoc_inputs(seed)
    res = associate(*[torch.from_numpy(a) for a in
                      (aff, m, n, prev_ids, next_id)], 0.9, 500, 0.01)
    for b in range(B):
        want = jassoc.associate(jnp.asarray(aff[b]), jnp.asarray(m[b]),
                                jnp.asarray(n[b]), jnp.asarray(prev_ids[b]),
                                jnp.asarray(next_id[b]), jnp.float32(0.9),
                                500, 0.01)
        np.testing.assert_array_equal(res.track_id[b].numpy(),
                                      np.asarray(want.track_id))
        np.testing.assert_array_equal(res.matched_prev[b].numpy(),
                                      np.asarray(want.matched_prev))
        assert int(res.next_id[b]) == int(want.next_id)
        np.testing.assert_allclose(res.conf[b].numpy(),
                                   np.asarray(want.conf), **TOL)


def test_descriptors_and_gt_match_match_jax():
    rng = np.random.RandomState(11)
    feats = rng.randn(B, N, 139).astype(np.float32)
    labels = rng.randint(-1, K, (B, N)).astype(np.int32)
    labels[1] = np.where(labels[1] >= 3, -1, labels[1])   # empty slots
    gt_dense = rng.randint(-1, 5, (B, N)).astype(np.int32)
    gt_ids = np.tile(100 + np.arange(K, dtype=np.int32), (B, 1))
    gt_valid = np.tile(np.arange(K) < 5, (B, 1))
    frame_idx = np.array([0, 7], np.int32)
    desc, valid, sizes, _ = cluster_descriptors(torch.from_numpy(feats),
                                                torch.from_numpy(labels), K)
    gt = greedy_gt_match(*[torch.from_numpy(a) for a in
                           (labels, gt_dense, gt_ids, gt_valid)], K,
                         torch.from_numpy(frame_idx))
    for b in range(B):
        jd, jv, js, _ = jassoc.cluster_descriptors(
            jnp.asarray(feats[b]), jnp.asarray(labels[b]), K)
        np.testing.assert_allclose(desc[b].numpy(), np.asarray(jd), **TOL)
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(sizes[b].numpy(), np.asarray(js))
        jg = jassoc.greedy_gt_match(
            jnp.asarray(labels[b]), jnp.asarray(gt_dense[b]),
            jnp.asarray(gt_ids[b]), jnp.asarray(gt_valid[b]), K,
            jnp.asarray(frame_idx[b]))
        np.testing.assert_array_equal(gt[b].numpy(), np.asarray(jg))


def test_reset_where_keeps_next_id():
    state = init_state(B, K, device="cpu")._replace(
        next_id=torch.tensor([5, 9], dtype=torch.int32),
        frame_idx=torch.tensor([3, 4], dtype=torch.int32),
        track_id=torch.ones((B, K), dtype=torch.int32))
    out = reset_where(torch.tensor([True, False]), state, init_state(B, K, device="cpu"))
    assert out.next_id.tolist() == [5, 9]
    assert out.frame_idx.tolist() == [0, 4]
    assert out.track_id[0].tolist() == [-1] * K
    assert out.track_id[1].tolist() == [1] * K


@pytest.fixture(scope="module")
def jax_scan(world):
    """The JAX cached eval scan over the (B, T) block: (final state, outs).
    Its frame 0 is the JAX per-frame step (the JAX suite pins the cached
    scan bit-exact to Track4D.__call__ per frame)."""
    model, v, _, frames = world
    ts = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jinit_state(K))
    return jscan(model)(v, ts, jax.tree_util.tree_map(jnp.asarray, frames))


def test_track4d_step_matches_jax(world, jax_scan):
    _, _, port, frames = world
    _, want = jax_scan
    fr = _frame_t(frames, 0)
    with torch.inference_mode():
        got, _ = port(to_tensors(fr, "cpu"), init_state(B, K, device="cpu"))
    np.testing.assert_allclose(got["cls"].numpy(),
                               np.asarray(want["cls"][:, 0]), **FWD)
    np.testing.assert_allclose(got["flow"].numpy(),
                               np.asarray(want["warp"][:, 0]) - fr.pc1, **FWD)
    for key in ("labels", "track_id", "n"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key][:, 0]),
                                      err_msg=key)
    assert (got["labels"] >= 0).any()      # the frame forms clusters


def test_cached_scan_matches_jax(world, jax_scan):
    _, _, port, frames = world
    w_state, want = jax_scan
    g_state, got = make_scan_eval_step_cached(port)(
        init_state(B, K, device="cpu"), to_tensors(FrameBatch(*frames), "cpu"))
    for key in ("cls", "warp"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **FWD)
    for key in ("labels", "track_id", "n"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(want["conf"]),
                               **TOL)
    for name in ("track_id", "next_id", "frame_idx", "gt_id", "valid"):
        np.testing.assert_array_equal(getattr(g_state, name).numpy(),
                                      np.asarray(getattr(w_state, name)),
                                      err_msg=name)


def test_chain_contiguous_gate():
    assert chain_contiguous([5, 6, 7], [True, False, False])
    assert chain_contiguous([9], [False])
    assert not chain_contiguous([5, 6, 8], [False, False, False])
    assert not chain_contiguous([5, 6, 7], [False, True, False])


def test_reference_checkpoint_loads_through_jax_converter(world):
    """A reference (torch RaTrack) state_dict reaches the port by the JAX
    package's converter then from_flax_variables, unchanged."""
    _, v, port, _ = world
    ref_sd = export_reference_state_dict(v)
    flax_vars, _ = convert_reference_state_dict(ref_sd)
    sd = from_flax_variables(jax.tree_util.tree_map(np.asarray, flax_vars))
    want = port.state_dict()
    assert set(sd) == set(want)
    for key, val in want.items():
        np.testing.assert_array_equal(sd[key].numpy(), val.numpy(),
                                      err_msg=key)


# ---- the general SA level: any number of scales, any depths <= 3 ---------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("level", sorted(GENERAL_LEVELS))
def test_general_sa_level_matches_jax(world, level, fused, train,
                                      monkeypatch):
    """SetAbstractionMSG with 1 scale, 3 scales and 2 scales of depths 2
    and 3, module against module on the same flax variables, over a masked
    cloud of 2 streams. The JAX side runs once unfused (query_and_group +
    PointwiseMLP) and once through its Pallas kernels in interpret mode
    (pallas_sa.FORCE_FUSED_ON_CPU; one stream then, the kernels are slow
    there).
    Eval: 1e-4, against both. Train against the unfused path: output and
    the running statistics after the call 1e-5 x max (the mean over streams
    of the per-stream updates), gradients to the features and every
    parameter 1e-4 x max|g_jax|; against the fused train kernels, whose
    bf16 passes set the class tests/test_pallas_sa_train.py pins: output
    and statistics 3% of max, the whole gradient's cosine >= 0.99, and
    every gradient leaf no further (in norm) from the fused kernels' than
    the JAX unfused path's own leaf is, plus 1e-4 of that leaf's norm."""
    monkeypatch.setattr(pallas_sa, "FORCE_FUSED_ON_CPU", fused)
    _, _, _, frames = world
    radii, nsamples, mlps, c = GENERAL_LEVELS[level]
    nb = 1 if fused else B
    rng = np.random.RandomState(50)
    xyz, mask = frames.pc1[:nb, 0], frames.mask1[:nb, 0]
    feats = rng.randn(nb, N, c).astype(np.float32)
    cot = rng.randn(nb, N, sum(m[-1] for m in mlps)).astype(np.float32)
    jmod = JSetAbstractionMSG(N, radii, nsamples, mlps)
    v = _random_tree(jax.eval_shape(
        lambda k: jmod.init(k, xyz[0], feats[0], mask[0], False),
        jax.random.PRNGKey(0)), 51)
    port = SetAbstractionMSG(N, radii, nsamples, mlps, 3 + c)
    port.load_state_dict(from_flax_variables(v), strict=True)
    assert [n for n, _ in port.named_children()] == [
        f"mlp_{i}" for i in range(len(radii))]

    if not train:
        want_xyz, want = jax.vmap(lambda x, f, m: jmod.apply(
            v, x, f, m, False))(xyz, feats, mask)
        port.eval()
        with torch.no_grad():
            got_xyz, got = port(torch.from_numpy(xyz),
                                torch.from_numpy(feats),
                                torch.from_numpy(mask))
        np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return

    def loss(params, f):
        def one(x, fb, mb, cb):
            (_, out), mut = jmod.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x, fb,
                mb, True, mutable=["batch_stats"])
            return jnp.sum(out * cb), (out, mut["batch_stats"])
        each, aux = jax.vmap(one)(xyz, f, mask, cot)
        return jnp.sum(each), aux
    grad_fn = jax.grad(loss, argnums=(0, 1), has_aux=True)
    (jg_params, jg_feats), (want, jstats) = grad_fn(v["params"], feats)
    if fused:     # the JAX package's own distance between its two paths
        monkeypatch.setattr(pallas_sa, "FORCE_FUSED_ON_CPU", False)
        (ug_params, ug_feats), _ = grad_fn(v["params"], feats)
        unfused = {"features": np.asarray(ug_feats), **{
            n: w.numpy() for n, w in from_flax_variables(
                {"params": ug_params}).items()}}

    port.train()
    f_t = torch.from_numpy(feats).requires_grad_(True)
    _, got = port(torch.from_numpy(xyz), f_t, torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    want_stats = from_flax_variables({"batch_stats": jax.tree_util.tree_map(
        lambda a: np.asarray(a).mean(0), jstats)})
    want_grads = from_flax_variables({"params": jg_params})
    got_grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(got_grads) == set(want_grads)
    pairs = [("features", f_t.grad.numpy(), np.asarray(jg_feats))] + [
        (n, got_grads[n].numpy(), w.numpy()) for n, w in want_grads.items()]
    outs = [("out", got.detach().numpy(), np.asarray(want))] + [
        (n, port.state_dict()[n].numpy(), w.numpy())
        for n, w in want_stats.items()]
    for name, a, b in outs:
        tol = (0.03 if fused else 1e-5) * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max(), tol)
    if fused:
        a = np.concatenate([a.ravel() for _, a, _ in pairs])
        b = np.concatenate([b.ravel() for _, _, b in pairs])
        cos = float(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.99, cos
    for name, a, b in pairs:
        if fused:
            u = unfused[name]
            assert np.linalg.norm(a - b) <= (
                np.linalg.norm(u - b) + 1e-4 * np.linalg.norm(u)), name
        else:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max(),
                                       err_msg=name)
