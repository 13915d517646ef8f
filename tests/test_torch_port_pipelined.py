"""CPU parity of the port's pipelined eval step, its stage methods and the
Sinkhorn early exit against the JAX package, and `fused_sa: false` on the
CPU.

Same setup as tests/test_torch_port_model.py: random numpy variables for
the JAX Track4D (N=128 points, k_max=8, 20 Sinkhorn iterations, full
channel widths) go to the port through utils/convert.py::
from_flax_variables; off the TPU the JAX model runs its unfused XLA path
and the port its kernels' plain versions; coordinates snapped to a 1/16
grid. The blocks are b = 2 streams x t = 5 frames: stream 0 starts a new
sequence at frame 3, stream 1 is padding throughout (every mask off).

Tolerances:
  - match_structure / assign_ids against JAX: ids and `matched` exact,
    conf 1e-6;
  - the Sinkhorn early exit against `jax.vmap` of the JAX function:
    1e-5 on the valid block and the dustbin;
  - frame_stage / gru_stage against the JAX methods: 1e-4 abs / rel;
  - the pipelined step against the port's sequential scan: labels, track
    ids, n, every integer and boolean output and the new state exact; cls,
    warp, flow, conf and aff within PIPE_TOL = 1e-6 (measured on the CPU:
    cls, warp, flow, conf and the state 0 apart; aff 9e-8, its MLP's
    products over B * T frames' rows rounding otherwise);
  - the pipelined step and the scans against the JAX scan: the forward
    tolerance 5e-4 for cls and warp, labels / track ids / n exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu.data.frames import FrameBatch as JFrameBatch
from ratrack_tpu.data.frames import empty_frame
from ratrack_tpu.data.synthetic import stack_frames, synthetic_clip
from ratrack_tpu.models import Track4D as JTrack4D
from ratrack_tpu.tracker import association as jassoc
from ratrack_tpu.tracker import init_state as jinit_state
from ratrack_tpu.tracker import sinkhorn as jsinkhorn
from ratrack_tpu.train.step import make_pipelined_eval_step as jpipelined
from ratrack_tpu.train.step import make_scan_eval_step as jscan
from ratrack_tpu_torch import config as tconfig
from ratrack_tpu_torch.data import FrameBatch, to_tensors
from ratrack_tpu_torch.models import Track4D, model_from_config
from ratrack_tpu_torch.ops import fused_sinkhorn
from ratrack_tpu_torch.tracker import (assign_ids, associate, init_state,
                                       log_optimal_transport_masked,
                                       match_structure)
from ratrack_tpu_torch.tracker import sinkhorn as tsinkhorn
from ratrack_tpu_torch.train import (make_eval_step,
                                     make_pipelined_eval_step,
                                     make_scan_eval_step)
from ratrack_tpu_torch.utils import from_flax_variables
from reference_impls import np_log_sinkhorn
from test_torch_port_model import _random_tree, _snap

N, K, ITERS, B, T = 128, 8, 20, 2, 5
NEW_SEQ_AT = 3            # stream 0 starts a new sequence at this frame
TOL = dict(atol=1e-4, rtol=1e-4)
FWD = dict(atol=5e-4, rtol=5e-4)
PIPE_TOL = dict(atol=1e-6, rtol=1e-6)
SINKHORN_TOL = dict(atol=1e-5, rtol=0)
EXIT_TOL = 1e-4           # the model's early exit in the scans below
INT_KEYS = ("labels", "track_id", "m", "n", "sizes", "prev_gt_id",
            "prev_valid", "curr_gt_id", "curr_valid")
FLOAT_KEYS = ("cls", "warp", "flow", "conf", "aff")


def _frames():
    """(B, T) numpy block: a synthetic clip with a new sequence at frame
    NEW_SEQ_AT, and a stream of padding frames."""
    clip = stack_frames(synthetic_clip(3, T, n_max=N, g_max=K, n_static=60,
                                       n_objects=3))
    new_seq = np.asarray(clip.new_seq).copy()
    new_seq[NEW_SEQ_AT] = True
    clip = clip._replace(new_seq=new_seq)
    pad = stack_frames([empty_frame(N, K)._replace(new_seq=np.asarray(t == 0))
                        for t in range(T)])
    frames = JFrameBatch(*[np.stack([np.asarray(getattr(c, f))
                                     for c in (clip, pad)])
                           for f in JFrameBatch._fields])
    return frames._replace(pc1=_snap(frames.pc1), pc2=_snap(frames.pc2),
                           pc1_comp=_snap(frames.pc1_comp))


@pytest.fixture(scope="module")
def world():
    """(numpy variables, numpy frames (B, T, ...), port tensors)."""
    frames = _frames()
    f0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0, 0]), frames)
    model = JTrack4D(npoint=N, k_max=K, sinkhorn_iters=ITERS)
    shapes = jax.eval_shape(
        lambda k: model.init(k, f0, jinit_state(K), train=False),
        jax.random.PRNGKey(0))
    variables = _random_tree(shapes, 0)
    return variables, frames, to_tensors(FrameBatch(*frames), "cpu")


def _port(variables, **kw):
    port = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu",
                   **kw)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return port


def _jstates():
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jinit_state(K))


@pytest.fixture(scope="module")
def jax_scans(world):
    """The JAX sequential scan over the block with tol 0 and EXIT_TOL."""
    variables, frames, _ = world
    jframes = jax.tree_util.tree_map(jnp.asarray, frames)
    return {tol: jscan(JTrack4D(npoint=N, k_max=K, sinkhorn_iters=ITERS,
                                sinkhorn_tol=tol))(variables, _jstates(),
                                                   jframes)
            for tol in (0.0, EXIT_TOL)}


def _per_frame(port, tensors):
    """Every output key of the per-frame step over the block, stacked to
    (B, T, ...), and the final state."""
    step = make_eval_step(port)
    state = init_state(B, K, device="cpu")
    outs = []
    for t in range(T):
        out, state = step(state, FrameBatch(*[x[:, t] for x in tensors]))
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs], dim=1)
                   for k in outs[0] if k != "feats"}


def _assert_states_equal(got, want):
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w.numpy(), **PIPE_TOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


# ---- Sinkhorn early exit ---------------------------------------------------

def _exit_batch():
    """Streams that stop at different iterations: score scales 0.05-4,
    m, n from 0 to K."""
    rng = np.random.RandomState(21)
    scale = np.array([0.05, 0.5, 1.0, 2.0, 4.0, 1.0, 3.0, 0.2], np.float32)
    aff = (rng.rand(8, K, K).astype(np.float32)
           * scale[:, None, None]).astype(np.float32)
    m = np.array([K, 3, 5, K, 2, 0, 7, 1], np.int32)
    n = np.array([K, 4, K, 6, 2, 3, 0, 1], np.int32)
    return aff, m, n


def _valid_block(z, m, n):
    rows = list(range(m)) + [K]
    cols = list(range(n)) + [K]
    return z[np.ix_(rows, cols)]


@pytest.mark.parametrize("safe_lse", [True, False])
@pytest.mark.parametrize("tol", [1e-3, 1e-5])
def test_early_exit_matches_vmapped_jax(safe_lse, tol):
    aff, m, n = _exit_batch()
    c, log_mu, log_nu, _ = tsinkhorn.transport_problem(
        torch.from_numpy(aff), torch.from_numpy(m), torch.from_numpy(n), 0.9)
    _, _, count = tsinkhorn.sinkhorn_uv_early_exit(c, log_mu, log_nu, 500,
                                                   tol, safe_lse=safe_lse)
    assert len(set(count.tolist())) >= 3        # streams stop apart
    got = log_optimal_transport_masked(
        torch.from_numpy(aff), torch.from_numpy(m), torch.from_numpy(n), 0.9,
        500, tol=tol, safe_lse=safe_lse).numpy()
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, mm, nn: jsinkhorn.log_optimal_transport_masked(
            a, mm, nn, jnp.float32(0.9), 500, tol=tol,
            safe_lse=safe_lse)))(aff, m, n))
    for b in range(len(m)):
        np.testing.assert_allclose(_valid_block(got[b], m[b], n[b]),
                                   _valid_block(want[b], m[b], n[b]),
                                   **SINKHORN_TOL, err_msg=f"stream {b}")
    # a stopped stream is frozen: its coupling equals the fixed-count loop
    # run for exactly its count
    for b in range(len(m)):
        one = [torch.from_numpy(x[b:b + 1]) for x in (aff, m, n)]
        fixed = log_optimal_transport_masked(*one, 0.9, int(count[b]),
                                             safe_lse=safe_lse)
        np.testing.assert_array_equal(got[b], fixed[0].numpy())


def test_sinkhorn_matches_numpy_reference():
    """tests/test_tracker.py::test_sinkhorn_matches_reference on the
    port, tol 0 and the early exit at 1e-7 (within the same 2e-3)."""
    rng = np.random.RandomState(0)
    m, n, k = 4, 3, 8
    padded = np.zeros((1, k, k), np.float32)
    padded[0, :m, :n] = rng.rand(m, n).astype(np.float32)
    want = np_log_sinkhorn(padded[0, :m, :n].astype(np.float64), 0.9, 200)
    for tol in (0.0, 1e-7):
        got = log_optimal_transport_masked(
            torch.from_numpy(padded), torch.tensor([m]), torch.tensor([n]),
            0.9, 200, tol=tol)[0].numpy()
        np.testing.assert_allclose(got[:m, :n], want[:m, :n], atol=2e-3)
        np.testing.assert_allclose(got[:m, k], want[:m, n], atol=2e-3)
        np.testing.assert_allclose(got[k, :n], want[m, :n], atol=2e-3)


def test_sinkhorn_early_exit_matches_full():
    """tests/test_tracker.py::test_sinkhorn_early_exit_matches_full on the
    port, and the port's early exit against the JAX one on that case."""
    rng = np.random.RandomState(1)
    m, n, k = 5, 4, 8
    padded = np.zeros((1, k, k), np.float32)
    padded[0, :m, :n] = rng.rand(m, n).astype(np.float32) * 2
    args = (torch.from_numpy(padded), torch.tensor([m]), torch.tensor([n]),
            0.9, 500)
    full = log_optimal_transport_masked(*args)[0].numpy()
    fast = log_optimal_transport_masked(*args, tol=1e-5)[0].numpy()
    np.testing.assert_allclose(fast[:m, :n], full[:m, :n], atol=1e-3)
    want = np.asarray(jsinkhorn.log_optimal_transport_masked(
        jnp.asarray(padded[0]), jnp.asarray(m), jnp.asarray(n),
        jnp.float32(0.9), 500, tol=1e-5))
    np.testing.assert_allclose(_valid_block(fast, m, n),
                               _valid_block(want, m, n), **SINKHORN_TOL)


def test_kernel_switch_with_tol_zero_calls_b7(monkeypatch):
    """tests/test_tracker.py::test_sinkhorn_fused_kernel_matches_xla_loop:
    with tol 0 the switch calls B7's wrapper (on the CPU its plain version,
    equal to the loop), which counts no launch on the CPU."""
    calls = []

    def spy(*a, **kw):
        calls.append(a[-1])
        return fused_sinkhorn.sinkhorn_uv(*a, **kw)
    monkeypatch.setattr(tsinkhorn, "sinkhorn_uv", spy)
    aff, m, n = [torch.from_numpy(x) for x in _exit_batch()]
    before = fused_sinkhorn.sinkhorn_uv.launches
    loop = log_optimal_transport_masked(aff, m, n, 0.9, 500, safe_lse=False)
    fused = log_optimal_transport_masked(aff, m, n, 0.9, 500, safe_lse=False,
                                         use_fused_kernel=True)
    assert calls == [500] and torch.equal(fused, loop)
    assert fused_sinkhorn.sinkhorn_uv.launches == before == 0


def test_kernel_switch_with_tol_raises():
    """B7 has no early exit: asking for it with tol > 0 raises at every
    level (the transport, the association, the model, the config) rather
    than run the eager loop in its place."""
    aff, m, n = [torch.from_numpy(x) for x in _exit_batch()]
    with pytest.raises(ValueError, match="early exit"):
        log_optimal_transport_masked(aff, m, n, 0.9, 500, tol=1e-4,
                                     safe_lse=False, use_fused_kernel=True)
    with pytest.raises(ValueError, match="early exit"):
        associate(aff, m, n, torch.zeros(8, K, dtype=torch.int32),
                  torch.zeros(8, dtype=torch.int32), 0.9, 500,
                  use_fused_kernel=True, sinkhorn_tol=1e-4)
    with pytest.raises(ValueError, match="early exit"):
        Track4D(npoint=N, k_max=K, sinkhorn_tol=1e-4, sinkhorn_kernel=True,
                device="cpu")
    cfg = tconfig.Config(npoints=N, k_max=K, sinkhorn_tol=1e-4)
    with pytest.raises(ValueError, match="early exit"):
        model_from_config(cfg, sinkhorn_kernel=True, device="cpu")
    assert fused_sinkhorn.sinkhorn_uv.launches == 0


# ---- match_structure, assign_ids, associate -------------------------------

def _all_counts(seed):
    """Every (m, n) in 0..K x 0..K, random affinities and previous ids."""
    rng = np.random.RandomState(seed)
    mm, nn = np.meshgrid(np.arange(K + 1), np.arange(K + 1), indexing="ij")
    m, n = mm.ravel().astype(np.int32), nn.ravel().astype(np.int32)
    s = len(m)
    aff = rng.rand(s, K, K).astype(np.float32)
    prev = rng.randint(0, 100, (s, K)).astype(np.int32)
    next_id = rng.randint(100, 200, (s,)).astype(np.int32)
    return aff, m, n, prev, next_id


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_match_structure_and_assign_ids_match_jax(tol):
    aff, m, n, prev, next_id = _all_counts(5)
    ms = match_structure(torch.from_numpy(aff), torch.from_numpy(m),
                         torch.from_numpy(n), 0.9, 100, tol)
    res = assign_ids(ms, torch.from_numpy(prev), torch.from_numpy(next_id),
                     torch.from_numpy(aff), 0.01)

    def jax_one(a, mm, nn, p, ni):
        s = jassoc.match_structure(a, mm, nn, jnp.float32(0.9), 100, tol)
        return s, jassoc.assign_ids(s, p, ni, a, 0.01)
    jms, jres = jax.jit(jax.vmap(jax_one))(aff, m, n, prev, next_id)
    col_ok = np.asarray(jms.col_ok)
    np.testing.assert_array_equal(ms.col_ok.numpy(), col_ok)
    np.testing.assert_array_equal(ms.matched.numpy(), np.asarray(jms.matched))
    # idx1 and conf of a slot past n are argmax over an all-masked column:
    # both packages take row 0, compared all the same
    np.testing.assert_array_equal(ms.idx1.numpy(), np.asarray(jms.idx1))
    np.testing.assert_allclose(ms.conf.numpy(), np.asarray(jms.conf),
                               atol=1e-6, rtol=0)
    for name in ("track_id", "matched_prev", "next_id"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    np.testing.assert_allclose(res.conf.numpy(), np.asarray(jres.conf),
                               atol=1e-6, rtol=0)
    assert ms.matched.any() and (~ms.matched & ms.col_ok).any()


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_associate_is_assign_ids_of_match_structure(tol):
    aff, m, n, prev, next_id = [torch.from_numpy(x) for x in _all_counts(6)]
    res = associate(aff, m, n, prev, next_id, 0.9, 100, 0.01,
                    sinkhorn_tol=tol)
    want = assign_ids(match_structure(aff, m, n, 0.9, 100, tol), prev,
                      next_id, aff, 0.01)
    for name in res._fields:
        assert torch.equal(getattr(res, name), getattr(want, name)), name


# ---- stage methods --------------------------------------------------------

def test_frame_stage_matches_jax(world):
    variables, frames, tensors = world
    port = _port(variables)
    t = 1
    fr = FrameBatch(*[x[:, t] for x in tensors])
    with torch.inference_mode():
        cls, prop, gin = port.frame_stage(fr)
    jmodel = JTrack4D(npoint=N, k_max=K, sinkhorn_iters=ITERS)
    jfr = jax.tree_util.tree_map(lambda x: jnp.asarray(x[:, t]), frames)
    want = jax.jit(jax.vmap(lambda f: jmodel.apply(
        variables, f, train=False, method=JTrack4D.frame_stage)))(jfr)
    for got, w in zip((cls, prop, gin), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
    assert torch.equal(gin[1], torch.zeros_like(gin[1]))   # padding stream


def test_gru_stage_matches_jax(world):
    variables, _, _ = world
    port = _port(variables)
    rng = np.random.RandomState(4)
    gin = rng.randn(B, 128).astype(np.float32)
    h = rng.randn(B, 5, 128).astype(np.float32)
    with torch.inference_mode():
        gout, h_new = port.gru_stage(torch.from_numpy(gin),
                                     torch.from_numpy(h))
    jmodel = JTrack4D(npoint=N, k_max=K, sinkhorn_iters=ITERS)
    wout, wh = jax.vmap(lambda g, hh: jmodel.apply(
        variables, g, hh, method=JTrack4D.gru_stage))(gin, h)
    np.testing.assert_allclose(gout.numpy(), np.asarray(wout), **TOL)
    np.testing.assert_allclose(h_new.numpy(), np.asarray(wh), **TOL)


# ---- the pipelined step ---------------------------------------------------

@pytest.mark.parametrize("tol", [0.0, EXIT_TOL], ids=["tol0", "exit"])
def test_pipelined_step_matches_the_sequential_step(world, tol):
    """Every output key and the new state against the per-frame step of
    the same port model, in one block of 5 frames and in blocks of 2 + 3
    (the second entered from the first's state)."""
    variables, _, tensors = world
    port = _port(variables, sinkhorn_tol=tol)
    want_state, want = _per_frame(port, tensors)
    step = make_pipelined_eval_step(port)
    state, got = step(init_state(B, K, device="cpu"), tensors)
    assert set(got) == set(want)
    split = 2
    s1, first = step(init_state(B, K, device="cpu"),
                     FrameBatch(*[x[:, :split] for x in tensors]))
    s2, second = step(s1, FrameBatch(*[x[:, split:] for x in tensors]))
    for out in (got, {k: torch.cat([first[k], second[k]], dim=1)
                      for k in first}):
        for key in INT_KEYS:
            assert torch.equal(out[key], want[key]), key
        for key in FLOAT_KEYS:
            np.testing.assert_allclose(out[key].numpy(), want[key].numpy(),
                                       **PIPE_TOL, err_msg=key)
    _assert_states_equal(state, want_state)
    _assert_states_equal(s2, want_state)
    # the block holds live tracks, a reset and a padding stream
    assert (got["track_id"][0] >= 0).any() and (got["m"][0] > 0).any()
    assert got["m"][0, NEW_SEQ_AT] == 0 and not got["curr_valid"][1].any()
    assert (state.frame_idx.tolist()
            == [T - NEW_SEQ_AT, T])


def test_pipelined_step_matches_the_ports_scan(world):
    variables, _, tensors = world
    port = _port(variables)
    w_state, want = make_scan_eval_step(port)(init_state(B, K, device="cpu"),
                                              tensors)
    g_state, got = make_pipelined_eval_step(port)(
        init_state(B, K, device="cpu"), tensors)
    for key in ("labels", "track_id", "n"):
        assert torch.equal(got[key], want[key]), key
    for key in ("cls", "warp", "conf"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   **PIPE_TOL, err_msg=key)
    _assert_states_equal(g_state, w_state)


@pytest.mark.parametrize("tol", [0.0, EXIT_TOL], ids=["tol0", "exit"])
def test_pipelined_step_and_scan_match_the_jax_scan(world, jax_scans, tol):
    variables, frames, tensors = world
    w_state, want = jax_scans[tol]
    port = _port(variables, sinkhorn_tol=tol)
    for g_state, got in (
            make_pipelined_eval_step(port)(init_state(B, K, device="cpu"),
                                           tensors),
            make_scan_eval_step(port)(init_state(B, K, device="cpu"),
                                      tensors)):
        for key in ("cls", "warp"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), **FWD)
        for key in ("labels", "track_id", "n"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
        np.testing.assert_allclose(got["conf"].numpy(),
                                   np.asarray(want["conf"]), **TOL)
        for name in ("track_id", "next_id", "frame_idx", "gt_id", "valid"):
            np.testing.assert_array_equal(
                getattr(g_state, name).numpy(),
                np.asarray(getattr(w_state, name)), err_msg=name)


def test_pipelined_step_matches_the_jax_pipelined_step(world):
    variables, frames, tensors = world
    jframes = jax.tree_util.tree_map(jnp.asarray, frames)
    w_state, want = jpipelined(JTrack4D(npoint=N, k_max=K,
                                        sinkhorn_iters=ITERS))(
        variables, _jstates(), jframes)
    g_state, got = make_pipelined_eval_step(_port(variables))(
        init_state(B, K, device="cpu"), tensors)
    assert set(got) == set(want)
    for key in INT_KEYS:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("cls", "warp", "flow"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **FWD, err_msg=key)
    for key in ("conf", "aff"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL, err_msg=key)
    for name in g_state._fields:
        np.testing.assert_allclose(getattr(g_state, name).numpy(),
                                   np.asarray(getattr(w_state, name)),
                                   **TOL, err_msg=name)


def test_pipelined_step_is_eval_only(world):
    variables, _, tensors = world
    port = _port(variables)
    port.train()
    with pytest.raises(RuntimeError, match="eval only"):
        make_pipelined_eval_step(port)(init_state(B, K, device="cpu"),
                                       tensors)


# ---- model_from_config: sinkhorn_tol and fused_sa --------------------------

def test_fused_sa_false_runs_the_plain_path_of_the_cpu(world):
    """On the CPU both settings of `fused_sa` run the plain versions: the
    scans are equal (tests/test_torch_port_serve.py checks that the card
    refuses `fused_sa: false`)."""
    variables, _, tensors = world
    cfg = tconfig.Config(npoints=N, k_max=K, sinkhorn_iters=ITERS)
    outs = []
    for fused in (True, False):
        model = model_from_config(cfg.replace(fused_sa=fused), device="cpu")
        model.load_state_dict(from_flax_variables(variables), strict=True)
        outs.append(make_scan_eval_step(model)(
            init_state(B, K, device="cpu"), tensors)[1])
    for key in outs[0]:
        assert torch.equal(outs[0][key], outs[1][key]), key


def test_sinkhorn_tol_reaches_the_association(world, monkeypatch):
    cfg = tconfig.Config(npoints=N, k_max=K, sinkhorn_iters=ITERS,
                         sinkhorn_tol=1e-3)
    model = model_from_config(cfg, device="cpu")
    assert model.sinkhorn_tol == 1e-3
    seen = []
    real = tsinkhorn.sinkhorn_uv_early_exit

    def spy(c, log_mu, log_nu, iters, tol, **kw):
        seen.append((iters, tol))
        return real(c, log_mu, log_nu, iters, tol, **kw)
    monkeypatch.setattr(tsinkhorn, "sinkhorn_uv_early_exit", spy)
    _, _, tensors = world
    make_scan_eval_step(model)(init_state(B, K, device="cpu"),
                               FrameBatch(*[x[:, :2] for x in tensors]))
    assert seen == [(ITERS, 1e-3)] * 2
