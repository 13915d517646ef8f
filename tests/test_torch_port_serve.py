"""CPU parity and behaviour of the port's serving entry point and config.

`ratrack_tpu_torch.serve.RadarTracker` runs the cases of tests/test_serve.py
(which pins the JAX service) on the port, with the port's model on the CPU
(plain versions of the kernels), and the same script of scans goes through
both services with the same weights (`from_flax_variables`): labels, point
track ids and track ids exact, flow and conf within 5e-4 (the forward class
of tests/test_torch_port_model.py). Scan coordinates are snapped to a 1/16
grid so that every distance is exact in both packages. Small sizes: 128
points, 8 track slots, 20 Sinkhorn iterations, full channel widths.

`ratrack_tpu_torch.config` must equal `ratrack_tpu.config` field for field
on every configs/*.yaml, and `model_from_config` must honour
`sinkhorn_tol` and raise on what the port does not implement (a dtype
other than float32, `fused_sa: false` on the card).
"""

import dataclasses
import glob
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu import config as jconfig
from ratrack_tpu.data.synthetic import stack_frames, synthetic_clip
from ratrack_tpu.models import Track4D as JTrack4D
from ratrack_tpu.serve import RadarTracker as JRadarTracker
from ratrack_tpu.tracker import init_state as jinit_state
from ratrack_tpu_torch import config as tconfig
from ratrack_tpu_torch.data import FrameBatch, to_tensors
from ratrack_tpu_torch.models import Track4D, model_from_config
from ratrack_tpu_torch.serve import RadarTracker, TrackOutput
from ratrack_tpu_torch.tracker import init_state
from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                     make_eval_step, make_scan_eval_step,
                                     make_scan_eval_step_cached,
                                     save_train_state)
from ratrack_tpu_torch.utils import from_flax_variables

N, K, T, ITERS = 128, 8, 5, 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _snap(x):
    return (np.round(np.asarray(x, np.float32) * 16.0) / 16.0).astype(
        np.float32)


def _random_tree(shapes, seed):
    """numpy leaves for a flax variable tree (as tests/test_torch_port_
    train.py): Dense kernels N(0, 1/fan_in), biases and BN means
    N(0, 0.1^2), BN scales and variances U(0.5, 1.5)."""
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
    """(JAX model, numpy variables, the port's model with those weights)."""
    jmodel = JTrack4D(npoint=N, k_max=K, sinkhorn_iters=ITERS)
    clip = synthetic_clip(0, 1, n_max=N, g_max=K, n_static=60, n_objects=3)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, clip[0], jinit_state(K), train=False),
        jax.random.PRNGKey(0))
    variables = _random_tree(shapes, 0)
    port = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu")
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return jmodel, variables, port


def clip_scans(seed, t=T):
    """A synthetic clip as raw scans [x y z RCS v_r] on the 1/16 grid: scan
    0 the first record's pc2 side, scan t + 1 record t's pc1 side; and the
    stacked records with the same snapped coordinates."""
    s = stack_frames(synthetic_clip(seed, t, n_max=N, g_max=K, n_static=60,
                                    n_objects=3))
    s = s._replace(pc1=_snap(s.pc1), pc2=_snap(s.pc2))
    scans = [np.concatenate([s.pc2[0][s.mask2[0]], s.ft2[0][s.mask2[0]]], 1)]
    for i in range(t):
        scans.append(np.concatenate([s.pc1[i][s.mask1[i]],
                                     s.ft1[i][s.mask1[i]]], 1))
    return scans, s


def _service(world, max_streams):
    return RadarTracker(world[2], n_max=N, max_streams=max_streams)


# ---- lifecycle (tests/test_serve.py::TestLifecycle) ----------------------

def test_first_scan_none_then_outputs(world):
    svc = _service(world, 2)
    sid = svc.open_stream()
    scans, _ = clip_scans(0)
    assert svc.track(sid, scans[0]) is None
    out = svc.track(sid, scans[1])
    assert isinstance(out, TrackOutput)
    assert out.labels.shape == (N,) and out.labels.dtype == np.int32
    assert out.point_track_id.shape == (N,)
    assert out.track_id.shape == (K,) and out.track_id.dtype == np.int32
    assert out.conf.shape == (K,) and out.moving.shape == (N,)
    assert out.flow.shape == (N, 3)
    assert out.n_points == scans[1].shape[0]
    assert out.n_objects == int((out.track_id >= 0).sum())
    clustered = out.labels >= 0
    assert np.array_equal(out.point_track_id[clustered],
                          out.track_id[out.labels[clustered]])
    assert np.all(out.point_track_id[~clustered] == -1)
    assert not out.moving[out.n_points:].any()
    assert np.all(out.flow[out.n_points:] == out.flow[out.n_points:])


def test_errors(world):
    svc = _service(world, 1)
    with pytest.raises(KeyError):
        svc.submit(0, np.zeros((4, 5)))
    sid = svc.open_stream()
    with pytest.raises(RuntimeError):
        svc.open_stream()                    # slots exhausted
    with pytest.raises(ValueError):
        svc.submit(sid, np.zeros((4, 3)))    # too few columns
    with pytest.raises(ValueError):
        svc.submit(sid, np.zeros((5,)))      # not a matrix
    svc.submit(sid, np.zeros((4, 5), np.float32))
    svc.submit(sid, np.zeros((4, 5), np.float32))
    with pytest.raises(RuntimeError):
        svc.submit(sid, np.zeros((4, 5), np.float32))  # double stage
    svc.close_stream(sid)
    with pytest.raises(KeyError):
        svc.submit(sid, np.zeros((4, 5), np.float32))
    assert svc.open_stream() == sid          # slot reusable
    train_mode = Track4D(npoint=16, k_max=2, device="cpu").train()
    with pytest.raises(ValueError):
        RadarTracker(train_mode, n_max=16)


def test_step_with_nothing_staged(world):
    assert _service(world, 1).step() == {}


def test_over_budget_scan_truncates(world):
    svc = _service(world, 1)
    sid = svc.open_stream()
    big = np.random.RandomState(0).randn(N + 40, 5).astype(np.float32)
    svc.submit(sid, big)
    out = svc.track(sid, big)
    assert out.n_points == N
    # the first n_max points are the ones kept
    svc2 = _service(world, 1)
    sid2 = svc2.open_stream()
    svc2.submit(sid2, big[:N])
    out2 = svc2.track(sid2, big[:N])
    assert np.array_equal(out.labels, out2.labels)
    assert np.array_equal(out.flow, out2.flow)


# ---- equivalence with the eval path --------------------------------------

def test_serving_matches_scan_eval(world):
    """The service on raw scans == the uncached eval scan on the same
    records, bit for bit (one program here, not two compilations): labels,
    track ids, conf, and flow = warp - pc1. The single uncached step and
    the cached scan give the same discrete outputs."""
    _, _, port = world
    scans, s = clip_scans(1)
    frames = to_tensors(FrameBatch(*[np.asarray(x)[None] for x in s]), "cpu")
    _, ref = make_scan_eval_step(port)(init_state(1, K, device="cpu"),
                                       frames)
    _, cached = make_scan_eval_step_cached(port)(
        init_state(1, K, device="cpu"), frames)
    for key in ("labels", "track_id"):
        assert torch.equal(ref[key], cached[key]), key
    out0, _ = make_eval_step(port)(
        init_state(1, K, device="cpu"),
        FrameBatch(*[x[:, 0].contiguous() for x in frames]))
    assert torch.equal(out0["labels"], ref["labels"][:, 0])

    svc = _service(world, 3)
    sid = svc.open_stream()
    assert svc.track(sid, scans[0]) is None
    for t, scan in enumerate(scans[1:]):
        out = svc.track(sid, scan)
        assert np.array_equal(out.labels, ref["labels"][0, t].numpy())
        assert np.array_equal(out.track_id, ref["track_id"][0, t].numpy())
        np.testing.assert_allclose(out.conf, ref["conf"][0, t].numpy(),
                                   atol=1e-6)
        pc1 = np.zeros((N, 3), np.float32)
        pc1[:out.n_points] = scan[:, :3]
        np.testing.assert_allclose(
            out.flow, ref["warp"][0, t].numpy() - pc1, atol=1e-5)
    assert (ref["labels"] >= 0).any()        # the clip forms clusters


def test_multi_stream_isolation(world):
    """Two interleaved streams == each stream run alone: discrete outputs
    exact, floats within 1e-5 (another batch size sums in another order)."""
    scans_a, _ = clip_scans(2)
    scans_b, _ = clip_scans(3)
    solo = {}
    for name, scans in (("a", scans_a), ("b", scans_b)):
        svc = _service(world, 4)
        sid = svc.open_stream()
        solo[name] = [o for o in (svc.track(sid, sc) for sc in scans)
                      if o is not None]
    svc = _service(world, 4)
    sa, sb = svc.open_stream(), svc.open_stream()
    joint_a, joint_b = [], []
    for sc_a, sc_b in zip(scans_a, scans_b):
        ra, rb = svc.submit(sa, sc_a), svc.submit(sb, sc_b)
        if ra or rb:
            res = svc.step()
            joint_a.append(res[sa])
            joint_b.append(res[sb])
    for solo_outs, joint_outs in ((solo["a"], joint_a), (solo["b"], joint_b)):
        assert len(solo_outs) == len(joint_outs) == T
        for o1, o2 in zip(solo_outs, joint_outs):
            assert np.array_equal(o1.labels, o2.labels)
            assert np.array_equal(o1.track_id, o2.track_id)
            np.testing.assert_allclose(o1.conf, o2.conf, atol=1e-5)
            np.testing.assert_allclose(o1.flow, o2.flow, atol=1e-4)


def test_inactive_stream_state_frozen(world):
    """A step without stream 1 leaves its carried state byte for byte, in a
    bucket it is not part of and in one where its slot is the padding
    row."""
    scans, _ = clip_scans(4)
    svc = _service(world, 4)
    s0, s1, s2, s3 = [svc.open_stream() for _ in range(4)]
    svc.track(s1, scans[0])
    svc.track(s1, scans[1])                   # s1 now has real state
    before = [x[s1].clone() for x in svc._states]
    assert bool(before[2].any())              # valid object slots
    svc.track(s0, scans[0])
    svc.track(s0, scans[1])                   # bucket 1, without s1
    assert svc.last_bucket == 1
    for sid in (s2, s3):
        svc.submit(sid, scans[0])
    for sid, t in ((s0, 2), (s2, 1), (s3, 1)):
        svc.submit(sid, scans[t])
    assert len(svc.step()) == 3               # bucket 4: s1 pads it
    assert svc.last_bucket == 4
    for a, b in zip(before, [x[s1] for x in svc._states]):
        assert torch.equal(a, b)
    out = svc.track(s1, scans[2])             # and s1 goes on from there
    solo = _service(world, 1)
    sid = solo.open_stream()
    want = [solo.track(sid, sc) for sc in scans[:3]][-1]
    assert np.array_equal(out.labels, want.labels)
    assert np.array_equal(out.track_id, want.track_id)


def test_reopened_stream_resets_but_ids_stay_unique(world):
    scans, _ = clip_scans(5)
    svc = _service(world, 1)
    sid = svc.open_stream()
    svc.track(sid, scans[0])
    out1 = svc.track(sid, scans[1])
    used = set(out1.track_id[out1.track_id >= 0].tolist())
    assert used
    svc.close_stream(sid)
    sid2 = svc.open_stream()
    svc.track(sid2, scans[0])
    out2 = svc.track(sid2, scans[1])
    fresh = out2.track_id[out2.track_id >= 0]
    assert np.array_equal(out1.labels, out2.labels)
    assert len(fresh) and not (set(fresh.tolist()) & used)


# ---- concurrency and buckets ---------------------------------------------

def test_threaded_submitters_single_stepper(world):
    """N threads submit to their own streams, one coordinator steps: the
    results are complete and equal a solo run of each stream."""
    svc = _service(world, 4)
    sids = [svc.open_stream() for _ in range(4)]
    scans = {sid: clip_scans(10 + i)[0] for i, sid in enumerate(sids)}
    got = {sid: [] for sid in sids}
    for t in range(T + 1):
        ready = []

        def submit_one(sid):
            if svc.submit(sid, scans[sid][t]):
                ready.append(sid)

        threads = [threading.Thread(target=submit_one, args=(sid,))
                   for sid in sids]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if ready:
            res = svc.step()
            assert set(res) == set(ready)
            for sid in ready:
                got[sid].append(res[sid])
    solo = _service(world, 1)
    s = solo.open_stream()
    want = [o for o in (solo.track(s, sc) for sc in scans[sids[2]]) if o]
    assert all(len(got[sid]) == T for sid in sids)
    for a, b in zip(want, got[sids[2]]):
        assert np.array_equal(a.labels, b.labels)
        assert np.array_equal(a.track_id, b.track_id)


def test_bucket_sizes(world):
    """A lone staged stream runs the one-stream step; more streams take the
    smallest power-of-two bucket that covers them, at most max_streams."""
    svc = _service(world, 8)
    sids = [svc.open_stream() for _ in range(5)]
    scans = [clip_scans(10 + i)[0] for i in range(5)]
    for sid, sc in zip(sids, scans):
        svc.submit(sid, sc[0])
    assert svc.step() == {} and svc.last_bucket == 0
    svc.submit(sids[0], scans[0][1])
    svc.step()
    assert svc.last_bucket == 1
    svc.submit(sids[0], scans[0][2])
    svc.submit(sids[1], scans[1][1])
    svc.step()
    assert svc.last_bucket == 2
    for i in range(3):
        svc.submit(sids[i], scans[i][3 if i == 0 else 2])
    svc.step()
    assert svc.last_bucket == 4
    for i in range(5):
        svc.submit(sids[i], scans[i][4 if i == 0 else 3 if i < 3 else 1])
    assert len(svc.step()) == 5 and svc.last_bucket == 8
    small = _service(world, 3)
    for _ in range(3):
        small.open_stream()
    for sid in range(3):
        small.submit(sid, scans[sid][0])
        small.submit(sid, scans[sid][1])
    small.step()
    assert small.last_bucket == 3             # capped at max_streams


# ---- the same script of scans through both services ----------------------

def test_same_scans_through_both_services(world):
    """Three streams, staggered (stream 2 opens late and skips a step),
    through the JAX RadarTracker and the port's: labels, point track ids
    and track ids exact, flow and conf within 5e-4."""
    jmodel, variables, _ = world
    jsvc = JRadarTracker(jmodel, jax.tree_util.tree_map(jnp.asarray,
                                                        variables),
                         n_max=N, max_streams=4)
    tsvc = _service(world, 4)
    scans = [clip_scans(20 + i)[0] for i in range(3)]
    # (stream, scan index) staged before each step
    script = [[(0, 0), (1, 0)], [(0, 1), (1, 1)], [(0, 2), (2, 0)],
              [(0, 3), (1, 2), (2, 1)], [(1, 3), (2, 2)],
              [(0, 4), (1, 4), (2, 3)]]
    sids = {}
    compared = 0
    for staged in script:
        for stream, t in staged:
            if stream not in sids:
                sids[stream] = (jsvc.open_stream(), tsvc.open_stream())
            js, ts = sids[stream]
            assert jsvc.submit(js, scans[stream][t]) == \
                tsvc.submit(ts, scans[stream][t])
        jres, tres = jsvc.step(), tsvc.step()
        # the JAX service sets last_bucket at its first non-empty step
        assert getattr(jsvc, "last_bucket", 0) == tsvc.last_bucket
        assert {s for s, (js, _) in sids.items() if js in jres} == \
            {s for s, (_, ts) in sids.items() if ts in tres}
        for stream, (js, ts) in sids.items():
            if js not in jres:
                continue
            want, got = jres[js], tres[ts]
            for key in ("labels", "point_track_id", "track_id", "moving"):
                np.testing.assert_array_equal(
                    getattr(got, key), np.asarray(getattr(want, key)),
                    err_msg=key)
            np.testing.assert_allclose(got.flow, np.asarray(want.flow),
                                       atol=5e-4, rtol=5e-4)
            np.testing.assert_allclose(got.conf, np.asarray(want.conf),
                                       atol=5e-4, rtol=5e-4)
            assert got.n_points == want.n_points
            assert got.n_objects == want.n_objects
            compared += 1
    assert compared == 11


# ---- config, model_from_config, from_checkpoint --------------------------

CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def test_config_dataclass_equals_the_jax_package():
    a = [(f.name, f.type, f.default)
         for f in dataclasses.fields(jconfig.Config)]
    b = [(f.name, f.type, f.default)
         for f in dataclasses.fields(tconfig.Config)]
    assert a == b
    assert tconfig.Config().replace(lr=0.5).lr == 0.5


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p)
                                               for p in CONFIGS])
def test_every_config_loads_equal_to_the_jax_package(path):
    want = jconfig.load_config(path)
    got = tconfig.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    over = tconfig.load_config(path, n_max=64, exp_name="x")
    assert (over.n_max, over.exp_name) == (64, "x")


def test_config_warns_on_unknown_keys(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("n_max: 64\nno_such_key: 1\n")
    with pytest.warns(UserWarning, match="no_such_key"):
        assert tconfig.load_config(p).n_max == 64


def test_model_from_config_builds_and_raises_on_unsupported_keys():
    cfg = tconfig.Config(npoints=64, k_max=4, sinkhorn_iters=7, mov_budget=16,
                         exact_fps=True, dbscan_eps=2.0)
    model = model_from_config(cfg, device="cpu")
    assert (model.npoint, model.k_max, model.sinkhorn_iters, model.mov_budget,
            model.dbscan_eps) == (64, 4, 7, 16, 2.0)
    assert model.pn_head.sa1.exact_fps and not model.sinkhorn_kernel
    assert not model.training
    assert model_from_config(cfg, sinkhorn_kernel=True,
                             device="cpu").sinkhorn_kernel
    assert model.sinkhorn_tol == 0.0
    assert model_from_config(cfg.replace(sinkhorn_tol=1e-3),
                             device="cpu").sinkhorn_tol == 1e-3
    # bfloat16 builds (ROADMAP A9); any other compute dtype is refused
    assert model_from_config(cfg.replace(dtype="bfloat16"),
                             device="cpu").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dtype"):
        model_from_config(cfg.replace(dtype="float16"), device="cpu")


def test_model_from_config_raises_on_fused_sa_false():
    """`fused_sa: false` asks the JAX package for its unfused path. On the
    CPU every wrapper takes its plain version, so the model builds; on the
    card the port always runs its kernels and says so rather than ignore
    the key."""
    cfg = tconfig.Config(npoints=64, k_max=4, sinkhorn_iters=7)
    assert model_from_config(cfg, device="cpu").npoint == 64
    assert model_from_config(cfg.replace(fused_sa=False),
                             device="cpu").npoint == 64
    with pytest.raises(NotImplementedError, match="fused_sa"):
        model_from_config(cfg.replace(fused_sa=False), device="cuda")


def test_from_checkpoint_serves_the_saved_weights(world, tmp_path):
    _, _, port = world
    cfg = tconfig.Config(npoints=N, n_max=N, k_max=K, sinkhorn_iters=ITERS)
    trained = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu")
    trained.load_state_dict(port.state_dict())
    save_train_state(tmp_path, "last", create_train_state(
        trained, TrainConfig(), steps_per_epoch=1, device="cpu"))
    svc = RadarTracker.from_checkpoint(cfg, str(tmp_path), device="cpu",
                                       max_streams=2)
    assert not svc.model.training and svc.n_max == N
    assert not any(p.requires_grad for p in svc.model.parameters())
    scans, _ = clip_scans(6)
    ref = _service(world, 2)
    a, b = svc.open_stream(), ref.open_stream()
    for sc in scans[:3]:
        got, want = svc.track(a, sc), ref.track(b, sc)
        if want is not None:
            assert np.array_equal(got.labels, want.labels)
            assert np.array_equal(got.flow, want.flow)
