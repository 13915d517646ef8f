"""CPU parity of the port's data parallelism (`ratrack_tpu_torch.parallel`)
against the unsharded port and the JAX package's dp mesh.

Two gloo ranks on the CPU, spawned once for the module with a `file://`
rendezvous under a temporary directory: each rank runs every check and
saves what it saw, and the tests below read it. The ranks import this
module and need none of JAX, so JAX is imported inside the fixture that
uses it.

Two worlds, both 2 frames, k_max 8, 20 Sinkhorn iterations:
  dryrun   the JAX dryrun's phase 1 (__graft_entry__.py:140-161): 64
           points, g_max 8, 4 streams, a fresh model's weights (the port's
           seeded init; the dryrun trains from its init). The mesh
           helpers, the sharded train scan and the sharded eval scans
           against the unsharded port.
  pair     test_torch_port_train.py's world (128 points, 2 streams, its
           random weights and snapped clouds), where the port and the JAX
           package's unsharded train scans are held together: the sharded
           port against `make_scan_train_step(model, tx,
           mesh=make_mesh(2))` on the 8-device virtual CPU mesh
           (tests/conftest.py), from the same variables through
           utils/convert.py::from_flax_variables. Not at the dryrun's
           shape: there, measured on the CPU from weights drawn as a fresh
           model's and from this world's kind of random weights, the JAX
           package's float32 frame-0 gradient is 5e-3 and 1.6e-3 of the
           whole gradient's norm from the port's float64 one, the port's
           float32 gradient 4e-6 and 6e-5, so no sharding could meet the
           pair's 1e-3 (JAX's float32 batch norm, E[x^2] - mean^2, loses
           the digits, as tests/test_torch_port_stretch.py found).

Tolerances:
  sharded against unsharded port (the dryrun's, derived there: only the
    order of the float32 mean over streams differs): per-frame loss items
    rtol 1e-5, atol 1e-5; frame-0 gradient per leaf 1e-4 max|g| + 1e-5;
    BN running statistics after frame 0 likewise; exactly two all-reduces
    a frame step and no other collective; every rank's parameters after
    the scan bit for bit the same. Frame 1's losses come from weights one
    Adam step apart, and Adam moves a weight whose gradient is float noise
    (a bias before a batch norm) by up to lr either way, so the sum order
    decides where those land: from the seeded init the frame-1 losses sit
    at 5% of that bound (1.2e-6 relative at most, measured), from random
    batch norm statistics at it (1.9e-5)
  sharded port against sharded JAX: test_torch_port_train.py's standard
    for the unsharded pair: loss items rtol 1e-3, atol 1e-6; each frame-0
    gradient leaf |g - g_jax| <= 1e-3 |G_jax| + 1e-6 in norm and cosine
    >= 0.999 above 1e-4 |G_jax|; BN statistics after frame 0 1e-5
  sharded eval scans (plain and cached): labels and track ids exact, cls
    within 1e-6, warp within 1e-6 of its largest magnitude (1e-6 absolute
    is under float32's step at the 16-32 m of the positions; the CPU's
    matrix products sum in another order at 2 streams than at 4), no
    collective
  the CLI under 2 ranks against the one-process CLI at dp 2: loss_history
    epoch 0 within 2e-2 relative (test_torch_port_cli.py's epoch-0 bound)
"""

import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from ratrack_tpu_torch.data import FrameBatch, to_tensors
from ratrack_tpu_torch.data.synthetic import stack_frames, synthetic_clip
from ratrack_tpu_torch.models import Track4D
from ratrack_tpu_torch.parallel import (count_collectives, gather_clips,
                                        init_from_env, make_mesh, replicate,
                                        shard_clips)
from ratrack_tpu_torch.tracker import init_state
from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                     make_scan_eval_step,
                                     make_scan_eval_step_cached,
                                     make_scan_train_step, make_train_step,
                                     restore_train_state)

K, T, ITERS, W = 8, 2, 20, 2
N, B = 64, 4                 # the dryrun world
PAIR_N, PAIR_B = 128, 2      # the pair world
REPO = Path(__file__).resolve().parents[1]
TIGHT = dict(rtol=1e-5, atol=1e-5)


def _snap(x):
    return (np.round(np.asarray(x, np.float32) * 16.0) / 16.0).astype(
        np.float32)


def _stack(clips):
    return FrameBatch(*[np.stack([np.asarray(getattr(c, f)) for c in clips])
                        for f in FrameBatch._fields])


def _dryrun_world():
    """(numpy frames (B, T, ...), state dict) of the dryrun world."""
    frames = _stack([stack_frames(synthetic_clip(
        s, T, n_max=N, g_max=K, n_static=24, n_objects=2, pts_per_obj=6))
        for s in range(B)])
    model = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    return frames, model.state_dict()


def _pair_world():
    """(JAX model, numpy variables, numpy frames (B, T, ...), state dict)
    of test_torch_port_train.py's world: its clouds on a 1/16 grid (every
    distance exact in both packages), Dense kernels N(0, 1/fan_in), biases
    and BN means N(0, 0.1^2), BN scales and variances U(0.5, 1.5)."""
    import jax
    import jax.numpy as jnp
    from ratrack_tpu.models import Track4D as JTrack4D
    from ratrack_tpu.tracker import init_state as jinit_state
    from ratrack_tpu_torch.utils import from_flax_variables

    fr = _stack([stack_frames(synthetic_clip(s, T, n_max=PAIR_N, g_max=K,
                                             n_static=60, n_objects=3))
                 for s in range(PAIR_B)])
    fr = fr._replace(pc1=_snap(fr.pc1), pc2=_snap(fr.pc2),
                     pc1_comp=_snap(fr.pc1_comp))
    model = JTrack4D(npoint=PAIR_N, k_max=K, sinkhorn_iters=ITERS)
    f0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0, 0]), fr)
    shapes = jax.eval_shape(
        lambda k: model.init(k, f0, jinit_state(K), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

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
    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    return model, variables, fr, from_flax_variables(variables)


def _model(state_dict, n):
    model = Track4D(npoint=n, k_max=K, sinkhorn_iters=ITERS, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


def _frame(frames, t):
    return FrameBatch(*[x[:, t:t + 1] for x in frames])


# --- what each rank runs ------------------------------------------------------

def _train_run(state_dict, frames, mesh=None):
    """T frame steps, one scan call each so that frame 0's gradient can be
    read: -> per-frame items (B,) each (gathered), frame 0's gradients and
    BN statistics, each step's collectives, the parameters after."""
    b, n = frames.pc1.shape[:3:2]
    ts = create_train_state(_model(state_dict, n), TrainConfig(),
                            steps_per_epoch=10, device="cpu")
    state = init_state(b, K, device="cpu")
    if mesh is not None:
        replicate(mesh, ts)
        frames, state = shard_clips(mesh, frames), shard_clips(mesh, state)
    scan = make_scan_train_step(ts, mesh)
    out = {"items": [], "collectives": []}
    for t in range(T):
        with count_collectives() as counts:
            state, items = scan(state, _frame(frames, t), False)
        out["collectives"].append(dict(counts))
        items = {k: v[0] for k, v in items.items()}
        if mesh is not None:
            items = gather_clips(mesh, items)
        out["items"].append(items)
        if t == 0:
            out["grads"] = {n: p.grad.clone()
                            for n, p in ts.model.named_parameters()}
            out["stats"] = {n: b.clone()
                            for n, b in ts.model.named_buffers()}
    out["params"] = {n: p.detach().clone()
                     for n, p in ts.model.named_parameters()}
    return out


def _eval_run(state_dict, frames, cached, mesh=None):
    model = _model(state_dict, N)
    make = make_scan_eval_step_cached if cached else make_scan_eval_step
    state = init_state(B, K, device="cpu")
    if mesh is not None:
        frames, state = shard_clips(mesh, frames), shard_clips(mesh, state)
    with count_collectives() as counts:
        state, outs = make(model, mesh)(state, frames)
    if mesh is not None:
        state, outs = gather_clips(mesh, (state, outs))
    return {"outs": outs, "track_id": state.track_id,
            "collectives": dict(counts)}


def _raises(fn):
    """The ValueError's message, or None where fn raised none."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _mesh_checks(mesh, frames, rank):
    cut = lambda n: FrameBatch(*[x[:n] for x in frames])  # noqa: E731
    out = dict(dp=mesh.dp, rank=mesh.rank, axis_names=mesh.axis_names,
               devices=mesh.devices,
               above=_raises(lambda: make_mesh(W + 1)),
               below=_raises(lambda: make_mesh(1)),
               indivisible=_raises(lambda: shard_clips(mesh, cut(B - 1))),
               shard_pc1=shard_clips(mesh, frames).pc1,
               small_pc1=shard_clips(mesh, cut(2)).pc1)
    out["gathered"] = gather_clips(mesh, shard_clips(mesh, frames))
    # every rank starts elsewhere; rank 0 alone has taken a step, so holds
    # optimizer state the others lack
    ts = create_train_state(
        Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu",
                generator=torch.Generator().manual_seed(100 + rank)),
        TrainConfig(), steps_per_epoch=1, device="cpu")
    if rank == 0:
        make_train_step(ts)(init_state(1, K, device="cpu"),
                            FrameBatch(*[x[:1, 0] for x in frames]), False)
    replicate(mesh, ts)
    out["replicated"] = dict(
        model=ts.model.state_dict(), step=ts.step,
        lr=ts.scheduler.get_last_lr(),
        adam=[{k: v.clone() for k, v in s.items()}
              for s in ts.optimizer.state.values()])
    return out


def _rank(rank, root):
    """One gloo rank: every check, saved to <root>/rank<rank>.pt."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(W),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    worlds = torch.load(os.path.join(root, "worlds.pt"), weights_only=False)
    frames, sd = worlds["dryrun"]
    frames = to_tensors(FrameBatch(*frames), "cpu")
    pair_frames, pair_sd = worlds["pair"]
    pair_frames = to_tensors(FrameBatch(*pair_frames), "cpu")
    init_from_env("cpu", init_method=f"file://{root}/rendezvous")
    try:
        mesh = make_mesh()
        out = {"mesh": _mesh_checks(mesh, frames, rank)}
        if rank == 0:
            out["train_u"] = _train_run(sd, frames)
            out["eval_u"] = [_eval_run(sd, frames, c) for c in (False, True)]
        out["train_s"] = _train_run(sd, frames, mesh)
        out["eval_s"] = [_eval_run(sd, frames, c, mesh)
                         for c in (False, True)]
        out["pair_s"] = _train_run(pair_sd, pair_frames, mesh)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


# --- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds, what each of the W gloo ranks saw ([rank 0's, rank
    1's]) and JAX's sharded run of the pair world. The ranks run while the
    JAX package compiles."""
    dryrun, pair = _dryrun_world(), _pair_world()
    root = tmp_path_factory.mktemp("ranks")
    torch.save({"dryrun": (tuple(dryrun[0]), dryrun[1]),
                "pair": (tuple(pair[2]), pair[3])}, root / "worlds.pt")
    procs = torch.multiprocessing.start_processes(
        _rank, args=(str(root),), nprocs=W, join=False,
        start_method="spawn")
    try:
        jax_out = _jax_sharded(pair)
    finally:
        while not procs.join():
            pass
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(W)]
    return dict(dryrun=dryrun, ranks=ranks, jax=jax_out)


@pytest.fixture(scope="module")
def dryrun(runs):
    return runs["dryrun"]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["ranks"]


@pytest.fixture(scope="module")
def jax_sharded(runs):
    return runs["jax"]


def _jax_sharded(pair):
    """JAX's sharded 2-frame scan of the pair world over a dp=2 mesh ->
    per-frame items (T, B), and its frame-0 gradient and BN statistics
    pmean'd over the mesh (the dryrun's check, __graft_entry__.py:185-208)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from ratrack_tpu.config import Config
    from ratrack_tpu.data.frames import FrameBatch as JFrameBatch
    from ratrack_tpu.parallel import make_mesh as jmake_mesh
    from ratrack_tpu.parallel import replicate as jreplicate
    from ratrack_tpu.parallel import shard_clips as jshard_clips
    from ratrack_tpu.tracker import init_state as jinit_state
    from ratrack_tpu.train.step import TrainState, _make_loss_fn
    from ratrack_tpu.train.step import make_optimizer
    from ratrack_tpu.train.step import make_scan_train_step as jscan_train

    model, v, frames, _ = pair
    mesh = jmake_mesh(W)
    frames = JFrameBatch(*[jnp.asarray(x) for x in frames])
    tstates = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (PAIR_B,) + x.shape), jinit_state(K))
    tx = make_optimizer(Config(), 10)
    params = jreplicate(mesh, jax.tree_util.tree_map(jnp.asarray,
                                                     v["params"]))
    stats = jreplicate(mesh, jax.tree_util.tree_map(jnp.asarray,
                                                    v["batch_stats"]))
    ts = TrainState(params, stats, jreplicate(mesh, tx.init(params)),
                    jnp.zeros((), jnp.int32))
    _, _, items = jscan_train(model, tx, mesh=mesh)(
        ts, jshard_clips(mesh, tstates), jshard_clips(mesh, frames),
        jnp.asarray(False))

    loss_fn = _make_loss_fn(model)

    def grad_local(params, stats, tstates, frames):
        g, (_, _, new_stats) = jax.grad(loss_fn, has_aux=True)(
            params, stats, tstates, frames, jnp.asarray(False))
        return jax.lax.pmean((g, new_stats), "dp")

    f0 = jax.tree_util.tree_map(lambda x: x[:, 0], frames)
    grads, new_stats = jax.jit(jax.shard_map(
        grad_local, mesh=mesh, in_specs=(P(), P(), P("dp"), P("dp")),
        out_specs=P(), check_vma=False))(
        params, stats, jshard_clips(mesh, tstates), jshard_clips(mesh, f0))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return to_np(items), to_np(grads), to_np(new_stats)


# (1) make_mesh, shard_clips, replicate, gather_clips ---------------------------

def test_mesh_axis(ranks):
    for r, res in enumerate(ranks):
        m = res["mesh"]
        assert (m["dp"], m["rank"], m["axis_names"]) == (W, r, ("dp",))
        assert m["devices"] == ["cpu"] * W


@pytest.mark.parametrize("case", ["above", "below"])
def test_make_mesh_refuses_a_dp_other_than_the_world(ranks, case):
    for res in ranks:
        assert res["mesh"][case] is not None, case


def test_shard_clips_rejects_indivisible_batch(ranks):
    """B % dp != 0 fails loudly, not by padding: pad streams would enter
    the mean-over-streams loss."""
    for res in ranks:
        assert "does not divide" in res["mesh"]["indivisible"]


def test_shard_clips_places_leading_axis(ranks, dryrun):
    pc1 = torch.from_numpy(dryrun[0].pc1)
    per = B // W
    for r, res in enumerate(ranks):
        assert torch.equal(res["mesh"]["shard_pc1"],
                           pc1[r * per:(r + 1) * per])
        for got, want in zip(res["mesh"]["gathered"], dryrun[0]):
            assert torch.equal(got, torch.from_numpy(np.asarray(want)))


def test_shard_clips_smaller_divisible_batch(ranks, dryrun):
    pc1 = torch.from_numpy(dryrun[0].pc1)
    for r, res in enumerate(ranks):
        assert torch.equal(res["mesh"]["small_pc1"], pc1[r:r + 1])


def test_replicate_places_full_copies(ranks):
    """Rank 1 started from other weights and no optimizer state; after
    `replicate` it holds rank 0's model, Adam moments, step and LR."""
    a, b = (res["mesh"]["replicated"] for res in ranks)
    assert a["step"] == b["step"] == 1 and a["lr"] == b["lr"]
    for name, x in a["model"].items():
        assert torch.equal(x, b["model"][name]), name
    assert len(a["adam"]) == len(b["adam"]) > 0
    for sa, sb in zip(a["adam"], b["adam"]):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


# (2) the sharded train scan against the unsharded one --------------------------

def test_sharded_train_losses_match_unsharded(ranks):
    u, s = ranks[0]["train_u"], ranks[0]["train_s"]
    for f in range(T):
        for k, want in u["items"][f].items():
            np.testing.assert_allclose(s["items"][f][k].numpy(),
                                       want.numpy(), **TIGHT,
                                       err_msg=f"frame {f} {k}")


@pytest.mark.parametrize("what", ["grads", "stats"])
def test_sharded_train_frame0_matches_unsharded(ranks, what):
    """Frame 0's gradient leaves and BN running statistics: max|d| <=
    1e-4 max|unsharded| + 1e-5."""
    u, s = ranks[0]["train_u"][what], ranks[0]["train_s"][what]
    assert set(u) == set(s)
    for name, want in u.items():
        d = float((s[name] - want).abs().max())
        assert d <= 1e-4 * float(want.abs().max()) + 1e-5, (name, d)


def test_sharded_train_issues_two_all_reduces_a_frame(ranks):
    """Gradients in one bucket, BN statistics in another: two all-reduces
    a frame step, nothing in the forward, no other collective. The
    unsharded step issues none."""
    for res in ranks:
        assert res["train_s"]["collectives"] == [{"all_reduce": 2}] * T
    assert ranks[0]["train_u"]["collectives"] == [{}] * T


def test_sharded_train_keeps_the_ranks_replicated(ranks):
    a, b = ranks[0]["train_s"], ranks[1]["train_s"]
    for name, x in a["params"].items():
        assert torch.equal(x, b["params"][name]), name
    for f in range(T):
        for k, x in a["items"][f].items():
            assert torch.equal(x, b["items"][f][k]), (f, k)


# (3) the sharded port against the sharded JAX scan ----------------------------

def test_sharded_train_items_match_jax(ranks, jax_sharded):
    jitems = jax_sharded[0]
    s = ranks[0]["pair_s"]["items"]
    assert float(jitems["TrackingLoss"][1].max()) > 0
    for key, val in jitems.items():
        got = np.stack([s[f][key].numpy() for f in range(T)])
        np.testing.assert_allclose(got, val, rtol=1e-3, atol=1e-6,
                                   err_msg=key)


def test_sharded_train_frame0_matches_jax(ranks, jax_sharded):
    from ratrack_tpu_torch.utils import from_flax_variables
    _, jgrads, jstats = jax_sharded
    s = ranks[0]["pair_s"]
    want = from_flax_variables({"params": jgrads})
    assert set(want) == set(s["grads"])
    norm = torch.linalg.vector_norm
    total = float(norm(torch.cat([w.flatten() for w in want.values()])))
    for name, w in want.items():
        g = s["grads"][name]
        err = float(norm(g - w))
        assert err <= 1e-3 * total + 1e-6, (name, err, total)
        if float(norm(w)) > 1e-4 * total:
            cos = float((g * w).sum()) / float(norm(g) * norm(w))
            assert cos >= 0.999, (name, cos)
    for name, val in from_flax_variables({"batch_stats": jstats}).items():
        np.testing.assert_allclose(s["stats"][name].numpy(), val.numpy(),
                                   **TIGHT, err_msg=name)


# (4) the sharded eval scans ----------------------------------------------------

@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cached"])
def test_sharded_eval_matches_unsharded(ranks, cached):
    u = ranks[0]["eval_u"][int(cached)]
    for res in ranks:
        s = res["eval_s"][int(cached)]
        assert s["collectives"] == {}
        assert torch.equal(s["track_id"], u["track_id"])
        for k in ("labels", "track_id", "n"):
            assert torch.equal(s["outs"][k], u["outs"][k]), k
        for k in ("cls", "warp"):
            want = u["outs"][k]
            scale = float(want.abs().max()) if k == "warp" else 1.0
            np.testing.assert_allclose(s["outs"][k].numpy(), want.numpy(),
                                       rtol=0, atol=1e-6 * scale, err_msg=k)


# (5) the CLI -----------------------------------------------------------------

def _smoke_dp(tmp_path, name, **kw):
    with open(REPO / "configs" / "smoke_dp.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(epochs=1, scan_frames=2, exp_name=name,
               checkpoints_dir=str(tmp_path / "ckpt"),
               results_dir=str(tmp_path / "results"), **kw)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _history(tmp_path, name):
    text = (tmp_path / "ckpt" / name / "loss_history.csv").read_text()
    head, *rows = text.strip().splitlines()
    return head, np.array([[float(x) for x in r.split(",")] for r in rows])


def test_cli_under_two_ranks_matches_one_process(tmp_path):
    """torchrun over 2 gloo ranks with --cpu against the one-process CLI at
    the same dp (both run at once, each in its own processes): the same
    history within the epoch-0 bound, one checkpoint set from rank 0,
    which restores into a one-process train state."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    cli = ["-m", "ratrack_tpu_torch.main", "--config"]
    runs = [subprocess.Popen(
        [sys.executable, *launch, *cli, _smoke_dp(tmp_path, name), "--cpu"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for name, launch in (
            ("dp", ["-m", "torch.distributed.run", "--standalone",
                    f"--nproc_per_node={W}"]),
            ("one", []))]
    for run in runs:
        _, err = run.communicate(timeout=300)
        assert run.returncode == 0, err[-3000:]

    head, got = _history(tmp_path, "dp")
    want_head, want = _history(tmp_path, "one")
    assert head == want_head and got.shape == want.shape == (1, 5)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-5)
    log = (tmp_path / "ckpt" / "dp" / "run.log").read_text()
    assert log.count("FINISH") == 1 and "mesh: dp=2 over" in log
    models = tmp_path / "ckpt" / "dp" / "models"
    assert sorted(os.listdir(models)) == ["best.pt", "last.pt", "last0.pt"]
    ts = create_train_state(
        Track4D(npoint=96, k_max=8, sinkhorn_iters=20, device="cpu"),
        TrainConfig(), steps_per_epoch=1, device="cpu")
    restore_train_state(str(models), "last", ts)
    assert ts.step == 12      # 2 streams of 12 frames, one step a frame
    assert all(bool(torch.isfinite(p).all()) for p in ts.model.parameters())


@pytest.mark.parametrize("case", ["eval", "indivisible_dp"])
def test_cli_refuses_eval_and_indivisible_dp_under_ranks(tmp_path,
                                                         monkeypatch, case):
    """Under WORLD_SIZE > 1 the eval CLI raises (JAX's builds no mesh), and
    so does a dp that the ranks do not divide; both before joining a
    process group."""
    from ratrack_tpu_torch.main import main
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2" if case == "eval" else "4")
    kw = {"eval": True} if case == "eval" else {"dp": 2}
    with pytest.raises(ValueError,
                       match="one process" if case == "eval" else "divide"):
        main(["--config", _smoke_dp(tmp_path, case, **kw), "--cpu"])
    assert not dist.is_initialized()


def test_init_from_env_on_the_card_raises_without_one(monkeypatch):
    """device=None is the card under NCCL: without CUDA it raises and
    joins no group (no fallback to gloo or the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_from_env()
    assert not dist.is_initialized()


# kernel builds at first use by several ranks at once --------------------------

FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: logs the call, takes a while, writes its -o target
echo "$@" >> "$NVCC_LOG"
sleep 0.3
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then touch "$2"; fi
  shift
done
"""


def _build_once(build_dir, out):
    from ratrack_tpu_torch.kernels import build
    build.BUILD_DIR = Path(build_dir)
    out.put(str(build.build()))


def test_kernel_build_is_shared_by_concurrent_ranks(tmp_path):
    """W ranks reaching their first launch together compile csrc/ once:
    build.build's file lock and atomic rename make the others wait and
    load the one library (a stand-in nvcc logs each compile)."""
    from ratrack_tpu_torch.kernels import build
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    saved = {k: os.environ.get(k) for k in ("CUDA_HOME", "NVCC_LOG")}
    os.environ.update(CUDA_HOME=str(tmp_path), NVCC_LOG=str(log))
    try:
        procs = [ctx.Process(target=_build_once,
                             args=(str(tmp_path / "build"), out))
                 for _ in range(3)]
        for p in procs:
            p.start()
        targets = {out.get(timeout=120) for _ in procs}
        for p in procs:
            p.join(timeout=60)
            assert not p.is_alive() and p.exitcode == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    calls = log.read_text().splitlines()
    n_sources = sum(1 for p in build.sources() if p.suffix == ".cu")
    assert len([c for c in calls if " -c " in f" {c} "]) == n_sources
    assert len([c for c in calls if "-shared" in c]) == 1
    assert len(targets) == 1 and Path(targets.pop()).exists()
    left = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert left == [".lock", f"libratrack_kernels_{build.source_hash()}.so"]
