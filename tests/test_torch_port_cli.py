"""CPU parity of the port's CLI (`ratrack_tpu_torch.main`) against the JAX
package's (`ratrack_tpu.main`), both run in-process with `--cpu`.

Shared weights: JAX variables initialised as the JAX CLI initialises them
(smoke shapes: 96 points, k_max 8, 20 Sinkhorn iterations) are written as
a reference-format `init.pt` by the JAX `save_reference_checkpoint`; both
CLIs train from it (`load_checkpoint: true, model_path: init.pt`), per
frame and batched (dp 2 x scan_frames 3), each into its own
checkpoints_dir. The JAX CLI's trained `best` is exported the same way and
both CLIs evaluate from that one file, per frame (`scan_frames: 0`) and
through the cached scan gated per chunk (`scan_frames: 3`), and on a VoD
fixture tree.

Tolerances:
  result trees: the same files, lines, track ids and points exactly; conf
    within 5e-4 (the forward class, tests/test_full_forward_parity.py)
  segmentation and scene-flow means within 5e-4; the MOT table equal as
    printed (two decimals)
  loss_history.csv: the same header and epochs; epoch 0's means within
    2e-2 relative, epoch 1's within 1e-1 (+ 1e-5 for the six printed
    decimals). Measured on the CPU from init.pt, step by step through both
    packages' per-frame train steps: the first step's loss agrees to 1e-7
    relative, and the distance between the two parameter sets grows from
    1.4e-4 of their norm after one step to 1.0e-3 after 6 and 2.6e-2 after
    12, the losses with it. Largest epoch-mean gaps through the CLIs: per
    frame 0.5% (epoch 0) and 4.7% (epoch 1); batched, where the JAX CLI
    also sums the two streams' gradients across a 2-device mesh, 1.3% and
    5.3%. Adam moves every weight by about lr whatever its gradient's
    size, so a gradient entry near zero that differs in sign between the
    packages (near-ties in max-pools and ReLUs, ROADMAP section C) moves
    that weight 2 lr apart.
  VoD fixture: the same result files, and each package's MOT scoring of
    the other's results tree equal to the other's table. The result lines
    are not compared: at the fixture's inputs (features 10-30x the
    synthetic ones the weights were trained on) the float32 forward is
    ill-conditioned in both packages (cls 2e-4 to 1.2e-3 from a float64
    run of the port for each), and one point's label of one frame differs.
"""

import ast
import os
import re

import numpy as np
import pytest
import torch
import yaml

from ratrack_tpu.eval.export import parse_frame_results as jparse

TRAIN_RTOL = (2e-2, 1e-1)          # epoch 0, epoch 1
SMOKE = dict(model="track4d_radar", dataset="synthetic", n_max=96,
             npoints=96, k_max=8, g_max=8, sinkhorn_iters=20, lr=0.002,
             epochs=2, pretrain_epochs=1, synth_clips=2, synth_frames=3)
# two val clips of four frames: a clip boundary and a padded tail chunk
EVAL = dict(SMOKE, eval=True, load_checkpoint=True, synth_clips=4,
            synth_frames=4)


def _yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _jax_cli(path):
    from ratrack_tpu.main import main
    main(["--config", path, "--cpu"])


def _port_cli(path):
    from ratrack_tpu_torch.main import main
    return main(["--config", path, "--cpu"])


def _run(work, name, cfg, cli):
    """Run one CLI on cfg with its own checkpoint and results dirs; ->
    (exp dir, results dir)."""
    d = work / name
    cfg = dict(cfg, exp_name=name, checkpoints_dir=str(d / "ckpt"),
               results_dir=str(d / "results"))
    cli(_yaml(work / f"{name}.yaml", cfg))
    return d / "ckpt" / name, d / "results"


def _log(exp_dir):
    return open(os.path.join(exp_dir, "run.log")).read()


def _metric_means(log):
    """The last eval's segmentation and scene-flow means in a run.log."""
    seg = re.findall(r"^segmentation: (\{.*\})$", log, re.M)[-1]
    flow = re.findall(r"^scene flow: (\{.*\})$", log, re.M)[-1]
    return ast.literal_eval(seg), ast.literal_eval(flow)


def _mot_table(log):
    return re.findall(r"^\| Metric \| Value \|\n(?:^\|.*\|\n)+", log,
                      re.M)[-1]


def _result_tree(root):
    tree = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            tree[os.path.relpath(path, root)] = jparse(path)
    return tree


def assert_same_results(got_root, want_root):
    got, want = _result_tree(got_root), _result_tree(want_root)
    assert sorted(got) == sorted(want) and want
    assert any(want.values())           # some frame tracked something
    for path in want:
        assert len(got[path]) == len(want[path]), path
        for (gc, gt, gp), (wc, wt, wp) in zip(got[path], want[path]):
            assert gt == wt, path
            np.testing.assert_array_equal(gp, wp)
            assert abs(gc - wc) <= 5e-4, path


def assert_same_eval(port_exp, jax_exp):
    port_log, jax_log = _log(port_exp), _log(jax_exp)
    for got, want in zip(_metric_means(port_log), _metric_means(jax_log)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 5e-4, k
    assert _mot_table(port_log) == _mot_table(jax_log)


def _loss_history(exp_dir):
    lines = open(os.path.join(exp_dir, "loss_history.csv")).read().split()
    return lines[0], np.array([[float(v) for v in l.split(",")]
                               for l in lines[1:]])


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


@pytest.fixture(scope="module")
def init_pt(work):
    """JAX variables as the JAX CLI initialises them, as a reference file."""
    from ratrack_tpu.config import Config
    from ratrack_tpu.data.synthetic import synthetic_clip
    from ratrack_tpu.models import model_from_config
    from ratrack_tpu.tracker.state import init_state
    from ratrack_tpu.train.step import create_train_state
    from ratrack_tpu.utils.convert import save_reference_checkpoint

    cfg = Config(**SMOKE)
    first = synthetic_clip(0, 1, n_max=cfg.n_max, g_max=cfg.g_max,
                           n_static=32)[0]
    ts = create_train_state(model_from_config(cfg), cfg, first,
                            init_state(cfg.k_max, cfg.gru_layers,
                                       cfg.feat_dim), 1, seed=cfg.seed)
    path = str(work / "init.pt")
    save_reference_checkpoint({"params": ts.params,
                               "batch_stats": ts.batch_stats}, path)
    return path, ts


@pytest.fixture(scope="module", params=["per_frame", "batched"])
def trained(request, work, init_pt):
    """Both CLIs trained from init.pt -> (port exp dir, JAX exp dir)."""
    cfg = dict(SMOKE, load_checkpoint=True, model_path=init_pt[0])
    if request.param == "batched":
        cfg.update(dp=2, scan_frames=3)
    port, _ = _run(work, f"port_{request.param}", cfg, _port_cli)
    jax_, _ = _run(work, f"jax_{request.param}", cfg, _jax_cli)
    return port, jax_


@pytest.fixture(scope="module")
def shared_best(work, init_pt):
    """The JAX CLI's per-frame-trained best, exported as a reference
    file."""
    from ratrack_tpu.train import checkpoint as jckpt
    from ratrack_tpu.utils.convert import save_reference_checkpoint

    cfg = dict(SMOKE, load_checkpoint=True, model_path=init_pt[0])
    jax_exp = work / "jax_per_frame" / "ckpt" / "jax_per_frame"
    if not (jax_exp / "models" / "best").is_dir():
        _run(work, "jax_per_frame", cfg, _jax_cli)
    ts = jckpt.restore_train_state(str(jax_exp / "models"), "best",
                                   init_pt[1])
    path = str(work / "best.t7")
    save_reference_checkpoint({"params": ts.params,
                               "batch_stats": ts.batch_stats}, path)
    return path


def test_train_loss_history_matches_jax(trained):
    port, jax_ = trained
    header, got = _loss_history(port)
    jheader, want = _loss_history(jax_)
    assert header == jheader == "epoch,Loss,SceneFlowLoss,SegLoss,TrackingLoss"
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for row, rtol in enumerate(TRAIN_RTOL):
        np.testing.assert_allclose(got[row, 1:], want[row, 1:], rtol=rtol,
                                   atol=1e-5)


def test_train_writes_the_checkpoint_tree(trained):
    port, _ = trained
    models = sorted(os.listdir(port / "models"))
    assert models == ["best.pt", "last.pt", "last0.pt", "last1.pt"]
    log = _log(port)
    assert "converted reference checkpoint" in log and "FINISH" in log


@pytest.mark.parametrize("scan_frames", [0, 3])
def test_eval_matches_jax_from_one_weight_file(work, shared_best,
                                               scan_frames):
    cfg = dict(EVAL, model_path=shared_best, scan_frames=scan_frames)
    port, port_res = _run(work, f"port_eval{scan_frames}", cfg, _port_cli)
    jax_, jax_res = _run(work, f"jax_eval{scan_frames}", cfg, _jax_cli)
    assert "converted reference checkpoint" in _log(port)
    assert ("[eval/scan]" in _log(port)) == (scan_frames > 0)
    assert_same_results(port_res, jax_res)
    assert_same_eval(port, jax_)


def test_eval_from_the_ports_own_checkpoint(work, trained):
    """A `.pt` train checkpoint of the port restores as one (not through
    the reference loader), by path and by name, to the same results."""
    port, _ = trained
    best = str(port / "models" / "best.pt")
    by_path, res_path = _run(work, "port_own_path",
                             dict(EVAL, model_path=best), _port_cli)
    assert f"restored checkpoint: {best}" in _log(by_path)
    cfg = dict(EVAL, exp_name=port.name,
               checkpoints_dir=str(port.parent),
               results_dir=str(work / "port_own_name_results"))
    _port_cli(_yaml(work / "port_own_name.yaml", cfg))
    assert "restored checkpoint: best" in _log(port)
    assert_same_results(res_path, work / "port_own_name_results")
    # the port's own file through the reference loader would not match
    # the model: it must never be taken for one
    from ratrack_tpu_torch.train.checkpoint import is_train_checkpoint
    assert is_train_checkpoint(best)


def _vod_tree(root, clips_dir):
    from ratrack_tpu.data.fixture import make_vod_fixture
    from ratrack_tpu.data.pipeline import CLIP_RANGES, TRAIN_CLIPS, VAL_CLIPS
    os.makedirs(clips_dir)
    first = CLIP_RANGES["delft_10"][0]
    make_vod_fixture(root, range(first, first + 5))
    for clip in TRAIN_CLIPS + VAL_CLIPS:
        with open(os.path.join(clips_dir, clip + ".txt"), "w") as f:
            if clip == "delft_10":
                f.write("\n".join(str(i) for i in range(first, first + 5)))


# slow: with it the file takes 3.5 min from a cold JAX cache; the port's
# VoD path through the CLI also runs in chip_smoke.py's phase 16
@pytest.mark.slow
def test_vod_fixture_eval_matches_jax(work, shared_best):
    root, clips_dir = str(work / "vod"), str(work / "clips")
    _vod_tree(root, clips_dir)
    cfg = dict(EVAL, dataset="vod", dataset_path=root, clips_dir=clips_dir,
               model_path=shared_best, scan_frames=2)
    port, port_res = _run(work, "port_vod", cfg, _port_cli)
    jax_, jax_res = _run(work, "jax_vod", cfg, _jax_cli)
    files = [f"{f:05d}.txt" for f in range(3576, 3580)]
    assert sorted(os.listdir(port_res / "delft_10")) == files
    assert sorted(os.listdir(jax_res / "delft_10")) == files
    from ratrack_tpu.eval.run import evaluate_results as jevaluate
    from ratrack_tpu.eval.run import format_table as jformat
    from ratrack_tpu_torch.eval.run import evaluate_results, format_table
    assert _mot_table(_log(port)) == jformat(jevaluate(
        str(port_res), root, min_obj_points=2)) + "\n"
    assert _mot_table(_log(jax_)) == format_table(evaluate_results(
        str(jax_res), root, min_obj_points=2)) + "\n"


def test_cli_without_cpu_flag_raises_where_there_is_no_card(work):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = _yaml(work / "card.yaml",
                 dict(SMOKE, checkpoints_dir=str(work / "card")))
    from ratrack_tpu_torch.main import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", path])
    assert not os.path.exists(work / "card")


def test_vis_dir_raises_until_the_renderer_is_ported(work):
    """The renderer is ported (it raised until then): an eval with
    `vis_dir` writes one BEV PNG a frame, vis_dir/<clip>/<frame>.png
    (the JAX CLI's file list: tests/test_torch_port_vis.py)."""
    pytest.importorskip("matplotlib")
    vis = work / "vis"
    path = _yaml(work / "vis.yaml", dict(EVAL, vis_dir=str(vis)))
    _port_cli(path)
    assert sorted(os.path.relpath(os.path.join(d, f), vis)
                  for d, _, files in os.walk(vis) for f in files) == [
        f"synth_{c}/{f:05d}.png" for c in (4, 5) for f in range(1, 5)]


def test_continue_model_resumes_last_and_profile_dir_writes_a_trace(work):
    """Port only: `continue_model` restores `last` (model, optimizer,
    schedule and step), and `profile_dir` leaves a torch.profiler trace."""
    cfg = dict(SMOKE, epochs=1, synth_frames=2,
               profile_dir=str(work / "profile"))
    exp, _ = _run(work, "port_resume", cfg, _port_cli)
    from ratrack_tpu_torch.train.checkpoint import _path
    first = torch.load(_path(exp / "models", "last"), weights_only=True)
    _run(work, "port_resume", dict(cfg, continue_model=True), _port_cli)
    assert "restored checkpoint: last" in _log(exp)
    second = torch.load(_path(exp / "models", "last"), weights_only=True)
    assert second["step"] == 2 * first["step"] == 8   # 2 clips x 2 frames
    assert os.path.getsize(work / "profile" / "trace.json") > 0
