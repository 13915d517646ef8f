"""CPU parity of the port's metrics, result export and MOT scoring against
the JAX package's: `train/metrics.py`, `eval/export.py`,
`eval/mot_metrics.py` and `eval/run.py` of `ratrack_tpu_torch` against the
same modules of `ratrack_tpu`, on the same inputs. All exact: equal
values, byte-equal text, equal metric dicts. The MOT cases are those of
tests/test_mot_oracle.py and of tests/test_eval.py's MOT classes.
"""

import os

import numpy as np
import pytest

from ratrack_tpu.eval import export as jexport
from ratrack_tpu.eval import mot_metrics as jmot
from ratrack_tpu.eval import run as jrun
from ratrack_tpu.train import metrics as jmetrics
from ratrack_tpu_torch.eval import export, mot_metrics, run
from ratrack_tpu_torch.train import metrics


def _pts(seed, n=6, offset=0.0, scale=1.0):
    r = np.random.RandomState(seed)
    return (r.randn(n, 3) * scale + offset).astype(np.float32)


def assert_same(got, want):
    """Equal metric dicts (nested per_clip dicts too), value for value."""
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_same(got[k], want[k])
        else:
            assert got[k] == want[k], k
            assert type(got[k]) is type(want[k]), k


# ---- per-frame metrics -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scene_flow_and_motion_seg_metrics(seed):
    rng = np.random.RandomState(seed)
    n = 96
    pc = (rng.randn(n, 3) * [15, 10, 1] + [20, 0, 1]).astype(np.float32)
    pred = pc + rng.randn(n, 3).astype(np.float32) * 0.3
    labels = pc + rng.randn(n, 3).astype(np.float32) * 0.3
    cls = rng.rand(n).astype(np.float32)
    cls[:5] = 0.0                  # the reference's mask == 0 "moving" set
    cls[5:9] = 1.0
    valid = rng.rand(n) > 0.2
    assert_same(metrics.eval_scene_flow(pc, pred, labels, cls, valid),
                jmetrics.eval_scene_flow(pc, pred, labels, cls, valid))
    seg_pred = (cls > 0.5).astype(float)
    gt = (rng.rand(n) > 0.6).astype(float)
    assert_same(metrics.eval_motion_seg(seg_pred, gt, valid),
                jmetrics.eval_motion_seg(seg_pred, gt, valid))
    np.testing.assert_array_equal(
        metrics.cartesian_resolution(pc, "radar"),
        jmetrics.cartesian_resolution(pc, "radar"))


def test_train_package_exports_the_metrics():
    from ratrack_tpu_torch.train import eval_motion_seg, eval_scene_flow
    assert eval_scene_flow is metrics.eval_scene_flow
    assert eval_motion_seg is metrics.eval_motion_seg


# ---- result export ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_export_text_is_byte_equal(seed, tmp_path):
    """float32 confidences and coordinates, as the CLIs pass them."""
    rng = np.random.RandomState(seed)
    n, k = 64, 8
    labels = rng.randint(-1, 6, size=n).astype(np.int32)
    labels[labels == 3] = -1                    # a slot with no point
    track_ids = rng.randint(0, 50, size=k).astype(np.int32)
    confs = rng.rand(k).astype(np.float32)
    pc1 = (rng.randn(n, 3) * 20).astype(np.float32)
    text = export.format_frame_results(labels, track_ids, confs, 6, pc1)
    assert text == jexport.format_frame_results(labels, track_ids, confs, 6,
                                                pc1)
    assert len(text.splitlines()) == 5
    path = export.write_frame_results(str(tmp_path / "p"), "delft_1", 42,
                                      text)
    jpath = jexport.write_frame_results(str(tmp_path / "j"), "delft_1", 42,
                                        text)
    assert os.path.relpath(path, tmp_path / "p") == os.path.relpath(
        jpath, tmp_path / "j") == os.path.join("delft_1", "00042.txt")
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    got, want = export.parse_frame_results(path), jexport.parse_frame_results(
        path)
    assert len(got) == len(want) == 5
    for (gc, gt, gp), (wc, wt, wp) in zip(got, want):
        assert (gc, gt) == (wc, wt)
        np.testing.assert_array_equal(gp, wp)
    # round trip: the parsed points are the exported rows of pc1
    slots = [s for s in range(6) if (labels == s).any()]
    for (conf, tid, pts), s in zip(got, slots):
        assert tid == track_ids[s] and conf == float(confs[s])
        np.testing.assert_array_equal(pts, pc1[labels == s])


def test_export_of_no_cluster_is_empty():
    args = (np.array([-1, -1]), np.array([1]), np.array([1.0]), 1,
            np.zeros((2, 3)))
    assert export.format_frame_results(*args) == ""
    assert jexport.format_frame_results(*args) == ""


# ---- MOT metrics -----------------------------------------------------------

# tests/test_mot_oracle.py's hand-computed scenario
A = _pts(1, 4, scale=10.0)
B = _pts(2, 4, scale=10.0) + 100.0
FAR1 = _pts(3, 4, scale=10.0) + 500.0
FAR2 = _pts(4, 2, scale=10.0) + 800.0
ORACLE = ([{10: A, 20: B}, {10: A, 20: B}],
          [[(0.9, 1, A.copy()), (0.7, 3, FAR1.copy()),
            (0.6, 2, np.concatenate([B[:2], FAR2]))],
           [(0.9, 1, A.copy())]])


def _perfect(n_frames=6):
    """tests/test_eval.py's two objects tracked perfectly."""
    g, p = [], []
    for t in range(n_frames):
        a, b = _pts(t), _pts(100 + t, offset=30.0)
        g.append({1: a, 2: b})
        p.append([(0.9, 11, a.copy()), (0.8, 22, b.copy())])
    return g, p


def _scenario(name):
    g, p = _perfect()
    if name == "oracle":
        return ORACLE
    if name == "id_switch":
        return g, [f if t < 3 else [(c, 99 if tid == 11 else tid, pts)
                                    for c, tid, pts in f]
                   for t, f in enumerate(p)]
    if name == "false_positives":
        return g, [f + [(0.5, 77, _pts(500 + t, offset=-40.0))]
                   for t, f in enumerate(p)]
    if name in ("low_junk", "high_junk"):
        conf = 0.01 if name == "low_junk" else 0.99
        return g, [f + [(conf, 1000 + t, _pts(900 + t, offset=60.0))]
                   for t, f in enumerate(p)]
    if name == "no_preds":
        return g, [[] for _ in g]
    if name == "ambiguous":          # greedy and hungarian disagree
        g1, g2 = _pts(11, 20, scale=10.0), _pts(12, 20, scale=10.0) + 200.0
        return [{1: g1, 2: g2}], [[(0.9, 1, np.concatenate([g1[:16],
                                                              g2[:8]])),
                                   (0.8, 2, g1[:10])]]
    if name == "many_confs":         # > 256 distinct confidences
        rng = np.random.RandomState(0)
        pts = [_pts(100 + i, 3, scale=10.0) for i in range(6)]
        return ([{i: pts[i] for i in range(6)} for _ in range(60)],
                [[(float(rng.rand()), i, pts[i].copy()) for i in range(6)]
                 for _ in range(60)])
    return g, p


SCENARIOS = ["oracle", "perfect", "id_switch", "false_positives",
             "low_junk", "high_junk", "no_preds", "ambiguous", "many_confs"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_clear_mot_and_integrated_mot_are_equal(name):
    g, p = _scenario(name)
    iou = 0.1 if name == "ambiguous" else 0.25
    for match in ("greedy", "hungarian"):
        for thr in (-np.inf, 0.6, 0.85, 0.9):
            assert_same(mot_metrics.clear_mot(g, p, iou, thr, match),
                        jmot.clear_mot(g, p, iou, thr, match))
        assert_same(mot_metrics.integrated_mot(g, p, iou, match=match),
                    jmot.integrated_mot(g, p, iou, match=match))
    assert_same(mot_metrics.integrated_mot(g, p, iou, n_recall=10,
                                           max_thresholds=4),
                jmot.integrated_mot(g, p, iou, n_recall=10,
                                    max_thresholds=4))


def test_point_set_iou_and_namespacing():
    a = _pts(0, 4)
    cases = [(a, a), (a, a + 100.0), (a, np.concatenate([a[:2], a[2:] + 50])),
             (np.zeros((0, 3)), a), (A, FAR1),
             (B, np.concatenate([B[:2], FAR2]))]
    for x, y in cases:
        assert mot_metrics.point_set_iou(x, y) == jmot.point_set_iou(x, y)
    g, p = _perfect(2)
    got, want = mot_metrics.namespace_ids(g, p, 3), jmot.namespace_ids(g, p,
                                                                       3)
    assert [list(f) for f in got[0]] == [list(f) for f in want[0]]
    assert [[(c, t) for c, t, _ in f] for f in got[1]] == [
        [(c, t) for c, t, _ in f] for f in want[1]]
    with pytest.raises(ValueError):
        mot_metrics.clear_mot(*ORACLE, match="munkres-typo")


# ---- offline scoring over a results tree -----------------------------------


@pytest.fixture(scope="module")
def scored_tree(tmp_path_factory):
    """A VoD fixture tree (val clip delft_10, 8 frames) and a results tree
    made from its GT with a dropped point, a switched id, a false positive
    and a missed object, so that no metric is trivially 0 or 1."""
    from ratrack_tpu.config import Config
    from ratrack_tpu.data.fixture import make_vod_fixture
    from ratrack_tpu.data.pipeline import CLIP_RANGES, VodTrackStream

    tmp = tmp_path_factory.mktemp("scored")
    root, results = str(tmp / "vod"), str(tmp / "results")
    first = CLIP_RANGES["delft_10"][0]
    make_vod_fixture(root, range(first, first + 8))
    stream = VodTrackStream(Config(dataset_path=root), split="val")
    rng = np.random.RandomState(0)
    for i, f in enumerate(range(first + 1, first + 8)):
        lines = []
        for oid, pts in jrun.gt_point_sets(stream, f).items():
            if i == 2 and oid == 9:
                continue                                   # missed
            tid = 1000 + oid + (50 if i >= 4 and oid == 7 else 0)
            pts = pts[1:] if i == 1 else pts               # dropped point
            conf = float(np.float32(rng.uniform(0.3, 1.0)))
            lines.append(" ".join(["NA", "1", "-1", "-1", str(conf),
                                   str(tid)]
                                  + [str(float(v)) for v in pts.ravel()]))
        if i == 3:
            lines.append("NA 1 -1 -1 0.2 5 1.0 2.0 3.0 4.0 5.0 6.0")
        jexport.write_frame_results(results, "delft_10", f,
                                    "\n".join(lines) + "\n")
    return root, results


def test_evaluate_results_is_equal(scored_tree):
    root, results = scored_tree
    got = run.evaluate_results(results, root, split="val")
    want = jrun.evaluate_results(results, root, split="val")
    assert_same(got, want)
    assert 0.0 < want["samota"] < 1.0 and want["idsw"] == 1
    assert run.format_table(got) == jrun.format_table(want)


def test_evaluate_results_stream_is_equal(scored_tree):
    """The synthetic CLIs' scoring: GT from the records themselves."""
    from ratrack_tpu_torch.config import Config
    from ratrack_tpu_torch.data.pipeline import VodTrackStream
    root, results = scored_tree
    stream = list(VodTrackStream(Config(dataset_path=root, g_max=8),
                                 split="val"))
    assert_same(run.evaluate_results_stream(iter(stream), results),
                jrun.evaluate_results_stream(iter(stream), results))
    for _, rec in stream[:3]:
        got, want = (run.gt_point_sets_from_record(rec),
                     jrun.gt_point_sets_from_record(rec))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_gt_point_sets_and_collect_clip_are_equal(scored_tree):
    from ratrack_tpu.config import Config as JConfig
    from ratrack_tpu.data.pipeline import VodTrackStream as JStream
    from ratrack_tpu_torch.config import Config
    from ratrack_tpu_torch.data.pipeline import VodTrackStream
    root, results = scored_tree
    stream = VodTrackStream(Config(dataset_path=root), split="val")
    jstream = JStream(JConfig(dataset_path=root), split="val")
    (g, p), (jg, jp) = (run.collect_clip(stream, results, "delft_10"),
                        jrun.collect_clip(jstream, results, "delft_10"))
    assert len(g) == len(jg) == 7 and len(p) == len(jp) == 7
    for a, b in zip(g, jg):
        assert list(a) == list(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert run.collect_clip(stream, results, "delft_1") == ([], [])


def test_eval_run_cli_prints_the_same(scored_tree, capsys):
    root, results = scored_tree
    for argv in (["--results", results, "--dataset", root],
                 ["--results", results, "--dataset", root, "--json",
                  "--iou", "0.5"]):
        run.main(argv)
        got = capsys.readouterr().out
        jrun.main(argv)
        assert got == capsys.readouterr().out
        assert ("samota" if "--json" in argv else "delft_10: samota") in got
