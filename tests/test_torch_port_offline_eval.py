"""CPU parity of the port's offline evaluation against the JAX package's:
`eval/kalman.py`, `eval/run_kf.py`, `eval/detection_ap.py` and
`eval/run_ap.py` of `ratrack_tpu_torch` against the same modules of
`ratrack_tpu`, on the same seeded numpy inputs; and the safe log-sum-exp
of the port's `tracker/sinkhorn.py` against the JAX function's.

Tolerances (both packages run the same numpy code):
  Kalman tracker: ids, lifecycle and output order equal; box states and
    covariances within 1e-10 absolute.
  run_kf: re-tracked ids and printed tables equal, metric dicts equal.
  detection AP: counts and thresholds equal, overlaps and AP tables within
    1e-9 absolute; annotation dicts equal.
  run_ap: KITTI lines, converted trees and printed output byte-equal.
  Sinkhorn: the default (safe) coupling within 1e-5 of JAX's default on
    the valid block, the bounded one within 1e-5 of JAX's bounded one.

The tracker scenarios are those of tests/test_kf_oracle.py (which skips
where the reference's AB3DMOT sources are absent; here the JAX tracker
takes the oracle's place) and of tests/test_eval.py; the AP cases those of
tests/test_detection_ap.py.
"""

import os
import runpy
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu.eval import detection_ap as jap
from ratrack_tpu.eval import kalman as jkalman
from ratrack_tpu.eval import run_ap as jrun_ap
from ratrack_tpu.eval import run_kf as jrun_kf
from ratrack_tpu.tracker import sinkhorn as jsinkhorn
from ratrack_tpu_torch.eval import (detection_ap, export, kalman, run_ap,
                                    run_kf)
from ratrack_tpu_torch.ops.fused_sinkhorn import sinkhorn_uv_reference
from ratrack_tpu_torch.tracker import association, sinkhorn
from ratrack_tpu_torch.tracker.sinkhorn import log_optimal_transport_masked
from test_detection_ap import _synth_annos
from test_kf_oracle import _make_ego_world, _walk_sequences

STATE_ATOL = 1e-10
AP_ATOL = 1e-9


# ---- the Kalman tracker ----------------------------------------------------


def _raw(frames):
    """Detections as (xyz, yaw, lwh, conf) tuples, whatever their class."""
    return [[(np.array(d.xyz, float), float(d.yaw), np.array(d.lwh, float),
              d.conf) for d in f] for f in frames]


def _near_threshold():
    """tests/test_kf_oracle.py: pairs at the 2 m gate, empty frames."""
    rng = np.random.RandomState(7)
    base = np.array([5.0, 0.0, 5.0])
    frames = []
    for f in range(20):
        dets = []
        if f not in (6, 7, 13):
            dets.append((base + np.array([1.95, 0, 0]) * f
                         + rng.randn(3) * 0.01, 0.3,
                         np.array([3.0, 1.5, 1.4]), 1.0))
            dets.append((base + np.array([0.0, 0.0, 2.1]), -0.2,
                         np.array([3.2, 1.6, 1.5]), 1.0))
        frames.append(dets)
    return frames


def _orientation_flips():
    """tests/test_kf_oracle.py: yaw flipping by pi every frame."""
    return [[(np.array([1.0 * f, 0.0, 3.0]),
              0.1 if f % 2 == 0 else 0.1 + np.pi,
              np.array([3.0, 1.5, 1.4]), 1.0)] for f in range(12)]


def _ego_world():
    """tests/test_kf_oracle.py: a static world seen from a turning ego,
    with the ego transforms the vendored tracker's indexing gives."""
    frames, poses = _make_ego_world(14)
    egos = [None] + [np.linalg.inv(poses[f]) @ poses[f + 1]
                     for f in range(1, len(frames))]
    return _raw(frames), egos


def _two_objects():
    """tests/test_eval.py::test_stable_ids_two_objects."""
    return [[(np.array([0.5 * t, 0.0, 0.0]), 0.0, np.array([4.0, 2.0, 1.5]),
              1.0),
             (np.array([10.0, -0.3 * t, 0.0]), 0.0, np.array([1.0, 1.0, 2.0]),
              1.0)] for t in range(8)]


def _ego_translation():
    """tests/test_eval.py::test_ego_motion_compensation."""
    ego = np.eye(4)
    ego[0, 3] = 2.0
    frames = [[(np.array([-2.0 * t, 0.0, 0.0]), 0.0, np.ones(3), 1.0)]
              for t in range(6)]
    return frames, [None] + [ego] * 5


def _scenario(name):
    """-> (frames of raw detections, ego motions or None, tracker kwargs,
    the frame counter to start from)."""
    if name.startswith("walk"):
        seed = int(name[4])
        return (_raw(_walk_sequences(seed)), None,
                dict(greedy=name.endswith("greedy")), 0)
    if name == "near_threshold":
        return _near_threshold(), None, {}, 0
    if name == "orientation_flips":
        return _orientation_flips(), None, {}, 0
    if name in ("ego_world", "ego_world_uncompensated"):
        frames, egos = _ego_world()
        return frames, egos if name == "ego_world" else None, {}, 0
    if name == "two_objects":
        return _two_objects(), None, dict(min_hits=2, max_age=3), 0
    if name == "velocity":
        return ([[(np.array([1.2 * t, 0.0, 0.0]), 0.0, np.ones(3), 1.0)]
                 for t in range(12)], None,
                dict(min_hits=1, max_age=2, match_dist=2.0), 0)
    if name == "death_after_max_age":
        return ([[(np.zeros(3), 0.0, np.ones(3), 1.0)]] + [[]] * 4, None,
                dict(min_hits=1, max_age=2), 0)
    if name == "birth_needs_min_hits":
        return ([[(np.zeros(3), 0.0, np.ones(3), 1.0)]], None,
                dict(min_hits=3, max_age=8), 100)
    if name == "ego_translation":
        frames, egos = _ego_translation()
        return frames, egos, dict(min_hits=1, max_age=1, match_dist=1.0), 0
    raise KeyError(name)


SCENARIOS = ["walk0", "walk1", "walk2", "walk0_greedy", "walk1_greedy",
             "near_threshold", "orientation_flips", "ego_world",
             "ego_world_uncompensated", "two_objects", "velocity",
             "death_after_max_age", "birth_needs_min_hits",
             "ego_translation"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_kalman_tracker_matches_jax(name):
    """Both trackers frame by frame: the same output (ids, order, conf),
    states within 1e-10, the same live tracks with the same filter state."""
    frames, egos, kw, start = _scenario(name)
    mine, ref = kalman.KalmanTracker(**kw), jkalman.KalmanTracker(**kw)
    mine.frame = ref.frame = start
    outputs = []
    for fi, dets in enumerate(frames):
        ego = egos[fi] if egos else None
        got = mine.track([kalman.BoxDet(x.copy(), y, s.copy(), c)
                          for x, y, s, c in dets], ego_motion=ego)
        want = ref.track([jkalman.BoxDet(x.copy(), y, s.copy(), c)
                          for x, y, s, c in dets], ego_motion=ego)
        assert [(i, c) for i, _, c in got] == [(i, c) for i, _, c in want]
        for (_, a, _), (_, b, _) in zip(got, want):
            assert isinstance(a, kalman.BoxDet)
            np.testing.assert_allclose(a.z, b.z, atol=STATE_ATOL, rtol=0)
            assert a.conf == b.conf
        assert ([(t.id, t.hits, t.time_since_update) for t in mine.tracks]
                == [(t.id, t.hits, t.time_since_update) for t in ref.tracks])
        for a, b in zip(mine.tracks, ref.tracks):
            np.testing.assert_allclose(a.x, b.x, atol=STATE_ATOL, rtol=0)
            np.testing.assert_allclose(a.P, b.P, atol=STATE_ATOL, rtol=0)
        outputs.append(sorted(i for i, _, _ in got))
    # the outcomes tests/test_eval.py and tests/test_kf_oracle.py assert
    ids = {i for frame in outputs for i in frame}
    if name in ("ego_world", "velocity", "ego_translation"):
        assert len(ids) == (3 if name == "ego_world" else 1)
    if name == "two_objects":
        assert all(f == outputs[-1] for f in outputs[2:])
        assert len(outputs[-1]) == 2
    if name == "death_after_max_age":
        assert not mine.tracks
    if name == "birth_needs_min_hits":
        assert outputs == [[]]


def test_greedy_pairs_match_jax():
    """tests/test_kf_oracle.py::test_greedy_matching_parity's costs, and
    costs with ties (argsort's order decides them)."""
    rng = np.random.RandomState(3)
    for i in range(30):
        nd, nt = rng.randint(1, 7), rng.randint(1, 7)
        cost = rng.rand(nd, nt)
        if i >= 20:
            cost = np.round(cost * 3) / 3
        got = kalman.KalmanTracker._greedy_pairs(cost)
        assert got == jkalman.KalmanTracker._greedy_pairs(cost)


# ---- run_kf: re-tracking a results tree ------------------------------------


def _pts(seed, n=6):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


def _retrack_frames(case):
    """The clips of tests/test_eval.py's TestKalmanRetrack, ids scrambled."""
    rng = np.random.RandomState(case)
    frames = []
    for t in range(8 if case == 0 else 10):
        if case == 0:
            a = _pts(t) + np.array([0.4 * t, 0, 0], np.float32)
            b = _pts(50 + t) + np.array([20.0, -0.3 * t, 0], np.float32)
        else:
            a = _pts(t) + np.array([0.3 * t, 0, 0], np.float32)
            b = _pts(70 + t) + np.array([25.0, 0.2 * t, 0], np.float32)
        frames.append([(0.9, int(rng.randint(10000)), a),
                       (0.8, int(rng.randint(10000)), b)])
    return frames


@pytest.mark.parametrize("case,kw", [
    (0, dict(min_hits=2, max_age=3, match_dist=3.0)),
    (1, dict(min_hits=1, max_age=3, match_dist=3.0)),
    (1, dict(min_hits=4, max_age=8, match_dist=2.0)),
])
def test_retrack_clip_matches_jax(case, kw):
    frames = _retrack_frames(case)
    frames[3].append((0.5, 7, np.zeros((0, 3), np.float32)))   # empty set
    got = run_kf.retrack_clip(frames, **kw)
    want = jrun_kf.retrack_clip(frames, **kw)
    assert [[(c, t) for c, t, _ in f] for f in got] == \
        [[(c, t) for c, t, _ in f] for f in want]
    for f, g in zip(got, want):
        for (_, _, a), (_, _, b) in zip(f, g):
            np.testing.assert_array_equal(a, b)
    if kw["min_hits"] < 4:
        later = [sorted(t for _, t, _ in f) for f in got[2:]]
        assert all(ids == later[0] for ids in later) and len(later[0]) == 2


def test_dets_from_points_matches_jax():
    pts = np.array([[0, 0, 0], [2, 4, 1]], np.float32)
    preds = [(0.5, 9, np.zeros((0, 3), np.float32)), (0.7, 3, pts),
             (0.2, 4, pts[:1])]
    got, want = run_kf.dets_from_points(preds), jrun_kf.dets_from_points(preds)
    assert [j for j, _ in got] == [j for j, _ in want] == [1, 2]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.z, b.z)
        assert a.conf == b.conf
    np.testing.assert_allclose(got[0][1].xyz, [1, 2, 0.5])
    np.testing.assert_allclose(got[1][1].lwh, [0.1, 0.1, 0.1])


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    """A VoD fixture tree (val clip delft_10, 8 frames) and a results tree
    the port's export wrote from seeded predictions over each frame's raw
    cloud: the GT objects as clusters, with a point dropped now and then,
    ids that switch, a false cluster of clutter and a missed object."""
    from ratrack_tpu_torch.config import Config
    from ratrack_tpu_torch.data.fixture import make_vod_fixture
    from ratrack_tpu_torch.data.pipeline import CLIP_RANGES, VodTrackStream
    from ratrack_tpu_torch.eval.run import gt_point_sets

    tmp = tmp_path_factory.mktemp("offline")
    root, results = str(tmp / "vod"), str(tmp / "results")
    first = CLIP_RANGES["delft_10"][0]
    make_vod_fixture(root, range(first, first + 8))
    stream = VodTrackStream(Config(dataset_path=root), split="val")
    rng = np.random.RandomState(5)
    for i, f in enumerate(range(first + 1, first + 8)):
        pc = stream._load_frame(f)[0].radar[:, :3]
        labels = np.full(pc.shape[0], -1, np.int32)
        slot = 0
        for oid, pts in gt_point_sets(stream, f).items():
            if rng.rand() < 0.15:
                continue                                   # missed
            member = np.flatnonzero((pc[:, None] == pts[None]).all(-1)
                                    .any(1))
            if rng.rand() < 0.3:
                member = member[1:]                        # dropped point
            labels[member] = slot
            slot += 1
        if i % 3 == 1:
            labels[np.flatnonzero(labels < 0)[:4]] = slot   # false cluster
            slot += 1
        track_ids = rng.randint(0, 4, 8).astype(np.int32) + 100
        confs = rng.uniform(0.3, 1.0, 8).astype(np.float32)
        export.write_frame_results(results, "delft_10", f,
                                   export.format_frame_results(
                                       labels, track_ids, confs, slot, pc))
    return root, results


@pytest.mark.parametrize("ego_comp", [False, True])
def test_evaluate_kf_matches_jax(fixture_tree, ego_comp):
    from test_torch_port_eval import assert_same
    root, results = fixture_tree
    for kw in (dict(min_hits=1), dict(min_hits=4, max_age=2)):
        got = run_kf.evaluate_kf(results, root, ego_comp=ego_comp, **kw)
        want = jrun_kf.evaluate_kf(results, root, ego_comp=ego_comp, **kw)
        assert_same(got, want)
        assert want["n_gt"] > 0 and 0.0 < want["samota"] < 1.0


def test_clip_ego_motions_match_jax(fixture_tree):
    from ratrack_tpu.config import Config as JConfig
    from ratrack_tpu.data.pipeline import VodTrackStream as JStream
    from ratrack_tpu_torch.config import Config
    from ratrack_tpu_torch.data.pipeline import VodTrackStream
    root, _ = fixture_tree
    frames = list(range(3576, 3584)) + [99999]           # the last: no file
    got = run_kf.clip_ego_motions(
        VodTrackStream(Config(dataset_path=root), split="val"), frames)
    want = jrun_kf.clip_ego_motions(
        JStream(JConfig(dataset_path=root), split="val"), frames)
    assert len(got) == len(want) == len(frames)
    assert got[0] is None and got[-1] is None and want[-1] is None
    for a, b in zip(got[1:-1], want[1:-1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra", [[], ["--json"], ["--json", "--ego-comp"],
                                   ["--ego-comp", "--min-hits", "1",
                                    "--max-age", "3", "--iou", "0.5"]])
def test_run_kf_cli_prints_the_same(fixture_tree, capsys, extra):
    root, results = fixture_tree
    argv = ["--results", results, "--dataset", root] + extra
    run_kf.main(argv)
    got = capsys.readouterr().out
    jrun_kf.main(argv)
    assert got == capsys.readouterr().out
    assert ("samota" if "--json" in extra else "SAMOTA") in got


# ---- detection AP ----------------------------------------------------------


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               atol=AP_ATOL, rtol=0)


def _dt_gt_pair():
    """tests/test_detection_ap.py::test_rotation_nudge_lands_on_detections."""
    dt = dict(bbox=np.array([[0., 0., 10., 10.]]),
              location=np.array([[0.0, 1.0, 10.0]]),
              dimensions=np.array([[1.5, 1.0, 4.0]]),
              rotation_y=np.array([0.30]))
    gt = dict(bbox=np.array([[0., 0., 10., 10.]]),
              location=np.array([[0.2, 1.0, 10.1]]),
              dimensions=np.array([[1.5, 1.1, 4.2]]),
              rotation_y=np.array([-0.25]))
    return dt, gt


GEOMETRY = {
    # tests/test_detection_ap.py's TestGeometry and TestReferenceQuirks
    "image_iou": lambda m: m.image_box_overlap(
        np.array([[0.0, 0.0, 10.0, 10.0]]),
        np.array([[5.0, 0.0, 15.0, 10.0], [20.0, 20.0, 30.0, 30.0]])),
    "rotated_axis_aligned": lambda m: m.rotate_iou(
        np.array([[0.0, 0.0, 2.0, 2.0, 0.0]]),
        np.array([[1.0, 0.0, 2.0, 2.0, 0.0]])),
    "rotated_self": lambda m: m.rotate_iou(
        np.array([[1.0, -2.0, 3.0, 1.5, 0.7]]),
        np.array([[1.0, -2.0, 3.0, 1.5, 0.7]])),
    "rotated_45": lambda m: m.rotate_iou(
        np.array([[0.0, 0.0, 2.0, 2.0, 0.0]]),
        np.array([[0.0, 0.0, 2.0, 2.0, np.pi / 4]])),
    "rotated_intersection": lambda m: m.rotate_iou(
        np.array([[0.0, 0.0, 2.0, 2.0, 0.0]]),
        np.array([[1.0, 0.0, 2.0, 2.0, 0.0]]), criterion=2),
    "rotation_nudge": lambda m: m.frame_overlaps(
        _dt_gt_pair()[1], _dt_gt_pair()[0], metric=1),
    "d3_overlap": lambda m: m.frame_overlaps(
        _dt_gt_pair()[1], _dt_gt_pair()[0], metric=2),
    "dontcare_criterion": lambda m: np.stack([
        m.image_box_overlap(np.array([[10., 10., 20., 20.]]),
                            np.array([[0., 0., 200., 200.]]), criterion=c)
        for c in (-1, 0)]),
    "random_rotated": lambda m: m.rotate_iou(
        *[np.concatenate([r.rand(6, 2) * 4, 0.5 + r.rand(6, 2) * 3,
                          r.rand(6, 1) * 2 * np.pi - np.pi], axis=1)
          for r in (np.random.RandomState(11), np.random.RandomState(12))]),
}


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_overlaps_match_jax(name):
    got, want = GEOMETRY[name](detection_ap), GEOMETRY[name](jap)
    assert got.shape == want.shape
    _close(got, want)


def test_analytic_overlaps():
    """The oracle values of tests/test_detection_ap.py on the port."""
    _close(GEOMETRY["image_iou"](detection_ap), [[50.0 / 150.0, 0.0]])
    _close(GEOMETRY["rotated_axis_aligned"](detection_ap), [[2.0 / 6.0]])
    _close(GEOMETRY["rotated_self"](detection_ap), [[1.0]])
    inter = 8.0 * (np.sqrt(2.0) - 1.0)
    np.testing.assert_allclose(GEOMETRY["rotated_45"](detection_ap),
                               [[inter / (8.0 - inter)]], atol=1e-7)
    _close(GEOMETRY["rotated_intersection"](detection_ap), [[2.0]])
    by_iou, by_dt_area = GEOMETRY["dontcare_criterion"](detection_ap)[:, 0, 0]
    assert by_iou < 0.01 and by_dt_area == pytest.approx(1.0)


def test_protocol_pieces_match_jax():
    """get_thresholds, compute_statistics and clean_frame on the cases of
    tests/test_detection_ap.py::TestProtocol."""
    scores = np.linspace(0.99, 0.01, 50)
    th = detection_ap.get_thresholds(scores.copy(), 50)
    np.testing.assert_array_equal(th, jap.get_thresholds(scores.copy(), 50))
    assert len(th) == 41
    gt = dict(name=np.array(["Car", "Car"]),
              bbox=np.array([[0, 0, 100, 100], [200, 0, 300, 100]]),
              score=np.zeros(2))
    dt = dict(name=np.array(["Car", "Car", "Car"]),
              bbox=np.array([[0, 0, 100, 100], [205, 0, 305, 100],
                             [400, 0, 500, 100.0]]),
              score=np.array([0.9, 0.8, 0.7]))
    for m in (detection_ap, jap):
        ov = m.image_box_overlap(dt["bbox"], gt["bbox"])
        args = (ov, gt, dt, np.zeros(2, np.int64), np.zeros(3, np.int64),
                np.zeros((0, 4)), 0, 0.5)
        stats = [m.compute_statistics(*args, compute_fp=True),
                 m.compute_statistics(*args, thresh=0.85, compute_fp=True)]
        if m is detection_ap:
            got = stats
        else:
            want = stats
    for (a, b) in zip(got, want):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])
    assert [s[:3] for s in got] == [(2, 1, 0), (1, 0, 1)]
    n = 3
    roi_gt = dict(name=np.array(["Car"] * n), truncated=np.zeros(n),
                  occluded=np.zeros(n, int), alpha=np.zeros(n),
                  bbox=np.array([[0, 0, 100, 100]] * n, float),
                  dimensions=np.ones((n, 3)),
                  location=np.array([[0.0, 1.0, 10.0], [8.0, 1.0, 10.0],
                                     [0.0, 1.0, 30.0]]),
                  rotation_y=np.zeros(n), score=np.zeros(n))
    for roi in (True, False):
        a = detection_ap.clean_frame(roi_gt, roi_gt, 0, roi=roi)
        b = jap.clean_frame(roi_gt, roi_gt, 0, roi=roi)
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    assert detection_ap.clean_frame(roi_gt, roi_gt, 0, roi=True)[0] == 1


@pytest.mark.parametrize("seed,n_frames,kw", [
    (3, 40, dict(drop=-1.0, jitter=0.0, fp_max=1)),   # perfect, >= 41 GT
    (4, 2, dict(drop=-1.0, jitter=0.0, fp_max=1)),    # few GT
    (5, 12, {}),
])
def test_eval_class_matches_jax(seed, n_frames, kw):
    """tests/test_detection_ap.py's perfect-detector and few-GT cases and a
    noisy one: the precision curves and both mAPs."""
    rng = np.random.RandomState(seed)
    gts, dts = _synth_annos(rng, n_frames=n_frames, **kw)
    if seed == 3:
        for dt in dts:
            dt["score"] = rng.permutation(len(dt["score"])) / max(
                len(dt["score"]), 1) * 0.9 + 0.05
    for metric in (1, 2):
        got = detection_ap.eval_class(gts, dts, 0, metric=metric, roi=False)
        want = jap.eval_class(gts, dts, 0, metric=metric, roi=False)
        _close(got, want)
        assert detection_ap.map_11(got) == pytest.approx(jap.map_11(want),
                                                         abs=AP_ATOL)
        assert detection_ap.map_40(got) == pytest.approx(jap.map_40(want),
                                                         abs=AP_ATOL)
    if seed == 3:
        assert detection_ap.map_11(got) == pytest.approx(100.0)


def _assert_tables(got, want):
    assert list(got) == list(want)
    for area in want:
        assert list(got[area]) == list(want[area])
        for k, v in want[area].items():
            assert abs(got[area][k] - v) <= AP_ATOL, (area, k)


@pytest.mark.parametrize("seed", [0, 1])
def test_official_evaluation_matches_jax(seed):
    """Seeded annotations (boxes 45-195 px high, above the 40 px cut) with
    drops, jitter and false positives, and a DontCare region."""
    gts, dts = _synth_annos(np.random.RandomState(seed), n_frames=10)
    g = gts[0]
    for k in g:
        g[k] = np.concatenate([g[k], g[k][:1]])
    g["name"][-1] = "DontCare"
    got = detection_ap.official_evaluation(gts, dts)
    want = jap.official_evaluation(gts, dts)
    _assert_tables(got, want)
    assert 0.0 < want["summary"]["entire_area_mAP_3d"] <= 100.0


def _kitti_line(ann, i, scored):
    """One KITTI label line (dimensions h, w, l; a 16th score column)."""
    d = ann["dimensions"][i]
    vals = [ann["truncated"][i], ann["occluded"][i], ann["alpha"][i],
            *ann["bbox"][i], d[1], d[2], d[0], *ann["location"][i],
            ann["rotation_y"][i]] + ([ann["score"][i]] if scored else [])
    return " ".join([str(ann["name"][i])] + ["%.6f" % v for v in vals])


def _write_labels(d, annos, scored):
    os.makedirs(d, exist_ok=True)
    for i, ann in enumerate(annos):
        lines = [_kitti_line(ann, j, scored)
                 for j in range(len(ann["name"]))]
        with open(os.path.join(d, f"{i:05d}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    with open(os.path.join(d, "readme.txt"), "w") as f:
        f.write("not a label file\n")


@pytest.fixture(scope="module")
def label_dirs(tmp_path_factory):
    """KITTI label files written from a seed: GT without a score column,
    detections with one; an empty detection file among them."""
    tmp = tmp_path_factory.mktemp("labels")
    gts, dts = _synth_annos(np.random.RandomState(9), n_frames=8)
    dts[3] = {k: v[:0] for k, v in dts[3].items()}
    _write_labels(str(tmp / "gt"), gts, scored=False)
    _write_labels(str(tmp / "dt"), dts, scored=True)
    return str(tmp / "gt"), str(tmp / "dt")


def test_parse_and_load_annotations_match_jax(label_dirs):
    gt_dir, dt_dir = label_dirs
    for d in (gt_dir, dt_dir):
        got, ids = detection_ap.load_annotations(d)
        want, jids = jap.load_annotations(d)
        assert ids == jids == [f"{i:05d}" for i in range(8)]
        for a, b in zip(got, want):
            assert list(a) == list(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
    got, _ = detection_ap.load_annotations(gt_dir, ["00002", "00000"])
    want = jap.parse_label_file(os.path.join(gt_dir, "00002.txt"))
    np.testing.assert_array_equal(got[0]["location"], want["location"])
    assert (got[0]["score"] == 0).all()


# ---- run_ap: point tracks -> KITTI detections, the CLI ---------------------


def _tracks(seed, n=6):
    """Point sets in front of the camera: radar x forward 5-30 m."""
    rng = np.random.RandomState(seed)
    out = [(float(np.float32(rng.uniform(0.2, 1.0))), int(rng.randint(100)),
            (rng.randn(rng.randint(1, 9), 3) * [0.6, 0.4, 0.5]
             + [rng.uniform(5, 30), rng.uniform(-5, 5),
                rng.uniform(-0.5, 1.0)]).astype(np.float32))
           for _ in range(n)]
    out.append((0.5, 1, np.zeros((0, 3), np.float32)))
    return out


def _radar_to_camera(seed):
    """A VoD-like radar -> camera transform: x forward -> z, y left -> -x,
    z up -> -y, a small seeded rotation and an offset."""
    rng = np.random.RandomState(seed)
    t = np.zeros((4, 4))
    t[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    a = rng.randn(3) * 0.02
    rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])],
                   [0, np.sin(a[0]), np.cos(a[0])]])
    t[:3, :3] = rx @ t[:3, :3]
    t[:3, 3] = rng.randn(3) * [0.1, 0.5, 0.2]
    t[3, 3] = 1.0
    return t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kitti_lines_match_jax(seed):
    from types import SimpleNamespace
    tr = SimpleNamespace(t_camera_radar=_radar_to_camera(seed))
    k = np.array([[1495.5, 0, 961.3, 0], [0, 1495.5, 624.9, 0],
                  [0, 0, 1, 0]], np.float32)
    preds = _tracks(seed)
    for cls in ("Pedestrian", "Car"):
        got = run_ap.kitti_lines_from_point_tracks(preds, tr, k, cls)
        want = jrun_ap.kitti_lines_from_point_tracks(preds, tr, k, cls)
        assert got == want
        assert len(got) == len(preds) - 1 and got[0].startswith(cls + " ")
    np.testing.assert_array_equal(
        run_ap._corners3d(np.ones(3), np.array([1.0, 2.0, 3.0])),
        jrun_ap._corners3d(np.ones(3), np.array([1.0, 2.0, 3.0])))


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_convert_results_tree_is_byte_equal(fixture_tree, tmp_path):
    root, results = fixture_tree
    n = run_ap.convert_results_tree(results, root, str(tmp_path / "p"))
    jn = jrun_ap.convert_results_tree(results, root, str(tmp_path / "j"))
    assert n == jn == 7
    got = _tree(str(tmp_path / "p"))
    assert got == _tree(str(tmp_path / "j")) and len(got) == 7


def test_format_ap_table_matches_jax():
    gts, dts = _synth_annos(np.random.RandomState(2), n_frames=6)
    res = jap.official_evaluation(gts, dts)
    assert run_ap.format_ap_table(res) == jrun_ap.format_ap_table(res)
    part = {"entire_area": {"Car_3d_all": 1.0, "Car_bev_all": 2.0},
            "roi": {}}
    assert run_ap.format_ap_table(part) == jrun_ap.format_ap_table(part)


@pytest.mark.parametrize("json_out", [False, True])
def test_run_ap_cli_prints_the_same(label_dirs, fixture_tree, tmp_path,
                                    capsys, json_out):
    """Both modes: --gt with --dt (seeded label files), and --gt with
    --results / --dataset, which converts the fixture's results tree."""
    gt_dir, dt_dir = label_dirs
    root, results = fixture_tree
    flag = ["--json"] if json_out else []
    run_ap.main(["--gt", gt_dir, "--dt", dt_dir] + flag)
    got = capsys.readouterr().out
    jrun_ap.main(["--gt", gt_dir, "--dt", dt_dir] + flag)
    assert got == capsys.readouterr().out
    assert ("entire_area" if json_out else "3d mAP11") in got
    fixture_gt = os.path.join(root, "lidar", "training", "label_2")
    outs = []
    for mod, name in ((run_ap, "p"), (jrun_ap, "j")):
        mod.main(["--gt", fixture_gt, "--results", results, "--dataset",
                  root, "--out-dt", str(tmp_path / name),
                  "--det-class", "Car"] + flag)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert _tree(str(tmp_path / "p")) == _tree(str(tmp_path / "j"))
    with pytest.raises(SystemExit):
        run_ap.main(["--gt", gt_dir])


@pytest.mark.parametrize("module", ["run_kf", "run_ap"])
def test_cli_help_runs_without_jax(module):
    """`python -m ratrack_tpu_torch.eval.<module> --help` where JAX cannot
    be imported."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'flax', 'ratrack_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['{module}', '--help']\n"
            f"runpy.run_module('ratrack_tpu_torch.eval.{module}', "
            "run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr
    assert "--results" in out.stdout


# ---- the Sinkhorn log-sum-exp (safe by default, bounded for the model) -----


K = 8


def _scores(hi, seed=0):
    rng = np.random.RandomState(seed)
    scores = (rng.rand(4, K, K) * hi).astype(np.float32)
    return scores, np.array([5, 8, 0, 1], np.int32), \
        np.array([6, 3, 4, 0], np.int32)


def _valid_block_err(got, scores, m, n, safe_lse):
    err = 0.0
    for b in range(len(m)):
        want = np.asarray(jsinkhorn.log_optimal_transport_masked(
            jnp.asarray(scores[b]), jnp.asarray(m[b]), jnp.asarray(n[b]),
            jnp.float32(0.9), 100, safe_lse=safe_lse))
        idx = np.ix_(list(range(m[b])) + [K], list(range(n[b])) + [K])
        err = max(err, float(np.abs(got[b][idx] - want[idx]).max()))
    return err


@pytest.mark.parametrize("hi", [1.0, 50.0, 100.0])
def test_sinkhorn_default_is_the_safe_lse(hi):
    """Scores uniform in [0, hi): the port's default within 1e-5 of the
    JAX default (safe_lse=True), finite at every size."""
    scores, m, n = _scores(hi)
    got = log_optimal_transport_masked(
        torch.from_numpy(scores), torch.from_numpy(m), torch.from_numpy(n),
        0.9, 100).numpy()
    assert np.isfinite(got).all()
    assert _valid_block_err(got, scores, m, n, True) <= 1e-5


@pytest.mark.parametrize("hi", [1.0, 50.0])
def test_sinkhorn_bounded_lse_matches_jax(hi):
    scores, m, n = _scores(hi, seed=1)
    got = log_optimal_transport_masked(
        torch.from_numpy(scores), torch.from_numpy(m), torch.from_numpy(n),
        0.9, 100, safe_lse=False).numpy()
    assert _valid_block_err(got, scores, m, n, False) <= 1e-5


def test_sinkhorn_kernel_with_the_safe_lse_raises():
    scores, m, n = _scores(1.0)
    args = (torch.from_numpy(scores), torch.from_numpy(m),
            torch.from_numpy(n), 0.9, 10)
    with pytest.raises(ValueError, match="bounded"):
        log_optimal_transport_masked(*args, use_fused_kernel=True)
    with pytest.raises(TypeError):
        log_optimal_transport_masked(*args, True)   # keyword-only switches
    log_optimal_transport_masked(*args, safe_lse=False,
                                 use_fused_kernel=True)


@pytest.mark.parametrize("fused", [False, True])
def test_associate_takes_the_bounded_lse(monkeypatch, fused):
    """The association asks for safe_lse=False by keyword, as JAX's does,
    and passes its early exit's tol (0 by default) and its kernel switch
    through; the Sinkhorn gets the affinities detached, while conf keeps
    the gradient of the affinities it gathers."""
    seen = []
    real = association.log_optimal_transport_masked

    def spy(*args, **kw):
        seen.append((len(args), args[0].requires_grad, kw))
        return real(*args, **kw)

    monkeypatch.setattr(association, "log_optimal_transport_masked", spy)
    scores, m, n = _scores(1.0, seed=2)
    prev = torch.arange(K, dtype=torch.int32).expand(4, K).contiguous()
    res = association.associate(
        torch.from_numpy(scores).requires_grad_(), torch.from_numpy(m),
        torch.from_numpy(n), prev, torch.full((4,), K, dtype=torch.int32),
        0.9, 20, 0.01, use_fused_kernel=fused)
    assert seen == [(5, False, dict(tol=0.0, safe_lse=False,
                                    use_fused_kernel=fused))]
    assert res.conf.requires_grad


@pytest.mark.parametrize("safe_lse,tol", [(False, 0.0), (True, 0.0),
                                          (False, 1e-4)])
def test_sinkhorn_on_the_cpu_takes_the_eager_loop(safe_lse, tol):
    """On the CPU no CUDA graph is captured or replayed: the coupling is
    the eager loop's bit for bit, and no counter moves."""
    scores, m, n = (torch.from_numpy(x) for x in _scores(1.0, seed=3))
    counters = ("captures", "replays", "eager_on_device")
    before = [getattr(log_optimal_transport_masked, a) for a in counters]
    got = log_optimal_transport_masked(scores, m, n, 0.9, 30, tol=tol,
                                       safe_lse=safe_lse)
    c, log_mu, log_nu, norm = sinkhorn.transport_problem(scores, m, n, 0.9)
    if tol > 0.0:
        u, v, _ = sinkhorn.sinkhorn_uv_early_exit(c, log_mu, log_nu, 30, tol,
                                                  safe_lse=safe_lse)
    else:
        solve = (sinkhorn._sinkhorn_uv_safe if safe_lse
                 else sinkhorn_uv_reference)
        u, v = solve(c, log_mu, log_nu, 30)
    assert torch.equal(got, c + u.unsqueeze(2) + v.unsqueeze(1)
                       - norm.reshape(-1, 1, 1))
    assert [getattr(log_optimal_transport_masked, a)
            for a in counters] == before
    assert not sinkhorn._graphs
