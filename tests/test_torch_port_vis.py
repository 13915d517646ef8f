"""CPU parity of the port's visualisers (`ratrack_tpu_torch/utils/vis.py`,
`utils/vis3d.py`) against the JAX package's (`ratrack_tpu/utils/`).

The cases of tests/test_vis3d.py (TestGeometryOracles, TestSceneRoundTrip)
and of tests/test_eval.py's renderers, each run through both packages on
the same input: arrays equal, scene JSON (and the HTML around it) equal,
each PNG written, decodable, and of the JAX file's shape; the oracles of
the JAX tests hold for the port too. Then `vis3d`'s CLI over a VoD fixture
frame with a tracker results file, and the eval CLI with `vis_dir` over a
2-clip synthetic config through the cached scan: the same PNG files as
the JAX CLI writes. The matplotlib cases import it with
importorskip; the 3D visualiser needs numpy only.
"""

import os

import numpy as np
import pytest

from ratrack_tpu.data import vod as jvod
from ratrack_tpu.utils import vis3d as jvis3d
from ratrack_tpu_torch.data import vod
from ratrack_tpu_torch.utils import vis3d


def _labels(pkg, **kw):
    base = dict(type="Car", id=0, occ=0.0, alpha=0.0,
                bbox2d=np.zeros(4, np.float32),
                h=1.5, w=2.0, l=4.0, x=0.0, y=0.0, z=0.0, ry=0.0)
    base.update(kw)
    return pkg.ObjectLabel(**base)


def _both(fn_name, *args, label_kw=None, **kw):
    """The function `fn_name` of both vis3d modules on the same input ->
    (port result, JAX result). label_kw: the first argument is a label
    (a dict) or a list of labels (a list of dicts), each built by the
    package's own ObjectLabel."""
    out = []
    for mod, pkg in ((vis3d, vod), (jvis3d, jvod)):
        if isinstance(label_kw, dict):
            args_ = (_labels(pkg, **label_kw),) + args
        elif label_kw is not None:
            args_ = ([_labels(pkg, **k) for k in label_kw],) + args
        else:
            args_ = args
        out.append(getattr(mod, fn_name)(*args_, **kw))
    return out


def _assert_boxes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], k)


class TestGeometryOracles:
    def test_label_corners_canonical(self):
        c, want = _both("label_corners_3d",
                        label_kw=dict(h=2.0, w=1.0, l=3.0))
        np.testing.assert_array_equal(c, want)
        assert np.allclose(c[:4, 2], 0.0) and np.allclose(c[4:, 2], 2.0)
        assert np.allclose(np.abs(c[:, 0]), 1.5)
        assert np.allclose(np.abs(c[:, 1]), 0.5)
        assert np.allclose(c[:4, :2], c[4:, :2])

    def test_transformed_corners_identity_frames(self):
        got, want = _both("transformed_label_corners", np.eye(4), np.eye(4),
                          label_kw=[dict(x=1.0, y=2.0, z=3.0,
                                         ry=-np.pi / 2)])
        _assert_boxes_equal(got, want)
        exp = vis3d.label_corners_3d(_labels(
            vod, x=1.0, y=2.0, z=3.0, ry=-np.pi / 2)) + [1.0, 2.0, 3.0]
        assert got[0]["label_class"] == "Car"
        assert np.allclose(got[0]["corners"], exp, atol=1e-9)

    def test_transformed_corners_rotation(self):
        got, want = _both("transformed_label_corners", np.eye(4), np.eye(4),
                          label_kw=[dict(l=4.0, w=0.0, h=0.0, ry=0.0)])
        _assert_boxes_equal(got, want)
        c = got[0]["corners"]
        assert np.allclose(np.abs(c[:, 1]), 2.0, atol=1e-9)
        assert np.allclose(c[:, 0], 0.0, atol=1e-9)

    def test_transformed_corners_camera_to_lidar_center(self):
        t_cam_lidar = np.eye(4)
        t_cam_lidar[:3, 3] = [10.0, 0.0, 0.0]
        got, want = _both("transformed_label_corners", np.eye(4),
                          t_cam_lidar,
                          label_kw=[dict(x=0, y=0, z=0, ry=-np.pi / 2, l=0,
                                         w=0, h=0)])
        _assert_boxes_equal(got, want)
        assert np.allclose(got[0]["corners"], [[-10.0, 0.0, 0.0]] * 8)

    def test_radial_velocity_vectors(self):
        pc = np.array([[3.0, 4.0, 0.0], [0.0, 0.0, 2.0]])
        got, want = _both("radial_velocity_vectors", pc,
                          np.array([5.0, -1.0]))
        np.testing.assert_array_equal(got, want)
        assert np.allclose(got[0], [3.0, 4.0, 0.0])
        assert np.allclose(got[1], [0.0, 0.0, -1.0])

    def test_radial_velocity_zero_norm_safe(self):
        got, want = _both("radial_velocity_vectors", np.zeros((1, 3)),
                          np.array([2.0]))
        np.testing.assert_array_equal(got, want)
        assert np.all(np.isfinite(got))

    def test_default_camera_identity(self):
        got, want = _both("default_camera")
        assert got == want
        assert np.allclose(got["eye"], [-10, 0, 20])
        assert np.allclose(got["target"], [10, 0, 1])
        up = np.array([10, 0, 70.0])
        assert np.allclose(got["up"], up / np.linalg.norm(up))

    def test_default_camera_translated_frame(self):
        t = np.eye(4)
        t[:3, 3] = [5.0, -2.0, 1.0]
        got, want = _both("default_camera", t)
        assert got == want
        assert np.allclose(got["eye"], [-5, -2, 21])
        assert np.allclose(got["target"], [15, -2, 2])


def _scenes(build, **kw):
    """`build(scene)` on a Scene3D of each package -> (port, JAX)."""
    return [build(mod.Scene3D(**kw)) for mod in (vis3d, jvis3d)]


class TestSceneRoundTrip:
    def test_points_lines_texts_roundtrip(self, tmp_path):
        pts = np.arange(12, dtype=np.float64).reshape(4, 3)

        def build(sc):
            sc.add_points(pts, color=0x123456, size=0.3, name="radar")
            sc.add_vectors(pts, np.ones_like(pts), color=0xFF0000)
            sc.add_text([1, 2, 3], "radar", 0xFF0000)
            return sc
        got, want = _scenes(build, title="t")
        paths = [sc.to_html(str(tmp_path / f"{i}.html"))
                 for i, sc in enumerate((got, want))]
        data, jdata = (vis3d.parse_scene_html(p) for p in paths)
        assert data == jdata == jvis3d.parse_scene_html(paths[0])
        assert open(paths[0]).read() == open(paths[1]).read()
        assert data["title"] == "t"
        p = data["points"][0]
        assert p["name"] == "radar" and p["color"] == 0x123456
        assert np.allclose(np.array(p["xyz"]).reshape(4, 3), pts)
        seg = np.array(data["lines"][0]["xyz"]).reshape(-1, 2, 3)
        assert seg.shape == (4, 2, 3)
        assert np.allclose(seg[:, 1] - seg[:, 0], 1.0)
        assert data["texts"][0] == {"pos": [1.0, 2.0, 3.0], "text": "radar",
                                    "color": "#ff0000", "size": 0.5}

    def test_box_topology_12_edges(self):
        corners = vis3d.label_corners_3d(_labels(vod))
        got, want = _scenes(lambda sc: sc.add_box(corners, color=0xFF0000,
                                                  width=0.05))
        assert got.scene_dict() == want.scene_dict()
        segs = np.array(got.lines[0]["xyz"]).reshape(-1, 2, 3)
        assert segs.shape[0] == 12
        diffs = np.abs(segs[:, 1] - segs[:, 0])
        assert np.all(np.sum(diffs > 1e-9, axis=1) == 1)
        assert np.sum(diffs[:, 2] > 1e-9) == 4

    def test_axes_triads(self):
        t = np.eye(4)
        t[:3, 3] = [1.0, 1.0, 1.0]
        got, want = _scenes(lambda sc: sc.add_axes(t, length=2.0))
        assert got.scene_dict() == want.scene_dict()
        assert len(got.lines) == 3
        tips = [np.array(ln["xyz"]).reshape(2, 3)[1] for ln in got.lines]
        assert np.allclose(tips, [[3, 1, 1], [1, 3, 1], [1, 1, 3]])
        assert [ln["color"] for ln in got.lines] == [0xFF0000, 0x00FF00,
                                                     0x0000FF]

    def test_track_points_palette_and_filtering(self):
        tid = np.array([0, 1, -1, 0, 21])
        valid = np.array([True, True, True, False, True])
        got, want = _scenes(lambda sc: sc.add_track_points(
            np.zeros((5, 3)), tid, valid))
        assert got.scene_dict() == want.scene_dict()
        entry = got.points[0]
        assert len(entry["xyz"]) == 3 * 3
        assert entry["colors"][0] == vis3d.track_color(0)
        assert entry["colors"][2] == vis3d.track_color(21)
        assert [vis3d.track_color(i) for i in range(45)] == [
            jvis3d.track_color(i) for i in range(45)]
        assert vis3d.track_color(21) == vis3d.track_color(1)

    def test_html_is_standalone(self, tmp_path):
        paths = [sc.add_points(np.zeros((1, 3))).to_html(
            str(tmp_path / f"{i}.html"))
            for i, sc in enumerate(_scenes(lambda sc: sc))]
        html = open(paths[0]).read()
        assert html == open(paths[1]).read()
        assert "<script src=" not in html
        assert "http://" not in html and "https://" not in html
        assert "webgl" in html


def test_detection_labels_and_vis3d_cli_on_a_vod_fixture(tmp_path):
    """`parse_detection_labels` on a fixture frame's label lines, and
    `python -m ...utils.vis3d` (its `main`) over that frame with the lidar
    cloud, the velocity vectors and a tracker results file: the same
    labels and the same scene as the JAX CLI's."""
    from ratrack_tpu_torch.data.fixture import make_vod_fixture
    from ratrack_tpu_torch.eval.export import (format_frame_results,
                                               write_frame_results)
    root = str(tmp_path / "vod")
    make_vod_fixture(root, range(0, 4), n_points=40)
    lines = vod.FrameData(vod.VodLocations(root), "00003").detection_labels
    got, want = (mod.parse_detection_labels(lines)
                 for mod in (vis3d, jvis3d))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in w.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field), field)
    pc1 = np.random.RandomState(3).randn(6, 3).astype(np.float32) * 5
    write_frame_results(str(tmp_path / "res"), "clip", 3, format_frame_results(
        np.array([0, 0, 1, 1, -1, 1]), np.array([4, 9]),
        np.array([0.9, 0.6], np.float32), 2, pc1))
    args = ["--dataset", root, "--frame", "00003", "--lidar", "--velocity",
            "--origin", "radar", "--results",
            str(tmp_path / "res" / "clip" / "00003.txt")]
    scenes = []
    for i, mod in enumerate((vis3d, jvis3d)):
        out = str(tmp_path / f"scene{i}.html")
        mod.main(args + ["--out", out])
        scenes.append(jvis3d.parse_scene_html(out))
    assert scenes[0] == scenes[1]
    names = [p["name"] for p in scenes[0]["points"]]
    assert names == ["lidar", "radar", "track:4", "track:9"]
    assert len(scenes[0]["lines"]) == 9 + 1 + 2    # axes, velocity, boxes


# ---- matplotlib renderers ----------------------------------------------------

@pytest.fixture
def plt_ok():
    pytest.importorskip("matplotlib")


def _assert_same_png(got, want):
    import matplotlib.image as mpimg
    assert os.path.getsize(got) > 1000
    assert mpimg.imread(got).shape == mpimg.imread(want).shape


def test_plot_frame_bev_writes_png(tmp_path, plt_ok):
    from ratrack_tpu.utils.vis import plot_frame_bev as jplot
    from ratrack_tpu_torch.utils.vis import plot_frame_bev
    rng = np.random.RandomState(0)
    n = 60
    pc1 = rng.randn(n, 3).astype(np.float32) * 10 + [20, 0, 1]
    mask = np.ones(n, bool)
    mask[-5:] = False
    args = (pc1, mask, rng.rand(n).astype(np.float32),
            np.where(rng.rand(n) > 0.7, rng.randint(0, 3, n), -1),
            np.array([5, 9, 12]))
    flow = rng.randn(n, 3).astype(np.float32) * 0.1
    paths = [fn(str(tmp_path / d / "f" / "00001.png"), *args, flow=flow,
                title="test frame")
             for fn, d in ((plot_frame_bev, "port"), (jplot, "jax"))]
    assert paths[0] == str(tmp_path / "port" / "f" / "00001.png")
    _assert_same_png(*paths)


def test_plot_projection_2d_writes_png(tmp_path, plt_ok):
    from ratrack_tpu.utils.vis import plot_projection_2d as jplot
    from ratrack_tpu_torch.utils.vis import plot_projection_2d
    rng = np.random.RandomState(0)
    pts = rng.uniform([-5, -3, 2], [5, 3, 40], (80, 3)).astype(np.float32)
    p = np.array([[800.0, 0, 960, 0], [0, 800.0, 600, 0],
                  [0, 0, 1.0, 0]], np.float32)
    paths = [fn(str(tmp_path / f"{d}.png"), pts, np.eye(4, dtype=np.float32),
                p, image_shape=(1216, 1936), title="proj")
             for fn, d in ((plot_projection_2d, "port"), (jplot, "jax"))]
    _assert_same_png(*paths)


def test_label_box_corners_2d_pinhole_oracle():
    """Axis-aligned box through identity transforms and a pinhole
    projection: the JAX result and the hand-computed corner pixels."""
    from ratrack_tpu.utils.vis import label_box_corners_2d as jcorners
    from ratrack_tpu_torch.utils.vis import label_box_corners_2d
    kw = dict(type="Car", id=3, occ=0, alpha=0,
              bbox2d=np.zeros(4, np.float32), h=2.0, w=1.0, l=4.0, x=1.0,
              y=0.5, z=10.0, ry=-np.pi / 2)
    f, cx, cy = 100.0, 300.0, 200.0
    p = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]])
    (b,) = label_box_corners_2d([vod.ObjectLabel(**kw)], np.eye(4), p)
    (jb,) = jcorners([jvod.ObjectLabel(**kw)], np.eye(4), p)
    _assert_boxes_equal([b], [jb])
    assert b["label_class"] == "Car" and b["id"] == 3
    np.testing.assert_allclose(b["corners"][0],
                               [f * 3.0 / 10 + cx, f * 1.0 / 10 + cy],
                               atol=1e-6)
    np.testing.assert_allclose(b["corners"][4],
                               [f * 3.0 / 12 + cx, f * 1.0 / 12 + cy],
                               atol=1e-6)
    assert b["range"] == pytest.approx(np.linalg.norm([1.0, 0.5, 10.0]))


def test_plot_projection_2d_with_labels_writes_png(tmp_path, plt_ok):
    from ratrack_tpu.utils.vis import plot_projection_2d_with_labels as jplot
    from ratrack_tpu_torch.utils.vis import plot_projection_2d_with_labels
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.rand(60, 1) * 20 + 2,
                          rng.randn(60, 2) * 3], axis=1)[:, [1, 2, 0]]
    kw = dict(type="Pedestrian", id=1, occ=0, alpha=0,
              bbox2d=np.zeros(4, np.float32), h=1.8, w=0.6, l=0.6, x=0.0,
              y=0.0, z=8.0, ry=0.2)
    p = np.array([[500.0, 0, 968, 0], [0, 500.0, 608, 0], [0, 0, 1, 0]])
    paths = [fn(str(tmp_path / f"{d}.png"), pts, [pkg.ObjectLabel(**kw)],
                np.eye(4), np.eye(4), p, title="labels overlay")
             for fn, pkg, d in ((plot_projection_2d_with_labels, vod, "port"),
                                (jplot, jvod, "jax"))]
    assert os.path.getsize(paths[0]) > 2000
    _assert_same_png(*paths)


# ---- the eval CLI's vis_dir --------------------------------------------------

def _png_tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_eval_cli_vis_dir_writes_the_jax_clis_files(tmp_path, plt_ok):
    """Both CLIs evaluate two synthetic val clips of 4 frames through the
    scan in 3-frame chunks (a clip boundary and a padded tail) with
    `vis_dir`: the same PNG files, each of the JAX file's shape. (The
    per-frame loop's files: tests/test_torch_port_cli.py::
    test_vis_dir_raises_until_the_renderer_is_ported.)"""
    import yaml
    from ratrack_tpu.main import main as jmain
    from ratrack_tpu_torch.main import main
    trees = []
    for name, cli in (("port", main), ("jax", jmain)):
        d = tmp_path / name
        cfg = dict(model="track4d_radar", dataset="synthetic", n_max=96,
                   npoints=96, k_max=8, g_max=8, sinkhorn_iters=20,
                   synth_clips=4, synth_frames=4, eval=True,
                   scan_frames=3, exp_name=name,
                   checkpoints_dir=str(d / "ckpt"),
                   results_dir=str(d / "results"), vis_dir=str(d / "vis"))
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        cli(["--config", str(path), "--cpu"])
        trees.append(d / "vis")
    files = _png_tree(trees[0])
    assert files == _png_tree(trees[1])
    assert files == [f"synth_{c}/{f:05d}.png" for c in (4, 5)
                     for f in range(1, 5)]
    for f in files:
        _assert_same_png(str(trees[0] / f), str(trees[1] / f))
