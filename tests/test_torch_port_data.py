"""CPU parity of the port's VoD data pipeline against the JAX package's:
`data/{vod,native,gt,projection,fixture,pipeline}.py` of
`ratrack_tpu_torch` against the same modules of `ratrack_tpu`, on the same
inputs. Everything here is exact: the same records array for array, the
same files byte for byte (the modules are NumPy and share one native
library). The native cases mirror tests/test_native.py: each entry point's
native route against the NumPy route, skipped where the library does not
load.
"""

import os

import numpy as np
import pytest

from ratrack_tpu.config import Config as JConfig
from ratrack_tpu.data import fixture as jfixture
from ratrack_tpu.data import gt as jgt
from ratrack_tpu.data import pipeline as jpipeline
from ratrack_tpu.data import projection as jprojection
from ratrack_tpu.data import vod as jvod
from ratrack_tpu_torch.config import Config
from ratrack_tpu_torch.data import fixture, gt, native, pipeline, projection
from ratrack_tpu_torch.data import vod

needs_lib = pytest.mark.skipif(not native.available(),
                               reason="libvod_native.so not available")
TRAIN_CLIP, VAL_CLIP = "delft_2", "delft_10"


def _first(clip):
    return pipeline.CLIP_RANGES[clip][0]


@pytest.fixture(scope="module")
def vod_root(tmp_path_factory):
    """One fixture tree (written by the JAX package) with 6 frames of a
    train clip and 6 of a val clip, and a clips_dir that lists the train
    clip's frames with one that is not on disk (a skipped frame), the val
    clip's six, and leaves every other clip empty."""
    root = tmp_path_factory.mktemp("vod")
    data = str(root / "tree")
    for clip in (TRAIN_CLIP, VAL_CLIP):
        jfixture.make_vod_fixture(data, range(_first(clip), _first(clip) + 6))
    clips_dir = root / "clips"
    clips_dir.mkdir()
    for clip in pipeline.TRAIN_CLIPS + pipeline.VAL_CLIPS:
        f = _first(clip)
        frames = {TRAIN_CLIP: [f, f + 1, f + 2, f + 3, f + 7, f + 4, f + 5],
                  VAL_CLIP: list(range(f, f + 6))}.get(clip, [])
        with open(clips_dir / f"{clip}.txt", "w") as fh:
            fh.write("\n".join(str(i) for i in frames))
    return data, str(clips_dir)


def _configs(vod_root, **kw):
    data, clips_dir = vod_root
    kw = {"dataset": "vod", "dataset_path": data, "clips_dir": clips_dir,
          "g_max": 8, **kw}
    return Config(**kw), JConfig(**kw)


def assert_same_records(got, want):
    assert len(got) == len(want) and want
    for (gclip, grec), (wclip, wrec) in zip(got, want):
        assert gclip == wclip
        assert grec._fields == wrec._fields
        for name in wrec._fields:
            g, w = np.asarray(getattr(grec, name)), np.asarray(
                getattr(wrec, name))
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("n_max", [64, 96])
@pytest.mark.parametrize("split", ["train", "val"])
def test_vod_stream_yields_the_same_records(vod_root, split, n_max):
    """n_max 64 subsamples the 80-point clouds (seeded by frame number),
    96 pads them; the train clip's list has a frame that is not on disk."""
    cfg, jcfg = _configs(vod_root, n_max=n_max)
    got = pipeline.VodTrackStream(cfg, split=split)
    want = jpipeline.VodTrackStream(jcfg, split=split)
    assert len(got) == len(want)
    assert_same_records(list(got), list(want))
    assert got.skipped == want.skipped
    if split == "train":
        # the pair (f + 8, f + 7): neither frame is on disk
        assert [s[:2] for s in got.skipped] == [
            (TRAIN_CLIP, _first(TRAIN_CLIP) + 7)]


def test_vod_stream_without_clips_dir_reads_the_clip_ranges(vod_root):
    """No clips_dir: a clip's frames are its CLIP_RANGES span; only the
    six on disk make records."""
    cfg, jcfg = _configs(vod_root, n_max=96, clips_dir="")
    clips = [VAL_CLIP]
    got = pipeline.VodTrackStream(cfg, clips=clips)
    want = jpipeline.VodTrackStream(jcfg, clips=clips)
    assert got.clip_frames(VAL_CLIP) == want.clip_frames(VAL_CLIP)
    records = list(got)
    assert_same_records(records, list(want))
    assert len(records) == 5 and got.skipped == want.skipped


def test_batched_blocks_are_the_same(vod_root):
    """dp = 2 streams x t = 3 frames over the train and val clips."""
    cfg, jcfg = _configs(vod_root, n_max=96)
    clips = [TRAIN_CLIP, VAL_CLIP]

    def blocks(mod, c):
        def make(cl):
            return mod.VodTrackStream(c, split="train", clips=cl)
        lengths = [len(make([cl]).clip_frames(cl)) - 1 for cl in clips]
        groups = mod.split_clips_balanced(clips, lengths, 2)
        glen = [sum(lengths[clips.index(cl)] for cl in g) for g in groups]
        return groups, list(mod.batched_blocks(make, groups, glen, 3,
                                               c.n_max, c.g_max))

    (groups, got), (jgroups, want) = blocks(pipeline, cfg), blocks(
        jpipeline, jcfg)
    assert groups == jgroups
    assert len(got) == len(want) == 2
    assert got[0].pc1.shape == (2, 3, 96, 3)
    assert_same_records([("", b) for b in got], [("", b) for b in want])


def test_split_clips_balanced_gives_the_same_groups():
    rng = np.random.RandomState(0)
    clips = [f"c{i}" for i in range(11)]
    lengths = list(rng.randint(1, 500, size=11))
    for n in (1, 2, 3, 4, 16):
        assert (pipeline.split_clips_balanced(clips, lengths, n)
                == jpipeline.split_clips_balanced(clips, lengths, n))


def test_prefetcher_reraises_the_producers_exception():
    def produce():
        yield 1
        yield 2
        raise ValueError("bad frame")

    got = []
    with pytest.raises(ValueError, match="bad frame"):
        for item in pipeline.Prefetcher(produce(), depth=1):
            got.append(item)
    assert got == [1, 2]
    assert list(pipeline.Prefetcher(iter(range(5)), depth=2)) == list(
        range(5))


def test_pad_or_subsample_is_the_same():
    arr = np.random.RandomState(1).randn(50, 4).astype(np.float32)
    for n_max, seed in ((64, 3), (50, 3), (20, 3), (20, 4)):
        for g, w in zip(pipeline._pad_or_subsample(arr, n_max, seed),
                        jpipeline._pad_or_subsample(arr, n_max, seed)):
            np.testing.assert_array_equal(g, w)


def test_fixture_tree_is_byte_identical(tmp_path):
    frames = range(100, 104)
    fixture.make_vod_fixture(str(tmp_path / "port"), frames, seed=3,
                             clip_motion=0.5)
    jfixture.make_vod_fixture(str(tmp_path / "jax"), frames, seed=3,
                              clip_motion=0.5)
    names = []
    for dirpath, _, files in os.walk(tmp_path / "jax"):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name),
                                  tmp_path / "jax")
            names.append(rel)
            with open(tmp_path / "jax" / rel, "rb") as a, \
                    open(tmp_path / "port" / rel, "rb") as b:
                assert a.read() == b.read(), rel
    assert len(names) == 4 * 7
    assert sum(len(f) for _, _, f in os.walk(tmp_path / "port")) == 28


def _frame_pair(vod_root):
    """Frames 0 and 1 of the val clip in both packages."""
    data = vod_root[0]
    f = _first(VAL_CLIP)
    out = []
    for mod in (vod, jvod):
        loc = mod.VodLocations(data)
        fds = [mod.FrameData(loc, str(n).zfill(5)) for n in (f, f + 1)]
        out.append((fds, [mod.Transforms(fd) for fd in fds]))
    return out


def _rot(rng):
    from scipy.spatial.transform import Rotation
    return Rotation.from_euler("xyz", rng.rand(3)).as_matrix()


def test_labels_transforms_and_ego_compensation(vod_root):
    (fds, trs), (jfds, jtrs) = _frame_pair(vod_root)
    for fd, jfd in zip(fds, jfds):
        np.testing.assert_array_equal(fd.radar, jfd.radar)
        lab = vod.parse_tracking_labels(fd.tracking_labels)
        jlab = jvod.parse_tracking_labels(jfd.tracking_labels)
        assert list(lab) == list(jlab) == [7, 9]
        mov = vod.filter_moving_labels(lab, fd.detection_labels)
        jmov = jvod.filter_moving_labels(jlab, jfd.detection_labels)
        assert {k: vars(v)["type"] for k, v in mov.items()} == {
            k: vars(v)["type"] for k, v in jmov.items()}
    for name in ("t_camera_radar", "t_radar_lidar", "t_odom_camera",
                 "t_camera_map", "t_camera_utm"):
        np.testing.assert_array_equal(getattr(trs[0], name),
                                      getattr(jtrs[0], name))
    rng = np.random.RandomState(2)
    pts = (rng.randn(300, 3) * 10).astype(np.float32)
    t = np.eye(4)
    t[:3, :3] = _rot(rng)
    t[:3, 3] = [0.8, -0.3, 0.1]
    np.testing.assert_array_equal(vod.ego_motion_radar(*trs),
                                  jvod.ego_motion_radar(*jtrs))
    np.testing.assert_array_equal(vod.transform_points(pts, t),
                                  jvod.transform_points(pts, t))
    np.testing.assert_array_equal(vod.compensate_ego(pts, t),
                                  jvod.compensate_ego(pts, t))


def test_ground_truth_boxes_and_rigid_flow(vod_root):
    (fds, trs), (jfds, jtrs) = _frame_pair(vod_root)

    def gts(mod, gmod, fds, trs):
        out = []
        for fd, tr in zip(fds, trs):
            lab = mod.filter_moving_labels(
                mod.parse_tracking_labels(fd.tracking_labels),
                fd.detection_labels)
            out.append(gmod.build_frame_gt(lab, fd.radar[:, :3], tr, 2))
        return out

    got, want = gts(vod, gt, fds, trs), gts(jvod, jgt, jfds, jtrs)
    for g, w in zip(got, want):
        for name in ("cls", "point_obj_id", "point_obj_combined"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert g.obj_ids_in_order == w.obj_ids_in_order
        assert g.ids_with_points == w.ids_with_points
        for k in w.boxes:
            np.testing.assert_array_equal(g.boxes[k].pose, w.boxes[k].pose)
    pc, comp = fds[1].radar[:, :3], fds[1].radar[:, :3] + 0.01
    np.testing.assert_array_equal(gt.rigid_gt_flow(pc, comp, got[1], got[0]),
                                  jgt.rigid_gt_flow(pc, comp, want[1],
                                                    want[0]))
    # the motion-threshold moving filter, both frames' labels
    labs = [vod.parse_tracking_labels(fd.tracking_labels) for fd in fds]
    jlabs = [jvod.parse_tracking_labels(fd.tracking_labels) for fd in jfds]
    assert list(gt.filter_moving_labels_by_motion(*labs, *trs)) == list(
        jgt.filter_moving_labels_by_motion(*jlabs, *jtrs))


def test_points_in_obb_on_seeded_boxes():
    rng = np.random.RandomState(5)
    pts = (rng.randn(500, 3) * 3).astype(np.float32)
    for _ in range(4):
        box = gt.OrientedBox(center=rng.randn(3), rot=_rot(rng),
                             extent=rng.uniform(0.5, 4.0, 3))
        jbox = jgt.OrientedBox(box.center, box.rot, box.extent)
        np.testing.assert_array_equal(gt.points_in_obb(pts, box),
                                      jgt.points_in_obb(pts, jbox))


def test_projection_matches(vod_root):
    rng = np.random.RandomState(7)
    cloud = np.concatenate([rng.randn(200, 3) * [5, 5, 2] + [0, 0, 10],
                            rng.rand(200, 4)], axis=1).astype(np.float32)
    t = np.eye(4)
    t[:3, :3] = _rot(rng) * 0.1 + np.eye(3)
    pm = np.array([[500, 0, 320, 0], [0, 500, 240, 0], [0, 0, 1, 0]],
                  np.float32)
    for g, w in zip(projection.project_pcl_to_image(cloud, t, pm, (480, 640)),
                    jprojection.project_pcl_to_image(cloud, t, pm,
                                                     (480, 640))):
        np.testing.assert_array_equal(g, w)
    hom = projection.homogeneous_coordinates(cloud[:, :3])
    np.testing.assert_array_equal(
        projection.project_3d_to_2d(hom, np.eye(4)),
        jprojection.project_3d_to_2d(hom, np.eye(4)))
    (fds, _), (jfds, _) = _frame_pair(vod_root)
    for sensor in ("radar", "lidar"):
        np.testing.assert_array_equal(
            projection.read_intrinsic(fds[0], sensor),
            jprojection.read_intrinsic(jfds[0], sensor))
    with pytest.raises(ValueError):
        projection.homogeneous_coordinates(cloud)


# ---- native library: the library's route against the NumPy route ----------


@pytest.fixture
def numpy_route(monkeypatch):
    """Run the port's native entry points on their NumPy fallbacks."""
    def use():
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_route", "numpy")
    return use


@needs_lib
def test_native_decode_scan_matches_fromfile(tmp_path):
    arr = np.random.RandomState(0).randn(133, 7).astype(np.float32)
    p = str(tmp_path / "scan.bin")
    arr.tofile(p)
    np.testing.assert_array_equal(native.decode_scan(p, 7), arr)
    np.testing.assert_array_equal(native.decode_scan(p, 7, max_pts=20),
                                  arr[:20])
    with pytest.raises(FileNotFoundError):
        native.decode_scan(str(tmp_path / "missing.bin"), 7)
    (tmp_path / "bad.bin").write_bytes(b"\x00" * 13)
    with pytest.raises(ValueError):
        native.decode_scan(str(tmp_path / "bad.bin"), 7)


@needs_lib
def test_native_and_numpy_routes_agree(numpy_route):
    rng = np.random.RandomState(3)
    pts = (rng.randn(500, 3) * 4).astype(np.float32)
    t = np.eye(4)
    t[:3, :3] = _rot(rng)
    t[:3, 3] = [1.0, -2.0, 0.5]
    center, rot, extent = np.array([0.5, -0.2, 0.1]), _rot(rng), np.array(
        [4.0, 2.0, 1.5])
    src = rng.randn(10, 5).astype(np.float32)

    def run():
        return (native.transform_points(pts, t),
                native.compensate_ego(pts, t),
                native.points_in_obb(pts, center, rot, extent),
                native.pad_cloud(src, 16), native.pad_cloud(src, 4))

    lib = run()
    numpy_route()
    assert native.route() == "numpy" and not native.available()
    ref = run()
    np.testing.assert_allclose(lib[0], ref[0], atol=1e-4)
    np.testing.assert_allclose(lib[1], ref[1], atol=1e-4)
    np.testing.assert_array_equal(lib[2], ref[2])
    assert 0 < ref[2].sum() < len(pts)
    for got, want in zip(lib[3] + lib[4], ref[3] + ref[4]):
        np.testing.assert_array_equal(got, want)


@needs_lib
def test_native_matches_the_jax_packages_binding():
    from ratrack_tpu.data import native as jnative
    pts = np.random.RandomState(4).randn(100, 3).astype(np.float32)
    t = np.eye(4)
    t[:3, 3] = [0.3, 0.2, 0.1]
    np.testing.assert_array_equal(native.compensate_ego(pts, t),
                                  jnative.compensate_ego(pts, t))


def test_native_builds_from_source_where_the_library_does_not_load(
        tmp_path, monkeypatch):
    """A library that does not load is rebuilt from native/src into the
    port's build directory (never into native/); without a compiler the
    NumPy route is taken."""
    import shutil
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr(native, "_BUILT_PATH", str(tmp_path / "built.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_route", None)
    if shutil.which("g++") is None:
        assert native.route() == "numpy"
        return
    assert native.route() == "built" and native.available()
    assert os.path.exists(tmp_path / "built.so")
    src = np.arange(12, dtype=np.float32).reshape(4, 3)
    out, mask, n = native.pad_cloud(src, 6)
    assert n == 4 and mask.sum() == 4
    np.testing.assert_array_equal(out[:4], src)
