"""The port's forward in float64 on a VoD fixture record against the JAX
package's, layer by layer, and where float32 loses its digits there.

The record: the first of val clip delft_10 in a `data/fixture.py` tree of
three frames (80 radar points padded to 128; the fixture's objects drift
0.3 m a frame from frame 0, so at frame 3577 its points lie up to 1.08 km
from the radar). The weights: `tests/test_torch_port_model.py::
_random_tree` with seed 0 (Dense kernels N(0, 1/fan_in), biases and BN
means N(0, 0.1^2), BN scales and variances U(0.5, 1.5)) for
`Track4D(npoint=128, k_max=8, sinkhorn_iters=20)`, through
`utils.convert.from_flax_variables`.

The JAX package's float64 mode (`jax.enable_x64`, `Track4D(dtype=
float64)`) still rounds to float32 in three places: `square_distance`
(ops/neighborhood.py:148-149, behind every ball query, kNN and 3-NN),
BatchNorm's input (models/layers.py:64, :90) and the DBSCAN features
(models/track4d.py:133). For a float64 yardstick those three modules run
here with `jnp.float32` read as float64 (`_TRUE_FLOAT64`, a monkeypatch of
their `jnp` name; the package's files are unchanged).

Tolerances: every layer within 1e-9 of its largest entry, cls and flow
within 1e-9 absolute, labels and track ids exact.

Run as a script it prints the diagnosis table: each layer's float32 error
against the float64 run for the port, the JAX package's XLA path and its
Pallas kernels (interpreted on the CPU):

    PYTHONPATH=. python tests/test_torch_port_vod_float64.py
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratrack_tpu.data.frames import FrameBatch as JFrameBatch
from ratrack_tpu.models import Track4D as JTrack4D
from ratrack_tpu.models.pnhead import SetAbstractionMSG as JSetAbstractionMSG
from ratrack_tpu.ops import pallas_sa
from ratrack_tpu.tracker import init_state as jinit_state
from ratrack_tpu_torch.data import FrameBatch, to_tensors
from ratrack_tpu_torch.models import Track4D
from ratrack_tpu_torch.models import correlator as port_correlator
from ratrack_tpu_torch.tracker import init_state
from ratrack_tpu_torch.utils import from_flax_variables

N, K, ITERS = 128, 8, 20
LAYERS = ("pn_head.sa1", "pn_head.sa2", "pn_head.sa3", "pn_head.fp3",
          "pn_head.fp2", "pn_head.fp1", "fc_layer.stage1", "fc_layer",
          "fd_layer.cp", "fd_layer.mse", "fd_layer.gru", "fd_layer.fp",
          "affinity")
# the JAX modules whose float32 casts are read as float64 for the yardstick
_CASTING = ("ratrack_tpu.models.layers", "ratrack_tpu.ops.neighborhood",
            "ratrack_tpu.models.track4d")


class _TRUE_FLOAT64:
    """`jax.numpy` with `float32` read as `float64`."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def _true_float64():
    mods = [importlib.import_module(m) for m in _CASTING]
    saved = [m.jnp for m in mods]
    try:
        for m in mods:
            m.jnp = _TRUE_FLOAT64()
        with jax.enable_x64(True):
            yield
    finally:
        for m, j in zip(mods, saved):
            m.jnp = j


def make_world(root):
    """(numpy record, JAX variables) for the fixture tree written at root."""
    from ratrack_tpu_torch.config import Config
    from ratrack_tpu_torch.data.fixture import make_vod_fixture
    from ratrack_tpu_torch.data.pipeline import CLIP_RANGES, VodTrackStream
    from test_torch_port_model import _random_tree
    first = CLIP_RANGES["delft_10"][0]
    make_vod_fixture(root, range(first, first + 3))
    stream = VodTrackStream(Config(dataset_path=root, n_max=N, g_max=K),
                            split="val")
    rec = next(iter(stream))[1]
    frame = jax.tree_util.tree_map(jnp.asarray, JFrameBatch(*rec))
    shapes = jax.eval_shape(lambda k: JTrack4D(
        npoint=N, k_max=K, sinkhorn_iters=ITERS).init(
        k, frame, jinit_state(K), train=False), jax.random.PRNGKey(0))
    return rec, _random_tree(shapes, 0)


def _flat(x):
    return np.asarray(x, np.float64).ravel()


def jax_forward(rec, v, dtype):
    """The JAX Track4D on one record: (outputs, {layer: [one array a
    call]}), in float32 or (inside _true_float64) float64."""
    cast = (lambda x: jnp.asarray(np.asarray(x), dtype)
            if np.asarray(x).dtype == np.float32 else jnp.asarray(x))
    conv = lambda t: jax.tree_util.tree_map(cast, t)
    model = JTrack4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, dtype=dtype)
    (out, _), inter = model.apply(
        conv(v), conv(JFrameBatch(*rec)),
        conv(jax.tree_util.tree_map(np.asarray, jinit_state(K))),
        train=False, capture_intermediates=True, mutable=["intermediates"])
    tree = inter["intermediates"]

    def calls(path):
        node = tree
        for p in path.split("."):
            node = node[p]
        return [_flat(c[-1] if isinstance(c, tuple) else c)
                for c in node["__call__"]]
    layers = {name: calls(name) for name in LAYERS
              if name != "fc_layer.stage1"}
    # stage 1 of the cost volume: the JAX module's sum over the slots of
    # WeightNet1 x the pair MLP (correlator.py:186); its kernel path keeps
    # stage 1 inside the kernel (the module calls then are dummy applies)
    shape = (N, 16, 256)
    wn1, mlp = calls("fc_layer.weightnet1")[0], calls("fc_layer.mlp")[0]
    layers["fc_layer.stage1"] = ([_flat(np.sum(
        wn1.reshape(shape) * mlp.reshape(shape), axis=1))]
        if wn1.size == np.prod(shape) else [])
    out = {k: np.asarray(x, np.float64) for k, x in out.items()}
    out["flow"] = out["warp"] - rec.pc1
    return out, layers


def port_forward(rec, v, dtype):
    """The port's Track4D on one record (one stream) in `dtype`: (outputs,
    {layer: [one array a call]})."""
    model = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu")
    model.load_state_dict(from_flax_variables(v), strict=True)
    model = model.to(dtype)
    layers = {name: [] for name in LAYERS}

    def keep(name):
        def hook(_, __, out):
            out = out[-1] if isinstance(out, tuple) else out
            layers[name].append(_flat(out.detach().double()))
        return hook
    handles = [model.get_submodule(name).register_forward_hook(keep(name))
               for name in LAYERS if name != "fc_layer.stage1"]
    aggregate = port_correlator.fused_knn_weight_aggregate

    def stage(*args, **kw):
        out = aggregate(*args, **kw)
        if args[3] is not None:                   # stage 1 adds add_q
            layers["fc_layer.stage1"].append(_flat(out.double()))
        return out
    port_correlator.fused_knn_weight_aggregate = stage
    try:
        frame = to_tensors(FrameBatch(*[np.asarray(x)[None] for x in rec]),
                           "cpu")
        frame = frame._replace(**{f: getattr(frame, f).to(dtype) for f in (
            "pc1", "pc2", "ft1", "ft2", "pc1_comp", "gt_flow")})
        state = init_state(1, K, device="cpu")
        state = state._replace(h=state.h.to(dtype),
                               desc=state.desc.to(dtype))
        with torch.inference_mode():
            out, _ = model(frame, state)
    finally:
        port_correlator.fused_knn_weight_aggregate = aggregate
        for h in handles:
            h.remove()
    return ({k: x.double().numpy()[0] for k, x in out.items()
             if torch.is_tensor(x)}, layers)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(str(tmp_path_factory.mktemp("vod64")))


def test_float64_forward_matches_jax_layer_by_layer(world):
    rec, v = world
    assert np.abs(rec.pc1[rec.mask1]).max() > 1000.0   # the far coordinates
    with _true_float64():
        want, want_layers = jax_forward(rec, v, jnp.float64)
    got, got_layers = port_forward(rec, v, torch.float64)
    for name in LAYERS:
        # two PNHead calls a frame (pc1, then pc2) in both packages
        assert len(got_layers[name]) == len(want_layers[name]) >= 1, name
        for a, b in zip(got_layers[name], want_layers[name]):
            assert a.shape == b.shape, name
            assert np.abs(a - b).max() <= 1e-9 * max(1.0, np.abs(b).max()), \
                name
    for key in ("cls", "flow"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-9, rtol=0,
                                   err_msg=key)
    for key in ("labels", "track_id", "n"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (want["labels"] >= 0).any()


def _sa1_pc2(rec, v, dtype, fused):
    """pn_head.sa1 on the record's pc2 (the cloud whose ball query float32
    flips) in the JAX package: its XLA path or its Pallas kernel."""
    mod = JSetAbstractionMSG(N, [2., 4.], [4, 8], [[16, 16, 32],
                                                   [16, 16, 32]])
    sub = {c: v[c]["pn_head"]["sa1"] for c in ("params", "batch_stats")}
    saved = pallas_sa.FORCE_FUSED_ON_CPU
    pallas_sa.FORCE_FUSED_ON_CPU = fused
    try:
        return _flat(mod.apply(sub, jnp.asarray(rec.pc2, dtype),
                               jnp.asarray(rec.ft2, dtype),
                               jnp.asarray(rec.mask2), False)[1])
    finally:
        pallas_sa.FORCE_FUSED_ON_CPU = saved


def _port_sa1_pc2(rec, v, dtype):
    model = Track4D(npoint=N, k_max=K, sinkhorn_iters=ITERS, device="cpu")
    model.load_state_dict(from_flax_variables(v), strict=True)
    sa1 = model.pn_head.sa1.to(dtype)
    with torch.inference_mode():
        return _flat(sa1(torch.from_numpy(rec.pc2)[None].to(dtype),
                         torch.from_numpy(rec.ft2)[None].to(dtype),
                         torch.from_numpy(rec.mask2)[None])[1])


def test_float32_error_at_the_first_ball_query_is_the_jax_kernels(world):
    """The layer that amplifies the float32 error: at 1.08 km the expanded
    squared distance (|c|^2 + |x|^2 - 2 c.x) is 0.4-0.5 m^2 off, and sa1's
    ball query on pc2 takes another neighbour at radius 2 for one center.
    The port computes that distance in the JAX Pallas kernel's order
    (csrc/common.cuh::sq_dist), so its float32 sa1 equals the JAX kernel's
    (interpreted) within 1e-5 of the largest entry, both 10% of it away
    from float64; the JAX XLA path, which adds -2 c.x to |c|^2 first, does
    not flip here."""
    rec, v = world
    exact = _port_sa1_pc2(rec, v, torch.float64)
    port32 = _port_sa1_pc2(rec, v, torch.float32)
    kernel32 = _sa1_pc2(rec, v, jnp.float32, fused=True)
    xla32 = _sa1_pc2(rec, v, jnp.float32, fused=False)
    scale = np.abs(exact).max()
    assert np.abs(port32 - kernel32).max() <= 1e-5 * scale
    assert np.abs(port32 - exact).max() > 0.1 * scale
    assert np.abs(xla32 - exact).max() <= 1e-6 * scale


def report(root):
    """The diagnosis table: per layer (each call), the float32 error of
    the port, the JAX XLA path and the JAX Pallas kernels (interpreted)
    against the float64 run, max |err| / max |float64|."""
    rec, v = make_world(root)
    with _true_float64():
        _, exact = jax_forward(rec, v, jnp.float64)
    runs = {"port": port_forward(rec, v, torch.float32)}
    runs["jax_xla"] = jax_forward(rec, v, jnp.float32)
    pallas_sa.FORCE_FUSED_ON_CPU = True
    runs["jax_kernels"] = jax_forward(rec, v, jnp.float32)
    pallas_sa.FORCE_FUSED_ON_CPU = False
    print(f"{'layer':22s} call " + " ".join(f"{k:>12s}" for k in runs))
    for name in LAYERS:
        for i, b in enumerate(exact[name]):
            scale = np.abs(b).max()
            errs = [f"{np.abs(r[1][name][i] - b).max() / scale:12.3e}"
                    if i < len(r[1][name]) else f"{'-':>12s}"
                    for r in runs.values()]
            print(f"{name:22s} {i:4d} " + " ".join(errs))
    with _true_float64():
        want, _ = jax_forward(rec, v, jnp.float64)
    for key in ("cls", "flow"):
        errs = [np.abs(r[0][key] - want[key]).max() / np.abs(want[key]).max()
                for r in runs.values()]
        print(f"{key:22s}      " + " ".join(f"{e:12.3e}" for e in errs))
    from ratrack_tpu.ops.neighborhood import square_distance
    from ratrack_tpu_torch.ops.neighborhood import point_distance
    for cloud, mask in ((rec.pc1, rec.mask1), (rec.pc2, rec.mask2)):
        c64 = cloud[mask].astype(np.float64)
        exact_d = ((c64[:, None] - c64[None]) ** 2).sum(-1)
        port_d = point_distance(torch.from_numpy(cloud[mask]),
                                torch.from_numpy(cloud[mask])).numpy()
        xla_d = np.asarray(square_distance(jnp.asarray(cloud[mask]),
                                           jnp.asarray(cloud[mask])))
        errs = [np.abs(d - exact_d).max() for d in (port_d, xla_d)]
        print(f"{'max |d2 err| (m^2)':22s}      "
              + " ".join(f"{e:12.3e}" for e in errs))
    for key in ("labels",):
        print(f"{key + ' differing':22s}      " + " ".join(
            f"{int((r[0][key] != want[key]).sum()):12d}"
            for r in runs.values()))


if __name__ == "__main__":
    import tempfile
    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        report(tmp)
