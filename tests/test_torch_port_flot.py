"""FLOT on the port (models/flot.py, the scan `make_scan_flow_step_cached`,
the transport `tracker.sinkhorn.unbalanced_transport_flow` and kernels B5 at
k = 32 and B11) against the plain reference (tests/reference_flot.py).

CPU, at n = 256 points, k = 32 neighbours and FLOT's published widths,
2 streams x 3 frames, on seeded weights (the instance norms' affine
parameters away from identity, eps = 0.08 and gamma = 1 as the benchmark
assumes): the scan's flow and ot_flow, one SetConv alone and the
transport's plain twin. Tolerances: both sides compute in float32 on the
CPU with the same neighbours (the kNN distance is the same rounded
elementwise ops on both sides, so the graphs are equal); they differ in
the order of sums (the instance norm's one-pass statistics against the
reference's two passes, the transport's rows in chunks against its dense
products), a few float32 roundings of values of up to ~60 m. SET_CONV_TOL
(1e-5, features of order 1) and FLOW_TOL (1e-4 m, flows from barycentres
of coordinates of tens of metres) leave a tenth or less of what TF32
products would move either (about 1e-3 on features, millimetres on the
flow).

Card (`cuda`, skipped without one; run there as tests/test_torch_port_cuda.py
says): B5 at k = 32 selects exactly its twin's indices and keys at 8 x
8192 points; B11 matches its twin at 8 x 8192 within KERNEL_FLOW_TOL;
B5's k <= 16 selections and B3's selection give the digests the tree
before the depth-32 list gave; the scan on the card launches B5 and B11;
a grad input to B11 raises there, and no twin takes its place.

Also: `knn_auto` sends every k that RaTrack's paths ask for (3 and 16)
the way it did before B5 took k = 32, and the benchmark's copy of the
reference (perfbench/reference/flot.py) equals this one.
"""

import hashlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import reference_flot as ref
from ratrack_tpu_torch.config import load_config
from ratrack_tpu_torch.data.frames import FrameBatch
from ratrack_tpu_torch.data.synthetic import stack_frames, synthetic_clip
from ratrack_tpu_torch.models.flot import FLOT
from ratrack_tpu_torch.models.track4d import model_from_config
from ratrack_tpu_torch.ops import fused_knn, fused_transport, neighborhood
from ratrack_tpu_torch.tracker import sinkhorn
from ratrack_tpu_torch.train.step import make_scan_flow_step_cached

ROOT = Path(__file__).resolve().parent.parent
N, K, B, T = 256, 32, 2, 3
MODEL = dict(nb_neighbors=K, nb_iter=1, support_m=10.0)
SET_CONV_TOL = 1e-5
FLOW_TOL = 1e-4
# the kernel against its twin at 8192 points: float32 sums of up to 8192
# terms in another order (~1e-5 relative at worst) of barycentres whose
# coordinates reach ~60 m; read 1.3e-4 on the card (NVIDIA H100 80GB
# HBM3), and a twentieth of the TF32 products' ~1e-2
KERNEL_FLOW_TOL = 5e-4


def seeded_weights(model: FLOT, seed: int) -> dict:
    """Every parameter drawn from `seed`: products N(0, 1 / fan in), the
    instance norms' scales 1 + N(0, 0.1^2) and shifts N(0, 0.1^2), the
    linear layer's bias N(0, 0.1^2); epsilon = ln 0.05 and gamma = 0 (eps
    0.08, gamma 1)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.state_dict().items():
        draw = torch.randn(p.shape, generator=gen)
        if name in ("epsilon", "gamma"):
            out[name] = torch.full(p.shape, math.log(0.05) if
                                   name == "epsilon" else 0.0)
        elif name.endswith("fc.weight") or ".fc" in name:
            out[name] = draw / p.shape[1] ** 0.5
        elif ".bn" in name and name.endswith("weight"):
            out[name] = 1.0 + 0.1 * draw
        else:
            out[name] = 0.1 * draw
    return out


def _model(seed=5, device="cpu"):
    model = FLOT(**MODEL, device=device)
    model.load_state_dict(seeded_weights(model, seed))
    return model


def _frames(n=N, b=B, t=T, seed=11):
    clips = [stack_frames(synthetic_clip(seed + s, t, n_max=n,
                                         n_static=n - 60, n_objects=5,
                                         pts_per_obj=12)) for s in range(b)]
    return FrameBatch(*[torch.as_tensor(np.stack(x)) for x in zip(*clips)])


def _reference(model, frames):
    w = model.state_dict()
    out = {"flow": [], "ot_flow": []}
    for s in range(frames.pc1.shape[0]):
        per = [ref.frame(w, frames.pc1[s, t], frames.pc2[s, t], MODEL)
               for t in range(frames.pc1.shape[1])]
        for k in out:
            out[k].append(torch.stack([p[k] for p in per]))
    return {k: torch.stack(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def scan_and_reference():
    model, frames = _model(), _frames()
    return (make_scan_flow_step_cached(model)(frames),
            _reference(model, frames), model, frames)


@pytest.mark.parametrize("key", ["flow", "ot_flow"])
def test_scan_matches_reference(scan_and_reference, key):
    got, want, _, _ = scan_and_reference
    assert got[key].shape == (B, T, N, 3)
    gap = (got[key] - want[key]).abs().max().item()
    assert gap <= FLOW_TOL, gap
    # the flow moves mass: not a trivially small answer
    assert want[key].abs().max().item() > 0.1


def test_uncached_forward_equals_the_scan(scan_and_reference):
    """The model's own forward (both clouds' features every frame) gives
    the scan's outputs: the carried features are pc2's."""
    got, _, model, frames = scan_and_reference
    for t in range(T):
        out = model(frames.pc1[:, t], frames.pc2[:, t], frames.mask1[:, t],
                    frames.mask2[:, t])
        for key in ("flow", "ot_flow"):
            assert torch.equal(out[key], got[key][:, t]), (t, key)


def test_set_conv_matches_reference():
    model, frames = _model(), _frames()
    pc = frames.pc1[:, 0]
    graph = model.graph(pc)
    signal = torch.randn((B, N, 32), generator=torch.Generator().manual_seed(2))
    got = model.feat_conv2(signal, graph)
    w = model.state_dict()
    for s in range(B):
        idx = ref.knn_graph(pc[s], K)
        assert torch.equal(graph.flat.reshape(B, N, K)[s] - s * N, idx)
        want = ref.set_conv(w, "feat_conv2", signal[s], pc[s], idx)
        gap = (got[s] - want).abs().max().item()
        assert gap <= SET_CONV_TOL, gap


def test_transport_twin_matches_the_dense_plan():
    """The plain twin, a few rows of K at a time and the plan never whole,
    against `unbalanced_transport_flow` and the reference's dense plan on
    the same features, at one and three iterations."""
    gen = torch.Generator().manual_seed(7)
    frames = _frames(t=1)
    p1, p2 = frames.pc1[:, 0], frames.pc2[:, 0]
    f1 = torch.randn((B, N, 128), generator=gen)
    f2 = f1 + 0.3 * torch.randn((B, N, 128), generator=gen)
    eps, gamma = torch.tensor([0.08]), torch.tensor([1.0])
    launches = fused_transport.transport_flow.launches
    for iters in (1, 3):
        got = sinkhorn.unbalanced_transport_flow(f1, f2, p1, p2, eps, gamma,
                                                 iters, 10.0)
        n1 = f1 / torch.sqrt(torch.sum(f1 ** 2, -1, keepdim=True) + 1e-8)
        n2 = f2 / torch.sqrt(torch.sum(f2 ** 2, -1, keepdim=True) + 1e-8)
        twin = fused_transport.transport_flow_reference(
            n1, n2, p1, p2, eps, gamma / (gamma + eps), iters, 100.0,
            rows=48)
        assert (twin - got).abs().max().item() <= FLOW_TOL
        for s in range(B):
            want = ref.transport_flow(f1[s], f2[s], p1[s], p2[s], eps, gamma,
                                      iters, 10.0)
            gap = (got[s] - want).abs().max().item()
            assert gap <= FLOW_TOL, (iters, gap)
    assert fused_transport.transport_flow.launches == launches


def test_support_keeps_mass_within_ten_metres():
    """A point whose only twin lies 20 m away keeps no mass there: its
    flow is the plan's barycentre of what lies within 10 m."""
    p1 = torch.tensor([[[0.0, 0.0, 0.0], [50.0, 0.0, 0.0]]])
    p2 = torch.tensor([[[20.0, 0.0, 0.0], [50.0, 3.0, 0.0]]])
    f = torch.eye(4)[:2].reshape(1, 2, 4).repeat(1, 1, 2)
    flow = sinkhorn.unbalanced_transport_flow(
        f, f, p1, p2, torch.tensor([0.08]), torch.tensor([1.0]), 1, 10.0)
    # point 0 has nothing within 10 m: no mass, flow = 0 / 1e-8 - p;
    # point 1's barycentre is its one neighbour 3 m off (to the rounding of
    # a row sum against its 1e-8)
    assert torch.equal(flow[0, 0], torch.zeros(3))
    assert torch.allclose(flow[0, 1], torch.tensor([0.0, 3.0, 0.0]),
                          atol=1e-5)


def test_model_from_config_builds_flot():
    cfg = load_config(ROOT / "configs" / "flot_8192.yaml")
    model = model_from_config(cfg, device="cpu")
    assert isinstance(model, FLOT)
    assert (model.nb_neighbors, model.nb_iter, model.support_m) == (32, 1,
                                                                    10.0)
    widths = [model.feat_conv1.fc1.weight.shape,
              model.feat_conv1.fc2.weight.shape,
              model.feat_conv3.fc1.weight.shape,
              model.feat_conv3.fc2.weight.shape]
    assert widths == [(32, 6), (64, 32), (128, 67), (256, 128)]
    assert not model.training
    with pytest.raises(NotImplementedError, match="float32"):
        model_from_config(cfg.replace(dtype="bfloat16"), device="cpu")


def test_an_invalid_point_raises():
    frames = _frames(t=2)
    mask1 = frames.mask1.clone()
    mask1[1, 1, 7] = False
    with pytest.raises(ValueError, match="valid"):
        make_scan_flow_step_cached(_model())(frames._replace(mask1=mask1))


# (query points, candidate points) of RaTrack's kNN calls through knn_auto:
# three_nn's feature propagation (k = 3) at 512 and at 8192 points, and the
# train correlator's selection (k = 16) at 512 and at 8192 points
RATRACK_CALLS = [(3, 512, 512), (3, 8192, 512), (3, 8192, 128),
                 (3, 2048, 512), (16, 512, 512), (16, 8192, 8192),
                 (16, 2048, 2048), (16, 4096, 1024), (16, 4097, 1024)]


@pytest.mark.parametrize("k,n,m", RATRACK_CALLS)
def test_knn_auto_routes_ratracks_k_as_before(k, n, m, monkeypatch):
    """The route is the dense `knn` up to KNN_DENSE_LIMIT pairs and B5
    above it, for k <= 16 as before B5's list went to 32 (raising the
    depth changes the route of 16 < k <= 32 only, which no RaTrack path
    asks for)."""
    taken = []
    monkeypatch.setattr(neighborhood, "knn",
                        lambda *a, **kw: taken.append("dense") or (None, None))
    monkeypatch.setattr(fused_knn, "knn_tiled",
                        lambda *a, **kw: taken.append("tiled") or (None, None))
    neighborhood.knn_auto(k, torch.zeros(1, n, 3), torch.zeros(1, m, 3))
    before = "tiled" if n * m > neighborhood.KNN_DENSE_LIMIT and k <= 16 \
        else "dense"
    assert taken == [before]


def test_knn_auto_takes_b5_for_flots_graph(monkeypatch):
    taken = []
    monkeypatch.setattr(fused_knn, "knn_tiled",
                        lambda *a, **kw: taken.append(a[0]) or (None, None))
    neighborhood.knn_auto(32, torch.zeros(1, 8192, 3), torch.zeros(1, 8192, 3))
    assert taken == [32]


def test_benchmark_reference_equals_this_one():
    """perfbench/reference/flot.py, the benchmark's frozen copy, gives this
    reference's outputs bit for bit on one seeded input."""
    sys.path.insert(0, str(ROOT))
    from perfbench.reference import flot as bench_ref
    model, frames = _model(seed=9), _frames(t=1, b=1)
    w = model.state_dict()
    got = bench_ref.frame(w, frames.pc1[0, 0], frames.pc2[0, 0], MODEL)
    want = ref.frame(w, frames.pc1[0, 0], frames.pc2[0, 0], MODEL)
    for key in ("flow", "ot_flow"):
        assert torch.equal(got[key], want[key]), key


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flot_clouds(seed, b=8, n=8192):
    """The FLOT cell's clouds: every point valid, 5 objects of 12 points."""
    fr = _frames(n=n, b=b, t=1, seed=seed)
    return fr.pc1[:, 0].contiguous(), fr.pc2[:, 0].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
def test_knn_tiled_k32_matches_twin(device, sort):
    """B5 at k = 32 on 8 x 8192 points (the graph FLOT builds), unsorted
    and Z-sorted: indices and keys exactly the twin's."""
    pc, _ = _flot_clouds(21)
    if sort:
        from ratrack_tpu_torch.ops.morton import morton_perm
        from ratrack_tpu_torch.ops.sampling import gather
        pc = gather(pc, morton_perm(pc, torch.ones(pc.shape[:2],
                                                   dtype=torch.bool)))
    pc = pc.to(device)
    idx, keys, valid = fused_knn.knn_indices_tiled(pc, pc, k=32,
                                                   return_keys=True)
    ridx, rkeys, rvalid = fused_knn.knn_indices_tiled_reference(pc, pc, k=32)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx)
    assert torch.equal(keys, rkeys) and torch.equal(valid, rvalid)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 2])
def test_transport_kernel_matches_twin(device, iters):
    p1, p2 = (x.to(device) for x in _flot_clouds(23))
    gen = torch.Generator().manual_seed(24)
    f1 = torch.randn((8, 8192, 128), generator=gen)
    f2 = f1 + 0.3 * torch.randn((8, 8192, 128), generator=gen)
    f1, f2 = (x.to(device) for x in (f1, f2))
    eps = torch.tensor([0.08], device=device)
    gamma = torch.tensor([1.0], device=device)
    before = fused_transport.transport_flow.launches
    got = sinkhorn.unbalanced_transport_flow(f1, f2, p1, p2, eps, gamma,
                                             iters, 10.0)
    assert fused_transport.transport_flow.launches == before + 1
    n1 = f1 / torch.sqrt(torch.sum(f1 ** 2, -1, keepdim=True) + 1e-8)
    n2 = f2 / torch.sqrt(torch.sum(f2 ** 2, -1, keepdim=True) + 1e-8)
    twin = fused_transport.transport_flow_reference(
        n1, n2, p1, p2, eps, gamma / (gamma + eps), iters, 100.0)
    torch.cuda.synchronize()
    gap = (got - twin).abs().max().item()
    assert gap <= KERNEL_FLOW_TOL, gap
    assert twin.abs().max().item() > 0.1


@pytest.mark.cuda
def test_transport_refuses_grad_inputs_on_the_card(device):
    """B11 is primal only: on the card a grad input raises, and nothing
    takes the plain twin in its place."""
    p1, p2 = (x[:1, :256].contiguous().to(device)
              for x in _flot_clouds(25, b=1))
    f = torch.randn((1, 256, 128), device=device, requires_grad=True)
    one = torch.tensor([1.0], device=device)
    before = fused_transport.transport_flow.launches
    with pytest.raises(RuntimeError, match="primal only"):
        sinkhorn.unbalanced_transport_flow(f, f.detach(), p1, p2, one, one,
                                           1, 10.0)
    assert fused_transport.transport_flow.launches == before


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def knn_depth16_digests(device) -> dict:
    """Digests of B5's k <= 16 selections (indices and keys, every launch
    shape) and of B3's selection launch on fixed seeded clouds."""
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_correlator
    out = {}
    pc1, m1, pc2, m2 = cases.stretch_clouds(31, 8192)
    for stage in (1, 2):
        kw = cases.to_device(cases.knn_tiled_case(stage, pc1, m1, pc2, m2),
                             device)
        for k in (3, 16):
            for shape in ((8, 128), (8, 256), (16, 256), (32, 512)):
                idx, keys, _ = fused_knn.knn_indices_tiled(
                    kw["query"], kw["points"], kw["points_mask"], k=k,
                    return_keys=True, shape=shape)
                out[f"knn_tiled.stage{stage}.k{k}.{shape[0]}x{shape[1]}"] = (
                    _sha(idx, keys))
    pc1, m1, pc2, m2 = cases.clouds(32, 4)
    for stage in (1, 2):
        kw = cases.to_device(cases.corr_case(stage, pc1, m1, pc2, m2,
                                             torch.Generator().manual_seed(0)),
                             device)
        idx = fused_correlator.launch_knn(kw["query"], kw["points"],
                                          kw["mask_p"], 16)
        out[f"knn_staged.stage{stage}"] = _sha(idx)
    torch.cuda.synchronize()
    return out


# knn_depth16_digests on the tree before the list took depth 32 (NVIDIA
# H100 80GB HBM3, 700 W); the same on every launch shape
DEPTH16_DIGESTS = {
    "knn_staged.stage1": "beaea36da89af4a8",
    "knn_staged.stage2": "f4a820c5231750aa",
    **{f"knn_tiled.stage{s}.k{k}.{shape}": digest
       for (s, k), digest in {(1, 16): "7f77d2f56a8af807",
                              (1, 3): "5227dffb6024b426",
                              (2, 16): "a62f53c761191ac6",
                              (2, 3): "b219a5ff53261d01"}.items()
       for shape in ("8x128", "8x256", "16x256", "32x512")},
}


@pytest.mark.cuda
def test_depth16_selections_are_unchanged(device):
    assert knn_depth16_digests(device) == DEPTH16_DIGESTS


@pytest.mark.cuda
def test_scan_on_the_card_takes_b5_and_b11(device):
    """At 8192 points the graph goes to B5 and the transport to B11, never
    to the transport's twin; the flow matches the CPU's scan at 2 streams
    x 2 frames within FLOW_TOL."""
    frames = _frames(n=8192, b=2, t=2, seed=41)
    cpu = make_scan_flow_step_cached(_model())(frames)
    before = (fused_knn.knn_indices_tiled.launches,
              fused_transport.transport_flow.launches)
    got = make_scan_flow_step_cached(_model(device=device))(
        FrameBatch(*[x.to(device) for x in frames]))
    torch.cuda.synchronize()
    assert fused_knn.knn_indices_tiled.launches == before[0] + 3
    assert fused_transport.transport_flow.launches == before[1] + 2
    for key in ("flow", "ot_flow"):
        gap = (got[key].cpu() - cpu[key]).abs().max().item()
        assert gap <= FLOW_TOL, (key, gap)
