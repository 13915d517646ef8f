"""Card-only tests: each CUDA kernel of ratrack_tpu_torch against its plain
PyTorch version on the same CUDA tensors.

Marked `cuda`; every test skips without a CUDA device (decided in the
`device` fixture, never at import). The repository's tests/conftest.py
imports JAX, which the GPU machine does not have, so run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| + 1e-5 (float32 sums
in another order; TF32 off); selected indices must match exactly (both
sides compute distances with the same rounded elementwise ops). The train
kernels' gradients (kernels.cases.compare_train): cosine with the plain
version >= 0.9999, and in norm no further from the plain version run in
float64 than 1e-3 of its norm plus twice the float32 plain version's
distance (the max-pools make the gradient ill-conditioned;
compare_train says by how much). The stretch kernels: B5 and B6 select
identical indices; B4 within the tolerance above; B7's potentials within
1e-4 absolute on the valid rows (another summation order, a few ulps an
iteration). The bfloat16 instantiations of B1, B1', B2, B3 and B4 against
their plain versions at compute_dtype=bfloat16: indices equal, values
within one bfloat16 step of the largest (2^-8 * max |plain| + 1e-5: both
multiply the same rounded operands exactly, but a float32 sum in another
order can round the next layer's operand to the neighbouring bfloat16).
The float32 eval kernels' outputs are bit for bit those the tree before
the bfloat16 instantiations gave (`kernels/digest.py`). A bfloat16 train
step launches the float32 train kernels as often as a float32 one and is
held to the CPU's float32 step by twice the CPU's own bfloat16 error
(tests/test_torch_port_bf16_train.py says why).
"""

import ctypes
import math
import re

import numpy as np
import pytest
import torch

from ratrack_tpu_torch.kernels import build as kb
from ratrack_tpu_torch.kernels import cases
from ratrack_tpu_torch.ops import (fused_correlator, fused_correlator_train,
                                   fused_fp, fused_knn, fused_sa,
                                   fused_sa_train, fused_sinkhorn, sampling)
from ratrack_tpu_torch.ops.neighborhood import knn, square_distance
from ratrack_tpu_torch.tracker.dbscan import (KERNEL_POINTS, dbscan,
                                              dbscan_labels, dbscan_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want):
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item() + 1e-5
    assert err <= tol, (err, tol)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("head", ["pn_head", "mse"])
@pytest.mark.parametrize("level", ["sa1", "sa2", "sa3"])
def test_sa_pair_matches_plain(device, level, head):
    pc1, m1, _, _ = cases.clouds(0, 4)
    kw = cases.to_device(cases.sa_case(level, head, pc1, m1, _gen()), device)
    oa, ob, ia, ib = fused_sa.sa_pair(**kw, return_indices=True)
    ra, rb, ja, jb = fused_sa.sa_pair_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(ia.long(), ja) and torch.equal(ib.long(), jb)
    _assert_close(oa, ra)
    _assert_close(ob, rb)


@pytest.mark.parametrize("n_valid", [0, 1, 5])
def test_sa_pair_no_hit_and_short_slots(device, n_valid):
    """No valid point: every center pools the pair (i, point 0); few valid
    points: most slot lists stay short."""
    pc1, _, _, _ = cases.clouds(1, 2)
    mask = (torch.arange(pc1.shape[1]) < n_valid).expand(2, -1).contiguous()
    kw = cases.to_device(cases.sa_case("sa1", "pn_head", pc1, mask, _gen(1)),
                         device)
    oa, ob, ia, ib = fused_sa.sa_pair(**kw, return_indices=True)
    ra, rb, ja, jb = fused_sa.sa_pair_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(ia.long(), ja) and torch.equal(ib.long(), jb)
    _assert_close(oa, ra)
    _assert_close(ob, rb)


@pytest.mark.parametrize("level", ["fp3", "fp2", "fp1"])
def test_fp_matches_plain(device, level):
    pc1, m1, _, _ = cases.clouds(2, 4)
    kw = cases.to_device(cases.fp_case(level, pc1, m1, _gen(2)), device)
    out, idx = fused_fp.fused_three_interpolate(**kw, return_indices=True)
    ref, ridx = fused_fp.three_interpolate_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ridx)
    _assert_close(out, ref)


@pytest.mark.parametrize("n_valid", [0, 2, 200])
def test_fp_known_mask(device, n_valid):
    """< 3 valid known points repeat the nearest; none valid gives index 0
    with uniform weights."""
    pc1, m1, _, _ = cases.clouds(3, 2)
    kw = cases.to_device(cases.fp_case("fp1", pc1, m1, _gen(3)), device)
    n = pc1.shape[1]
    kw["known_mask"] = (torch.arange(n, device=device) < n_valid).expand(
        2, -1).contiguous()
    out, idx = fused_fp.fused_three_interpolate(**kw, return_indices=True)
    ref, ridx = fused_fp.three_interpolate_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ridx)
    _assert_close(out, ref)


@pytest.mark.parametrize("stage", [1, 2])
def test_correlator_matches_plain(device, stage):
    pc1, m1, pc2, m2 = cases.clouds(4, 4)
    kw = cases.to_device(cases.corr_case(stage, pc1, m1, pc2, m2, _gen(4)),
                         device)
    out, idx = fused_correlator.fused_knn_weight_aggregate(
        **kw, return_indices=True)
    ref, ridx = fused_correlator.knn_weight_aggregate_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ridx)
    _assert_close(out, ref)


@pytest.mark.parametrize("n_valid", [0, 5])
def test_correlator_few_valid(device, n_valid):
    """< 16 valid candidates: slots repeat the nearest (feature AND
    direction, as the sum counts duplicates); none valid: index 0."""
    pc1, m1, pc2, _ = cases.clouds(5, 2)
    n = pc1.shape[1]
    m2 = (torch.arange(n) < n_valid).expand(2, -1).contiguous()
    kw = cases.to_device(cases.corr_case(1, pc1, m1, pc2, m2, _gen(5)),
                         device)
    out, idx = fused_correlator.fused_knn_weight_aggregate(
        **kw, return_indices=True)
    ref, ridx = fused_correlator.knn_weight_aggregate_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ridx)
    _assert_close(out, ref)


def test_wrappers_raise_on_what_the_kernels_do_not_take(device):
    pc1, m1, pc2, m2 = cases.clouds(6, 2)
    kw = cases.to_device(cases.fp_case("fp2", pc1, m1, _gen(6)), device)
    with pytest.raises(TypeError):
        fused_fp.fused_three_interpolate(kw["unknown"].double(), kw["known"],
                                         kw["feats"])
    with pytest.raises(ValueError):
        fused_fp.fused_three_interpolate(
            kw["unknown"], kw["known"],
            kw["feats"].transpose(1, 2).contiguous().transpose(1, 2))
    ck = cases.to_device(cases.corr_case(2, pc1, m1, pc2, m2, _gen(6)),
                         device)
    with pytest.raises(ValueError):
        fused_correlator.fused_knn_weight_aggregate(**ck, k=8)


def test_launch_counters_count_only_kernel_launches(device):
    pc1, m1, _, _ = cases.clouds(7, 2)
    kw = cases.fp_case("fp3", pc1, m1, _gen(7))
    before = fused_fp.fused_three_interpolate.launches
    fused_fp.fused_three_interpolate(**kw)                 # CPU: plain
    assert fused_fp.fused_three_interpolate.launches == before
    fused_fp.fused_three_interpolate(**cases.to_device(kw, device))
    assert fused_fp.fused_three_interpolate.launches == before + 1


def test_track4d_gpu_matches_cpu(device):
    """Two streams x 3 frames of the cached eval scan on the card against
    the same weights and inputs on the CPU (plain versions)."""
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, to_tensors
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    n, k = 128, 8
    clips = [stack_frames(synthetic_clip(s, 3, n_max=n, g_max=k,
                                         n_static=60, n_objects=3))
             for s in range(2)]
    frames = stack_frames(clips)
    model = Track4D(npoint=n, k_max=k, sinkhorn_iters=50,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    scan = make_scan_eval_step_cached(model)
    _, cpu = scan(init_state(2, k, device="cpu"), to_tensors(frames, "cpu"))
    model.to(device)
    _, gpu = scan(init_state(2, k, device=device), to_tensors(frames, device))
    for key in ("cls", "warp"):
        np.testing.assert_allclose(gpu[key].cpu().numpy(), cpu[key].numpy(),
                                   atol=1e-3)
    labels_bad = (gpu["labels"].cpu() != cpu["labels"]).float().mean().item()
    assert labels_bad <= 0.01, labels_bad


def test_ragged_shapes(device):
    """Sizes that fill no warp, block or 32-point scan step evenly:
    3 streams, 333 candidate points, 77 centers / queries."""
    gen = _gen(8)
    b, n, m = 3, 333, 77

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(device)

    pts = rnd(b, n, 3, scale=4.0)
    qry = pts[:, :m].contiguous()
    mask = (torch.rand((b, n), generator=gen) > 0.3).to(device)
    rest_a = [(rnd(32, 32, scale=0.2), rnd(32, scale=0.1))]
    rest_b = [(rnd(32, 64, scale=0.2), rnd(64, scale=0.1))]
    kw = dict(xyz=pts, centers=qry, mask=mask, p1a=rnd(b, n, 32),
              cwa=rnd(b, m, 32), rest_a=rest_a, p1b=rnd(b, n, 32),
              cwb=rnd(b, m, 32), rest_b=rest_b, radius_a=2.0, radius_b=4.0,
              nsample_a=8, nsample_b=16)
    oa, ob, ia, ib = fused_sa.sa_pair(**kw, return_indices=True)
    ra, rb, ja, jb = fused_sa.sa_pair_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(ia.long(), ja) and torch.equal(ib.long(), jb)
    _assert_close(oa, ra)
    _assert_close(ob, rb)

    fkw = dict(unknown=qry, known=pts, feats=rnd(b, n, 96), known_mask=mask)
    out, idx = fused_fp.fused_three_interpolate(**fkw, return_indices=True)
    ref, ridx = fused_fp.three_interpolate_reference(**fkw)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ridx)
    _assert_close(out, ref)

    c = 256
    ckw = dict(query=qry, points=pts, feats_p=rnd(b, n, c),
               add_q=rnd(b, m, c), mask_p=mask,
               mlp_ws=[rnd(c, c, scale=c ** -0.5) for _ in range(2)],
               mlp_bs=[rnd(c, scale=0.1) for _ in range(2)],
               wn_ws=[rnd(3, 8), rnd(8, 8, scale=0.3), rnd(8, c, scale=0.3)],
               wn_bs=[rnd(8, scale=0.1), rnd(8, scale=0.1),
                      rnd(c, scale=0.1)])
    out, idx = fused_correlator.fused_knn_weight_aggregate(
        **ckw, return_indices=True)
    ref, ridx = fused_correlator.knn_weight_aggregate_reference(**ckw)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ridx)
    _assert_close(out, ref)


def _corr_train_kernel(**kw):
    return fused_correlator_train.fused_knn_weight_aggregate_train(
        **kw, return_indices=True)


def _assert_train_match(run, fn_kernel, fn_plain, kw, cancelling=None):
    want = run(fn_plain, kw)
    want64 = run(fn_plain, cases.to_float64(kw))
    bad, _ = cases.compare_train(run(fn_kernel, kw), want, want64,
                                 cancelling)
    torch.cuda.synchronize()
    assert not bad, bad


@pytest.mark.parametrize("head", ["pn_head", "mse"])
@pytest.mark.parametrize("level", ["sa1", "sa2", "sa3"])
def test_sa_pair_train_matches_plain(device, level, head):
    pc1, m1, _, _ = cases.clouds(10, 4)
    kw = cases.to_device(cases.sa_train_case(level, head, pc1, m1, _gen(10)),
                         device)
    _assert_train_match(cases.sa_train_run, fused_sa_train.sa_pair_train,
                        fused_sa_train.sa_pair_train_reference, kw)


@pytest.mark.parametrize("n_valid", [0, 1, 5])
def test_sa_pair_train_no_hit_and_short_slots(device, n_valid):
    """Centers at every cloud row, n_valid valid points: centers far from
    them have no hit and pool point 0 in every slot; the rest have short
    slot lists padded with the first hit (ties in the max-pool). With fewer
    than 2 valid points every slot is point 0, so dPF is one row that
    cancels to 0 (see compare_train)."""
    pc1, _, _, _ = cases.clouds(11, 2)
    mask = (torch.arange(pc1.shape[1]) < n_valid).expand(2, -1).contiguous()
    kw = cases.to_device(cases.sa_train_case("sa1", "pn_head", pc1, mask,
                                             _gen(11), centers=pc1), device)
    cancelling = ({"pfa": "wxyz_a", "pfb": "wxyz_b"} if n_valid < 2
                  else None)
    _assert_train_match(cases.sa_train_run, fused_sa_train.sa_pair_train,
                        fused_sa_train.sa_pair_train_reference, kw,
                        cancelling)


@pytest.mark.parametrize("stage", [1, 2])
def test_correlator_train_matches_plain(device, stage):
    pc1, m1, pc2, m2 = cases.clouds(12, 4)
    kw = cases.to_device(cases.corr_train_case(stage, pc1, m1, pc2, m2,
                                               _gen(12)), device)
    _assert_train_match(
        cases.corr_train_run, _corr_train_kernel,
        fused_correlator_train.knn_weight_aggregate_train_reference, kw)


@pytest.mark.parametrize("n_valid", [0, 1, 5])
def test_correlator_train_few_valid(device, n_valid):
    """< 16 valid candidates: slots repeat the nearest, so the scatters add
    several slots into one point; none valid: every slot is point 0."""
    pc1, m1, pc2, _ = cases.clouds(13, 2)
    m2 = (torch.arange(pc1.shape[1]) < n_valid).expand(2, -1).contiguous()
    kw = cases.to_device(cases.corr_train_case(1, pc1, m1, pc2, m2,
                                               _gen(13)), device)
    _assert_train_match(
        cases.corr_train_run, _corr_train_kernel,
        fused_correlator_train.knn_weight_aggregate_train_reference, kw)


def test_train_ragged_shapes(device):
    """3 streams, 333 points, 77 centers / queries: no tile, chunk or block
    is full."""
    gen = _gen(14)
    b, n, m = 3, 333, 77
    pts = (4.0 * torch.randn((b, n, 3), generator=gen))
    qry = pts[:, :m].contiguous()
    mask = torch.rand((b, n), generator=gen) > 0.3
    kw = dict(xyz=pts, centers=qry, mask=mask,
              pfa=torch.randn((b, n, 32), generator=gen),
              wxyz_a=torch.randn((3, 32), generator=gen),
              ws_a=[0.2 * torch.randn((32, 32), generator=gen)],
              gammas_a=[0.5 + torch.rand(32, generator=gen)] * 2,
              betas_a=[0.1 * torch.randn(32, generator=gen)] * 2,
              pfb=torch.randn((b, n, 16), generator=gen),
              wxyz_b=torch.randn((3, 16), generator=gen),
              ws_b=[0.2 * torch.randn((16, 64), generator=gen)],
              gammas_b=[0.5 + torch.rand(16, generator=gen),
                        0.5 + torch.rand(64, generator=gen)],
              betas_b=[0.1 * torch.randn(16, generator=gen),
                       0.1 * torch.randn(64, generator=gen)],
              radius_a=2.0, radius_b=4.0, nsample_a=8, nsample_b=24)
    _assert_train_match(cases.sa_train_run, fused_sa_train.sa_pair_train,
                        fused_sa_train.sa_pair_train_reference,
                        cases.to_device(kw, device))
    c = 256
    ckw = dict(query=qry, points=pts,
               feats_p=torch.randn((b, n, c), generator=gen),
               add_q=torch.randn((b, m, c), generator=gen), mask_p=mask,
               mlp_ws=[torch.randn((c, c), generator=gen) / 16
                       for _ in range(2)],
               mlp_bs=[0.1 * torch.randn(c, generator=gen) for _ in range(2)],
               wn_ws=[torch.randn((3, 8), generator=gen),
                      0.3 * torch.randn((8, 8), generator=gen),
                      0.3 * torch.randn((8, c), generator=gen)],
               wn_bs=[0.1 * torch.randn(8, generator=gen),
                      0.1 * torch.randn(8, generator=gen),
                      0.1 * torch.randn(c, generator=gen)],
               w_dir=0.05 * torch.randn((3, c), generator=gen))
    _assert_train_match(
        cases.corr_train_run, _corr_train_kernel,
        fused_correlator_train.knn_weight_aggregate_train_reference,
        cases.to_device(ckw, device))


def test_train_wrappers_raise_on_what_the_kernels_do_not_take(device):
    pc1, m1, pc2, m2 = cases.clouds(15, 2)
    kw = cases.to_device(cases.sa_train_case("sa2", "pn_head", pc1, m1,
                                             _gen(15)), device)
    with pytest.raises(ValueError):         # scales of unequal depth
        fused_sa_train.sa_pair_train(**{**kw, "ws_b": [], "gammas_b":
                                        kw["gammas_b"][:1],
                                        "betas_b": kw["betas_b"][:1]})
    with pytest.raises(ValueError):         # nsample above 32
        fused_sa_train.sa_pair_train(**{**kw, "nsample_b": 33})
    with pytest.raises(TypeError):
        fused_sa_train.sa_pair_train(**{**kw, "pfa": kw["pfa"].double()})
    ck = cases.to_device(cases.corr_train_case(1, pc1, m1, pc2, m2,
                                               _gen(15)), device)
    with pytest.raises(ValueError):
        fused_correlator_train.fused_knn_weight_aggregate_train(**ck, k=8)
    with pytest.raises(ValueError):         # w_dir without add_q
        fused_correlator_train.fused_knn_weight_aggregate_train(
            **{**ck, "add_q": None})


def test_train_launch_counters_count_only_kernel_launches(device):
    pc1, m1, pc2, m2 = cases.clouds(16, 2)
    kw = cases.corr_train_case(2, pc1, m1, pc2, m2, _gen(16))
    fwd = fused_correlator_train.knn_weight_aggregate_train_fwd
    bwd = fused_correlator_train.knn_weight_aggregate_train_bwd
    f0, b0 = fwd.launches, bwd.launches
    cases.corr_train_run(_corr_train_kernel, kw)              # CPU: plain
    assert (fwd.launches, bwd.launches) == (f0, b0)
    cases.corr_train_run(_corr_train_kernel, cases.to_device(kw, device))
    assert (fwd.launches, bwd.launches) == (f0 + 1, b0 + 1)
    skw = cases.sa_train_case("sa3", "mse", pc1, m1, _gen(16))
    sf, sb = fused_sa_train.sa_pair_train_fwd, fused_sa_train.sa_pair_train_bwd
    f0, b0 = sf.launches, sb.launches
    cases.sa_train_run(fused_sa_train.sa_pair_train, skw)
    assert (sf.launches, sb.launches) == (f0, b0)
    cases.sa_train_run(fused_sa_train.sa_pair_train,
                       cases.to_device(skw, device))
    assert (sf.launches, sb.launches) == (f0 + 1, b0 + 1)


def test_train_step_all_padding_stream_keeps_gradients_finite(device):
    """The counterpart of tests/test_train.py's all-padding-stream test on
    the card: one real stream beside an empty one (every point padding);
    the empty stream's loss is 0 and every gradient and updated parameter
    stays finite. Also counts one frame step's train launches: 3 PNHeads
    x 3 SA levels and 2 correlator stages, forward and backward, and no
    eval kernel."""
    from ratrack_tpu_torch.data import (empty_frame, stack_frames,
                                        synthetic_clip, to_tensors)
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_train_step)

    n, k = 128, 8
    real = synthetic_clip(0, 1, n_max=n, g_max=k, n_static=60,
                          n_objects=3)[0]
    frame = to_tensors(stack_frames([real, empty_frame(n, k)]), device)
    model = Track4D(npoint=n, k_max=k, sinkhorn_iters=20,
                    generator=torch.Generator().manual_seed(0), device=device)
    ts = create_train_state(model, TrainConfig(), steps_per_epoch=10,
                            device=device)
    counters = [fused_sa_train.sa_pair_train_fwd,
                fused_sa_train.sa_pair_train_bwd,
                fused_correlator_train.knn_weight_aggregate_train_fwd,
                fused_correlator_train.knn_weight_aggregate_train_bwd,
                fused_sa.sa_pair, fused_fp.fused_three_interpolate,
                fused_correlator.fused_knn_weight_aggregate]
    before = [c.launches for c in counters]
    _, items = make_train_step(ts)(init_state(2, k, device=device), frame,
                                   False)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [9, 9, 2, 2, 0, 0, 0]
    assert float(items["Loss"][1]) == 0.0
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


# ---- the stretch kernels: B5, B4, B6, B7 --------------------------------

def _stretch_clouds(seed, n, n_valid=None):
    """One stream of n points; n_valid: keep only that many valid."""
    pc1, m1, pc2, m2 = cases.stretch_clouds(seed, n)
    if n_valid is not None:
        keep = torch.arange(n) < n_valid
        m1, m2 = m1 & keep, m2 & keep
    return pc1, m1, pc2, m2


@pytest.mark.parametrize("n,n_valid", [(1024, None), (1500, None),
                                       (1024, 5), (1024, 0), (2048, 16)])
@pytest.mark.parametrize("stage", [1, 2])
def test_knn_tiled_matches_plain(device, stage, n, n_valid):
    """Several candidate chunks, a ragged last chunk (1500), fewer than 16
    and no valid candidates, exactly 16."""
    kw = cases.to_device(cases.knn_tiled_case(
        stage, *_stretch_clouds(10, n, n_valid)), device)
    idx, keys, valid = fused_knn.knn_indices_tiled(**kw, return_keys=True)
    ridx, rkeys, rvalid = fused_knn.knn_indices_tiled_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(valid, rvalid)
    assert torch.equal(keys, rkeys)       # the same rounded operations


def test_knn_tiled_ties_go_to_the_lowest_index(device):
    """Grid-snapped clouds, 3 streams, no mask, k = 3 and 16: many exactly
    equal distances."""
    gen = _gen(11)
    q = torch.round(4 * torch.randn((3, 700, 3), generator=gen)).to(device)
    p = torch.round(4 * torch.randn((3, 1300, 3), generator=gen)).to(device)
    for k in (3, 16):
        idx = fused_knn.knn_indices_tiled(q, p, None, k=k)
        ridx = fused_knn.knn_indices_tiled_reference(q, p, None, k=k)[0]
        assert torch.equal(idx, ridx)
        assert torch.equal(idx, ops_knn(k, q, p)[1])


def ops_knn(k, q, p):
    from ratrack_tpu_torch.ops.neighborhood import knn
    return knn(k, q, p)


@pytest.mark.parametrize("stage", [1, 2])
def test_knn_gather_apply_matches_plain(device, stage):
    kw = cases.to_device(cases.apply_case(
        stage, *_stretch_clouds(12, 1024), _gen(12)), device)
    out = fused_correlator.knn_gather_apply(**kw)
    ref = fused_correlator.knn_gather_apply_reference(**kw)
    torch.cuda.synchronize()
    _assert_close(out, ref)


def test_knn_gather_apply_fewer_queries_than_candidates(device):
    """N != M: 300 queries into 1024 candidates."""
    kw = cases.apply_case(1, *_stretch_clouds(13, 1024), _gen(13))
    for key in ("query", "add_q", "idx"):
        kw[key] = kw[key][:, :300].contiguous()
    kw = cases.to_device(kw, device)
    out = fused_correlator.knn_gather_apply(**kw)
    ref = fused_correlator.knn_gather_apply_reference(**kw)
    torch.cuda.synchronize()
    assert out.shape == (1, 300, 256)
    _assert_close(out, ref)


@pytest.mark.parametrize("n,npoint,n_valid", [
    (8192, 512, None), (2048, 512, 40), (1000, 64, None), (512, 512, -1),
    (640, 32, 1), (640, 32, 0), (16384, 128, None)])
def test_fps_matches_plain(device, n, npoint, n_valid):
    """n_valid None: the cloud's own mask; -1: no mask (a permutation at
    npoint == n); 40 / 1 / 0: npoint above the valid count, one valid
    point, none. 3 streams."""
    gen = _gen(n + npoint)
    xyz = (20 * torch.randn((3, n, 3), generator=gen)).to(device)
    if n_valid == -1:
        mask = None
    elif n_valid is None:
        mask = (torch.rand((3, n), generator=gen) > 0.4).to(device)
    else:
        mask = torch.zeros((3, n), dtype=torch.bool)
        for s in range(3):
            mask[s, torch.randperm(n, generator=gen)[:n_valid]] = True
        mask = mask.to(device)
    got = sampling.furthest_point_sample(xyz, npoint, mask)
    want = sampling.furthest_point_sample_reference(xyz, npoint, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if n_valid == -1:
        assert sorted(got[0].tolist()) == list(range(n))


@pytest.mark.parametrize("n,npoint", [(4096, 300), (16384, 200), (700, 700)])
def test_fps_first_maximum_on_exact_ties(device, n, npoint):
    """Coordinates on a coarse integer grid: many points coincide and many
    distances are exactly equal, within one thread's points too (4 and 16
    points a thread at 4096 and 16384), so the choice of the FIRST index of
    the maximum decides most samples; half the points are masked out."""
    gen = _gen(n)
    xyz = torch.round(2 * torch.randn((2, n, 3), generator=gen)).to(device)
    mask = (torch.rand((2, n), generator=gen) > 0.5).to(device)
    for m in (mask, None):
        got = sampling.furthest_point_sample(xyz, npoint, m)
        want = sampling.furthest_point_sample_reference(xyz, npoint, m)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [33, 500, 4096, 8192, 16384])
def test_fps_launch_shapes_match_plain(device, n):
    """The kernel's own launch shape and every forced one that fits n (one
    block of few or many threads, clusters of 2, 4 and 8 blocks; at most 16
    points a thread) against the plain loop, masked and not: 33 and 500
    leave a warp ragged, 8192 and 16384 are the stretch clouds' sizes."""
    gen = _gen(n)
    xyz = (20 * torch.randn((3, n, 3), generator=gen)).to(device)
    mask = (torch.rand((3, n), generator=gen) > 0.4).to(device)
    npoint = min(n, 96)
    shapes = [None] + [sh for sh in ((32, 1), (128, 1), (1024, 1), (256, 2),
                                     (64, 4), (128, 8), (256, 8))
                       if n <= 16 * sh[0] * sh[1]]
    for m in (mask, None):
        want = sampling.furthest_point_sample_reference(xyz, npoint, m)
        for shape in shapes:
            got = sampling.furthest_point_sample(xyz, npoint, m, shape=shape)
            torch.cuda.synchronize()
            assert torch.equal(got, want), shape


def test_fps_refuses_a_shape_the_kernel_does_not_take(device):
    xyz = torch.randn((1, 4096, 3), device=device)
    for shape in ((100, 1), (128, 16), (1024, 4), (64, 1)):
        with pytest.raises(RuntimeError):   # threads % 32, blocks > 8, over
            sampling.furthest_point_sample(  # 64 warps, over 16 points
                xyz, 8, shape=shape)


@pytest.mark.parametrize("k,iters", [(32, 500), (8, 20), (100, 50)])
def test_sinkhorn_matches_plain(device, k, iters):
    kw, meta = cases.sinkhorn_case(14, 8, k, iters)
    kw, meta = cases.to_device(kw, device), cases.to_device(meta, device)
    u, v = fused_sinkhorn.sinkhorn_uv(**kw)
    ru, rv = fused_sinkhorn.sinkhorn_uv_reference(**kw)
    torch.cuda.synchronize()
    ar = torch.arange(k + 1, device=device)
    rows = (ar < meta["m"].unsqueeze(1)) | (ar == k)
    cols = (ar < meta["n"].unsqueeze(1)) | (ar == k)
    assert (u - ru)[rows].abs().max().item() <= 1e-4
    assert (v - rv)[cols].abs().max().item() <= 1e-4
    assert bool(torch.isfinite(u).all() and torch.isfinite(v).all())


def test_stretch_wrappers_raise_and_count(device):
    kw = cases.knn_tiled_case(1, *_stretch_clouds(15, 512))
    before = fused_knn.knn_indices_tiled.launches
    fused_knn.knn_indices_tiled(**kw)                      # CPU: plain
    assert fused_knn.knn_indices_tiled.launches == before
    kw = cases.to_device(kw, device)
    fused_knn.knn_indices_tiled(**kw)
    assert fused_knn.knn_indices_tiled.launches == before + 1
    with pytest.raises(ValueError):
        fused_knn.knn_indices_tiled(**{**kw,
                                       "k": fused_knn.KERNEL_K_MAX + 1})
    with pytest.raises(TypeError):
        sampling.furthest_point_sample(kw["query"].double(), 8)
    with pytest.raises(ValueError):
        sampling.furthest_point_sample(
            torch.zeros((1, 20000, 3), device=device), 8)
    c = torch.zeros((1, 3, 3), device=device, requires_grad=True)
    with pytest.raises(RuntimeError):
        fused_sinkhorn.sinkhorn_uv(c, torch.zeros((1, 3), device=device),
                                   torch.zeros((1, 3), device=device), 2)


def test_stretch_track4d_gpu_matches_cpu(device):
    """exact_fps + mov_budget + the Sinkhorn kernel at 1024 points, 256
    centers, one stream x 2 frames, the split correlator forced (its limit
    lowered): the card against the CPU's plain versions."""
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, to_tensors
    from ratrack_tpu_torch.models import Track4D, correlator
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    n, k = 1024, 8
    frames = stack_frames([stack_frames(synthetic_clip(
        0, 2, n_max=n, g_max=k, n_static=600, n_objects=4))])
    model = Track4D(npoint=256, k_max=k, sinkhorn_iters=50, exact_fps=True,
                    mov_budget=128, sinkhorn_kernel=True,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    scan = make_scan_eval_step_cached(model)
    limit = correlator.SPLIT_ABOVE
    correlator.SPLIT_ABOVE = 512
    try:
        _, cpu = scan(init_state(1, k, device="cpu"),
                      to_tensors(frames, "cpu"))
        model.to(device)
        counters = [fused_knn.knn_indices_tiled,
                    fused_correlator.knn_gather_apply,
                    sampling.furthest_point_sample,
                    fused_sinkhorn.sinkhorn_uv,
                    fused_correlator.fused_knn_weight_aggregate]
        before = [c.launches for c in counters]
        _, gpu = scan(init_state(1, k, device=device),
                      to_tensors(frames, device))
        torch.cuda.synchronize()
    finally:
        correlator.SPLIT_ABOVE = limit
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [4, 4, 15, 2, 0]
    for key in ("cls", "warp"):
        np.testing.assert_allclose(gpu[key].cpu().numpy(), cpu[key].numpy(),
                                   atol=1e-3)
    labels_bad = (gpu["labels"].cpu() != cpu["labels"]).float().mean().item()
    assert labels_bad <= 0.01, labels_bad


# ---- the one-scale kernels B1' and B8, and the general SA level ----------

LEVELS = sorted(cases.GENERAL_LEVELS)


def _assert_scale_matches(kw):
    out, idx = fused_sa.sa_scale(**kw, return_indices=True)
    ref, ridx = fused_sa.sa_scale_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ridx)
    _assert_close(out, ref)


@pytest.mark.parametrize("level", LEVELS)
def test_sa_scale_matches_plain(device, level):
    """Every scale of a one-scale level, a three-scale level and a pair of
    unequal depth, over a masked cloud."""
    pc1, m1, _, _ = cases.clouds(30, 4)
    for kw in cases.sa_scale_cases(level, pc1, m1, _gen(30)):
        _assert_scale_matches(cases.to_device(kw, device))


@pytest.mark.parametrize("n_valid", [0, 1, 5])
def test_sa_scale_no_hit_and_short_slots(device, n_valid):
    """No valid point: every center pools the pair (i, point 0); few valid
    points: most slot lists stay short."""
    pc1, _, _, _ = cases.clouds(31, 2)
    mask = (torch.arange(pc1.shape[1]) < n_valid).expand(2, -1).contiguous()
    for kw in cases.sa_scale_cases("three_scales", pc1, mask, _gen(31)):
        _assert_scale_matches(cases.to_device(kw, device))


def test_sa_scale_fewer_centers_than_points(device):
    """N != M with ragged sizes: 1100 points (700 valid), 130 centers."""
    pc, _, _, _ = cases.clouds(32, 2, 1100, n_static=600)
    mask = (torch.arange(1100) < 700).expand(2, -1).contiguous()
    for kw in cases.sa_scale_cases("mixed_depth", pc, mask, _gen(32),
                                   npoint=130):
        assert kw["centers"].shape == (2, 130, 3)
        _assert_scale_matches(cases.to_device(kw, device))


@pytest.mark.parametrize("level", ["sa1", "sa2", "sa3"])
def test_sa_pair_equals_two_sa_scales(device, level):
    """The pair kernel and two one-scale launches agree bit for bit."""
    pc1, m1, _, _ = cases.clouds(33, 4)
    kw = cases.to_device(cases.sa_case(level, "pn_head", pc1, m1, _gen(33)),
                         device)
    pair = fused_sa.sa_pair(**kw, return_indices=True)
    for t, single in enumerate(cases.split_sa_case(kw)):
        out, idx = fused_sa.sa_scale(**single, return_indices=True)
        assert torch.equal(out, pair[t]) and torch.equal(idx, pair[t + 2])


def _assert_scale_train_match(kw, cancelling=None):
    _assert_train_match(cases.sa_scale_train_run,
                        fused_sa_train.sa_scale_train,
                        fused_sa_train.sa_scale_train_reference, kw,
                        cancelling)


@pytest.mark.parametrize("level", LEVELS)
def test_sa_scale_train_matches_plain(device, level):
    pc1, m1, _, _ = cases.clouds(34, 4)
    for kw in cases.sa_scale_train_cases(level, pc1, m1, _gen(34)):
        _assert_scale_train_match(cases.to_device(kw, device))


@pytest.mark.parametrize("n_valid", [0, 1, 5])
def test_sa_scale_train_no_hit_and_short_slots(device, n_valid):
    """As test_sa_pair_train_no_hit_and_short_slots, per scale of the
    mixed-depth level."""
    pc1, _, _, _ = cases.clouds(35, 2)
    mask = (torch.arange(pc1.shape[1]) < n_valid).expand(2, -1).contiguous()
    cancelling = {"pf": "wxyz"} if n_valid < 2 else None
    for kw in cases.sa_scale_train_cases("mixed_depth", pc1, mask, _gen(35),
                                         centers=pc1):
        _assert_scale_train_match(cases.to_device(kw, device), cancelling)


def test_sa_scale_train_fewer_centers_than_points(device):
    """N != M with ragged sizes: 1100 points (700 valid), 130 centers."""
    pc, _, _, _ = cases.clouds(36, 2, 1100, n_static=600)
    mask = (torch.arange(1100) < 700).expand(2, -1).contiguous()
    centers = cases.fps_centers(pc, mask, 130)
    for kw in cases.sa_scale_train_cases("three_scales", pc, mask, _gen(36),
                                         centers=centers):
        _assert_scale_train_match(cases.to_device(kw, device))


@pytest.mark.parametrize("level", ["sa1", "sa2", "sa3"])
def test_sa_pair_train_equals_two_sa_scale_trains(device, level):
    """Kernel B9 over a same-depth pair and two kernel B8 calls: pooled
    outputs, selections, statistics and every weight, scale and bias
    gradient equal bit for bit; the feature gradient, scattered with float
    atomics in an order that changes from run to run, within 1e-5 of its
    largest element."""
    pc1, m1, _, _ = cases.clouds(37, 4)
    kw = cases.to_device(cases.sa_train_case(level, "pn_head", pc1, m1,
                                             _gen(37)), device)
    outs, grads = cases.sa_train_run(fused_sa_train.sa_pair_train, kw)
    for t, (tag, single) in enumerate(zip("ab",
                                          cases.split_sa_train_case(kw))):
        o1, g1 = cases.sa_scale_train_run(fused_sa_train.sa_scale_train,
                                          single, seed=t)
        for key, val in o1.items():
            assert torch.equal(val, outs[cases.pair_key(key, tag)]), key
        for key, val in g1.items():
            want = grads[cases.pair_key(key, tag)]
            if key == "pf":
                assert (val - want).abs().max().item() <= \
                    1e-5 * want.abs().max().item() + 1e-7
            else:
                assert torch.equal(val, want), key


@pytest.mark.parametrize("b,m", [(1, 100), (2, 37), (2, 12)])
@pytest.mark.parametrize("level", ["sa1", "sa2", "sa3"])
def test_sa_train_backward_cluster_shares(device, level, b, m):
    """The backward's partition: a cluster of 8 blocks shares a stream's m
    centers (100: rows that fill no whole number of 64-row tiles; 37:
    ragged shares; 12: two blocks own nothing), one stream and two. B9 and
    both B8 launches against the plain version by the float64 yardstick;
    B9 twice on the same inputs: every output and gradient identical but
    the feature gradient (float atomics); B9 == two B8 launches bit for
    bit, the feature gradient within 1e-5 of its largest element."""
    pc, mask, _, _ = cases.clouds(40 + m, b, 256, n_static=150)
    kw = cases.to_device(cases.sa_train_case(
        level, "pn_head", pc, mask, _gen(40 + m),
        centers=cases.fps_centers(pc, mask, m)), device)
    assert kw["centers"].shape == (b, m, 3)
    _assert_train_match(cases.sa_train_run, fused_sa_train.sa_pair_train,
                        fused_sa_train.sa_pair_train_reference, kw)
    outs, grads = cases.sa_train_run(fused_sa_train.sa_pair_train, kw)
    outs2, grads2 = cases.sa_train_run(fused_sa_train.sa_pair_train, kw)
    for key, val in outs.items():
        assert torch.equal(val, outs2[key]), key
    for key, val in grads.items():
        if not key.startswith("pf"):
            assert torch.equal(val, grads2[key]), key
    for t, (tag, single) in enumerate(zip("ab",
                                          cases.split_sa_train_case(kw))):
        _assert_scale_train_match(single)
        o1, g1 = cases.sa_scale_train_run(fused_sa_train.sa_scale_train,
                                          single, seed=t)
        for key, val in o1.items():
            assert torch.equal(val, outs[cases.pair_key(key, tag)]), key
        for key, val in g1.items():
            want = grads[cases.pair_key(key, tag)]
            if key == "pf":
                assert (val - want).abs().max().item() <= \
                    1e-5 * want.abs().max().item() + 1e-7
            else:
                assert torch.equal(val, want), key


@pytest.mark.parametrize("level", LEVELS)
def test_general_sa_level_gpu_matches_cpu(device, level):
    """SetAbstractionMSG with 1 scale, 3 scales and 2 scales of unequal
    depth: eval and one train forward + backward on the card against the
    CPU within 2e-3 x max + 1e-5 (the gradients pass max-pool near-ties),
    and the kernels it launches, by the JAX module's routing: in eval a
    level of two scales takes one B1 whatever their depths, any other one
    B1' per scale; in train one B8 per scale, B9 only for equal depths."""
    from ratrack_tpu_torch.models import SetAbstractionMSG, init_parameters
    radii, nsamples, mlps, c_feat = cases.GENERAL_LEVELS[level]
    pc1, m1, _, _ = cases.clouds(38, 2)
    feats = torch.randn((2, pc1.shape[1], c_feat), generator=_gen(38))
    mods = {}
    for dev in ("cpu", device):
        mod = SetAbstractionMSG(pc1.shape[1], radii, nsamples, mlps,
                                3 + c_feat)
        init_parameters(mod, _gen(39))
        mods[dev] = mod.eval().to(dev)
    count = (fused_sa.sa_scale, fused_sa.sa_pair,
             fused_sa_train.sa_scale_train_fwd,
             fused_sa_train.sa_scale_train_bwd,
             fused_sa_train.sa_pair_train_fwd)
    before = [c.launches for c in count]
    res = {}
    for dev, mod in mods.items():
        with torch.no_grad():
            ev = mod(pc1.to(dev), feats.to(dev), m1.to(dev))[1]
        mod.train()
        f = feats.to(dev).clone().requires_grad_(True)
        out = mod(pc1.to(dev), f, m1.to(dev))[1]
        out.square().sum().backward()
        res[dev] = [ev, out.detach(), f.grad] + [
            p.grad for p in mod.parameters()] + [
            b for b in mod.buffers() if b.is_floating_point()]
    torch.cuda.synchronize()
    n = len(radii)
    want = [0, 1, n, n, 0] if n == 2 else [n, 0, n, n, 0]
    assert [c.launches - b for c, b in zip(count, before)] == want
    for got, want in zip(res[device], res["cpu"]):
        err = (got.cpu() - want).abs().max().item()
        assert err <= 2e-3 * want.abs().max().item() + 1e-5, err


def test_scale_wrappers_raise_on_what_the_kernels_do_not_take(device):
    pc1, m1, _, _ = cases.clouds(40, 2)
    kw = cases.to_device(cases.sa_scale_cases("one_scale", pc1, m1,
                                              _gen(40))[0], device)
    with pytest.raises(ValueError):
        fused_sa.sa_scale(**{**kw, "nsample": 33})
    with pytest.raises(TypeError):
        fused_sa.sa_scale(**{**kw, "p1": kw["p1"].double()})
    with pytest.raises(ValueError):        # a layer wider than 64
        wide = [(torch.zeros((32, 128), device=device),
                 torch.zeros(128, device=device))]
        fused_sa.sa_scale(**{**kw, "rest": wide})
    tk = cases.to_device(cases.sa_scale_train_cases("one_scale", pc1, m1,
                                                    _gen(40))[0], device)
    with pytest.raises(ValueError):
        fused_sa_train.sa_scale_train(**{**tk, "nsample": 64})
    with pytest.raises(ValueError):        # four layers
        fused_sa_train.sa_scale_train(**{
            **tk, "ws": tk["ws"] + [torch.zeros((64, 64), device=device)],
            "gammas": tk["gammas"] + [torch.ones(64, device=device)],
            "betas": tk["betas"] + [torch.zeros(64, device=device)]})
    with pytest.raises(ValueError):        # the pair kernel: equal depth
        a, b = [cases.to_device(c, device) for c in
                cases.sa_scale_train_cases("mixed_depth", pc1, m1, _gen(40))]
        fused_sa_train.sa_pair_train(
            a["xyz"], a["centers"], a["mask"], a["pf"], a["wxyz"], a["ws"],
            a["gammas"], a["betas"], b["pf"], b["wxyz"], b["ws"],
            b["gammas"], b["betas"], radius_a=4.0, radius_b=8.0,
            nsample_a=8, nsample_b=16)


# ---- the aggregate kernel on the tensor cores (B4, B3, B10 forward) and B7
# with a group of lanes a row -------------------------------------------------

def _agg_case(stage, streams, n, seed):
    """Stage-1 (n queries into n + 17 candidates, a fifth of them masked
    out) or stage-2 (the queries in themselves) train-case arguments on
    random clouds: query counts that fill no block of 4 or 8 queries."""
    gen = _gen(seed)
    q = 3.0 * torch.randn((streams, n, 3), generator=gen)
    p = 3.0 * torch.randn((streams, n + 17, 3), generator=gen)
    pm = torch.rand((streams, n + 17), generator=gen) > 0.2
    qm = torch.ones((streams, n), dtype=torch.bool)
    kw = cases.corr_train_case(stage, q, qm, p, pm, gen)
    if stage == 1:      # feats_p must match the candidates, not the queries
        kw["feats_p"] = torch.randn((streams, n + 17, 256), generator=gen)
    return kw


def _plain_stash(kw, idx):
    """The activations the B10 forward stashes, by the plain version's
    operations: h_0 = leaky(feats_p[j] + add_q + dir @ W_dir), then each
    pair layer's output, each (B, N, 16, 256)."""
    import torch.nn.functional as F
    from ratrack_tpu_torch.ops.grouping import group
    idx = idx.long()
    dirs = group(kw["points"], idx) - kw["query"].unsqueeze(2)
    h = F.leaky_relu(group(kw["feats_p"], idx) + kw["add_q"].unsqueeze(2)
                     + dirs @ kw["w_dir"], 0.1)
    out = [h]
    for w, b in zip(kw["mlp_ws"], kw["mlp_bs"]):
        out.append(F.leaky_relu(out[-1] @ w + b, 0.1))
    return out


@pytest.mark.parametrize("entry", ["apply", "aggregate", "train_fwd"])
@pytest.mark.parametrize("streams", [1, 3])
@pytest.mark.parametrize("n", [33, 300, 1000])
@pytest.mark.parametrize("stage", [1, 2])
def test_aggregate_kernel_at_ragged_query_counts(device, entry, streams, n,
                                                 stage):
    """The shared aggregate kernel through its three entries at query
    counts that fill no block (B4 also with 64 and 128 pair rows a block
    forced), against the plain versions; B10's forward also with every
    stashed activation against the plain version's, element by element."""
    kw = cases.to_device(_agg_case(stage, streams, n, 80 + n + streams),
                         device)
    mask = kw.pop("mask_p")
    w_dir = kw.pop("w_dir")
    if entry == "apply":
        from ratrack_tpu_torch.ops.neighborhood import knn
        idx = knn(16, kw["query"], kw["points"], mask)[1]
        want = fused_correlator.knn_gather_apply_reference(idx, **kw)
        for rows in (None, 64, 128):
            got = fused_correlator.knn_gather_apply(idx, **kw,
                                                    block_rows=rows)
            torch.cuda.synchronize()
            _assert_close(got, want)
        return
    if entry == "aggregate":
        got, idx = fused_correlator.fused_knn_weight_aggregate(
            **kw, mask_p=mask, return_indices=True)
        want, ridx = fused_correlator.knn_weight_aggregate_reference(
            **kw, mask_p=mask)
        torch.cuda.synchronize()
        assert torch.equal(idx.long(), ridx.long())
        _assert_close(got, want)
        return
    train = dict(kw, mask_p=mask, w_dir=w_dir,
                 feats_p=kw["feats_p"].clone().requires_grad_(True))
    got, idx = _corr_train_kernel(**train)
    want, ridx = fused_correlator_train.knn_weight_aggregate_train_reference(
        **dict(kw, mask_p=mask, w_dir=w_dir))
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ridx.long())
    _assert_close(got.detach(), want)
    if stage == 1:
        stash = got.grad_fn.saved_tensors[-3:]
        for l, (s_, p_) in enumerate(zip(stash, _plain_stash(
                dict(kw, w_dir=w_dir), idx))):
            _assert_close(s_.view(p_.shape), p_)


@pytest.mark.parametrize("streams,n", [(1, 33), (3, 300)])
@pytest.mark.parametrize("stage", [1, 2])
def test_correlator_train_forward_then_backward_at_ragged_query_counts(
        device, streams, n, stage):
    """The B10 forward on the tensor cores followed by the B10 backward,
    forward and gradients inside phase 6's float64 yardstick."""
    kw = cases.to_device(_agg_case(stage, streams, n, 90 + n), device)
    _assert_train_match(
        cases.corr_train_run, _corr_train_kernel,
        fused_correlator_train.knn_weight_aggregate_train_reference, kw)


@pytest.mark.parametrize("k1", [1, 33, 100, 128])
def test_sinkhorn_every_width_and_variant(device, k1):
    """B7 at K1 = 1, 33, 100 and 128 (one to sixteen terms a lane), its
    own shape and every forced variant that K1 admits (4, 8, 16 lanes a
    row, K1 * lanes <= 1024; exp(c + v) a term, or exp(c) once times
    exp(v)) against the plain loop: u and v within 1e-4 on the valid rows
    and columns, all finite. A variant K1 does not admit raises."""
    kw, meta = cases.sinkhorn_case(15 + k1, 3, k1 - 1, 100)
    kw, meta = cases.to_device(kw, device), cases.to_device(meta, device)
    ru, rv = fused_sinkhorn.sinkhorn_uv_reference(**kw)
    ar = torch.arange(k1, device=device)
    rows = (ar < meta["m"].unsqueeze(1)) | (ar == k1 - 1)
    cols = (ar < meta["n"].unsqueeze(1)) | (ar == k1 - 1)
    variants = [(None, None)] + [
        (lanes, mode) for lanes in fused_sinkhorn.KERNEL_LANES
        for mode in ("exp", "factored")]
    for lanes, mode in variants:
        if lanes is not None and k1 * lanes > 1024:
            with pytest.raises(ValueError):
                fused_sinkhorn.sinkhorn_uv(**kw, lanes=lanes, mode=mode)
            continue
        u, v = fused_sinkhorn.sinkhorn_uv(**kw, lanes=lanes, mode=mode)
        torch.cuda.synchronize()
        assert (u - ru)[rows].abs().max().item() <= 1e-4, (lanes, mode)
        assert (v - rv)[cols].abs().max().item() <= 1e-4, (lanes, mode)
        assert bool(torch.isfinite(u).all() and torch.isfinite(v).all())


@pytest.mark.parametrize("what", ["apply", "aggregate", "train_fwd",
                                  "sinkhorn"])
def test_aggregate_and_sinkhorn_launches_per_call(device, what):
    """CUDA kernels one wrapper call launches, counted by torch.profiler:
    a B4 call is one aggregate launch, a B3 call and a B10 forward the
    kNN selection and one aggregate launch, a B7 call one launch."""
    pc1, m1, pc2, m2 = cases.clouds(51, 4)
    if what == "sinkhorn":
        kw = cases.to_device(cases.sinkhorn_case(51, 4)[0], device)
        got = _package_kernels(lambda: fused_sinkhorn.sinkhorn_uv(**kw))
        assert got == ["sinkhorn_kernel"], got
        return
    if what == "apply":
        kw = cases.to_device(cases.apply_case(1, *_stretch_clouds(51, 1024),
                                              _gen(51)), device)
        got = _package_kernels(
            lambda: fused_correlator.knn_gather_apply(**kw))
        assert got == ["aggregate_kernel"], got
        return
    kw = cases.to_device(cases.corr_train_case(1, pc1, m1, pc2, m2,
                                               _gen(51)), device)
    w_dir = kw.pop("w_dir")
    with torch.no_grad():
        if what == "aggregate":
            got = _package_kernels(
                lambda: fused_correlator.fused_knn_weight_aggregate(**kw))
        else:
            got = _package_kernels(
                lambda: _corr_train_kernel(**kw, w_dir=w_dir))
    assert sorted(got) == ["aggregate_kernel", "knn_staged_kernel"], got


# ---- B9 / B8 forward (one cluster launch) and B10 backward (3xTF32) -------

PROFILE_RERUNS = 3


def _package_kernels(fn):
    """The CUDA kernels of csrc/ that fn() launches, by name, as
    torch.profiler sees them (PyTorch's own kernels, such as the fill of a
    zero-initialised gradient, are not counted). The tracer gets a
    warm-up step of its own, with one PyTorch kernel, whose records are
    dropped: with fn() first in the window, a run of the card tests saw
    its first kernel go unreported now and then, and with the warm-up step
    alone one still did (a card-test call of the bfloat16 slice), so the
    window opens on a PyTorch kernel too, which no result counts. A
    profile that recorded no CUDA event at all (one to three of the
    launch-count tests in half of the card-test calls, while the kernels'
    own counters saw every launch) is taken again, up to PROFILE_RERUNS
    times, so fn must be safe to call again; a profile with CUDA events is
    returned as it is, right or wrong."""
    from torch.profiler import ProfilerActivity, profile, schedule
    names = set()
    for src in kb.CSRC_DIR.glob("*.cu*"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", src.read_text()))
    for _ in range(1 + PROFILE_RERUNS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            torch.ones(1, device="cuda").add_(1)
            fn()
            torch.cuda.synchronize()
            prof.step()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    found = []
    for e in events:
        hit = [k for k in names if re.search(rf"\b{k}\b", e.name)]
        found += hit[:1]
    return found


@pytest.mark.parametrize("what", ["pair_fwd", "scale_fwd", "corr_bwd_stage1",
                                  "corr_bwd_stage2"])
def test_train_kernels_launch_counts_per_call(device, what):
    """CUDA kernels one wrapper call launches, counted by torch.profiler: a
    B9 pair forward and a B8 forward are the ball query and one cluster
    launch, a B10 backward at most 6 kernels for stage 1 and 3 for stage
    2."""
    pc1, m1, pc2, m2 = cases.clouds(50, 4)
    if what.startswith("corr"):
        stage = int(what[-1])
        kw = cases.to_device(cases.corr_train_case(stage, pc1, m1, pc2, m2,
                                                   _gen(50)), device)
        loss, _, leaves = cases.corr_train_loss(_corr_train_kernel, kw)
        flat = [x for _, x in cases.flat_leaves(leaves)]
        got = _package_kernels(
            lambda: torch.autograd.grad(loss, flat, retain_graph=True))
        assert 1 <= len(got) <= (6 if stage == 1 else 3), got
        return
    for level in ("sa1", "sa2", "sa3"):
        kw = cases.to_device(cases.sa_train_case(level, "pn_head", pc1, m1,
                                                 _gen(50)), device)
        with torch.no_grad():
            if what == "scale_fwd":
                single = cases.split_sa_train_case(kw)[1]
                got = _package_kernels(
                    lambda: fused_sa_train.sa_scale_train(**single))
            else:
                got = _package_kernels(
                    lambda: fused_sa_train.sa_pair_train(**kw))
        assert sorted(got) == ["fwd_cluster_kernel", "select_kernel"], \
            (level, got)


# name: (streams, queries, candidates (stage 1), valid candidates per stream)
CORR_RAGGED = {
    "one_stream_37_queries": (1, 37, 50, None),
    "two_streams_past_a_chunk": (2, 70, 90, None),
    "fewer_valid_than_k": (2, 20, 40, (40, 9)),
}


def _corr_ragged_case(name, stage, seed=60):
    """The B10 cases of tests/test_torch_port_redesign.py on the card: B N
    16 pair rows that fill no 128-row tile and no 1,024-row dW chunk, one
    stream, a stream with fewer valid candidates than k."""
    b, n, m, valid = CORR_RAGGED[name]
    gen = _gen(seed + stage)
    q = torch.round(64 * torch.randn((b, n, 3), generator=gen)) / 16
    p = (torch.round(64 * torch.randn((b, m, 3), generator=gen)) / 16
         if stage == 1 else q)
    mask = torch.ones(p.shape[:2], dtype=torch.bool)
    for s_, v in enumerate(valid or ()):
        mask[s_, v:] = False
    kw = cases.corr_train_case(stage, q, mask, p, mask, gen)
    kw["feats_p"] = torch.randn((b, p.shape[1], 256), generator=gen)
    return kw


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("name", sorted(CORR_RAGGED))
def test_correlator_train_ragged_rows(device, name, stage):
    kw = cases.to_device(_corr_ragged_case(name, stage), device)
    if stage == 2:
        kw["points"] = kw["query"]
    _assert_train_match(
        cases.corr_train_run, _corr_train_kernel,
        fused_correlator_train.knn_weight_aggregate_train_reference, kw)


@pytest.mark.parametrize("stage", [1, 2])
def test_correlator_train_backward_repeats_run_to_run(device, stage):
    """Two runs of B10 on the same inputs: the output and every gradient
    identical but those the float atomics scatter (d_feats_p, d_points, and
    in stage 2, where the candidates are the queries, d_query)."""
    pc1, m1, pc2, m2 = cases.clouds(61, 8)
    kw = cases.to_device(cases.corr_train_case(stage, pc1, m1, pc2, m2,
                                               _gen(61)), device)
    runs = [cases.corr_train_run(_corr_train_kernel, kw) for _ in range(2)]
    scattered = {"feats_p", "points"} | ({"query"} if stage == 2 else set())
    assert torch.equal(runs[0][0]["out"], runs[1][0]["out"])
    for key, g in runs[0][1].items():
        if key not in scattered:
            assert torch.equal(g, runs[1][1][key]), key


CANARY = {torch.float32: -1.2345e30, torch.float64: -1.2345e30,
          torch.int32: -123456789}


class _Guard:
    """Outputs and scratch as views inside larger buffers with canary
    values on both sides; `assert_intact` checks them after the launch."""
    PAD = 64      # elements: keeps every view 256-byte aligned

    def __init__(self, device):
        self.device, self.bufs = device, []

    def view(self, shape, dtype=torch.float32, zero=False, name=""):
        n = math.prod(shape)
        buf = torch.full((n + 2 * self.PAD,), CANARY[dtype], dtype=dtype,
                         device=self.device)
        v = buf[self.PAD:self.PAD + n].view(shape)
        if zero:
            v.zero_()
        self.bufs.append((buf, n, name or str(tuple(shape))))
        return v

    def assert_intact(self):
        torch.cuda.synchronize()
        broken = []
        for buf, n, name in self.bufs:
            c = CANARY[buf.dtype]
            if not (bool((buf[:self.PAD] == c).all())
                    and bool((buf[self.PAD + n:] == c).all())):
                broken.append(name)
        assert not broken, broken


def _canary_cloud(n_valid, b=2, n=33):
    pc = 2.0 * torch.randn((b, n, 3), generator=_gen(70 + n_valid))
    mask = (torch.arange(n) < n_valid).expand(b, -1).contiguous()
    return pc, mask


def _canary_sa_eval(lib, stream, guard, pc, mask, device):
    """B1 (both scales of sa1) and B1' (one of them), each in float32 and
    bfloat16: outputs and indices guarded."""
    b, n = pc.shape[:2]
    kw = cases.to_device(cases.sa_case("sa1", "pn_head", pc, mask, _gen(71)),
                         device)
    m = kw["centers"].shape[1]
    clouds = (kb.ptr(kw["xyz"]), kb.ptr(kw["centers"]), kb.ptr(kw["mask"]),
              b, n, m)
    # every center tile, 16 the one the eval and serving paths run (33
    # centers: the last tile part-full)
    for tile in fused_sa.KERNEL_TILES:
        for sfx in ("", "_bf16"):
            args = []
            for t in "ab":
                a, _, _ = fused_sa._kernel_scale(
                    t, kw["xyz"], kw["centers"], kw[f"p1{t}"], kw[f"cw{t}"],
                    kw[f"rest_{t}"], kw[f"radius_{t}"], kw[f"nsample_{t}"],
                    True)
                width = (kw[f"rest_{t}"][-1][0].shape[1] if kw[f"rest_{t}"]
                         else kw[f"p1{t}"].shape[-1])
                a[-2] = kb.ptr(guard.view(
                    (b, m, width), name=f"sa_pair{sfx}[{tile}].out_{t}"))
                a[-1] = kb.ptr(guard.view(
                    (b, m, kw[f"nsample_{t}"]), torch.int32,
                    name=f"sa_pair{sfx}[{tile}].idx_{t}"))
                args.append(a)
            kb.check(getattr(lib, f"ratrack_sa_pair{sfx}")(
                *clouds, *args[0], *args[1], tile, stream), "sa_pair")
        sc = cases.split_sa_case(kw)[1]
        a, _, _ = fused_sa._kernel_scale(
            "", sc["xyz"], sc["centers"], sc["p1"], sc["cw"], sc["rest"],
            sc["radius"], sc["nsample"], True)
        for sfx in ("", "_bf16"):
            a[-2] = kb.ptr(guard.view((b, m, sc["rest"][-1][0].shape[1]),
                                      name=f"sa_scale{sfx}[{tile}].out"))
            a[-1] = kb.ptr(guard.view((b, m, sc["nsample"]), torch.int32,
                                      name=f"sa_scale{sfx}[{tile}].idx"))
            kb.check(getattr(lib, f"ratrack_sa_scale{sfx}")(
                *clouds, *a, tile, stream), "sa_scale")


def _canary_fp_and_stretch(lib, stream, guard, pc, mask, device):
    """B2 (with the known mask; float32 and bfloat16 features), B5, B6
    (its own launch shape, one block, clusters of 2 and 8) and B7 (33 x
    33; its own shape and every variant): every output guarded."""
    b, n = pc.shape[:2]
    kw = cases.to_device(cases.fp_case("fp1", pc, mask, _gen(75)), device)
    m, c = kw["known"].shape[1], kw["feats"].shape[-1]
    # its own launch shape and every one it offers (33 unknowns: the last
    # tile part-full)
    feats = {"": kw["feats"], "_bf16": kw["feats"].to(torch.bfloat16)}
    for queries, lanes in [(0, 0)] + FP_SHAPES[1:]:
        for sfx, f in feats.items():
            name = f"three_interpolate{sfx}[{queries},{lanes}]"
            kb.check(getattr(lib, f"ratrack_three_interpolate{sfx}")(
                kb.ptr(kw["unknown"]), kb.ptr(kw["known"]), kb.ptr(f),
                kb.ptr(mask.to(device)), b, n, m, c, fused_fp.EPS, queries,
                lanes, kb.ptr(guard.view((b, n, c), name=f"{name}.out")),
                kb.ptr(guard.view((b, n, 3), torch.int32,
                                  name=f"{name}.idx")), stream), name)
    xyz, dmask = pc.to(device), mask.to(device)
    # the smallest and largest shapes and the kernel's own (8, 256)
    # and the depth-32 list at its one launch shape (8 queries a block)
    for queries, chunk, k in ((8, 128, 16), fused_knn.KERNEL_SHAPE + (16,),
                              (32, 512, 16), (8, 256, 32)):
        name = f"knn_tiled[{queries},{chunk},k={k}]"
        kb.check(lib.ratrack_knn_tiled(
            kb.ptr(xyz), kb.ptr(xyz), kb.ptr(dmask), b, n, n, k, queries,
            chunk, kb.ptr(guard.view((b * (4 * chunk + 8),),
                                        name=f"{name}.scratch")),
            kb.ptr(guard.view((b, n, k), torch.int32, name=f"{name}.idx")),
            kb.ptr(guard.view((b, n, k), name=f"{name}.keys")), stream),
            name)
    for threads, blocks in ((0, 0), (32, 1), (128, 2), (128, 8)):
        kb.check(lib.ratrack_fps(
            kb.ptr(xyz), kb.ptr(dmask), b, n, 20,
            kb.ptr(guard.view((b, 20), torch.int32,
                              name=f"fps.out[{threads}x{blocks}]")),
            threads, blocks, stream), "fps")
    sk, _ = cases.sinkhorn_case(76, b, n - 1, 20)
    sk = cases.to_device(sk, device)
    kb.check(lib.ratrack_sinkhorn(
        kb.ptr(sk["c"]), kb.ptr(sk["log_mu"]), kb.ptr(sk["log_nu"]), b, n,
        sk["iters"], kb.ptr(guard.view((b, n), name="sinkhorn.u")),
        kb.ptr(guard.view((b, n), name="sinkhorn.v")), stream), "sinkhorn")
    for lanes in fused_sinkhorn.KERNEL_LANES:
        for mode, code in fused_sinkhorn.KERNEL_MODES.items():
            name = f"sinkhorn_variant[{lanes},{mode}]"
            kb.check(lib.ratrack_sinkhorn_variant(
                kb.ptr(sk["c"]), kb.ptr(sk["log_mu"]), kb.ptr(sk["log_nu"]),
                b, n, sk["iters"], lanes, code,
                kb.ptr(guard.view((b, n), name=f"{name}.u")),
                kb.ptr(guard.view((b, n), name=f"{name}.v")), stream), name)


def _corr_weights(ck):
    return (kb.ptr_array(list(ck["mlp_ws"])), kb.ptr_array(list(ck["mlp_bs"])),
            len(ck["mlp_ws"]),
            *fused_correlator_train._wn_ptrs(ck["wn_ws"] + ck["wn_bs"]))


def _canary_correlator(lib, stream, guard, pc, mask, device):
    """B3 (its kNN selection, then the aggregate), B4 (its own block shape
    and 64 and 128 pair rows a block), both also in bfloat16, and the B10
    forward
    (every stash pointer) and backward (every output and scratch pointer),
    both stages: each output guarded; the backward reads the guarded
    forward's stash."""
    b, n = pc.shape[:2]
    c, rows = 256, b * n * 16
    pc2, _ = _canary_cloud(int(mask[0].sum()))
    for stage in (1, 2):
        ck = cases.to_device(cases.corr_train_case(
            stage, pc, mask, pc2, mask, _gen(73)), device)
        clouds = (kb.ptr(ck["query"]), kb.ptr(ck["points"]))
        # the selection at its own tile and every one it offers
        for queries in (0,) + fused_correlator.KNN_QUERIES:
            idx = guard.view((b, n, 16), torch.int32,
                             name=f"knn{stage}[{queries}].idx")
            kb.check(lib.ratrack_knn(*clouds, kb.ptr(ck["mask_p"]), b, n, n,
                                     16, queries, kb.ptr(idx), stream), "knn")
        head = (*clouds, kb.ptr(idx), b, n, n, kb.ptr(ck["feats_p"]),
                kb.ptr(ck["add_q"]))
        for sfx in ("", "_bf16"):
            for name in ("corr_aggregate", "corr_apply"):
                out = guard.view((b, n, c), name=f"{name}{sfx}{stage}.out")
                kb.check(getattr(lib, f"ratrack_{name}{sfx}")(
                    *head, *_corr_weights(ck), kb.ptr(out), stream), name)
            for rows_ in (64, 128):
                out = guard.view((b, n, c),
                                 name=f"corr_apply_rows{sfx}{stage}.{rows_}")
                kb.check(getattr(lib, f"ratrack_corr_apply_rows{sfx}")(
                    *head, *_corr_weights(ck), rows_, kb.ptr(out), stream),
                    "corr_apply_rows")
        n_mlp = len(ck["mlp_ws"])
        stash = [guard.view((rows, c), name=f"train_fwd{stage}.stash{l}")
                 for l in range(n_mlp + 1)]
        out = guard.view((b, n, c), name=f"train_fwd{stage}.out")
        ws, bs, _, *wn = _corr_weights(ck)
        kb.check(lib.ratrack_corr_train_fwd(
            *head, kb.ptr(ck["w_dir"]), ws, bs, n_mlp, *wn,
            kb.ptr_array(stash), kb.ptr(out), stream), "corr_train_fwd")
        if stage == 2:
            stash = [None]     # the backward reads feats_p itself
        blocks = -(-b * n // 4)
        chunks = -(-rows // fused_correlator_train._DW_CHUNK)
        wn_grad = fused_correlator_train._WN_GRAD

        def gv(shape, name, zero=False):
            return guard.view(shape, zero=zero, name=f"train_bwd{stage}.{name}")
        g = dict(
            d_feats_p=gv((b, n, c), "d_feats_p", zero=True),
            d_add_q=gv((b, n, c), "d_add_q") if stage == 1 else None,
            d_query=gv((b, n, 3), "d_query"),
            d_points=gv((b, n, 3), "d_points", zero=True),
            d_wdir=gv((3, c), "d_wdir") if stage == 1 else None,
            d_mlp_w=[gv((c, c), f"d_mlp_w{i}") for i in range(n_mlp)],
            d_mlp_b=[gv((c,), f"d_mlp_b{i}") for i in range(n_mlp)],
            d_wn=gv((wn_grad,), "d_wn"),
            dz=[gv((rows, c), f"dz{i}") for i in range(2 if n_mlp else 1)],
            ddir=gv((rows, 3), "ddir"),
            part=gv((blocks * (wn_grad + 3 * c)
                     + n_mlp * chunks * (c * c + c),), "part"))
        dout = torch.randn((b, n, c), generator=_gen(74)).to(device)
        kb.check(lib.ratrack_corr_train_bwd(
            *clouds, kb.ptr(idx), b, n, n, kb.ptr(ck["feats_p"]),
            int(ck["add_q"] is not None), kb.ptr(ck["w_dir"]), ws, n_mlp,
            kb.ptr_array(stash), *wn, kb.ptr(dout), kb.ptr(g["d_feats_p"]),
            kb.ptr(g["d_add_q"]), kb.ptr(g["d_query"]),
            kb.ptr(g["d_points"]), kb.ptr(g["d_wdir"]),
            kb.ptr_array(g["d_mlp_w"]), kb.ptr_array(g["d_mlp_b"]),
            kb.ptr(g["d_wn"]), kb.ptr(g["dz"][0]), kb.ptr(g["dz"][-1]),
            kb.ptr(g["ddir"]), kb.ptr(g["part"]), stream), "corr_train_bwd")
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        assert bool(torch.isfinite(g["d_wn"]).all())


def _canary_sa_train(lib, stream, guard, pc, mask, device):
    """B9 / B8 forward (the ball query inside the cluster launch and as
    select_kernel's launch) and backward, pair and one-scale entries: every
    output and scratch pointer of the scale structs guarded."""
    b, n = pc.shape[:2]
    tk = cases.to_device(cases.sa_train_case("sa1", "pn_head", pc, mask,
                                             _gen(72), centers=pc), device)
    mw, ml = fused_sa_train.MAX_WIDTH, fused_sa_train.MAX_LAYERS
    keep = []
    for t in "ab":
        ns = tk[f"nsample_{t}"]
        dims = [tk[f"wxyz_{t}"].shape[1]] + [w.shape[1]
                                             for w in tk[f"ws_{t}"]]

        def gv(shape, name, dtype=torch.float32, zero=False):
            return guard.view(shape, dtype, zero, name=f"sa_train.{t}.{name}")
        keep.append(dict(
            ws=tk[f"ws_{t}"], gam=tk[f"gammas_{t}"], bet=tk[f"betas_{t}"],
            dims=dims, ns=ns, r=tk[f"radius_{t}"], pf=tk[f"pf{t}"],
            wx=tk[f"wxyz_{t}"],
            z=[gv((b, n * ns, c), f"z{i}") for i, c in enumerate(dims)],
            mus=[gv((b, c), f"mu{i}") for i, c in enumerate(dims)],
            vrs=[gv((b, c), f"var{i}") for i, c in enumerate(dims)],
            idx=gv((b, n, ns), "idx", torch.int32),
            pooled=gv((b, n, dims[-1]), "pooled")))
    common = (kb.ptr(tk["xyz"]), kb.ptr(tk["centers"]),
              kb.ptr(tk["mask"]), b, n, n, 1e-5)
    structs = [fused_sa_train._scale_struct(sc) for sc in keep]
    kb.check(lib.ratrack_sa_train_fwd(
        *common, ctypes.addressof(structs[0]),
        ctypes.addressof(structs[1]), stream), "sa_pair_train_fwd")
    kb.check(lib.ratrack_sa_scale_train_fwd(
        *common, ctypes.addressof(structs[1]), stream),
        "sa_scale_train_fwd")
    torch.cuda.synchronize()
    for sc in keep:
        assert bool(torch.isfinite(sc["pooled"]).all())
    # the backward over the guarded forward's stash, as
    # SATrainFunction.backward builds its structs
    for k, sc in enumerate(keep):
        t, dims = "ab"[k], sc["dims"]

        def gv(shape, name, dtype=torch.float32, zero=False):
            return guard.view(shape, dtype, zero,
                              name=f"sa_train_bwd.{t}.{name}")
        sc.update(
            dpooled=torch.randn(sc["pooled"].shape, generator=_gen(77 + k)
                                ).to(device),
            dy=[gv((b, n * sc["ns"], mw), f"dy{i}") for i in range(2)],
            dpf=gv(tuple(sc["pf"].shape), "dpf", zero=True),
            dwx=gv((3, dims[0]), "dwxyz"),
            dw=[None] + [gv((i, o), f"dw{li + 1}") for li, (i, o) in
                         enumerate(zip(dims[:-1], dims[1:]))],
            dgam=[gv((c,), f"dgamma{i}") for i, c in enumerate(dims)],
            dbet=[gv((c,), f"dbeta{i}") for i, c in enumerate(dims)])
    bwd = [fused_sa_train._scale_struct(sc) for sc in keep]
    for name, scales in (("sa_train_bwd", bwd), ("sa_scale_train_bwd",
                                                 bwd[1:])):
        n_sc = len(scales)
        ssum = guard.view((n_sc, ml, b, 2, mw), torch.float64,
                          name=f"{name}.ssum")
        pdw = guard.view((n_sc, b * fused_sa_train._CLUSTER,
                          fused_sa_train._GRAD_LEN), name=f"{name}.pdw")
        kb.check(getattr(lib, f"ratrack_{name}")(
            kb.ptr(tk["xyz"]), kb.ptr(tk["centers"]), b, n, n, 1e-5,
            *[ctypes.addressof(st) for st in scales], kb.ptr(ssum),
            kb.ptr(pdw), stream), name)
    torch.cuda.synchronize()
    for sc in keep:
        assert bool(torch.isfinite(sc["dwx"]).all())


def _canary_transport(lib, stream, guard, pc, mask, device):
    """B11 on the cloud against its first 32 points (m a multiple of 4),
    128 features, one and two iterations: the plan's scratch, a, b and
    the flow guarded."""
    b, n = pc.shape[:2]
    m, c = 32, 128
    gen = _gen(78)
    f = torch.nn.functional.normalize(torch.randn((b, n, c), generator=gen),
                                      dim=-1).to(device)
    g = f[:, :m].contiguous()
    p = pc.to(device)
    q = p[:, :m].contiguous()
    params = torch.tensor([0.08, 1.0 / 1.08], device=device)
    for iters in (1, 2):
        name = f"transport_flow[{iters}]"
        a = guard.view((b, n), name=f"{name}.a")
        a.fill_(1.0 / n)
        kb.check(lib.ratrack_transport_flow(
            kb.ptr(f), kb.ptr(g), kb.ptr(p), kb.ptr(q), kb.ptr(params), b, n,
            m, c, 100.0, iters,
            kb.ptr(guard.view((b, n, m), name=f"{name}.kmat")), kb.ptr(a),
            kb.ptr(guard.view((b, m), name=f"{name}.b")),
            kb.ptr(guard.view((b, n, 3), name=f"{name}.flow")), stream), name)


def _canary_dbscan(lib, stream, guard, pc, mask, device):
    """B12 on the cloud's squared distances at eps 1.5, with and without
    rounds of propagation: the labels guarded."""
    b, n = pc.shape[:2]
    d2 = square_distance(pc, pc).to(device)
    m = mask.to(device)
    for rounds in (1, 65):
        name = f"dbscan_labels[{rounds}]"
        kb.check(lib.ratrack_dbscan_labels(
            kb.ptr(d2), kb.ptr(m), b, n, 2.25, 2, rounds,
            kb.ptr(guard.view((b, n), dtype=torch.int32, name=name)),
            stream), name)


# every C entry of kernels/build.py's library that launches a kernel, by
# the helper above that calls it with guarded outputs
CANARY_ENTRIES = {
    "ratrack_sa_pair": _canary_sa_eval, "ratrack_sa_scale": _canary_sa_eval,
    "ratrack_sa_pair_bf16": _canary_sa_eval,
    "ratrack_sa_scale_bf16": _canary_sa_eval,
    "ratrack_three_interpolate": _canary_fp_and_stretch,
    "ratrack_three_interpolate_bf16": _canary_fp_and_stretch,
    "ratrack_knn_tiled": _canary_fp_and_stretch,
    "ratrack_fps": _canary_fp_and_stretch,
    "ratrack_sinkhorn": _canary_fp_and_stretch,
    "ratrack_sinkhorn_variant": _canary_fp_and_stretch,
    "ratrack_knn": _canary_correlator,
    "ratrack_corr_aggregate": _canary_correlator,
    "ratrack_corr_apply": _canary_correlator,
    "ratrack_corr_apply_rows": _canary_correlator,
    "ratrack_corr_aggregate_bf16": _canary_correlator,
    "ratrack_corr_apply_bf16": _canary_correlator,
    "ratrack_corr_apply_rows_bf16": _canary_correlator,
    "ratrack_corr_train_fwd": _canary_correlator,
    "ratrack_corr_train_bwd": _canary_correlator,
    "ratrack_sa_train_fwd": _canary_sa_train,
    "ratrack_sa_scale_train_fwd": _canary_sa_train,
    "ratrack_sa_train_bwd": _canary_sa_train,
    "ratrack_sa_scale_train_bwd": _canary_sa_train,
    "ratrack_transport_flow": _canary_transport,
    "ratrack_dbscan_labels": _canary_dbscan,
}


@pytest.mark.parametrize("n_valid", [33, 1, 0])
def test_kernels_write_only_inside_their_outputs(device, n_valid):
    """Every C entry of the library (CANARY_ENTRIES: B1, B1', B2 at every
    launch shape, B3's two launches (the selection at every tile), B4 at
    both block shapes, the bfloat16 instantiations of B1, B1', B2, B3's
    aggregate launch and B4 (their outputs are float32), B5 (at k = 16
    and 32), B11 at one and two iterations, B12 with and without
    propagation rounds, B6 at four
    launch shapes, B7 and each of its variants, the B9 / B8 forward
    and backward, the B10 forward and backward, both correlator stages),
    called directly, with every output and scratch pointer a view inside
    a larger buffer: after the launches the canaries on both sides are
    intact. 33 points, all, one or none valid."""
    launching = {name for name in kb.SIGNATURES
                 if not name.endswith("_clusters")}
    assert launching == set(CANARY_ENTRIES), launching ^ set(CANARY_ENTRIES)
    lib = kb.load()
    stream = torch.cuda.current_stream().cuda_stream
    pc, mask = _canary_cloud(n_valid)
    guard = _Guard(device)
    for helper in dict.fromkeys(CANARY_ENTRIES.values()):
        helper(lib, stream, guard, pc, mask, device)
    guard.assert_intact()


# ---- B1 / B1' in center tiles, B5 with its chunk gate ---------------------

SA_TILES = (None,) + fused_sa.KERNEL_TILES


def _tile_sa_case(level, b, n, m, n_valid=None, seed=80, spread=3.0):
    """A `sa_pair` case at an SA_LEVELS level (pn_head widths) over a random
    cloud of n points (the first n_valid valid; None: no mask) and m
    centers near cloud points, so that N != M and the last center tile of
    a stream is part-full."""
    radii, nsamples, mlps, c_feat = cases.SA_LEVELS[level]
    gen = _gen(seed)
    xyz = spread * torch.randn((b, n, 3), generator=gen)
    pick = torch.randint(0, n, (m,), generator=gen)
    centers = (xyz[:, pick] + 0.1 * torch.randn((b, m, 3), generator=gen))
    mask = (None if n_valid is None else
            (torch.arange(n) < n_valid).expand(b, -1).contiguous())
    feats = torch.randn((b, n, c_feat["pn_head"]), generator=gen)
    kw = dict(xyz=xyz, centers=centers.contiguous(), mask=mask)
    for tag, widths in zip("ab", mlps):
        ws, bs = cases._weights(gen, (3 + c_feat["pn_head"],) + tuple(widths))
        kw[f"p1{tag}"], kw[f"cw{tag}"] = fused_sa.hoist_layer1(
            xyz, kw["centers"], feats, ws[0], bs[0])
        kw[f"rest_{tag}"] = list(zip(ws[1:], bs[1:]))
    kw.update(radius_a=radii[0], radius_b=radii[1], nsample_a=nsamples[0],
              nsample_b=nsamples[1])
    return kw


def _assert_pair_matches(kw, **shape):
    oa, ob, ia, ib = fused_sa.sa_pair(**kw, return_indices=True, **shape)
    ra, rb, ja, jb = fused_sa.sa_pair_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(ia.long(), ja) and torch.equal(ib.long(), jb), shape
    _assert_close(oa, ra)
    _assert_close(ob, rb)


@pytest.mark.parametrize("m", [33, 100, 513])
@pytest.mark.parametrize("level", ["sa1", "sa2", "sa3"])
def test_sa_pair_every_tile_matches_plain(device, level, m):
    """33, 100 and 513 centers over 600 points (450 valid): every center
    tile ends part-full somewhere; each tile and the kernel's own."""
    kw = cases.to_device(_tile_sa_case(level, 2, 600, m, 450), device)
    for tile in SA_TILES:
        _assert_pair_matches(kw, tile=tile)


@pytest.mark.parametrize("n_valid", [0, 1, None])
def test_sa_pair_no_slot_one_slot_every_slot(device, n_valid):
    """No valid point (every center pools (i, point 0)), one valid point
    (at most one filled slot), and a dense cloud with no mask where sa3's
    radii fill all 16 + 32 slots of every center."""
    for level in ("sa1", "sa3"):
        kw = cases.to_device(_tile_sa_case(level, 2, 300, 100, n_valid,
                                           spread=1.0), device)
        if n_valid is None and level == "sa3":
            _, _, ia, ib = fused_sa.sa_pair_reference(**kw)
            assert bool((ia != ia[..., :1]).any(-1).all())
            assert bool((ib != ib[..., :1]).any(-1).all())
        for tile in SA_TILES:
            _assert_pair_matches(kw, tile=tile)


@pytest.mark.parametrize("head", ["pn_head", "mse"])
def test_sa_pair_at_the_stretch_shape(device, head):
    """sa1 of the stretch path: 8192 points, 512 farthest-point centers."""
    pc, mask, _, _ = cases.stretch_clouds(81, 8192)
    kw = cases.to_device(cases.sa_case("sa1", head, pc, mask, _gen(81),
                                       npoint=512), device)
    _assert_pair_matches(kw)


@pytest.mark.parametrize("level", LEVELS)
def test_sa_scale_every_tile_matches_plain(device, level):
    """Every scale of the GENERAL_LEVELS at 100 centers over 700 points."""
    pc, _, _, _ = cases.clouds(82, 2, 700, n_static=500)
    mask = (torch.arange(700) < 520).expand(2, -1).contiguous()
    for kw in cases.sa_scale_cases(level, pc, mask, _gen(82), npoint=100):
        kw = cases.to_device(kw, device)
        ref, ridx = fused_sa.sa_scale_reference(**kw)
        for tile in SA_TILES:
            out, idx = fused_sa.sa_scale(**kw, return_indices=True,
                                         tile=tile)
            torch.cuda.synchronize()
            assert torch.equal(idx.long(), ridx), tile
            _assert_close(out, ref)


@pytest.mark.parametrize("level", ["sa1", "sa2", "sa3"])
def test_sa_pair_equals_two_singles_at_every_tile(device, level):
    """A pair launch equals two one-scale launches bit for bit at every
    tile (the tile changes no bit either), and repeats itself."""
    kw = cases.to_device(_tile_sa_case(level, 3, 500, 100, 400, seed=83),
                         device)
    first = fused_sa.sa_pair(**kw, return_indices=True)
    for tile in SA_TILES:
        pair = fused_sa.sa_pair(**kw, return_indices=True, tile=tile)
        assert all(torch.equal(x, y) for x, y in zip(pair, first)), tile
        for t, single in enumerate(cases.split_sa_case(kw)):
            out, idx = fused_sa.sa_scale(**single, return_indices=True,
                                         tile=tile)
            assert torch.equal(out, pair[t]) and torch.equal(idx, pair[t + 2])


KNN_SHAPES = [(q, c) for q in fused_knn.KERNEL_QUERIES
              for c in fused_knn.KERNEL_CHUNKS]


def _assert_knn_matches(kw, shapes=KNN_SHAPES):
    ridx, rkeys, rvalid = fused_knn.knn_indices_tiled_reference(**kw)
    for shape in [None] + list(shapes):
        idx, keys, valid = fused_knn.knn_indices_tiled(
            **kw, return_keys=True, shape=shape)
        torch.cuda.synchronize()
        assert torch.equal(idx, ridx), shape
        assert torch.equal(valid, rvalid) and torch.equal(keys, rkeys)


@pytest.mark.parametrize("zsorted", [True, False])
@pytest.mark.parametrize("n", [8192, 16384])
def test_knn_tiled_stretch_clouds_sorted_and_not(device, n, zsorted):
    """Both stages at the stretch sizes, Z-sorted as the split correlator
    sorts them (the gate skips most chunks) and as they come (B10's
    selection in train stretch: it rarely fires)."""
    pc1, m1, pc2, m2 = cases.stretch_clouds(84, n)
    for stage in (1, 2):
        if zsorted:
            kw = cases.knn_tiled_case(stage, pc1, m1, pc2, m2)
        else:
            kw = dict(query=pc1, points=pc2 if stage == 1 else pc1,
                      points_mask=m2 if stage == 1 else m1, k=16)
        _assert_knn_matches(cases.to_device(kw, device),
                            shapes=KNN_SHAPES if n == 8192 else [(8, 512)])


def test_knn_tiled_exact_ties_across_chunk_boundaries(device):
    """Candidates on a coarse grid, each point repeated 256, 512 and 1024
    places later, so that equal distances fall in different chunks of
    every chunk size: lowest index first."""
    gen = _gen(85)
    base = torch.round(2 * torch.randn((2, 130, 3), generator=gen))
    p = torch.cat([base, torch.zeros(2, 126, 3), base, torch.zeros(2, 126, 3),
                   base, torch.zeros(2, 382, 3), base], dim=1)
    mask = torch.ones(p.shape[:2], dtype=torch.bool)
    mask[:, 130:256] = False
    q = torch.round(2 * torch.randn((2, 300, 3), generator=gen))
    for k in (3, 16):
        _assert_knn_matches(cases.to_device(
            dict(query=q, points=p, points_mask=mask, k=k), device))


@pytest.mark.parametrize("k", [1, 5, 15, 16])
def test_knn_tiled_few_valid_and_a_stream_without_any(device, k):
    """Three streams of 1500 candidates: all valid, 9 valid (fewer than
    16; first-hit padding), none valid (index 0, key -1e10); k below 16."""
    gen = _gen(86)
    p = 5 * torch.randn((3, 1500, 3), generator=gen)
    q = 5 * torch.randn((3, 700, 3), generator=gen)
    mask = torch.ones((3, 1500), dtype=torch.bool)
    mask[1] = torch.arange(1500) % 167 == 3
    mask[2] = False
    _assert_knn_matches(cases.to_device(
        dict(query=q, points=p, points_mask=mask, k=k), device))


def test_knn_tiled_far_query_tiles(device):
    """Query tiles far from every candidate, and one tile straddling two
    clusters: the gate must keep the chunks that hold the nearest."""
    gen = _gen(87)
    p = torch.cat([torch.randn((1, 2000, 3), generator=gen),
                   torch.randn((1, 2000, 3), generator=gen) + 300.0], dim=1)
    q = torch.cat([torch.randn((1, 40, 3), generator=gen) + 1000.0,
                   torch.randn((1, 40, 3), generator=gen) - 150.0,
                   torch.randn((1, 40, 3), generator=gen) * 300.0], dim=1)
    kw = dict(query=q, points=p, points_mask=None, k=16)
    _assert_knn_matches(cases.to_device(kw, device))
    sq, sm, sp, spm = cases.stretch_clouds(87, 8192)
    kw = cases.knn_tiled_case(1, sq, sm, sp, spm)
    kw["query"] = kw["query"] + torch.tensor([500.0, -300.0, 20.0])
    _assert_knn_matches(cases.to_device(kw, device), shapes=[(32, 128)])


def test_measuring_builds_stay_apart_from_the_ports(device):
    """kernels/tune.py's measuring builds: the skeleton runs B1's ball
    query (indices as the plain version's) and no layer (outputs 0) and
    B5's scan without an insertion (no slot valid); with the gate off B5
    selects as the plain version. After each block the port's own kernels
    run again."""
    kw = cases.to_device(_tile_sa_case("sa2", 2, 300, 100, 250, seed=89),
                         device)
    _, _, ja, jb = fused_sa.sa_pair_reference(**kw)
    kn = cases.to_device(cases.knn_tiled_case(
        1, *_stretch_clouds(89, 2048)), device)
    with kb.measuring("RATRACK_SKELETON"):
        oa, ob, ia, ib = fused_sa.sa_pair(**kw, return_indices=True)
        _, _, valid = fused_knn.knn_indices_tiled(**kn, return_keys=True)
        torch.cuda.synchronize()
    assert torch.equal(ia.long(), ja) and torch.equal(ib.long(), jb)
    assert not bool(oa.any()) and not bool(ob.any())
    assert not bool(valid.any())
    with kb.measuring("RATRACK_KNN_NO_GATE"):
        _assert_knn_matches(kn, shapes=[])
    _assert_pair_matches(kw)
    _assert_knn_matches(kn, shapes=[])


@pytest.mark.parametrize("what", ["pair", "scale", "knn", "fp", "select"])
def test_sa_and_knn_launches_per_call(device, what):
    """CUDA kernels one wrapper call launches, counted by torch.profiler
    over one call at each tile (B1, B1': one launch of the SA
    kernel each; B3's selection: one launch) or at each launch shape (B5:
    the packing launch and the selection launch each; B2: one launch),
    all in one torch.profiler run."""
    if what == "fp":
        kw = cases.to_device(cases.fp_case("fp2", *cases.clouds(88, 2)[:2],
                                           _gen(88)), device)
        got = _package_kernels(lambda: [fused_fp.fused_three_interpolate(
            **kw, shape=shape) for shape in FP_SHAPES])
        assert got == ["three_interpolate_kernel"] * len(FP_SHAPES), got
        return
    if what == "select":
        pc1, m1, pc2, m2 = [t.to(device) for t in cases.clouds(88, 2)]
        got = _package_kernels(lambda: [fused_correlator.launch_knn(
            pc1, pc2, m2, 16, queries=q) for q in SELECT_QUERIES])
        assert got == ["knn_staged_kernel"] * len(SELECT_QUERIES), got
        return
    if what == "knn":
        kw = cases.to_device(cases.knn_tiled_case(
            1, *_stretch_clouds(88, 2048)), device)
        shapes = [None] + KNN_SHAPES
        got = _package_kernels(lambda: [fused_knn.knn_indices_tiled(
            **kw, shape=shape) for shape in shapes])
        assert sorted(got) == sorted(
            ["knn_prep_kernel", "knn_select_kernel"] * len(shapes)), got
        return
    kw = cases.to_device(_tile_sa_case("sa3", 2, 300, 100, seed=88), device)
    single = cases.split_sa_case(kw)[1]
    if what == "pair":
        got = _package_kernels(lambda: [fused_sa.sa_pair(
            **kw, tile=tile) for tile in SA_TILES])
    else:
        got = _package_kernels(lambda: [fused_sa.sa_scale(
            **single, tile=tile) for tile in SA_TILES])
    assert got == ["sa_kernel"] * len(SA_TILES), got


# ---- B2 over lane groups, B3's selection in one pass ----------------------

FP_SHAPES = [None] + list(fused_fp.KERNEL_SHAPES)
SELECT_QUERIES = (None,) + fused_correlator.KNN_QUERIES


def _stream(device, *arrays):
    """numpy arrays of one stream as (1, ...) tensors on `device`."""
    return [None if a is None else
            torch.from_numpy(np.ascontiguousarray(a))[None].to(device)
            for a in arrays]


def _assert_fp_shapes_match(unknown, known, feats, mask=None,
                            shapes=FP_SHAPES):
    ref, ridx = fused_fp.three_interpolate_reference(unknown, known, feats,
                                                     mask)
    for shape in shapes:
        out, idx = fused_fp.fused_three_interpolate(
            unknown, known, feats, mask, return_indices=True, shape=shape)
        torch.cuda.synchronize()
        assert torch.equal(idx.long(), ridx), shape
        _assert_close(out, ref)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("m", cases.FP_PARTITION_KNOWN + (5000,))
def test_fp_every_shape_at_lane_group_shapes(device, m, n):
    """The CPU tests' known counts (fewer than 3, lane groups part-filled)
    and 5000 (two staged pieces of 4096), at every launch shape."""
    _assert_fp_shapes_match(*_stream(device, *cases.fp_partition_case(
        m, n, seed=m + n)))


@pytest.mark.parametrize("n_valid", [None, 0, 1, 2])
def test_fp_every_shape_duplicates_and_few_valid(device, n_valid):
    """Known points repeated 1, 3 and 5 places later (ties on other lanes
    of a group), all valid or 0, 1, 2 of them."""
    _assert_fp_shapes_match(*_stream(device, *cases.fp_partition_case(
        100, 256, c=128, n_valid=n_valid, duplicates=True, seed=97)))


@pytest.mark.parametrize("n, npoint", [(4096, None), (8192, 512)])
def test_fp_every_shape_at_the_large_shapes(device, n, npoint):
    """One stream of 4096 unknowns over 4096 known points and the stretch
    fp1, 8192 unknowns over 512 farthest-point centers."""
    pc, mask, _, _ = cases.stretch_clouds(90, n)
    kw = cases.to_device(cases.fp_case("fp1", pc, mask, _gen(90),
                                       npoint=npoint), device)
    _assert_fp_shapes_match(kw["unknown"], kw["known"], kw["feats"])


def _assert_select_matches(query, points, mask, queries=SELECT_QUERIES):
    _, ridx = knn(16, query, points, mask)
    for q in queries:
        idx = fused_correlator.launch_knn(query, points, mask, 16, queries=q)
        torch.cuda.synchronize()
        assert torch.equal(idx.long(), ridx), q


@pytest.mark.parametrize("m", cases.SELECT_PARTITION_CANDIDATES + (5000,))
def test_select_every_tile_at_batch_shapes(device, m):
    """The CPU tests' candidate counts (a part-filled last batch of 16, a
    whole 4096-point piece) and 5000 (two pieces), at every tile."""
    _assert_select_matches(*_stream(device, *cases.select_partition_case(
        m, seed=m)))


@pytest.mark.parametrize("n_valid", [0, 1, 15, 16, 17])
def test_select_every_tile_few_valid(device, n_valid):
    _assert_select_matches(*_stream(device, *cases.select_partition_case(
        513, n_valid=n_valid, seed=100 + n_valid)))


@pytest.mark.parametrize("m", [33, 4096])
def test_select_every_tile_ties_across_lanes(device, m):
    _assert_select_matches(*_stream(device, *cases.select_partition_case(
        m, ties=True, seed=120 + m)))


def test_select_every_tile_at_the_path_shapes(device):
    """Both correlator stages at 8 streams x 512 points (eval) and one
    stream of 4096 (the largest dense cloud)."""
    for pc1, m1, pc2, m2 in (cases.clouds(91, 8), cases.stretch_clouds(91,
                                                                        4096)):
        pc1, m1, pc2, m2 = [t.to(device) for t in (pc1, m1, pc2, m2)]
        _assert_select_matches(pc1, pc2, m2)
        _assert_select_matches(pc1, pc1, m1)


def test_fp_and_select_repeat_run_to_run(device):
    """B2 and B3's selection give identical results twice on the same
    inputs, at the eval shape."""
    pc1, m1, pc2, m2 = [t.to(device) for t in cases.clouds(92, 8)]
    kw = cases.to_device(cases.fp_case("fp1", pc1.cpu(), m1.cpu(),
                                       _gen(92)), device)
    a = fused_fp.fused_three_interpolate(**kw, return_indices=True)
    b = fused_fp.fused_three_interpolate(**kw, return_indices=True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    i1 = fused_correlator.launch_knn(pc1, pc2, m2, 16)
    i2 = fused_correlator.launch_knn(pc1, pc2, m2, 16)
    torch.cuda.synchronize()
    assert torch.equal(i1, i2)


def test_fp_and_select_measuring_builds(device):
    """The skeleton of B3's selection stages and scans but inserts nothing
    (every index 0); B2's scans one known point a lane (indices in range,
    outputs finite). After the block the port's kernels select as the
    plain versions again."""
    pc1, m1, pc2, m2 = [t.to(device) for t in cases.clouds(93, 2)]
    kw = cases.to_device(cases.fp_case("fp2", pc1.cpu(), m1.cpu(),
                                       _gen(93)), device)
    with kb.measuring("RATRACK_SKELETON"):
        idx = fused_correlator.launch_knn(pc1, pc2, m2, 16)
        out, fidx = fused_fp.fused_three_interpolate(**kw,
                                                     return_indices=True)
        torch.cuda.synchronize()
    assert not bool(idx.any())
    m = kw["known"].shape[1]
    assert bool(((fidx >= 0) & (fidx < m)).all())
    assert bool(torch.isfinite(out).all())
    _assert_select_matches(pc1, pc2, m2, queries=[None])
    _assert_fp_shapes_match(kw["unknown"], kw["known"], kw["feats"],
                            shapes=[None])


def test_fp_and_select_refuse_what_the_kernels_do_not_take(device):
    """B2 raises on a channel count that is not a multiple of 4 (float4
    rows) and on a launch shape it does not offer; the selection on a tile
    it does not offer."""
    pc1, m1, pc2, m2 = [t.to(device) for t in cases.clouds(94, 2)]
    feats = torch.randn((2, pc1.shape[1], 6), device=device)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_fp.fused_three_interpolate(pc1, pc1, feats)
    with pytest.raises(ValueError, match="shape"):
        fused_fp.fused_three_interpolate(pc1, pc1, feats[..., :4].contiguous(),
                                         shape=(64, 8))
    with pytest.raises(ValueError, match="queries"):
        fused_correlator.launch_knn(pc1, pc2, m2, 16, queries=12)


# ---- the pipelined eval step, the Sinkhorn early exit ---------------------

def _pipelined_world(device, **kw):
    """4 streams x 4 frames of 256 points (stream 0 starts a new sequence
    at frame 2) and a seeded Track4D of 50 Sinkhorn iterations on the
    card."""
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, to_tensors
    from ratrack_tpu_torch.models import Track4D

    n, k = 256, 16
    clips = [stack_frames(synthetic_clip(s, 4, n_max=n, g_max=k,
                                         n_static=150, n_objects=4))
             for s in range(4)]
    frames = stack_frames(clips)
    new_seq = np.asarray(frames.new_seq).copy()
    new_seq[0, 2] = True
    frames = frames._replace(new_seq=new_seq)
    model = Track4D(npoint=n, k_max=k, sinkhorn_iters=50,
                    generator=torch.Generator().manual_seed(0), device=device,
                    **kw)
    return model, to_tensors(frames, device), k


def _assert_same_tracking(got, want):
    """Phase 4's gates: cls and warp within 1e-3, at most 1% of labels and
    track ids apart."""
    for key in ("cls", "warp"):
        np.testing.assert_allclose(got[key].cpu().numpy(),
                                   want[key].cpu().numpy(), atol=1e-3)
    for key in ("labels", "track_id"):
        bad = (got[key].cpu() != want[key].cpu()).float().mean().item()
        assert bad <= 0.01, (key, bad)


def test_pipelined_step_on_the_card_matches_the_sequential_scan(device):
    """One launch of B1 / B2 / B3 per SA level / FP level / correlator stage
    for the whole block (9 / 9 / 2), and the sequential scan's tracking."""
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (make_pipelined_eval_step,
                                         make_scan_eval_step)

    model, frames, k = _pipelined_world(device)
    b = frames.pc1.shape[0]
    _, want = make_scan_eval_step(model)(init_state(b, k, device=device),
                                         frames)
    counters = (fused_sa.sa_pair, fused_fp.fused_three_interpolate,
                fused_correlator.fused_knn_weight_aggregate)
    before = [fn.launches for fn in counters]
    _, got = make_pipelined_eval_step(model)(init_state(b, k, device=device),
                                             frames)
    torch.cuda.synchronize()
    assert [fn.launches - x for fn, x in zip(counters, before)] == [9, 9, 2]
    _assert_same_tracking(got, want)
    assert (got["track_id"] >= 0).any()


def test_pipelined_step_with_the_sinkhorn_kernel_launches_b7_once(device):
    """With `sinkhorn_kernel` the block's B * T matchings are one launch of
    B7, and the tracking is the sequential scan's with the same switch."""
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (make_pipelined_eval_step,
                                         make_scan_eval_step)

    model, frames, k = _pipelined_world(device, sinkhorn_kernel=True)
    b = frames.pc1.shape[0]
    _, want = make_scan_eval_step(model)(init_state(b, k, device=device),
                                         frames)
    before = fused_sinkhorn.sinkhorn_uv.launches
    _, got = make_pipelined_eval_step(model)(init_state(b, k, device=device),
                                             frames)
    torch.cuda.synchronize()
    assert fused_sinkhorn.sinkhorn_uv.launches - before == 1
    _assert_same_tracking(got, want)


@pytest.mark.parametrize("safe_lse", [True, False])
def test_sinkhorn_early_exit_on_the_card_matches_the_cpu(device, safe_lse):
    """The early exit (tol 1e-4) on 64 streams with m, n in 0..32: for
    each stream with a valid row and column, the coupling's valid block
    within 1e-4 of the CPU run and its iteration count within one of the
    CPU's; B7 never launched (the loop is eager torch). (A stream with no row or no column has no
    transport plan: its bin potential drifts every iteration, and no
    output of the association reads it.)"""
    from ratrack_tpu_torch.tracker import sinkhorn

    _, raw = cases.sinkhorn_case(3, 64, 32, 500)
    c, log_mu, log_nu, norm = sinkhorn.transport_problem(
        raw["scores"], raw["m"], raw["n"], 0.9)
    before = fused_sinkhorn.sinkhorn_uv.launches
    runs = {}
    for dev in ("cpu", device):
        u, v, count = sinkhorn.sinkhorn_uv_early_exit(
            c.to(dev), log_mu.to(dev), log_nu.to(dev), 500, 1e-4,
            safe_lse=safe_lse)
        z = sinkhorn.log_optimal_transport_masked(
            raw["scores"].to(dev), raw["m"].to(dev), raw["n"].to(dev), 0.9,
            500, tol=1e-4, safe_lse=safe_lse)
        runs[str(dev)] = (z.cpu(), count.cpu())
    assert fused_sinkhorn.sinkhorn_uv.launches == before
    (z_cpu, n_cpu), (z_gpu, n_gpu) = runs["cpu"], runs[str(device)]
    k = 32
    for s, (m, n) in enumerate(zip(raw["m"].tolist(), raw["n"].tolist())):
        if not (m and n):
            continue
        assert abs(int(n_cpu[s]) - int(n_gpu[s])) <= 1, s
        rows, cols = list(range(m)) + [k], list(range(n)) + [k]
        np.testing.assert_allclose(
            z_gpu[s][np.ix_(rows, cols)].numpy(),
            z_cpu[s][np.ix_(rows, cols)].numpy(), atol=1e-4, rtol=0)


# ---- the Sinkhorn loop as one CUDA graph ----------------------------------

_OT_COUNTERS = ("captures", "replays", "eager_on_device")


@pytest.fixture
def no_graphs():
    """No Sinkhorn graph captured before the test; none kept after it."""
    from ratrack_tpu_torch.tracker import sinkhorn
    sinkhorn._graphs.clear()
    yield sinkhorn
    sinkhorn._graphs.clear()


def _ot_counts(sinkhorn):
    return [getattr(sinkhorn.log_optimal_transport_masked, a)
            for a in _OT_COUNTERS]


def _ot_problems(b, k=32, seed=0):
    """Sigmoid scores (b, k, k) and the m, n (b,) of every stream: stream 0
    has no row, stream 1 no column, stream 2 is full, the rest random; one
    stream is each kind in turn, so b = 1 gives three problems."""
    _, raw = cases.sinkhorn_case(seed, max(b, 3), k, 500)
    m, n = raw["m"].clone(), raw["n"].clone()
    m[2], n[2] = k, k
    if b > 1:
        return [(raw["scores"][:b], m[:b], n[:b])]
    return [(raw["scores"][i:i + 1], m[i:i + 1], n[i:i + 1])
            for i in range(3)]


def _ot_eager(sinkhorn, scores, m, n, iters, safe_lse):
    """The coupling by the eager loop on the card, as the call ran it
    before the graph."""
    c, log_mu, log_nu, norm = sinkhorn.transport_problem(scores, m, n, 0.9)
    solve = (sinkhorn._sinkhorn_uv_safe if safe_lse
             else fused_sinkhorn.sinkhorn_uv_reference)
    return sinkhorn._coupling(c, *solve(c, log_mu, log_nu, iters), norm)


def _same_bits(a, b):
    """Equal bit for bit, NaNs too: with the two-pass log-sum-exp a stream
    with no row drifts to NaN after 500 iterations, in the eager loop as
    in its graph, and NaN != NaN under torch.equal."""
    return a.dtype == b.dtype == torch.float32 and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("safe_lse", [False, True])
@pytest.mark.parametrize("b", [32, 8, 1])
def test_sinkhorn_graph_equals_the_eager_loop(device, no_graphs, b,
                                              safe_lse):
    """The replayed graph's coupling equals the eager loop's bit for bit
    (the same kernels on the same shapes), streams with m = 0, n = 0 and
    full among them; the first call of the shape captures, the later ones
    replay, none takes the eager loop."""
    sinkhorn = no_graphs
    before = _ot_counts(sinkhorn)
    calls = 0
    for seed in (0, 1):
        for scores, m, n in _ot_problems(b, seed=seed):
            scores, m, n = scores.to(device), m.to(device), n.to(device)
            z = sinkhorn.log_optimal_transport_masked(
                scores, m, n, 0.9, 500, safe_lse=safe_lse)
            want = _ot_eager(sinkhorn, scores, m, n, 500, safe_lse)
            assert _same_bits(z, want), (seed, m.tolist(), n.tolist())
            calls += 1
    after = _ot_counts(sinkhorn)
    assert [a - b0 for a, b0 in zip(after, before)] == [1, calls - 1, 0]


def test_sinkhorn_graph_result_outlives_the_next_replay(device, no_graphs):
    """Two calls of one shape on different inputs: the first call's result
    is a tensor of its own, unchanged by the second replay."""
    sinkhorn = no_graphs
    (s0, m0, n0), = _ot_problems(8, seed=0)
    (s1, m1, n1), = _ot_problems(8, seed=1)
    args0 = [x.to(device) for x in (s0, m0, n0)]
    args1 = [x.to(device) for x in (s1, m1, n1)]
    z0 = sinkhorn.log_optimal_transport_masked(*args0[:3], 0.9, 500,
                                               safe_lse=False)
    kept = z0.clone()
    z1 = sinkhorn.log_optimal_transport_masked(*args1[:3], 0.9, 500,
                                               safe_lse=False)
    torch.cuda.synchronize()
    assert torch.equal(z0, kept)
    assert not torch.equal(z0, z1)
    assert torch.equal(z0, _ot_eager(sinkhorn, *args0, 500, False))
    assert torch.equal(z1, _ot_eager(sinkhorn, *args1, 500, False))


def test_sinkhorn_graph_counters_and_eviction(device, no_graphs,
                                              monkeypatch):
    """The first call of a shape captures and the next replays; an input
    that requires grad, tol > 0, B7 and a call inside a capture already
    under way each take the eager loop (eager_on_device) and capture
    nothing; a ninth shape on the device drops the least recently used
    graph, which its next call captures again."""
    sinkhorn = no_graphs
    ot = sinkhorn.log_optimal_transport_masked
    (scores, m, n), = _ot_problems(8)
    scores, m, n = scores.to(device), m.to(device), n.to(device)

    def delta(fn):
        before = _ot_counts(sinkhorn)
        out = fn()
        torch.cuda.synchronize()
        return [a - b for a, b in zip(_ot_counts(sinkhorn), before)], out

    assert delta(lambda: ot(scores, m, n, 0.9, 50, safe_lse=False))[0] \
        == [1, 0, 0]
    assert delta(lambda: ot(scores, m, n, 0.9, 50, safe_lse=False))[0] \
        == [0, 1, 0]
    grad_in = scores.clone().requires_grad_()
    assert delta(lambda: ot(grad_in, m, n, 0.9, 50, safe_lse=False))[0] \
        == [0, 0, 1]
    assert delta(lambda: ot(scores, m, n, 0.9, 50, tol=1e-4,
                            safe_lse=False))[0] == [0, 0, 1]
    b7 = fused_sinkhorn.sinkhorn_uv.launches
    assert delta(lambda: ot(scores, m, n, 0.9, 50, safe_lse=False,
                            use_fused_kernel=True))[0] == [0, 0, 1]
    assert fused_sinkhorn.sinkhorn_uv.launches == b7 + 1

    # transport_problem makes device tensors from Python scalars, which a
    # capture refuses: the outer capture gets the problem made before it
    problem = sinkhorn.transport_problem(scores, m, n, 0.9)
    monkeypatch.setattr(sinkhorn, "transport_problem", lambda *a: problem)
    outer = torch.cuda.CUDAGraph()
    before = _ot_counts(sinkhorn)
    with torch.cuda.graph(outer):      # no synchronize inside a capture
        z = ot(scores, m, n, 0.9, 50, safe_lse=False)
    assert [a - b for a, b in zip(_ot_counts(sinkhorn), before)] == [0, 0, 1]
    outer.replay()
    torch.cuda.synchronize()
    assert torch.equal(z, _ot_eager(sinkhorn, scores, m, n, 50, False))
    monkeypatch.undo()

    keys = []
    for bb in range(1, 10):
        s, mm, nn = (x[:bb] for x in (scores.repeat(2, 1, 1), m.repeat(2),
                                      n.repeat(2)))
        got, _ = delta(lambda: ot(s, mm, nn, 0.9, 5, safe_lse=False))
        assert got == [1, 0, 0], bb
        keys.append((torch.device(device.type, torch.cuda.current_device()),
                     bb, 33, torch.float32, 5, False))
    held = [k for k in sinkhorn._graphs if k[0] == keys[0][0]]
    assert len(held) == sinkhorn._GRAPHS_PER_DEVICE == 8
    assert keys[0] not in held and keys[1] in held and keys[8] in held
    s, mm, nn = scores[:1], m[:1], n[:1]
    assert delta(lambda: ot(s, mm, nn, 0.9, 5, safe_lse=False))[0] \
        == [1, 0, 0]
    assert keys[1] not in sinkhorn._graphs


def test_scan_with_the_sinkhorn_graph_equals_the_eager_loop(
        device, no_graphs, monkeypatch):
    """Four streams x 4 frames of the cached eval scan at 512 points, k_max
    32 and 500 iterations, every valid point moving (mov_thres 0) so that
    every frame has clusters to match: labels, track ids and conf equal by
    torch.equal with the graph and with the eager loop; every Sinkhorn call
    of the graphed run captured or replayed."""
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, to_tensors
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    sinkhorn = no_graphs
    n, k, b, t = 512, 32, 4, 4
    clips = [stack_frames(synthetic_clip(s, t, n_max=n, g_max=k,
                                         n_static=300, n_objects=5))
             for s in range(b)]
    frames = to_tensors(stack_frames(clips), device)
    model = Track4D(npoint=n, k_max=k, mov_thres=0.0,
                    generator=torch.Generator().manual_seed(0), device=device)
    scan = make_scan_eval_step_cached(model)
    before = _ot_counts(sinkhorn)
    _, graphed = scan(init_state(b, k, device=device), frames)
    torch.cuda.synchronize()
    assert [a - b0 for a, b0 in zip(_ot_counts(sinkhorn), before)] \
        == [1, t - 1, 0]
    monkeypatch.setattr(
        sinkhorn, "_replayed",
        lambda solve, c, log_mu, log_nu, norm, iters, safe_lse:
        sinkhorn._coupling(c, *solve(c, log_mu, log_nu, iters), norm))
    _, eager = scan(init_state(b, k, device=device), frames)
    assert int((eager["labels"] >= 0).sum()) > 0
    assert int((eager["track_id"] >= 0).sum()) > 0
    for key in ("labels", "track_id", "conf"):
        assert torch.equal(graphed[key], eager[key]), key


# ---- bfloat16 operands: B1, B1', B2, B3, B4 --------------------------------

def _assert_bf16_close(got, want):
    """Within one bfloat16 step of the largest plain value (see the module
    docstring)."""
    assert got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max().item()
    tol = 2.0 ** -8 * want.abs().max().item() + 1e-5
    assert err <= tol, (err, tol)


def _bf16(kw, device):
    return cases.to_device(cases.bf16_case(kw), device)


@pytest.mark.parametrize("head", ["pn_head", "mse"])
@pytest.mark.parametrize("level", ["sa1", "sa2", "sa3"])
def test_sa_pair_bf16_matches_plain(device, level, head):
    pc1, m1, _, _ = cases.clouds(90, 4)
    kw = _bf16(cases.sa_case(level, head, pc1, m1, _gen(90)), device)
    before = fused_sa.sa_pair.bf16.launches, fused_sa.sa_pair.launches
    oa, ob, ia, ib = fused_sa.sa_pair(**kw, return_indices=True)
    ra, rb, ja, jb = fused_sa.sa_pair_reference(**kw)
    torch.cuda.synchronize()
    assert (fused_sa.sa_pair.bf16.launches,
            fused_sa.sa_pair.launches) == (before[0] + 1, before[1])
    assert torch.equal(ia.long(), ja) and torch.equal(ib.long(), jb)
    _assert_bf16_close(oa, ra)
    _assert_bf16_close(ob, rb)


@pytest.mark.parametrize("n_valid", [0, 1, 5])
def test_sa_pair_bf16_no_hit_rows(device, n_valid):
    """A center without a hit pools relu(P1[0] - CW) from the float32 row
    in the bfloat16 kernel too."""
    pc1, _, _, _ = cases.clouds(91, 2)
    mask = (torch.arange(pc1.shape[1]) < n_valid).expand(2, -1).contiguous()
    kw = _bf16(cases.sa_case("sa1", "pn_head", pc1, mask, _gen(91)), device)
    for tile in SA_TILES:
        oa, ob, ia, ib = fused_sa.sa_pair(**kw, return_indices=True,
                                          tile=tile)
        ra, rb, ja, jb = fused_sa.sa_pair_reference(**kw)
        torch.cuda.synchronize()
        assert torch.equal(ia.long(), ja) and torch.equal(ib.long(), jb)
        _assert_bf16_close(oa, ra)
        _assert_bf16_close(ob, rb)


@pytest.mark.parametrize("level", LEVELS)
def test_sa_scale_bf16_matches_plain(device, level):
    """B1' in bfloat16 on every scale of the general levels, and a pair
    launch equal to two one-scale launches bit for bit."""
    pc1, m1, _, _ = cases.clouds(92, 4)
    for kw in cases.sa_scale_cases(level, pc1, m1, _gen(92)):
        kw = _bf16(kw, device)
        out, idx = fused_sa.sa_scale(**kw, return_indices=True)
        ref, ridx = fused_sa.sa_scale_reference(**kw)
        torch.cuda.synchronize()
        assert torch.equal(idx.long(), ridx)
        _assert_bf16_close(out, ref)
    kw = _bf16(cases.sa_case("sa2", "pn_head", pc1, m1, _gen(93)), device)
    pair = fused_sa.sa_pair(**kw, return_indices=True)
    for i, single in enumerate(cases.split_sa_case(kw)):
        one = fused_sa.sa_scale(**single, return_indices=True,
                                compute_dtype=torch.bfloat16)
        assert torch.equal(pair[i], one[0]) and torch.equal(pair[i + 2],
                                                            one[1])


@pytest.mark.parametrize("level", ["fp3", "fp2", "fp1"])
def test_fp_bf16_matches_plain(device, level):
    """B2 on bfloat16 known features, at every launch shape."""
    pc1, m1, _, _ = cases.clouds(94, 4)
    kw = _bf16(cases.fp_case(level, pc1, m1, _gen(94)), device)
    assert kw["feats"].dtype == torch.bfloat16
    ref, ridx = fused_fp.three_interpolate_reference(**kw)
    for shape in FP_SHAPES:
        out, idx = fused_fp.fused_three_interpolate(
            **kw, return_indices=True, shape=shape)
        torch.cuda.synchronize()
        assert torch.equal(idx.long(), ridx), shape
        _assert_bf16_close(out, ref)


@pytest.mark.parametrize("n_valid", [0, 5, None])
@pytest.mark.parametrize("stage", [1, 2])
def test_correlator_bf16_matches_plain(device, stage, n_valid):
    """B3 in bfloat16 (gathered rows and coordinates rounded), with every,
    five or no candidate valid."""
    pc1, m1, pc2, m2 = cases.clouds(95, 4)
    if n_valid is not None:
        m2 = (torch.arange(pc1.shape[1]) < n_valid).expand(4, -1).contiguous()
        m1 = m2
    kw = _bf16(cases.corr_case(stage, pc1, m1, pc2, m2, _gen(95)), device)
    out, idx = fused_correlator.fused_knn_weight_aggregate(
        **kw, return_indices=True)
    ref, ridx = fused_correlator.knn_weight_aggregate_reference(**kw)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ridx)
    _assert_bf16_close(out, ref)


@pytest.mark.parametrize("block_rows", [None, 64, 128])
@pytest.mark.parametrize("stage", [1, 2])
def test_knn_gather_apply_bf16_matches_plain(device, stage, block_rows):
    """B4 in bfloat16 (rows gathered in float32) at both block shapes, 1024
    and 300 queries."""
    kw = cases.apply_case(stage, *_stretch_clouds(96, 1024), _gen(96))
    for n in (1024, 300):
        part = dict(kw)
        for key in ("query", "add_q", "idx"):
            if part[key] is not None:
                part[key] = part[key][:, :n].contiguous()
        part = _bf16(part, device)
        before = fused_correlator.knn_gather_apply.bf16.launches
        out = fused_correlator.knn_gather_apply(**part,
                                                block_rows=block_rows)
        ref = fused_correlator.knn_gather_apply_reference(**part)
        torch.cuda.synchronize()
        assert fused_correlator.knn_gather_apply.bf16.launches == before + 1
        _assert_bf16_close(out, ref)


def test_bf16_wrappers_launch_one_kernel_each(device):
    """A bfloat16 call of B1, B1', B2, B4 is one launch of its kernel, of
    B3 the selection and one aggregate launch (torch.profiler)."""
    pc1, m1, pc2, m2 = cases.clouds(97, 2)
    sa = _bf16(cases.sa_case("sa3", "pn_head", pc1, m1, _gen(97)), device)
    single = cases.split_sa_case(sa)[1]
    fp = _bf16(cases.fp_case("fp2", pc1, m1, _gen(97)), device)
    ck = _bf16(cases.corr_case(1, pc1, m1, pc2, m2, _gen(97)), device)
    ap = _bf16(cases.apply_case(2, *_stretch_clouds(97, 1024), _gen(97)),
               device)
    got = _package_kernels(lambda: (
        fused_sa.sa_pair(**sa),
        fused_sa.sa_scale(**single, compute_dtype=torch.bfloat16),
        fused_fp.fused_three_interpolate(**fp),
        fused_correlator.fused_knn_weight_aggregate(**ck),
        fused_correlator.knn_gather_apply(**ap)))
    assert sorted(got) == sorted(
        ["sa_kernel"] * 2 + ["three_interpolate_kernel", "knn_staged_kernel"]
        + ["aggregate_kernel"] * 2), got


def test_track4d_bf16_gpu_matches_cpu(device):
    """Two streams x 3 frames of the bfloat16 cached scan on the card
    against the same bfloat16 model on the CPU (plain versions), at
    chip_smoke.py phase 19's gates: over the valid points cls within 0.02
    on average and 0.5 at most, flow within 0.05 on average and 1.0 at
    most (the JAX package's two bfloat16 paths differ by 0.009 / 0.195 and
    0.023 / 0.375: a bfloat16 step in the heads moves the random weights'
    large logits, tests/test_torch_port_bf16.py), labels mismatching on at
    most 1% of points; the bfloat16 kernels launched, the float32 ones
    not."""
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, to_tensors
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    n, k = 128, 8
    frames = stack_frames([stack_frames(synthetic_clip(
        s, 3, n_max=n, g_max=k, n_static=60, n_objects=3)) for s in range(2)])
    model = Track4D(npoint=n, k_max=k, sinkhorn_iters=50,
                    dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    scan = make_scan_eval_step_cached(model)
    _, cpu = scan(init_state(2, k, device="cpu"), to_tensors(frames, "cpu"))
    model.to(device)
    f32_before = fused_sa.sa_pair.launches
    bf_before = fused_sa.sa_pair.bf16.launches
    _, gpu = scan(init_state(2, k, device=device), to_tensors(frames, device))
    assert fused_sa.sa_pair.launches == f32_before
    assert fused_sa.sa_pair.bf16.launches == bf_before + 6 * 3 + 3
    assert gpu["cls"].dtype == torch.bfloat16
    valid = torch.from_numpy(frames.mask1)
    d_cls = (gpu["cls"].cpu().float() - cpu["cls"].float()).abs()[valid]
    d_flow = (gpu["warp"].cpu() - cpu["warp"]).abs()[valid]
    assert d_cls.mean().item() <= 0.02 and d_cls.max().item() <= 0.5, (
        d_cls.mean().item(), d_cls.max().item())
    assert d_flow.mean().item() <= 0.05 and d_flow.max().item() <= 1.0, (
        d_flow.mean().item(), d_flow.max().item())
    labels_bad = (gpu["labels"].cpu() != cpu["labels"]).float().mean().item()
    assert labels_bad <= 0.01, labels_bad


def _bf16_train_step(device, dtype, n=128, k=8, streams=2):
    """One train step of Track4D(npoint=n, dtype=dtype) with seeded weights
    over `streams` synthetic streams on `device` -> (loss items, float64
    gradients on the CPU, launches of B9 / B10 forward and backward and
    of every eval kernel, float32 and bfloat16)."""
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, to_tensors
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_train_step)
    frame = to_tensors(stack_frames([synthetic_clip(
        s, 1, n_max=n, g_max=k, n_static=60, n_objects=3)[0]
        for s in range(streams)]), device)
    model = Track4D(npoint=n, k_max=k, sinkhorn_iters=20, dtype=dtype,
                    generator=torch.Generator().manual_seed(0), device=device)
    ts = create_train_state(model, TrainConfig(), steps_per_epoch=10,
                            device=device)
    counters = [fused_sa_train.sa_pair_train_fwd,
                fused_sa_train.sa_pair_train_bwd,
                fused_correlator_train.knn_weight_aggregate_train_fwd,
                fused_correlator_train.knn_weight_aggregate_train_bwd]
    evals = [fused_sa.sa_pair, fused_fp.fused_three_interpolate,
             fused_correlator.fused_knn_weight_aggregate]
    counters += evals + [c.bf16 for c in evals]
    before = [c.launches for c in counters]
    _, items = make_train_step(ts)(init_state(streams, k, device=device),
                                   frame, False)
    if frame.pc1.is_cuda:
        torch.cuda.synchronize()
    grads = {n_: p.grad.detach().double().cpu()
             for n_, p in model.named_parameters()}
    return ({k_: v.double().cpu() for k_, v in items.items()}, grads,
            [c.launches - b for c, b in zip(counters, before)])


def test_train_step_bf16_launches_the_float32_train_kernels(device):
    """A bfloat16 model's train step launches what a float32 model's does:
    B9 / B10 forward and backward 9 / 9 / 2 / 2 times a frame step (the
    train kernels take no compute dtype), and no eval kernel in either
    instantiation."""
    for dtype in (torch.float32, torch.bfloat16):
        _, _, launches = _bf16_train_step(device, dtype)
        assert launches == [9, 9, 2, 2, 0, 0, 0, 0, 0, 0], (dtype, launches)


def test_train_step_bf16_gpu_matches_cpu(device):
    """One bfloat16 train step (2 streams x 128 points) on the card
    against the CPU, both held to the CPU's float32 step by the rule of
    tests/test_torch_port_bf16_train.py: loss items within 2e-2 of the
    CPU's (a stream whose BCE saturated gives the largest float on both);
    gradient leaves NaN on the card exactly where on the CPU (the
    reference's saturated bfloat16 BCE, ROADMAP), and every other leaf
    and all of them together |g - g_f32| <= 1e-2 |G| + 2 |g_cpu - g_f32|
    in norm."""
    got, g_gpu, _ = _bf16_train_step(device, torch.bfloat16)
    want, g_cpu, _ = _bf16_train_step("cpu", torch.bfloat16)
    _, g_f32, _ = _bf16_train_step("cpu", torch.float32)
    for key, w in want.items():
        g = got[key]
        sat = w.abs() >= 1e30
        assert torch.equal(g.abs() >= 1e30, sat), key
        assert ((g - w).abs() <= 2e-2 * w.abs() + 1e-6)[~sat].all(), (
            key, g, w)
    nan = sorted(n for n, g in g_cpu.items() if not torch.isfinite(g).all())
    assert nan == sorted(n for n, g in g_gpu.items()
                         if not torch.isfinite(g).all())
    names = [n for n in sorted(g_f32) if n not in nan]
    assert names and all(torch.isfinite(g_f32[n]).all() for n in names)
    flat = [torch.cat([d[n].flatten() for n in names])
            for d in (g_gpu, g_cpu, g_f32)]
    total = flat[2].norm().item()
    for name, g, c, f in [(n, g_gpu[n], g_cpu[n], g_f32[n]) for n in names
                          ] + [("all", *flat)]:
        err, own = (g - f).norm().item(), (c - f).norm().item()
        assert err <= 1e-2 * total + 2 * own, (name, err, own, total)


# Digests of the float32 eval kernels' outputs (kernels/digest.py) that the
# tree before the bfloat16 instantiations printed on an NVIDIA H100 80GB
# HBM3; the float32 instantiations must still give them bit for bit.
F32_DIGESTS = {
    "knn_gather_apply.stage1": "002af6c66daf9bd4",
    "knn_gather_apply.stage2": "533f3a61b55693e5",
    "knn_weight_aggregate.stage1": "4159fa9b708af5e6",
    "knn_weight_aggregate.stage2": "8473e4a2e5f3eb91",
    "sa_pair.mse.sa1": "c877340230a18290",
    "sa_pair.mse.sa2": "e698f8df482dc67e",
    "sa_pair.mse.sa3": "bcb48c2d1bf6d565",
    "sa_pair.pn_head.sa1": "92b27aa8bbfd5561",
    "sa_pair.pn_head.sa2": "bd2cb27ec6f008e3",
    "sa_pair.pn_head.sa3": "7d79ae412847934d",
    "sa_scale.three_scales.0": "55a0e54825b32bae",
    "sa_scale.three_scales.1": "8968dea11d61a8f3",
    "sa_scale.three_scales.2": "7d9fd83e1f63ce08",
    "three_interpolate.fp1": "7c31423b602bfc4a",
    "three_interpolate.fp2": "7432061a5782ff15",
    "three_interpolate.fp3": "8a0bc0f7366894cb",
}


def test_float32_eval_kernels_bit_identical_to_recorded(device):
    from ratrack_tpu_torch.kernels.digest import digests
    got = digests(device)
    assert got == F32_DIGESTS, {k: (v, F32_DIGESTS.get(k))
                                for k, v in got.items()
                                if F32_DIGESTS.get(k) != v}


def _dp_train_run(device, mesh=None, n=128, k=8, streams=4, frames=2):
    """`frames` train frame steps of Track4D(npoint=n) with seeded weights
    over `streams` synthetic streams, sharded over `mesh` where one is
    given -> (per-frame loss items, frame 0's gradients and BN statistics,
    all float64 on the CPU, and each step's collectives)."""
    from ratrack_tpu_torch.data import FrameBatch, stack_frames, synthetic_clip
    from ratrack_tpu_torch.data import to_tensors
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.parallel import (count_collectives, replicate,
                                            shard_clips)
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    block = to_tensors(FrameBatch(*[np.stack(x) for x in zip(*[
        stack_frames(synthetic_clip(s, frames, n_max=n, g_max=k,
                                    n_static=60, n_objects=3))
        for s in range(streams)])]), device)
    model = Track4D(npoint=n, k_max=k, sinkhorn_iters=20,
                    generator=torch.Generator().manual_seed(0), device=device)
    ts = create_train_state(model, TrainConfig(), steps_per_epoch=10,
                            device=device)
    state = init_state(streams, k, device=device)
    if mesh is not None:
        replicate(mesh, ts)
        block, state = shard_clips(mesh, block), shard_clips(mesh, state)
    scan = make_scan_train_step(ts, mesh)
    items, collectives = [], []
    for t in range(frames):
        with count_collectives() as counts:
            state, it = scan(state, FrameBatch(*[x[:, t:t + 1]
                                                 for x in block]), False)
        collectives.append(dict(counts))
        items.append({k_: v[0].double().cpu() for k_, v in it.items()})
        if t == 0:
            grads = {n_: p.grad.double().cpu()
                     for n_, p in model.named_parameters()}
            stats = {n_: b.double().cpu()
                     for n_, b in model.named_buffers()}
    return items, grads, stats, collectives


def test_sharded_train_step_under_nccl_matches_unsharded(device, tmp_path,
                                                         monkeypatch):
    """One rank under NCCL (a real NCCL all-reduce on the card) against
    the unsharded step from the same weights: two all-reduces a frame
    step; frame 0's loss items, gradient leaves (in norm, against the whole
    gradient's) and BN statistics no further from the unsharded run than
    twice what two unsharded runs differ by (B9 / B10 add their feature
    gradients with float atomics) plus 1e-5 of the scale."""
    import torch.distributed as dist
    from ratrack_tpu_torch.parallel import init_from_env, make_mesh
    for key, val in (("RANK", "0"), ("WORLD_SIZE", "1"),
                     ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, val)
    init_from_env(init_method=f"file://{tmp_path}/rendezvous")
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl"
        assert mesh.device == torch.device("cuda", 0)
        sharded = _dp_train_run(device, mesh)
    finally:
        dist.destroy_process_group()
    runs = [_dp_train_run(device) for _ in range(2)]
    assert sharded[3] == [{"all_reduce": 2}] * 2
    assert runs[0][3] == [{}] * 2
    norm = torch.linalg.vector_norm
    for part in range(3):
        a, b, s = runs[0][part], runs[1][part], sharded[part]
        if part == 0:
            a, b, s = a[0], b[0], s[0]
        scale = float(norm(torch.cat([x.flatten() for x in a.values()])))
        yard = max(float(norm(b[n] - a[n])) for n in a)
        for n in a:
            err = float(norm(s[n] - a[n]))
            assert err <= 2 * yard + 1e-5 * scale, (part, n, err, yard)


def test_init_from_env_refuses_a_rank_without_a_card(device, monkeypatch):
    """LOCAL_RANK beyond the visible cards raises before joining a group:
    no rank falls back to another card, to gloo or to the CPU."""
    import torch.distributed as dist
    from ratrack_tpu_torch.parallel import init_from_env
    n = torch.cuda.device_count()
    for key, val in (("RANK", str(n)), ("WORLD_SIZE", str(n + 1)),
                     ("LOCAL_RANK", str(n))):
        monkeypatch.setenv(key, val)
    with pytest.raises(RuntimeError, match="cards"):
        init_from_env()
    assert not dist.is_initialized()


# ---- B12: DBSCAN's labels -------------------------------------------------

# (kind, streams, points, masks / max_iters): seeded blobs and uniform noise
# under every mask at min_samples 1, 2 and 5; chains 1.0 apart whose
# propagation the cap cuts; a cloud above the kernel's limit
DBSCAN_CASES = (
    [("blobs", b, n, masks) for b in (1, 3, 32, 256)
     for n in (33, 360, 512, 1000) for masks in ("all", "none", "random")]
    + [("chain", 2, n, iters) for n in (360, 1000) for iters in (0, 1, 2, 64)]
    + [("blobs", 2, KERNEL_POINTS + 76, "random")])


def _dbscan_cloud(kind, b, n, masks, seed):
    """(x (b, n, 8), mask (b, n)): blobs (std 0.3, centers in [-6, 6]) of
    half the points and uniform noise in [-20, 20], or a chain of points
    1.0 apart along one axis (exact squared distances), in a random
    order."""
    gen = _gen(seed)
    if kind == "chain":
        x = torch.zeros((b, n, 8))
        x[..., 0] = torch.arange(n, dtype=torch.float32)
        mask = torch.ones((b, n), dtype=torch.bool)
    else:
        blobs = max(n // 40, 1)
        per = n // (2 * blobs)
        centers = 12 * torch.rand((b, blobs, 1, 8), generator=gen) - 6
        pts = centers + 0.3 * torch.randn((b, blobs, per, 8), generator=gen)
        noise = 40 * torch.rand((b, n - blobs * per, 8), generator=gen) - 20
        x = torch.cat([pts.reshape(b, -1, 8), noise], dim=1)
        mask = {"all": torch.ones((b, n), dtype=torch.bool),
                "none": torch.zeros((b, n), dtype=torch.bool),
                "random": torch.rand((b, n), generator=gen) > 0.3}[masks]
    return x[:, torch.randperm(n, generator=gen)].contiguous(), mask


@pytest.mark.parametrize("case", DBSCAN_CASES,
                         ids=["-".join(map(str, c)) for c in DBSCAN_CASES])
def test_dbscan_kernel_equals_the_plain_version(device, case):
    """B12's labels equal dbscan_reference's on the card (torch.equal,
    int32), and a call launches B12 once; a cloud above KERNEL_POINTS
    raises and launches nothing. A chain under a cap of 0-2 rounds stops
    short of its converged labels, so the early exit is held to the
    cap."""
    kind, b, n, arg = case
    x, mask = (t.to(device) for t in _dbscan_cloud(kind, b, n, arg,
                                                   90 + n + b))
    runs = ([(2, arg)] if kind == "chain" else
            [(min_samples, 64) for min_samples in (1, 2, 5)])
    for min_samples, iters in runs:
        launches = dbscan_labels.launches
        if n > KERNEL_POINTS:
            with pytest.raises(ValueError, match="mov_budget"):
                dbscan(x, mask, 1.5, min_samples, iters)
            assert dbscan_labels.launches == launches
            continue
        got = dbscan(x, mask, 1.5, min_samples, iters)
        assert dbscan_labels.launches == launches + 1
        want = dbscan_reference(x, mask, 1.5, min_samples, iters)
        assert got.dtype == torch.int32
        assert torch.equal(got, want), (min_samples, iters)
        if kind == "chain" and iters < 3:
            assert not torch.equal(
                got, dbscan_reference(x, mask, 1.5, min_samples, 64))
        if arg == "none":
            assert bool((got == -1).all())
        elif kind == "blobs":
            assert int(got.max()) >= 0


@pytest.mark.parametrize("n", [512, 8192])
def test_track4d_labels_with_the_dbscan_kernel_equal_the_plain_version(
        device, monkeypatch, n):
    """Two eval frames of the cached scan at 512 points, and at 8192 with
    mov_budget 512 (compact DBSCAN over the 512 selected points): the same
    labels with B12 as with the plain version (`dbscan_reference`
    monkeypatched in as the route), and one B12 launch a frame step. The
    motion threshold is set so that 30% of the valid points move."""
    import importlib
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, to_tensors
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    module = importlib.import_module("ratrack_tpu_torch.tracker.dbscan")
    track4d = importlib.import_module("ratrack_tpu_torch.models.track4d")
    k, t = 8, 2
    frames = to_tensors(stack_frames([stack_frames(synthetic_clip(
        1, t, n_max=n, g_max=k, n_static=n // 2, n_objects=6))]), device)
    big = n > 512
    model = Track4D(npoint=512 if big else n, k_max=k, sinkhorn_iters=50,
                    exact_fps=big, mov_budget=512 if big else 0,
                    sinkhorn_kernel=big,
                    generator=torch.Generator().manual_seed(0),
                    device="cpu").to(device)
    scan = make_scan_eval_step_cached(model)

    def run():
        launches = dbscan_labels.launches
        _, out = scan(init_state(1, k, device=device), frames)
        torch.cuda.synchronize()
        return out, dbscan_labels.launches - launches

    with monkeypatch.context() as m:
        for mod in (module, track4d):   # dbscan, and compact_dbscan's
            m.setattr(mod, "dbscan", module.dbscan_reference)
        out, _ = run()
        cls = out["cls"][frames.mask1]
        model.mov_thres = float(torch.quantile(cls.float(), 0.7))
        plain, plain_launches = run()
    kernel, launches = run()
    assert (plain_launches, launches) == (0, t)
    assert torch.equal(kernel["labels"], plain["labels"])
    assert int(kernel["labels"].max()) >= 0
