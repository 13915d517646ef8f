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
iteration).
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
        fused_knn.knn_indices_tiled(**{**kw, "k": 17})
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


# ---- B9 / B8 forward (one cluster launch) and B10 backward (3xTF32) -------

def _package_kernels(fn):
    """The CUDA kernels of csrc/ that fn() launches, by name, as
    torch.profiler sees them (PyTorch's own kernels, such as the fill of a
    zero-initialised gradient, are not counted)."""
    from torch.profiler import ProfilerActivity, profile
    names = set()
    for src in kb.CSRC_DIR.glob("*.cu*"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", src.read_text()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
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
        got = _package_kernels(lambda: torch.autograd.grad(loss, flat))
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

    def view(self, shape, dtype=torch.float32, zero=False):
        n = math.prod(shape)
        buf = torch.full((n + 2 * self.PAD,), CANARY[dtype], dtype=dtype,
                         device=self.device)
        v = buf[self.PAD:self.PAD + n].view(shape)
        if zero:
            v.zero_()
        self.bufs.append((buf, n))
        return v

    def assert_intact(self):
        torch.cuda.synchronize()
        for buf, n in self.bufs:
            c = CANARY[buf.dtype]
            assert bool((buf[:self.PAD] == c).all()), buf.shape
            assert bool((buf[self.PAD + n:] == c).all()), buf.shape


def _canary_cloud(n_valid, b=2, n=33):
    pc = 2.0 * torch.randn((b, n, 3), generator=_gen(70 + n_valid))
    mask = (torch.arange(n) < n_valid).expand(b, -1).contiguous()
    return pc, mask


@pytest.mark.parametrize("n_valid", [33, 1, 0])
def test_kernels_write_only_inside_their_outputs(device, n_valid):
    """The C entries of B1, of the B9 / B8 forward and of the B10
    backward (both stages), called directly, with every output and scratch
    pointer a view inside a larger buffer: after the launches the canaries
    on both sides are intact. 33 points, all, one or none valid."""
    lib = kb.load()
    stream = torch.cuda.current_stream().cuda_stream
    pc, mask = _canary_cloud(n_valid)
    b, n = pc.shape[:2]
    guard = _Guard(device)

    # B1: both scales of sa1, outputs and indices guarded
    kw = cases.to_device(cases.sa_case("sa1", "pn_head", pc, mask, _gen(71)),
                         device)
    m = kw["centers"].shape[1]
    args = []
    for t in "ab":
        a, _, _ = fused_sa._kernel_scale(
            t, kw["xyz"], kw["centers"], kw[f"p1{t}"], kw[f"cw{t}"],
            kw[f"rest_{t}"], kw[f"radius_{t}"], kw[f"nsample_{t}"], True)
        width = (kw[f"rest_{t}"][-1][0].shape[1] if kw[f"rest_{t}"]
                 else kw[f"p1{t}"].shape[-1])
        a[-2] = kb.ptr(guard.view((b, m, width)))
        a[-1] = kb.ptr(guard.view((b, m, kw[f"nsample_{t}"]), torch.int32))
        args += a
    kb.check(lib.ratrack_sa_pair(kb.ptr(kw["xyz"]), kb.ptr(kw["centers"]),
                                 kb.ptr(kw["mask"]), b, n, m, *args, stream),
             "sa_pair")

    # B9 / B8 forward: every output of the TrainScale structs guarded
    tk = cases.to_device(cases.sa_train_case("sa1", "pn_head", pc, mask,
                                             _gen(72), centers=pc), device)
    structs, keep = [], []
    for t in "ab":
        ns = tk[f"nsample_{t}"]
        dims = [tk[f"wxyz_{t}"].shape[1]] + [w.shape[1]
                                             for w in tk[f"ws_{t}"]]
        sc = dict(ws=tk[f"ws_{t}"], gam=tk[f"gammas_{t}"],
                  bet=tk[f"betas_{t}"], dims=dims, ns=ns,
                  r=tk[f"radius_{t}"], pf=tk[f"pf{t}"],
                  wx=tk[f"wxyz_{t}"],
                  z=[guard.view((b, n * ns, c)) for c in dims],
                  mus=[guard.view((b, c)) for c in dims],
                  vrs=[guard.view((b, c)) for c in dims],
                  idx=guard.view((b, n, ns), torch.int32),
                  pooled=guard.view((b, n, dims[-1])))
        keep.append(sc)
        structs.append(fused_sa_train._scale_struct(sc))
    common = (kb.ptr(tk["xyz"]), kb.ptr(tk["centers"]),
              kb.ptr(tk["mask"]), b, n, n, 1e-5)
    kb.check(lib.ratrack_sa_train_fwd(
        *common, ctypes.addressof(structs[0]),
        ctypes.addressof(structs[1]), stream), "sa_pair_train_fwd")
    kb.check(lib.ratrack_sa_scale_train_fwd(
        *common, ctypes.addressof(structs[1]), stream),
        "sa_scale_train_fwd")
    torch.cuda.synchronize()
    for sc in keep:
        assert bool(torch.isfinite(sc["pooled"]).all())

    # B10 backward: the forward through the wrapper, the backward's C entry
    # with guarded outputs and scratch
    pc2, _ = _canary_cloud(n_valid)
    for stage in (1, 2):
        ck = cases.to_device(cases.corr_train_case(
            stage, pc, mask, pc2, mask, _gen(73)), device)
        out, idx = _corr_train_kernel(
            **dict(ck, feats_p=ck["feats_p"].clone().requires_grad_(True)))
        n_mlp = len(ck["mlp_ws"])
        stash = (list(out.grad_fn.saved_tensors[-(n_mlp + 1):])
                 if stage == 1 else [None])
        c, rows = 256, b * n * 16
        blocks = -(-b * n // 4)
        chunks = -(-rows // fused_correlator_train._DW_CHUNK)
        wn_grad = fused_correlator_train._WN_GRAD
        g = dict(
            d_feats_p=guard.view((b, n, c), zero=True),
            d_add_q=guard.view((b, n, c)) if stage == 1 else None,
            d_query=guard.view((b, n, 3)),
            d_points=guard.view((b, n, 3), zero=True),
            d_wdir=guard.view((3, c)) if stage == 1 else None,
            d_mlp_w=[guard.view((c, c)) for _ in range(n_mlp)],
            d_mlp_b=[guard.view((c,)) for _ in range(n_mlp)],
            d_wn=guard.view((wn_grad,)),
            dz=[guard.view((rows, c)) for _ in range(2 if n_mlp else 1)],
            ddir=guard.view((rows, 3)),
            part=guard.view((blocks * (wn_grad + 3 * c)
                             + n_mlp * chunks * (c * c + c),)))
        dout = torch.randn((b, n, c), generator=_gen(74)).to(device)
        wn = fused_correlator_train._wn_ptrs(ck["wn_ws"] + ck["wn_bs"])
        kb.check(lib.ratrack_corr_train_bwd(
            kb.ptr(ck["query"]), kb.ptr(ck["points"]), kb.ptr(idx), b, n, n,
            kb.ptr(ck["feats_p"]), int(ck["add_q"] is not None),
            kb.ptr(ck["w_dir"]), kb.ptr_array(list(ck["mlp_ws"])), n_mlp,
            kb.ptr_array(stash), *wn, kb.ptr(dout), kb.ptr(g["d_feats_p"]),
            kb.ptr(g["d_add_q"]), kb.ptr(g["d_query"]),
            kb.ptr(g["d_points"]), kb.ptr(g["d_wdir"]),
            kb.ptr_array(g["d_mlp_w"]), kb.ptr_array(g["d_mlp_b"]),
            kb.ptr(g["d_wn"]), kb.ptr(g["dz"][0]), kb.ptr(g["dz"][-1]),
            kb.ptr(g["ddir"]), kb.ptr(g["part"]), stream), "corr_train_bwd")
        torch.cuda.synchronize()
        assert bool(torch.isfinite(g["d_wn"]).all())
    guard.assert_intact()
