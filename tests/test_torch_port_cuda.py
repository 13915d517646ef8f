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
compare_train says by how much).
"""

import numpy as np
import pytest
import torch

from ratrack_tpu_torch.kernels import cases
from ratrack_tpu_torch.ops import (fused_correlator, fused_correlator_train,
                                   fused_fp, fused_sa, fused_sa_train)

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
                    generator=torch.Generator().manual_seed(0))
    scan = make_scan_eval_step_cached(model)
    _, cpu = scan(init_state(2, k), to_tensors(frames))
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
                    generator=torch.Generator().manual_seed(0)).to(device)
    ts = create_train_state(model, TrainConfig(), steps_per_epoch=10)
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
