"""The frozen copies hold to the program's originals: the clip generator
array for array, the roofline work counts call for call at each cell's
shapes."""

import numpy as np
import pytest
import torch

from perfbench import spec, traffic, work
from ratrack_tpu_torch.data import synthetic
from ratrack_tpu_torch.kernels import cases


@pytest.mark.parametrize("kw", [
    dict(n_max=512, n_static=300, n_objects=5),
    dict(n_max=8192, n_static=cases.stretch_static_points(8192),
         n_objects=5),
    dict(n_max=64, n_static=20, n_objects=2, pts_per_obj=3, g_max=4)])
def test_traffic_is_the_programs_generator(kw):
    for seed in (0, 7, traffic.CLIP_SEEDS - 1):
        got = traffic.synthetic_clip(seed, 3, **kw)
        want = synthetic.synthetic_clip(seed, 3, **kw)
        for g, w in zip(got, want):
            assert g._fields == w._fields
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_stretch_mix_is_the_stretch_scenario():
    mix = spec.cell("eval_stretch8k_b4").traffic
    assert mix["n_static"] == cases.stretch_static_points(mix["n_max"])


def _clouds(n, batch=1, seed=3):
    static = 300 if n == 512 else cases.stretch_static_points(n)
    return cases.clouds(seed, batch, n, n_static=static)


def _level_sources(pc, mask, levels):
    """The cloud each level of the program's head runs over: the masked
    cloud, then the level above's centers."""
    return [(pc, mask)] + [(xyz, None) for xyz, _, _ in levels[1:]]


@pytest.mark.parametrize("n,npoint", [(512, None), (8192, 512)])
@pytest.mark.parametrize("head", ["pn_head", "mse"])
def test_sa_eval_work(n, npoint, head):
    """B1: each level's frozen count, from the reference's selections,
    equals cases.sa_pair_work on the program's case."""
    from ratrack_tpu_torch.ops.fused_sa import sa_pair_reference
    pc, mask, _, _ = _clouds(n)
    gen = torch.Generator().manual_seed(0)
    levels = work.level_clouds(pc, mask, npoint or n, npoint is not None)
    mine = work.sa_eval_calls(levels)
    for li, (src, m) in enumerate(_level_sources(pc, mask, levels)):
        kw = cases.sa_case(list(cases.SA_LEVELS)[li], head, src, m, gen,
                           npoint=npoint)
        assert torch.equal(kw["centers"], levels[li][1])
        oa, ob, ia, ib = sa_pair_reference(**kw)
        assert mine[li] == cases.sa_pair_work(kw, oa, ob, ia, ib)


@pytest.mark.parametrize("head", ["pn_head", "mse"])
def test_sa_train_work(head):
    """B9 forward and backward at the train cell's 512 points."""
    from ratrack_tpu_torch.ops.fused_sa_train import sa_pair_train_reference
    pc, mask, _, _ = _clouds(512, batch=2)
    gen = torch.Generator().manual_seed(1)
    levels = work.level_clouds(pc, mask, 512, False)
    mine = work.sa_train_calls(levels)
    for li, level in enumerate(cases.SA_LEVELS):
        kw = cases.sa_train_case(level, head, pc, mask, gen)
        _, outs, _ = cases.sa_train_loss(sa_pair_train_reference, kw)
        # the kernel writes its slot indices as int32
        outs = {k: v.int() if k.startswith("idx") else v
                for k, v in outs.items()}
        assert mine[2 * li:2 * li + 2] == list(cases.sa_train_work(kw, outs))


def test_corr_eval_work():
    """B3, both stages, at 512 points."""
    from ratrack_tpu_torch.ops.fused_correlator import (
        knn_weight_aggregate_reference)
    pc1, m1, pc2, m2 = _clouds(512, batch=2)
    gen = torch.Generator().manual_seed(2)
    mine = work.corr_eval_calls(pc1, m1, m2)
    for stage in (1, 2):
        kw = cases.corr_case(stage, pc1, m1, pc2, m2, gen)
        out, _ = knn_weight_aggregate_reference(**kw)
        assert mine[stage - 1] == cases.corr_work(kw, out)


def test_corr_split_work():
    """B5 and B4, both stages, at 8192 points."""
    from ratrack_tpu_torch.ops.fused_correlator import (
        knn_gather_apply_reference)
    from ratrack_tpu_torch.ops.fused_knn import knn_indices_tiled_reference
    pc1, m1, pc2, m2 = _clouds(8192)
    gen = torch.Generator().manual_seed(3)
    mine = work.corr_split_calls(pc1, m1, m2)
    for stage in (1, 2):
        sel = cases.knn_tiled_case(stage, pc1, m1, pc2, m2)
        idx, keys, _ = knn_indices_tiled_reference(
            sel["query"], sel["points"], sel["points_mask"], k=16)
        assert mine[2 * stage - 2] == cases.knn_tiled_work(sel, idx, keys)
        kw = cases.apply_case(stage, pc1, m1, pc2, m2, gen)
        out = knn_gather_apply_reference(**kw)
        assert mine[2 * stage - 1] == cases.corr_work(kw, out, select=False)


def test_corr_train_work():
    """B10 forward and backward, both stages, at 512 points."""
    from ratrack_tpu_torch.ops.fused_correlator_train import (
        knn_weight_aggregate_train_reference)
    pc1, m1, pc2, m2 = _clouds(512, batch=2)
    gen = torch.Generator().manual_seed(4)
    mine = work.corr_train_calls(pc1, m1, m2)
    for stage in (1, 2):
        kw = cases.corr_train_case(stage, pc1, m1, pc2, m2, gen)
        out, _ = knn_weight_aggregate_train_reference(**kw)
        assert mine[2 * stage - 2:2 * stage] == [
            cases.corr_work(kw, out), cases.corr_train_bwd_work(kw, out)]


def test_model_flops_count_every_linear_layer():
    """The model FLOPs a frame: 2 x the multiply-adds of the reference
    model's linear layers over the shapes each runs at, counted apart by
    hooks on one forward at the vod512 shapes."""
    from perfbench.reference.model import Track4D
    from perfbench import traffic as tr
    args = spec.cell("eval_vod512_b32").config["model"]
    model = Track4D(**args).eval()
    macs = [0]

    def hook(mod, inp, out):
        macs[0] += inp[0].numel() // inp[0].shape[-1] * \
            mod.in_features * mod.out_features
    for mod in model.modules():
        if isinstance(mod, torch.nn.Linear):
            mod.register_forward_hook(hook)
    frames = tr.stack_frames([tr.stack_frames(tr.synthetic_clip(
        5, 1, n_objects=5))])
    fr = tr.frame_at(tr.FrameBatch(*[torch.from_numpy(np.asarray(x))
                                     for x in frames]), 0)
    with torch.no_grad():
        model(fr, model.fresh_state(1, "cpu"))
    # the affinity runs over k_max x k_max object pairs
    assert work.model_flops_per_frame(args, 512, False) == 2 * macs[0]
    assert work.model_flops_per_frame(args, 512, True) == 6 * macs[0]
