"""Cost-volume feature correlator. Counterpart of
`ratrack_tpu/models/correlator.py:67-135, 141-176`.

  1. kNN(16) of pc1 in pc2; MLP over [f1_i, f2_j, x_j - x_i] (no BN, leaky
     0.1); WeightNet1(direction)-weighted unnormalised sum over the slots.
  2. kNN(16) of pc1 in pc1; WeightNet2-weighted sum of the stage-1 cost
     over the self-neighbourhood.

Layer 1 of the pair MLP factorises; with W1 = [W_f1; W_f2; W_dir]:
  eval (kernel B3): pre1_ij = (f1 W_f1 - x1 W_dir)_i + (f2 W_f2 + x2 W_dir
    + b1)_j, two torch matmuls here, as the JAX package computes them
    outside its kernel;
  train (kernel B10): add_q = f1 W_f1 and feats_p = f2 W_f2 + b1, and the
    kernel adds dir @ W_dir from the exact directions (the train hoist of
    correlator.py:153-163).
Eval above SPLIT_ABOVE points takes the split formulation
(correlator.py:99-135): both clouds sorted along a Z-curve
(`spatial_sort`), then per stage the tiled kNN selection (kernel B5) and
the apply over its indices (kernel B4), and one unsort of the result. The
sort changes only which of several equidistant neighbours is taken (the
lowest sorted index).

Compute dtype (`dtype`): the hoists take the features in the parameters'
dtype, float32 (correlator.py:84-89, :155-166), the eval kernels take
`dtype` as their operand type, and the cost volume leaves in `dtype`
(correlator.py:135, :176). The train kernel B10 takes no compute dtype (as
JAX's): it runs in float32 behind the hoists in a bfloat16 model too.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.fused_correlator import (fused_knn_weight_aggregate,
                                    knn_gather_apply)
from ..ops.fused_correlator_train import fused_knn_weight_aggregate_train
from ..ops.fused_knn import knn_indices_tiled
from ..ops.morton import invert_perm, morton_perm
from ..ops.sampling import gather
from ..trace import span
from .layers import PointwiseMLP, WeightNet, cast_to

# clouds above this many points take the split formulation in eval
SPLIT_ABOVE = 4096


class FeatureCorrelator(nn.Module):
    """spatial_sort: Z-order both clouds on the split path (the JAX
    module's SPLIT_SPATIAL_SORT switch, here fixed per instance)."""

    def __init__(self, nsample: int = 16,
                 mlp: Sequence[int] = (256, 256, 256), d1: int = 256,
                 d2: int = 256, spatial_sort: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nsample, self.d1, self.d2 = nsample, d1, d2
        self.spatial_sort, self.dtype = spatial_sort, dtype
        self.mlp = PointwiseMLP(d1 + d2 + 3, mlp, bn=False, act="leaky_relu",
                                dtype=dtype)
        self.weightnet1 = WeightNet(mlp[-1], dtype=dtype)
        self.weightnet2 = WeightNet(mlp[-1], dtype=dtype)

    @span("cost_volume")
    def forward(self, pc1, pc2, f1, f2, mask1=None, mask2=None):
        """pc (B, N, 3), f1 (B, N, d1), f2 (B, N, d2) -> (B, N, mlp[-1])."""
        d1, d2 = self.d1, self.d2
        dense = [getattr(self.mlp, f"dense_{i}")
                 for i in range(len(self.mlp.features))]
        w1 = dense[0].weight.t()
        w_f1, w_f2, w_dir = w1[:d1], w1[d1:d1 + d2], w1[d1 + d2:]
        mlp_ws = [d.weight.t().contiguous() for d in dense[1:]]
        mlp_bs = [d.bias for d in dense[1:]]
        wn1_ws, wn1_bs = self.weightnet1.kernel_params()
        wn2_ws, wn2_bs = self.weightnet2.kernel_params()
        f1, f2 = f1.to(w1.dtype), f2.to(w1.dtype)
        if self.training:
            cost = fused_knn_weight_aggregate_train(
                pc1, pc2, (f2 @ w_f2 + dense[0].bias).contiguous(),
                (f1 @ w_f1).contiguous(), mask2, mlp_ws, mlp_bs, wn1_ws,
                wn1_bs, w_dir=w_dir.contiguous(), k=self.nsample)
            return cast_to(fused_knn_weight_aggregate_train(
                pc1, pc1, cost, None, mask1, [], [], wn2_ws, wn2_bs,
                k=self.nsample), self.dtype)
        add_q = (f1 @ w_f1 - pc1 @ w_dir).contiguous()
        feats_p = (f2 @ w_f2 + pc2 @ w_dir
                   + dense[0].bias).contiguous()
        if pc1.shape[1] > SPLIT_ABOVE:
            cost = self._split(pc1, pc2, feats_p, add_q, mask1, mask2,
                               mlp_ws, mlp_bs, wn1_ws, wn1_bs, wn2_ws, wn2_bs)
            return cast_to(cost, self.dtype)
        dt = self.dtype
        cost = fused_knn_weight_aggregate(
            pc1, pc2, feats_p, add_q, mask2, mlp_ws, mlp_bs, wn1_ws, wn1_bs,
            k=self.nsample, compute_dtype=dt)
        return cast_to(fused_knn_weight_aggregate(
            pc1, pc1, cost, None, mask1, [], [], wn2_ws, wn2_bs,
            k=self.nsample, compute_dtype=dt), dt)

    def _split(self, pc1, pc2, feats_p, add_q, mask1, mask2, mlp_ws, mlp_bs,
               wn1_ws, wn1_bs, wn2_ws, wn2_bs):
        k, dt = self.nsample, self.dtype
        if self.spatial_sort:
            perm1, perm2 = morton_perm(pc1, mask1), morton_perm(pc2, mask2)
            pc1, add_q = gather(pc1, perm1), gather(add_q, perm1)
            pc2, feats_p = gather(pc2, perm2), gather(feats_p, perm2)
            if mask1 is not None:
                mask1 = torch.gather(mask1, 1, perm1)
            if mask2 is not None:
                mask2 = torch.gather(mask2, 1, perm2)
        cost = knn_gather_apply(
            knn_indices_tiled(pc1, pc2, mask2, k=k), pc1, pc2, feats_p,
            add_q, mlp_ws, mlp_bs, wn1_ws, wn1_bs, k=k, compute_dtype=dt)
        cost = knn_gather_apply(
            knn_indices_tiled(pc1, pc1, mask1, k=k), pc1, pc1, cost, None,
            [], [], wn2_ws, wn2_bs, k=k, compute_dtype=dt)
        if self.spatial_sort:
            cost = gather(cost, invert_perm(perm1))
        return cost
