"""PointNet++-MSG backbone head: set abstraction and feature propagation.

Counterpart of `ratrack_tpu/models/pnhead.py`. The live config has
npoint == N, so the centers are the identity sample (every valid point,
padding rows taking the first valid point) and FPS does not run. With
`exact_fps`, or npoint < N (the 8192 / 16384-point stretch clouds with 512
centers), the centers are farthest point samples (kernel B6).

Eval: SA through kernel B1 where the level has two scales, else one
kernel B1' per scale (BN folded); FP through kernel B2.
Train (`self.training`): SA through kernel B9 (`fused_sa_pair_train`) where
the level is two scales of equal depth, else one kernel B8
(`fused_sa_scale_train`) per scale; the kernels compute the train-mode
batch statistics, which feed the running averages with count
npoint * nsample. FP through the plain three_nn / three_interpolate with
autograd, as the JAX train path (pnhead.py:197-207). The routing is the JAX
module's (pnhead.py:79-97, 126-144, 155-172), without its size gates:
those are limits of the TPU kernels' fast memory, not of the function.

Compute dtype (`dtype`): the eval kernels take it as their operand type
(`compute_dtype`); their float32 outputs are cast to `dtype`, as the JAX
module casts (pnhead.py:93-95, :200-203), and the Dense layers and MLPs
compute in it (layers.Dense). The layer-1 hoist stays float32. The train
kernels B9 / B8 take no compute dtype (nor do JAX's): their wrappers take
the features in float32 and the pooled outputs are cast to `dtype`
(pnhead.py:152). The train FP interpolates in float32 (bfloat16 features
times float32 weights, as JAX's three_interpolate promotes), and the
concatenation with bfloat16 skip features stays float32 until the
bfloat16 Dense, as jnp.concatenate promotes.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.fused_fp import (fused_three_interpolate,
                            three_interpolate_reference)
from ..ops.fused_sa import fused_sa_pair, fused_sa_scale
from ..ops.fused_sa_train import (fused_sa_pair_train,
                                  fused_sa_scale_train)
from ..ops.sampling import (furthest_point_sample, gather, identity_gather,
                            identity_sample)
from .layers import Dense, PointwiseMLP, cast_to


class SetAbstractionMSG(nn.Module):
    """One multi-scale-grouping level of one or more scales: per scale a
    ball query at its radius, a shared MLP of up to 3 layers with batch
    norm, and the max over the slots; the scales' outputs concatenated.
    The scales' MLPs are `mlp_0`, `mlp_1`, ..., the flax tree's names."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 c_in: int, exact_fps: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps) >= 1:
            raise ValueError(f"one radius, nsample and MLP per scale; got "
                             f"{len(radii)}, {len(nsamples)}, {len(mlps)}")
        self.npoint, self.exact_fps = npoint, exact_fps
        self.radii, self.nsamples = tuple(radii), tuple(nsamples)
        self.dtype = dtype
        for s, mlp in enumerate(mlps):
            self.add_module(f"mlp_{s}",
                            PointwiseMLP(c_in, mlp, bn=True, dtype=dtype))

    @property
    def scale_mlps(self):
        return [getattr(self, f"mlp_{s}") for s in range(len(self.radii))]

    def centers(self, xyz, mask):
        """The level's npoint centers (B, npoint, 3), the three branches of
        pnhead.py:62-74: the identity sample where npoint == N (as a row
        select in eval, as a gather in train), else, or with exact_fps,
        farthest point samples."""
        n = xyz.shape[1]
        if self.npoint == n and not self.exact_fps:
            if not self.training:
                return identity_gather(xyz, mask)
            return gather(xyz, identity_sample(n, self.npoint, mask,
                                               batch=xyz.shape[0],
                                               device=xyz.device))
        return gather(xyz, furthest_point_sample(xyz.detach().contiguous(),
                                                 self.npoint, mask))

    def forward(self, xyz, features, mask=None):
        """xyz (B, N, 3), features (B, N, C) or None, mask (B, N) or None
        -> (new_xyz (B, npoint, 3), new_feats (B, npoint, sum of scale
        widths))."""
        if self.training:
            return self._forward_train(xyz, features, mask)
        new_xyz = self.centers(xyz, mask).contiguous()
        folded = [mlp.folded() for mlp in self.scale_mlps]
        if len(folded) == 2:
            outs = fused_sa_pair(
                xyz, new_xyz, features, mask, *folded[0], *folded[1],
                radius_a=self.radii[0], radius_b=self.radii[1],
                nsample_a=self.nsamples[0], nsample_b=self.nsamples[1],
                compute_dtype=self.dtype)
        else:
            outs = [fused_sa_scale(xyz, new_xyz, features, mask, ws, bs,
                                   radius=r, nsample=ns,
                                   compute_dtype=self.dtype)
                    for (ws, bs), r, ns in zip(folded, self.radii,
                                               self.nsamples)]
        return new_xyz, torch.cat([cast_to(o, self.dtype) for o in outs],
                                  dim=-1)

    def _forward_train(self, xyz, features, mask):
        new_xyz = self.centers(xyz, mask).contiguous()
        xyz = xyz.contiguous()
        mlps = self.scale_mlps
        params = [mlp.train_params() for mlp in mlps]
        if len(mlps) == 2 and len(mlps[0].features) == len(mlps[1].features):
            results = fused_sa_pair_train(
                xyz, new_xyz, features, mask, *params[0], *params[1],
                radius_a=self.radii[0], nsample_a=self.nsamples[0],
                radius_b=self.radii[1], nsample_b=self.nsamples[1])
        else:
            results = [fused_sa_scale_train(xyz, new_xyz, features, mask,
                                            *prm, radius=r, nsample=ns)
                       for prm, r, ns in zip(params, self.radii,
                                             self.nsamples)]
        for mlp, (_, mus, vrs), ns in zip(mlps, results, self.nsamples):
            mlp.update_running_stats(mus, vrs, self.npoint * ns)
        return new_xyz, torch.cat([cast_to(r[0], self.dtype)
                                   for r in results], dim=-1)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation, concat skip features, MLP."""

    def __init__(self, c_in: int, mlp: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = PointwiseMLP(c_in, mlp, bn=True, dtype=dtype)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats,
                unknown_mask=None):
        """unknown_mask: rows that count in the train-mode batch norm."""
        if self.training:
            interp, _ = three_interpolate_reference(unknown_xyz, known_xyz,
                                                    known_feats)
        else:
            interp = cast_to(fused_three_interpolate(
                unknown_xyz, known_xyz, known_feats,
                compute_dtype=self.dtype), self.dtype)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp, unknown_mask)


class PNHead(nn.Module):
    """3-level SA-MSG encoder + 3-level FP decoder -> 128-d per point.

    Channel flow (c = input feature channels):
      sa1 [(3+c -> 16,16,32) x 2] -> 64 -> linear1 -> 32
      sa2 [(35 -> 32,32), (35 -> 32,64)] -> 96 -> linear2 -> 64
      sa3 [(67 -> 64,64) x 2] -> 128 -> linear3 -> 64
      fp3 128 -> 128, fp2 160 -> 128, fp1 128 -> 128
    Only sa1 sees the cloud mask; sa2/sa3 run over sa1's centers with no
    mask (with exact_fps their farthest point sampling of npoint from
    npoint is a permutation), and the FP levels take no known-point mask
    (pnhead.py:248-265). In train mode fp1's batch norm alone counts only
    the cloud's valid points (pnhead.py:263-265).
    """

    def __init__(self, npoint: int, c_feat: int, exact_fps: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = dict(dtype=dtype)
        self.sa1 = SetAbstractionMSG(npoint, (2.0, 4.0), (4, 8),
                                     ((16, 16, 32), (16, 16, 32)), 3 + c_feat,
                                     exact_fps, **dt)
        self.sa2 = SetAbstractionMSG(npoint, (4.0, 8.0), (8, 16),
                                     ((32, 32), (32, 64)), 3 + 32, exact_fps,
                                     **dt)
        self.sa3 = SetAbstractionMSG(npoint, (8.0, 16.0), (16, 32),
                                     ((64, 64), (64, 64)), 3 + 64, exact_fps,
                                     **dt)
        self.linear1 = Dense(64, 32, **dt)
        self.linear2 = Dense(96, 64, **dt)
        self.linear3 = Dense(128, 64, **dt)
        self.fp3 = FeaturePropagation(64 + 64, [128], **dt)
        self.fp2 = FeaturePropagation(128 + 32, [128], **dt)
        self.fp1 = FeaturePropagation(128, [128], **dt)

    def forward(self, xyz, features, mask=None):
        l1_xyz, l1 = self.sa1(xyz, features, mask)
        l1 = self.linear1(l1)
        l2_xyz, l2 = self.sa2(l1_xyz, l1, None)
        l2 = self.linear2(l2)
        l3_xyz, l3 = self.sa3(l2_xyz, l2, None)
        l3 = self.linear3(l3)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(xyz, l1_xyz, None, l1, mask)
        return l3_xyz, l0
