"""Seeded inputs for each kernel at the model's widths.

One case per kernel call the eval step makes, built from synthetic radar
clouds (data/synthetic.py) and random weights, all drawn from a seed:

  SA pair  sa1/sa2/sa3 for the pn_head (sa1 features: 2 channels) and the
           decoder's mse head (sa1 features: 2 + 256 + 256 = 514);
  FP       fp3/fp2/fp1 (known features 64 / 128 / 128);
  corr     stage 1 (pc1 in pc2, add_q, 2 pair layers) and stage 2 (pc1 in
           pc1, no pair MLP).

Used by chip_smoke.py and tests/test_torch_port_cuda.py to hold every
kernel against its plain version on the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.synthetic import stack_frames, synthetic_clip
from ..ops.fused_sa import hoist_layer1
from ..ops.sampling import identity_gather

# name: (radii, nsamples, per-scale MLP widths, feature channels by head)
SA_LEVELS = {
    "sa1": ((2.0, 4.0), (4, 8), ((16, 16, 32), (16, 16, 32)),
            {"pn_head": 2, "mse": 514}),
    "sa2": ((4.0, 8.0), (8, 16), ((32, 32), (32, 64)),
            {"pn_head": 32, "mse": 32}),
    "sa3": ((8.0, 16.0), (16, 32), ((64, 64), (64, 64)),
            {"pn_head": 64, "mse": 64}),
}
FP_LEVELS = {"fp3": 64, "fp2": 128, "fp1": 128}
CORR_C = 256


def clouds(seed: int, batch: int, n: int = 512, n_static: int = 300,
           n_objects: int = 5):
    """(pc1, mask1, pc2, mask2) of the first frame of `batch` synthetic
    streams, as (B, n, 3) / (B, n) CPU tensors."""
    frames = stack_frames([synthetic_clip(seed + s, 1, n_max=n,
                                          n_static=n_static,
                                          n_objects=n_objects)[0]
                           for s in range(batch)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return t(frames.pc1), t(frames.mask1), t(frames.pc2), t(frames.mask2)


def _weights(gen, dims):
    ws, bs = [], []
    for i, o in zip(dims[:-1], dims[1:]):
        ws.append(torch.randn((i, o), generator=gen) / i ** 0.5)
        bs.append(0.1 * torch.randn((o,), generator=gen))
    return ws, bs


def sa_case(level: str, head: str, pc, mask, gen: torch.Generator):
    """Keyword arguments of ops.fused_sa.sa_pair / sa_pair_reference."""
    radii, nsamples, mlps, c_feat = SA_LEVELS[level]
    b, n, _ = pc.shape
    if level == "sa1":
        xyz, m = pc, mask
    else:   # deeper levels run over the identity-gathered centers, no mask
        xyz, m = identity_gather(pc, mask), None
    centers = identity_gather(xyz, m)
    feats = torch.randn((b, n, c_feat[head]), generator=gen)
    kw = dict(xyz=xyz.contiguous(), centers=centers.contiguous(), mask=m)
    for tag, widths in zip("ab", mlps):
        ws, bs = _weights(gen, (3 + c_feat[head],) + tuple(widths))
        p1, cw = hoist_layer1(xyz, centers, feats, ws[0], bs[0])
        kw[f"p1{tag}"], kw[f"cw{tag}"] = p1, cw
        kw[f"rest_{tag}"] = list(zip(ws[1:], bs[1:]))
    kw.update(radius_a=radii[0], radius_b=radii[1], nsample_a=nsamples[0],
              nsample_b=nsamples[1])
    return kw


def fp_case(level: str, pc, mask, gen: torch.Generator):
    """Arguments of ops.fused_fp.fused_three_interpolate (no known mask,
    as on the model's path)."""
    b, n, _ = pc.shape
    known = identity_gather(pc, mask)
    unknown = pc if level == "fp1" else known
    feats = torch.randn((b, n, FP_LEVELS[level]), generator=gen)
    return dict(unknown=unknown.contiguous(), known=known.contiguous(),
                feats=feats)


def corr_case(stage: int, pc1, mask1, pc2, mask2, gen: torch.Generator):
    """Arguments of ops.fused_correlator.fused_knn_weight_aggregate."""
    b, n, _ = pc1.shape
    c = CORR_C
    wn_ws, wn_bs = _weights(gen, (3, 8, 8, c))
    feats_p = torch.randn((b, n, c), generator=gen)
    if stage == 1:
        mlp_ws, mlp_bs = _weights(gen, (c, c, c))
        return dict(query=pc1, points=pc2, feats_p=feats_p,
                    add_q=torch.randn((b, n, c), generator=gen),
                    mask_p=mask2, mlp_ws=mlp_ws, mlp_bs=mlp_bs,
                    wn_ws=wn_ws, wn_bs=wn_bs)
    return dict(query=pc1, points=pc1, feats_p=feats_p, add_q=None,
                mask_p=mask1, mlp_ws=[], mlp_bs=[], wn_ws=wn_ws,
                wn_bs=wn_bs)


def to_device(case: dict, device) -> dict:
    """Every tensor of a case (lists and pairs included) on `device`."""
    def move(x):
        if torch.is_tensor(x):
            return x.to(device).contiguous()
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        return x
    return {k: move(v) for k, v in case.items()}
