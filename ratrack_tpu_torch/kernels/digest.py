"""Digests of the float32 eval kernels' outputs on seeded cases.

    python3 -m ratrack_tpu_torch.kernels.digest

prints one JSON object {case: sha256 of the outputs' bytes} for B1 (every
SA level config of both heads), B1' (each scale of the three-scale level),
B2 (every FP level), B3 (both stages, 4 streams x 512 points) and B4 (both
stages at 1024 points), each launched once on the card. The inputs are
made on the CPU from fixed seeds with the wrappers and cases that the
package has had since its kernels were first redesigned, so two checkouts
run on one card (a change and its parent) print equal digests where their
float32 kernels compute bit for bit the same;
tests/test_torch_port_cuda.py holds the digests a tree recorded.
"""

from __future__ import annotations

import hashlib
import json


def digests(device="cuda") -> dict:
    import torch

    from . import cases
    from ..ops import fused_correlator, fused_fp, fused_sa

    def sha(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    gen = torch.Generator().manual_seed(0)
    pc1, m1, pc2, m2 = cases.clouds(0, 4)
    out = {}
    for head in ("pn_head", "mse"):
        for level in cases.SA_LEVELS:
            kw = cases.to_device(cases.sa_case(level, head, pc1, m1, gen),
                                 device)
            out[f"sa_pair.{head}.{level}"] = sha(
                *fused_sa.sa_pair(**kw, return_indices=True))
    for i, kw in enumerate(cases.sa_scale_cases("three_scales", pc1, m1,
                                                gen)):
        out[f"sa_scale.three_scales.{i}"] = sha(*fused_sa.sa_scale(
            **cases.to_device(kw, device), return_indices=True))
    for level in cases.FP_LEVELS:
        kw = cases.to_device(cases.fp_case(level, pc1, m1, gen), device)
        out[f"three_interpolate.{level}"] = sha(
            *fused_fp.fused_three_interpolate(**kw, return_indices=True))
    for stage in (1, 2):
        kw = cases.to_device(cases.corr_case(stage, pc1, m1, pc2, m2, gen),
                             device)
        out[f"knn_weight_aggregate.stage{stage}"] = sha(
            *fused_correlator.fused_knn_weight_aggregate(
                **kw, return_indices=True))
    sc = cases.clouds(1, 1, 1024, n_static=600)
    for stage in (1, 2):
        kw = cases.to_device(cases.apply_case(stage, *sc, gen), device)
        out[f"knn_gather_apply.stage{stage}"] = sha(
            fused_correlator.knn_gather_apply(**kw))
    torch.cuda.synchronize()
    return out


if __name__ == "__main__":
    print(json.dumps(digests(), sort_keys=True))
