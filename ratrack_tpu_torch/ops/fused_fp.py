"""3-NN inverse-distance interpolation: kernel B2 and its plain twin.

Replaces `ratrack_tpu/ops/pallas_fp.py::_fp_kernel`
(`fused_three_interpolate`). The CUDA kernel is `csrc/fp.cu`; its header
says what bounds it on the H100 and how its design answers that.

  fused_three_interpolate     the kernel wrapper: CUDA tensors launch the
                              kernel (or raise), CPU tensors take
  three_interpolate_reference the plain version: three_nn + weights
                              1/(d + 1e-8), normalised + weighted sum.
"""

from __future__ import annotations

import torch

from ..kernels import build as kb
from .grouping import three_interpolate, three_interpolate_weights
from .neighborhood import three_nn

EPS = 1e-8


def three_interpolate_reference(unknown, known, feats, known_mask=None):
    """(B, N, 3), (B, M, 3), (B, M, C) -> ((B, N, C), idx (B, N, 3))."""
    dist, idx = three_nn(unknown, known, known_mask)
    return three_interpolate(feats, idx, three_interpolate_weights(dist)), idx


def fused_three_interpolate(unknown, known, feats, known_mask=None, *,
                            return_indices: bool = False):
    """Kernel B2: interpolate `feats` of the known points at `unknown`."""
    if not unknown.is_cuda:
        out, idx = three_interpolate_reference(unknown, known, feats,
                                               known_mask)
        return (out, idx) if return_indices else out

    dev = unknown.device
    b, n, m, c = unknown.shape[0], unknown.shape[1], known.shape[1], \
        feats.shape[-1]
    kb.require(unknown, "unknown", (b, n, 3), dev)
    kb.require(known, "known", (b, m, 3), dev)
    kb.require(feats, "feats", (b, m, c), dev)
    if known_mask is not None:
        kb.require(known_mask, "known_mask", (b, m), dev, torch.bool)
    out = torch.empty((b, n, c), device=dev, dtype=torch.float32)
    idx = (torch.empty((b, n, 3), device=dev, dtype=torch.int32)
           if return_indices else None)
    lib = kb.load()
    with torch.cuda.device(dev):
        code = lib.ratrack_three_interpolate(
            kb.ptr(unknown), kb.ptr(known), kb.ptr(feats), kb.ptr(known_mask),
            b, n, m, c, EPS, kb.ptr(out), kb.ptr(idx), kb.stream_of(unknown))
    kb.check(code, "three_interpolate")
    fused_three_interpolate.launches += 1
    return (out, idx) if return_indices else out


fused_three_interpolate.launches = 0
