"""All Sinkhorn iterations in one launch: kernel B7 and its plain twin.

Replaces `ratrack_tpu/ops/pallas_sinkhorn.py::_kernel` (`sinkhorn_uv`).
The CUDA kernel is `csrc/sinkhorn.cu`; its header says what bounds it on
the H100 and how its design answers that.

  sinkhorn_uv            the kernel wrapper: CUDA tensors launch the kernel
                         (or raise), CPU tensors take
  sinkhorn_uv_reference  the plain version, the eager loop.

Both run `iters` iterations of the bounded log-sum-exp updates from
u = v = 0:
  u = log_mu - log(max(sum_j exp(c + v), 1e-30))
  v = log_nu - log(max(sum_i exp(c + u), 1e-30))   (with the new u)
The kernel sums in another order than torch, and by default as exp(c) *
exp(v) (exp(c) taken once), so u and v differ in the last bits per
iteration. Primal only, as the JAX kernel: nothing differentiates
through the coupling, and the wrapper raises on an input that requires
grad.
"""

from __future__ import annotations

import torch

from ..kernels import build as kb

KERNEL_MAX_K1 = 128   # csrc/sinkhorn.cu: one block, 8 lanes a row
# csrc/sinkhorn.cu's variants: lanes a row (K1 * lanes <= 1024), and how a
# term is summed
KERNEL_LANES = (4, 8, 16)
KERNEL_MODES = {"exp": 0, "factored": 1, "skeleton": 2}


def lse_bounded(a: torch.Tensor, dim: int) -> torch.Tensor:
    """log(sum(exp(a))) without the max pass: every finite operand of this
    OT instance is in [-20, 20] (sigmoid affinities, bin 0.9, bounded
    potentials; sinkhorn.py:48-70)."""
    return torch.log(torch.clamp_min(torch.sum(torch.exp(a), dim=dim),
                                     1e-30))


def sinkhorn_uv_reference(c, log_mu, log_nu, iters: int):
    """Plain version: c (B, K1, K1), log_mu / log_nu (B, K1) -> (u, v)."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - lse_bounded(c + v.unsqueeze(1), dim=2)
        v = log_nu - lse_bounded(c + u.unsqueeze(2), dim=1)
    return u, v


def sinkhorn_uv(c, log_mu, log_nu, iters: int, *, lanes: int | None = None,
                mode: str | None = None):
    """Kernel B7: the potentials (u, v), each (B, K1), of `iters` Sinkhorn
    iterations on c (B, K1, K1) with log-marginals log_mu, log_nu (B, K1).

    lanes / mode force one of the kernel's variants, for measuring them
    against each other: lanes a row (KERNEL_LANES) and "exp" (exp(c + v) a
    term), "factored" (exp(c) once, times exp(v)) or "skeleton" (no exp or
    log: the latency floor of the launch shape; its u and v are not the
    potentials). By default the kernel's own choice."""
    if c.requires_grad or log_mu.requires_grad or log_nu.requires_grad:
        raise RuntimeError("sinkhorn_uv is primal only: detach its inputs "
                           "(nothing differentiates through the coupling)")
    if (lanes is None) != (mode is None):
        raise ValueError("lanes and mode force a variant together")
    if lanes is not None and (lanes not in KERNEL_LANES
                              or mode not in KERNEL_MODES):
        raise ValueError(f"lanes in {KERNEL_LANES} and mode in "
                         f"{tuple(KERNEL_MODES)}; got {lanes}, {mode}")
    if not c.is_cuda:
        if mode == "skeleton":
            raise ValueError("the skeleton variant is a timing of the card")
        return sinkhorn_uv_reference(c, log_mu, log_nu, iters)
    dev = c.device
    b, k1 = log_mu.shape
    kb.require(c, "c", (b, k1, k1), dev)
    kb.require(log_mu, "log_mu", (b, k1), dev)
    kb.require(log_nu, "log_nu", (b, k1), dev)
    if not (1 <= k1 <= KERNEL_MAX_K1 and iters >= 0):
        raise ValueError(f"the kernel takes K + 1 <= {KERNEL_MAX_K1} and "
                         f"iters >= 0; got {k1}, {iters}")
    if lanes is not None and k1 * lanes > 1024:
        raise ValueError(f"{lanes} lanes a row take K + 1 <= {1024 // lanes}; "
                         f"got {k1}")
    u = torch.empty_like(log_mu)
    v = torch.empty_like(log_nu)
    lib = kb.load()
    args = (kb.ptr(c), kb.ptr(log_mu), kb.ptr(log_nu), b, k1, iters)
    with torch.cuda.device(dev):
        if lanes is None:
            code = lib.ratrack_sinkhorn(*args, kb.ptr(u), kb.ptr(v),
                                        kb.stream_of(c))
        else:
            code = lib.ratrack_sinkhorn_variant(
                *args, lanes, KERNEL_MODES[mode], kb.ptr(u), kb.ptr(v),
                kb.stream_of(c))
    kb.check(code, "sinkhorn")
    sinkhorn_uv.launches += 1
    return u, v


sinkhorn_uv.launches = 0
