"""Masked log-space Sinkhorn optimal transport with a dustbin, batched.
Counterpart of `ratrack_tpu/tracker/sinkhorn.py::log_optimal_transport_masked`
on the path the association takes (safe_lse=False, tol=0): the bounded
single-pass log-sum-exp, all `iters` iterations (500 in the model).

A fixed (K+1) x (K+1) matrix per stream: the first m rows / n columns are
valid, the dustbin is index K, invalid entries carry -1e9 scores and
log-marginals, whose exp underflows to exactly 0.

The iterations run as the eager loop (`ops.fused_sinkhorn.
sinkhorn_uv_reference`) or, with `use_fused_kernel`, in one launch of
kernel B7 (`ops.fused_sinkhorn.sinkhorn_uv`). The switch is off by default,
as `USE_FUSED_KERNEL` of the JAX module (sinkhorn.py:33).
"""

from __future__ import annotations

import torch

from ..ops.fused_sinkhorn import sinkhorn_uv, sinkhorn_uv_reference

NEG = -1e9


def transport_problem(scores: torch.Tensor, m: torch.Tensor,
                      n: torch.Tensor, alpha: float):
    """The padded problem of scores (B, K, K) with m / n (B,) valid rows /
    columns -> (c (B, K+1, K+1), log_mu (B, K+1), log_nu (B, K+1),
    norm (B,))."""
    b, k = scores.shape[0], scores.shape[-1]
    dev, dt = scores.device, scores.dtype
    ar = torch.arange(k, device=dev)
    row_ok = ar.unsqueeze(0) < m.unsqueeze(1)                 # (B, K)
    col_ok = ar.unsqueeze(0) < n.unsqueeze(1)
    mf = torch.clamp_min(m.to(dt), 1.0)
    nf = torch.clamp_min(n.to(dt), 1.0)
    norm = -torch.log(mf + nf)                                # (B,)

    neg = torch.tensor(NEG, dtype=dt, device=dev)
    a = torch.tensor(alpha, dtype=dt, device=dev)
    c = torch.full((b, k + 1, k + 1), NEG, dtype=dt, device=dev)
    c[:, :k, :k] = torch.where(row_ok.unsqueeze(2) & col_ok.unsqueeze(1),
                               scores, neg)
    c[:, :k, k] = torch.where(row_ok, a, neg)
    c[:, k, :k] = torch.where(col_ok, a, neg)
    c[:, k, k] = a

    log_mu = torch.cat([torch.where(row_ok, norm.unsqueeze(1), neg),
                        (torch.log(nf) + norm).unsqueeze(1)], dim=1)
    log_nu = torch.cat([torch.where(col_ok, norm.unsqueeze(1), neg),
                        (torch.log(mf) + norm).unsqueeze(1)], dim=1)

    return c, log_mu, log_nu, norm


def log_optimal_transport_masked(scores: torch.Tensor, m: torch.Tensor,
                                 n: torch.Tensor, alpha: float,
                                 iters: int,
                                 use_fused_kernel: bool = False
                                 ) -> torch.Tensor:
    """scores (B, K, K) prev x curr, m/n (B,) valid counts ->
    (B, K+1, K+1) log-coupling with the dustbin at index K.
    use_fused_kernel: all iterations in kernel B7 (primal only: scores must
    not require grad)."""
    c, log_mu, log_nu, norm = transport_problem(scores, m, n, alpha)
    solve = sinkhorn_uv if use_fused_kernel else sinkhorn_uv_reference
    u, v = solve(c, log_mu, log_nu, iters)
    return c + u.unsqueeze(2) + v.unsqueeze(1) - norm.reshape(-1, 1, 1)
