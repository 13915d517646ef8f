"""Masked log-space Sinkhorn optimal transport with a dustbin, batched.
Counterpart of `ratrack_tpu/tracker/sinkhorn.py::log_optimal_transport_masked`
on the path the association takes (safe_lse=False, tol=0): the bounded
single-pass log-sum-exp, all `iters` iterations (500 in the model).

A fixed (K+1) x (K+1) matrix per stream: the first m rows / n columns are
valid, the dustbin is index K, invalid entries carry -1e9 scores and
log-marginals, whose exp underflows to exactly 0.
"""

from __future__ import annotations

import torch

NEG = -1e9


def _lse_bounded(a: torch.Tensor, dim: int) -> torch.Tensor:
    """log(sum(exp(a))) without the max pass: every finite operand of this
    OT instance is in [-20, 20] (sigmoid affinities, bin 0.9, bounded
    potentials; sinkhorn.py:48-70)."""
    return torch.log(torch.clamp_min(torch.sum(torch.exp(a), dim=dim),
                                     1e-30))


def log_optimal_transport_masked(scores: torch.Tensor, m: torch.Tensor,
                                 n: torch.Tensor, alpha: float,
                                 iters: int) -> torch.Tensor:
    """scores (B, K, K) prev x curr, m/n (B,) valid counts ->
    (B, K+1, K+1) log-coupling with the dustbin at index K."""
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

    u = torch.zeros((b, k + 1), dtype=dt, device=dev)
    v = torch.zeros((b, k + 1), dtype=dt, device=dev)
    for _ in range(iters):
        u = log_mu - _lse_bounded(c + v.unsqueeze(1), dim=2)
        v = log_nu - _lse_bounded(c + u.unsqueeze(2), dim=1)
    return c + u.unsqueeze(2) + v.unsqueeze(1) - norm.reshape(b, 1, 1)
