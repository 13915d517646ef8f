"""Masked log-space Sinkhorn optimal transport with a dustbin, batched.
Counterpart of `ratrack_tpu/tracker/sinkhorn.py::log_optimal_transport_masked`.
With tol = 0 it runs all `iters` iterations (500 in the model); with tol > 0
each stream stops early (`sinkhorn_uv_early_exit`).

A fixed (K+1) x (K+1) matrix per stream: the first m rows / n columns are
valid, the dustbin is index K, invalid entries carry -1e9 scores and
log-marginals, whose exp underflows to exactly 0.

Two log-sum-exps, as the JAX function's `safe_lse`:
  safe_lse=True   (the default) the two-pass, max-subtracted form
                  (`_lse`, sinkhorn.py:41-45 of the JAX package), safe for
                  scores of any size; a plain torch loop, as it is XLA code
                  there.
  safe_lse=False  the bounded single-pass form, right only where every
                  finite score is O(1): the association, whose scores are
                  sigmoid affinities, asks for it (association.py:147-152
                  of the JAX package). Its iterations run as the eager loop
                  (`ops.fused_sinkhorn.sinkhorn_uv_reference`) or, with
                  `use_fused_kernel`, in one launch of kernel B7
                  (`ops.fused_sinkhorn.sinkhorn_uv`). The switch is off by
                  default, as `USE_FUSED_KERNEL` of the JAX module
                  (sinkhorn.py:33).
B7 computes only the bounded form, so `use_fused_kernel` with
`safe_lse=True` raises (the JAX function takes its loop there instead).

The early exit (tol > 0, sinkhorn.py:127-142 of the JAX package): a stream
iterates while it has run fewer than `iters` iterations and the last one
moved u by more than tol (max |u_new - u| over the entries with |u_new| <
1e8, +inf before the first). A stream that stops keeps u, v and its count
frozen while the others go on: what `jax.vmap` of the JAX `while_loop`
computes. The host asks after every iteration whether any stream still
iterates. It takes either log-sum-exp. B7 has no early exit, so
`use_fused_kernel` with tol > 0 raises rather than run the loop in its
place.

The eager loop as one CUDA graph: its 500 iterations are 6,000 launches
of tiny kernels on (B, K+1, K+1), so the host's launch calls, not the
device, pace them. Where the call can be replayed (CUDA tensors, tol = 0,
no B7, no input that requires grad, no capture already under way on the
current stream) the iterations and the coupling run as a CUDA graph of
that loop, captured once per (device, B, K+1, dtype, iters, safe_lse) on
a side stream after one eager warm-up and replayed on the current stream
after that: the same kernels in the same order on the same shapes, so
the same bits. `_GRAPHS_PER_DEVICE` graphs are kept a device, the least
recently used dropped first. Counters on `log_optimal_transport_masked`:
`.captures` (calls that captured), `.replays` (calls that replayed a
graph captured before) and `.eager_on_device` (CUDA calls that took the
eager loop, the early exit or B7); CPU calls move none. The share of
CUDA calls the graph serves is replays / (replays + eager_on_device).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from ..ops.fused_sinkhorn import (lse_bounded, sinkhorn_uv,
                                  sinkhorn_uv_reference)
from ..trace import span

NEG = -1e9


def transport_problem(scores: torch.Tensor, m: torch.Tensor,
                      n: torch.Tensor, alpha: float):
    """The padded problem of scores (B, K, K) with m / n (B,) valid rows /
    columns -> (c (B, K+1, K+1), log_mu (B, K+1), log_nu (B, K+1),
    norm (B,)), at least float32: bfloat16 scores (a bfloat16 model's
    affinities) enter a float32 problem, as the JAX package's float32
    -1e9 and alpha promote them (sinkhorn.py:21, track4d.py:201)."""
    b, k = scores.shape[0], scores.shape[-1]
    dev = scores.device
    dt = torch.promote_types(scores.dtype, torch.float32)
    scores = scores.to(dt)
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


def _lse(a: torch.Tensor, dim: int) -> torch.Tensor:
    """log(sum(exp(a))) over dim, max-subtracted; an all-masked row's max
    is clamped at -1e9."""
    amax = torch.clamp_min(torch.amax(a, dim=dim, keepdim=True), NEG)
    return amax.squeeze(dim) + torch.log(torch.sum(torch.exp(a - amax),
                                                   dim=dim))


def _sinkhorn_uv_safe(c, log_mu, log_nu, iters: int):
    """The iterations of sinkhorn_uv_reference with the two-pass _lse:
    c (B, K1, K1), log_mu / log_nu (B, K1) -> (u, v)."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - _lse(c + v.unsqueeze(1), dim=2)
        v = log_nu - _lse(c + u.unsqueeze(2), dim=1)
    return u, v


def sinkhorn_uv_early_exit(c, log_mu, log_nu, iters: int, tol: float, *,
                           safe_lse: bool = True):
    """The early-exit iterations on c (B, K1, K1), log_mu / log_nu (B, K1)
    -> (u, v, count (B,) int32: the iterations each stream ran)."""
    lse = _lse if safe_lse else lse_bounded
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    count = torch.zeros(log_mu.shape[:1], dtype=torch.int32,
                        device=c.device)
    delta = torch.full(log_mu.shape[:1], float("inf"), dtype=c.dtype,
                       device=c.device)
    for _ in range(iters):
        # count < iters here, so a stream iterates while delta > tol
        active = delta > tol
        if not bool(active.any()):
            break
        u_new = log_mu - lse(c + v.unsqueeze(1), dim=2)
        v_new = log_nu - lse(c + u_new.unsqueeze(2), dim=1)
        moved = torch.where(u_new.abs() < 1e8, (u_new - u).abs(),
                            torch.zeros_like(u)).amax(dim=1)
        keep = active.unsqueeze(1)
        u = torch.where(keep, u_new, u)
        v = torch.where(keep, v_new, v)
        delta = torch.where(active, moved, delta)
        count = count + active.to(torch.int32)
    return u, v, count


def _coupling(c, u, v, norm):
    """The log-coupling c + u_i + v_j - norm, (B, K1, K1)."""
    return c + u.unsqueeze(2) + v.unsqueeze(1) - norm.reshape(-1, 1, 1)


_GRAPHS_PER_DEVICE = 8


class _SinkhornGraph:
    """The iterations and the coupling captured as one CUDA graph on static
    copies of one problem shape; calling it copies a problem of that shape
    in, replays and returns a clone of the coupling."""

    def __init__(self, solve, c, log_mu, log_nu, norm, iters: int):
        dev = c.device
        # static tensors that a later call outside inference mode may copy
        # into (an inference tensor takes no in-place write there)
        with torch.inference_mode(False), torch.no_grad(), \
                torch.cuda.device(dev):
            self.args = [t.clone() for t in (c, log_mu, log_nu, norm)]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                solve(*self.args[:3], iters)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: a data pipeline's thread may touch the card
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.z = _coupling(self.args[0],
                                   *solve(*self.args[:3], iters),
                                   self.args[3])
        self.lock = threading.Lock()
        # the last caller's clone is done: a caller on another stream waits
        # for it before it overwrites the static tensors
        self.free = torch.cuda.Event()

    def __call__(self, c, log_mu, log_nu, norm) -> torch.Tensor:
        stream = torch.cuda.current_stream(c.device)
        with self.lock:
            stream.wait_event(self.free)
            for static, t in zip(self.args, (c, log_mu, log_nu, norm)):
                static.copy_(t)
            self.graph.replay()
            z = self.z.clone()
            self.free.record(stream)
        return z


_graphs: "OrderedDict[tuple, _SinkhornGraph]" = OrderedDict()
_graphs_lock = threading.Lock()


def _replayed(solve, c, log_mu, log_nu, norm, iters: int, safe_lse: bool):
    """The coupling by the shape's graph, captured on its first call."""
    dev = c.device
    key = (dev, *log_mu.shape, c.dtype, iters, safe_lse)
    with _graphs_lock:
        graph = _graphs.get(key)
        if graph is None:
            same_device = [k for k in _graphs if k[0] == dev]
            if len(same_device) >= _GRAPHS_PER_DEVICE:
                del _graphs[same_device[0]]
            graph = _graphs[key] = _SinkhornGraph(solve, c, log_mu, log_nu,
                                                  norm, iters)
            log_optimal_transport_masked.captures += 1
        else:
            _graphs.move_to_end(key)
            log_optimal_transport_masked.replays += 1
    return graph(c, log_mu, log_nu, norm)


@span("sinkhorn")
def log_optimal_transport_masked(scores: torch.Tensor, m: torch.Tensor,
                                 n: torch.Tensor, alpha: float,
                                 iters: int, *, tol: float = 0.0,
                                 safe_lse: bool = True,
                                 use_fused_kernel: bool = False
                                 ) -> torch.Tensor:
    """scores (B, K, K) prev x curr, m/n (B,) valid counts ->
    (B, K+1, K+1) log-coupling with the dustbin at index K.
    tol: > 0 stops each stream early (see the module docstring); 0 runs
    all `iters` iterations.
    safe_lse: the two-pass log-sum-exp (see the module docstring).
    use_fused_kernel: all iterations in kernel B7 (bounded form only, so
    with safe_lse=False, and tol=0; primal only: scores must not require
    grad).
    On the card the eager loop runs as a replayed CUDA graph where it can
    (see the module docstring)."""
    if use_fused_kernel and safe_lse:
        raise ValueError("kernel B7 computes the bounded log-sum-exp only: "
                         "pass safe_lse=False with use_fused_kernel")
    if use_fused_kernel and tol > 0.0:
        raise ValueError(f"kernel B7 has no early exit: pass tol=0 with "
                         f"use_fused_kernel (got tol={tol})")
    c, log_mu, log_nu, norm = transport_problem(scores, m, n, alpha)
    solve = _sinkhorn_uv_safe if safe_lse else sinkhorn_uv_reference
    if c.is_cuda:
        if (tol == 0.0 and not use_fused_kernel and not c.requires_grad
                and not torch.cuda.is_current_stream_capturing()):
            return _replayed(solve, c, log_mu, log_nu, norm, iters,
                             safe_lse)
        log_optimal_transport_masked.eager_on_device += 1
    if tol > 0.0:
        u, v, _ = sinkhorn_uv_early_exit(c, log_mu, log_nu, iters, tol,
                                         safe_lse=safe_lse)
    else:
        u, v = (sinkhorn_uv if use_fused_kernel else solve)(
            c, log_mu, log_nu, iters)
    return _coupling(c, u, v, norm)


log_optimal_transport_masked.captures = 0
log_optimal_transport_masked.replays = 0
log_optimal_transport_masked.eager_on_device = 0
