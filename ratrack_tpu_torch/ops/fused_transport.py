"""FLOT's unbalanced transport and the flow of its plan: kernel B11 and its
plain twin.

Replaces no TPU kernel (the JAX package runs no FLOT); the CUDA kernel is
`csrc/transport.cu`, whose header says what bounds it on the H100 and how
its design answers that. Both versions compute, per stream, from
normalised features f (n, C), g (m, C), the clouds p (n, 3), q (m, 3), eps
and power = gamma / (gamma + eps):

  K = exp(-(1 - f g^T) / eps) * [|p_i - q_j|^2 < support2]
  a = 1/n; `iters` times: b = (1/m / (K^T a + 1e-8))^power,
                          a = (1/n / (K b + 1e-8))^power
  T = diag(a) K diag(b);  flow = T q / (T 1 + 1e-8) - p

(FLOT's `ot.sinkhorn` and the flow of `FLOT.forward`, arXiv:2007.11142),
d^2 in the difference form ((dx dx + dy dy) + dz dz) so that every
version decides the 10 m support alike.

  transport_flow            the kernel wrapper: CUDA tensors launch the
                            kernel (or raise), CPU tensors take
  transport_flow_reference  the plain version, a chunk of rows of K at a
                            time, recomputed on every pass: the plan is
                            never whole.
"""

from __future__ import annotations

import torch

from ..kernels import build as kb

TINY = 1e-8
REFERENCE_ROWS = 512     # rows of K a step of the plain version


def _plan_rows(f, g, p, q, eps, support2: float, r0: int, r1: int):
    """Rows [r0, r1) of K, (B, r, m)."""
    cost = 1.0 - torch.matmul(f[:, r0:r1], g.transpose(1, 2))
    k = torch.exp(-cost / eps)
    d = p[:, r0:r1, None, :] - q[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return torch.where(d2 < support2, k, torch.zeros_like(k))


def transport_flow_reference(f, g, p, q, eps, power, iters: int,
                             support2: float, rows: int = REFERENCE_ROWS):
    """Plain version: f (B, n, C), g (B, m, C) normalised, p (B, n, 3), q
    (B, m, 3), eps and power tensors that broadcast against (B, 1, 1)
    -> the flow (B, n, 3)."""
    if iters < 1:
        raise ValueError(f"iters={iters}: the transport takes iters >= 1")
    b_, n, m = f.shape[0], f.shape[1], g.shape[1]
    eps = torch.as_tensor(eps, dtype=f.dtype, device=f.device)
    power = torch.as_tensor(power, dtype=f.dtype, device=f.device)
    eps3, pow2 = eps.reshape(-1, 1, 1), power.reshape(-1, 1)
    prob1 = torch.ones(b_, n, dtype=f.dtype, device=f.device) / n
    prob2 = torch.ones(b_, m, dtype=f.dtype, device=f.device) / m
    a = prob1.clone()
    chunks = [(r0, min(r0 + rows, n)) for r0 in range(0, n, rows)]
    for it in range(iters):
        kta = torch.zeros(b_, m, dtype=f.dtype, device=f.device)
        for r0, r1 in chunks:
            k = _plan_rows(f, g, p, q, eps3, support2, r0, r1)
            kta += torch.matmul(a[:, None, r0:r1], k)[:, 0]
        b = (prob2 / (kta + TINY)) ** pow2
        last = it == iters - 1
        a_new, flow = [], []
        for r0, r1 in chunks:
            k = _plan_rows(f, g, p, q, eps3, support2, r0, r1)
            kb_ = torch.matmul(k, b[:, :, None])[..., 0]
            ai = (prob1[:, r0:r1] / (kb_ + TINY)) ** pow2
            a_new.append(ai)
            if last:
                tq = ai[..., None] * torch.matmul(k, b[:, :, None] * q)
                flow.append(tq / (ai * kb_ + TINY)[..., None]
                            - p[:, r0:r1])
        a = torch.cat(a_new, dim=1)
    return torch.cat(flow, dim=1)


def transport_flow(f, g, p, q, eps, power, iters: int, support2: float):
    """Kernel B11: f (B, n, C), g (B, m, C) normalised, p (B, n, 3), q
    (B, m, 3); eps and power one-element tensors on the device -> the flow
    (B, n, 3). The plan's K lives in a (B, n, m) scratch for the call."""
    if not f.is_cuda:
        return transport_flow_reference(f, g, p, q, eps, power, iters,
                                        support2)
    if any(t.requires_grad for t in (f, g, p, q, eps, power)):
        raise RuntimeError("transport_flow is primal only: detach its "
                           "inputs")
    dev = f.device
    b_, n, c = f.shape
    m = g.shape[1]
    kb.require(f, "f", (b_, n, c), dev, align16=True)
    kb.require(g, "g", (b_, m, c), dev, align16=True)
    kb.require(p, "p", (b_, n, 3), dev)
    kb.require(q, "q", (b_, m, 3), dev, align16=True)
    if c % 8 or m % 4 or iters < 1:
        raise ValueError(f"the kernel takes C % 8 == 0, m % 4 == 0 and "
                         f"iters >= 1; got C={c}, m={m}, iters={iters}")
    params = torch.cat([eps.reshape(1), power.reshape(1)]).to(
        dtype=torch.float32).contiguous()
    kmat = torch.empty((b_, n, m), device=dev, dtype=torch.float32)
    a = torch.ones((b_, n), device=dev, dtype=torch.float32) / n
    b = torch.empty((b_, m), device=dev, dtype=torch.float32)
    flow = torch.empty((b_, n, 3), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        code = kb.load().ratrack_transport_flow(
            kb.ptr(f), kb.ptr(g), kb.ptr(p), kb.ptr(q), kb.ptr(params), b_,
            n, m, c, float(support2), iters, kb.ptr(kmat), kb.ptr(a),
            kb.ptr(b), kb.ptr(flow), kb.stream_of(f))
    kb.check(code, "transport_flow")
    transport_flow.launches += 1
    return flow


transport_flow.launches = 0
