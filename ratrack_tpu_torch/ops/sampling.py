"""Farthest point sampling, identity sampling and row gathers, batched.

Counterpart of `ratrack_tpu/ops/sampling.py`. Where npoint == N (the live
512-point config) farthest point sampling picks every valid point and
`identity_sample` stands in for it; `exact_fps` and the stretch clouds
(8192 / 16384 points, 512 centers) run the real thing:

  furthest_point_sample            the kernel wrapper (kernel B6,
                                   `csrc/fps.cu`, which replaces
                                   `ratrack_tpu/ops/pallas_fps_kernel.py::
                                   _fps_kernel`): CUDA tensors launch the
                                   kernel (or raise), CPU tensors take
  furthest_point_sample_reference  the plain version, the sequential loop.

The JAX package's TPU gather workarounds (one-hot matmuls, bf16 splits, the
select trick of `identity_gather`) become plain indexed loads here.
"""

from __future__ import annotations

import torch

from ..kernels import build as kb

FPS_MAX_POINTS = 16384   # csrc/fps.cu: kMaxPoints


def first_valid(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B,) index of the first True (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def identity_sample(n: int, npoint: int,
                    mask: torch.Tensor | None = None,
                    batch: int = 1, device=None) -> torch.Tensor:
    """arange(npoint) % n, with slots past the valid count redirected to
    the first valid index (JAX `identity_sample`, :72-85). -> (B, npoint)."""
    if mask is not None:
        batch, device = mask.shape[0], mask.device
    idx = (torch.arange(npoint, device=device) % n).expand(batch, npoint)
    if mask is None:
        return idx
    n_valid = mask.sum(dim=-1, keepdim=True)
    return torch.where(idx < n_valid, idx, first_valid(mask)[:, None])


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather (B, N, C) x (B, M) -> (B, M, C)."""
    return torch.gather(
        points, 1, idx.unsqueeze(-1).expand(-1, -1, points.shape[-1]))


def identity_gather(points: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """gather(points, identity_sample(n, n, mask)): rows past the valid
    count take the first valid point's row."""
    if mask is None:
        return points
    return gather(points, identity_sample(points.shape[1], points.shape[1],
                                          mask))


def furthest_point_sample_reference(xyz: torch.Tensor, npoint: int,
                                    mask: torch.Tensor | None = None
                                    ) -> torch.Tensor:
    """Plain version of kernel B6: iterative farthest point sampling over
    the valid points of each stream (JAX `furthest_point_sample`, :29-69).

    xyz (B, N, 3), mask (B, N) bool or None -> (B, npoint) int64. Seeded at
    the first valid index; the next sample is the first index of the
    largest running minimum distance, invalid points pinned at -1 (never
    selected while a valid point remains; with none valid every sample is
    0). npoint above the valid count repeats points deterministically.
    The distance is dx*dx + dy*dy + dz*dz in that order, float32, as in the
    kernel."""
    b, n, _ = xyz.shape
    xyz = xyz.to(torch.float32)
    xs, ys, zs = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    temp = torch.where(mask, 1e10, -1.0).to(torch.float32)
    old = first_valid(mask).unsqueeze(1)                       # (B, 1)
    out = [old]
    for _ in range(1, npoint):
        dx = xs - torch.gather(xs, 1, old)
        dy = ys - torch.gather(ys, 1, old)
        dz = zs - torch.gather(zs, 1, old)
        d = dx * dx + dy * dy + dz * dz
        temp = torch.where(mask, torch.minimum(temp, d),
                           torch.full_like(temp, -1.0))
        old = torch.argmax(temp, dim=1, keepdim=True)          # first max
        out.append(old)
    return torch.cat(out, dim=1)


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: torch.Tensor | None = None,
                          shape: tuple[int, int] | None = None
                          ) -> torch.Tensor:
    """Kernel B6: xyz (B, N, 3), mask (B, N) or None -> (B, npoint) int64
    sample indices, all streams in one launch. shape: by default the kernel
    picks its launch shape by N; (threads a block, blocks a stream) forces
    one (1 block: no cluster), for measuring the shapes against each other.
    """
    if not xyz.is_cuda:
        return furthest_point_sample_reference(xyz, npoint, mask)
    dev = xyz.device
    b, n = xyz.shape[0], xyz.shape[1]
    kb.require(xyz, "xyz", (b, n, 3), dev)
    if mask is not None:
        kb.require(mask, "mask", (b, n), dev, torch.bool)
    if not (1 <= n <= FPS_MAX_POINTS and npoint >= 1):
        raise ValueError(f"the kernel takes 1 <= N <= {FPS_MAX_POINTS} and "
                         f"npoint >= 1; got N={n}, npoint={npoint}")
    out = torch.empty((b, npoint), device=dev, dtype=torch.int32)
    threads, blocks = (0, 0) if shape is None else shape
    with torch.cuda.device(dev):
        code = kb.load().ratrack_fps(kb.ptr(xyz), kb.ptr(mask), b, n, npoint,
                                     kb.ptr(out), int(threads), int(blocks),
                                     kb.stream_of(xyz))
    kb.check(code, "fps")
    furthest_point_sample.launches += 1
    return out.long()


furthest_point_sample.launches = 0
