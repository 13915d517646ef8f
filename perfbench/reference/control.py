"""The control of the comparison: the reference one precision step down.

The configurations compute in float32 with TF32 off. The step below, the
one a later change would be tempted to take, is TF32: every matrix product
takes its operands rounded to TF32's 10-bit mantissa (round to nearest,
ties away from zero, as the tensor cores' cvt.rna) and accumulates in
float32. `tf32_products()` runs the reference so, on any device, by
rounding the operands of every product that the TF32 switch of cuBLAS
would route to the tensor cores, in the forward pass and, through the
gradient of its output, in the two products of its backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.mm, torch.bmm, F.linear, torch._C._nn.linear}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), held in float32."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rounded(x):
    """x's value rounded to TF32, its gradient passed through whole."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    if not x.requires_grad:
        return tf32_round(x)
    return x + (tf32_round(x.detach()) - x).detach()


class _RoundGrad(torch.autograd.Function):
    """Identity whose backward rounds the incoming gradient to TF32: the
    operand the backward's products take from above."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


class tf32_products(TorchFunctionMode):
    """Inside the block every float32 matrix product has TF32 operands."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _PRODUCTS:
            return func(*args, **kwargs)
        # the two operands; a bias is added in float32
        args = tuple(_rounded(a) if i < 2 else a for i, a in enumerate(args))
        out = func(*args, **kwargs)
        if torch.is_tensor(out) and out.requires_grad:
            out = _RoundGrad.apply(out)
        return out
