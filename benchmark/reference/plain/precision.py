"""Operand rounding of the reference's precision control.

The benchmark's configurations compute the sparse convolutions' operands in
bf16 with f32 accumulation. The control of the comparison that decides
``correct`` is this reference computed one precision lower: fp8 (e4m3)
operands, each tensor scaled so that its largest magnitude sits at e4m3's
largest finite value (448), as an fp8 GEMM takes them, with f32
accumulation. :func:`fp8` rounds a forward operand and passes its gradient
through; :func:`fp8_grad` leaves the forward alone and rounds the gradient,
as the bf16 backward rounds the incoming gradient before its GEMMs.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, returned in f32."""
    x = x.float()
    amax = x.detach().abs().amax()
    if not bool(torch.isfinite(amax)) or float(amax) == 0.0:
        return x
    scale = _E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_e4m3(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def fp8_grad(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Grad.apply(x)
