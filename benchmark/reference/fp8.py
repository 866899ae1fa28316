"""Float32 products with TF32 off, and the control's float8 products.

`matmul(a, b, "fp8")` rounds both operands to float8 e4m3 under one
scale a tensor (the largest magnitude maps to the format's largest
finite value) and multiplies in float32; its backward rounds the
incoming gradient to float8 e5m2 the same way. That is the step below
the bfloat16 that the configurations state."""

from __future__ import annotations

import torch

FP8_FORWARD = torch.float8_e4m3fn
FP8_BACKWARD = torch.float8_e5m2


def strict_float32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor, fmt=FP8_FORWARD) -> torch.Tensor:
    """x rounded to `fmt` under one scale, returned in x's dtype."""
    fmax = torch.finfo(fmt).max
    amax = x.detach().abs().max().clamp_min(1e-30)
    scale = fmax / amax
    return (x * scale).to(fmt).to(x.dtype) / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(aq, bq)
        return torch.matmul(aq, bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = fp8_round(g, FP8_BACKWARD)
        ga = torch.matmul(gq, bq.transpose(-1, -2))
        gb = torch.matmul(aq.transpose(-1, -2), gq)
        # broadcast batch dimensions summed back to the operand's shape
        while gb.dim() > bq.dim():
            gb = gb.sum(0)
        while ga.dim() > aq.dim():
            ga = ga.sum(0)
        return ga, gb


def matmul(a, b, precision: str = "float32"):
    if precision == "fp8":
        return _Fp8MatMul.apply(a, b)
    return torch.matmul(a, b)
