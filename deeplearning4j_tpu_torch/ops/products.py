"""The layers' matrix product with a float32 result, the counterpart of
`jnp.dot(..., preferred_element_type=jnp.float32)` in the JAX package's
`nn/layers.py:100-105` and `models/conv.py:98-100`.

Operands in float32 take `torch.matmul`. Operands in bfloat16 are
multiplied with float32 accumulation and the float32 result is kept:

- on a CUDA tensor, through cuBLAS's bf16 x bf16 -> float32 product
  (`torch.mm(..., out_dtype=torch.float32)`) where this torch offers it,
  else through `torch.matmul` in bfloat16 cast to float32, which rounds
  the result to bfloat16 first (`bf16_product_route` says which);
- on a CPU tensor, as a float32 product of the bfloat16 values, which
  is what XLA computes on the CPU.

The backward casts the float32 cotangent to bfloat16 and runs the two
products in bfloat16 (float32 accumulation), as autograd of a bfloat16
`matmul` would; the gradients come out in bfloat16.
"""

from __future__ import annotations

import torch

#: device index -> whether `torch.mm(..., out_dtype=float32)` runs there
_MM_OUT_DTYPE = {}


def bf16_product_route(device) -> str:
    """"mm.out_dtype" where this torch multiplies bfloat16 into a float32
    result on `device` (a CUDA device), else "matmul+cast"."""
    device = torch.device(device)
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    if key not in _MM_OUT_DTYPE:
        a = torch.ones((1, 16), dtype=torch.bfloat16, device=device)
        try:
            torch.mm(a, a.T, out_dtype=torch.float32)
            _MM_OUT_DTYPE[key] = True
        except (TypeError, RuntimeError, NotImplementedError):
            _MM_OUT_DTYPE[key] = False
    return "mm.out_dtype" if _MM_OUT_DTYPE[key] else "matmul+cast"


class _Bf16ProductF32(torch.autograd.Function):
    """(M, K) x (K, N) bfloat16 -> (M, N) float32 on the card."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b.T if ctx.needs_input_grad[0] else None
        gb = a.T @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul_f32(a, b):
    """a (..., K) @ b (K, N) with a float32 result, a and b of one dtype
    (float32 or bfloat16)."""
    if a.dtype != b.dtype:
        raise ValueError(f"operands of one dtype expected, got {a.dtype} "
                         f"and {b.dtype}")
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.dtype != torch.bfloat16:
        raise ValueError(f"float32 or bfloat16 operands expected, got "
                         f"{a.dtype}")
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if bf16_product_route(a.device) == "matmul+cast":
        return torch.matmul(a, b).float()
    out = _Bf16ProductF32.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*a.shape[:-1], b.shape[-1])
