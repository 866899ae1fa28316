"""Flash attention: the hand-written Hopper kernels and their plain
versions. Counterpart of the JAX package's `attention/flash_pallas.py`.

`flash_attention` and `flash_attention_with_lse` take q (..., Tq, d) and
k/v (..., Tk, d) and flatten the leading dims to (B*H, T, d). The forward
is `_flash_forward`, the backward `_flash_backward`:

- a CUDA tensor launches the kernels — `csrc/flash_fwd.cu` (K1) forward,
  `csrc/flash_bwd.cu` (K2 for dQ, then K3 for dK and dV) backward —
  float32 or bfloat16, head dim 64 or 128, any Tq and Tk (the kernels
  mask the ragged edge themselves), or raises for anything else;
- a CPU tensor runs `flash_attention_ref` / `flash_attention_bwd_ref`,
  the same base-2 arithmetic and rounding points written in plain
  PyTorch over the whole score matrix. That is the test lane, as
  interpret mode is for the Pallas kernels.

Gradients go through `_FlashAttention`, a `torch.autograd.Function`: its
forward asks K1 for the row log-sum-exp and saves (q, k, v, out, lse),
its backward runs K2 and K3 (on the CPU, their plain version), with the
lse cotangent folded into D = rowsum(dO * out) - g_lse as the JAX vjp
does. Only a call that needs a gradient (grad mode on and an input that
requires one) takes the Function; every other call, serving included,
launches K1 without the lse.

Causal masking is bottom-right aligned (query i sees keys up to
i + Tk - Tq). A query row that sees no key gives out = 0, lse = +1e30 (a
sentinel, not the -inf merge identity; see the JAX docstring of
`flash_attention_with_lse`) and exactly zero gradient.

`launches`, `dq_launches` and `dkv_launches` count launches of K1, K2 and
K3, never plain-version calls. A K1 call made while the current stream
is capturing a CUDA graph runs no kernel: it counts in the calling
thread's `captured_launches()` instead of `launches`.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634   # softmax state is kept in base 2 (exp2)
LN2 = 0.6931471805599453     # converts the base-2 lse back to natural log

#: head dims and dtypes the kernels are instantiated for
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of K1 (forward), K2 (dQ) and K3 (dK, dV) since import
#: (chip_smoke.py resets and reads them)
launches = 0
dq_launches = 0
dkv_launches = 0
#: per thread: K1 launches recorded into CUDA graphs under capture
_captured = threading.local()

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_ref", "flash_attention_bwd_ref", "launches",
           "dq_launches", "dkv_launches", "captured_launches", "LOG2E", "LN2",
           "NEG_INF"]


def captured_launches() -> int:
    """K1 launches this thread has recorded into CUDA graphs under
    capture (they ran no kernel, so `launches` leaves them out)."""
    return getattr(_captured, "n", 0)


def scale2(d: int) -> float:
    """log2(e)/sqrt(d) rounded as the forward kernel computes it, in
    float32."""
    return float(np.float32(LOG2E) / np.sqrt(np.float32(d)))


def bwd_scales(d: int):
    """(1/sqrt(d), 1/sqrt(d) * log2(e)), each rounded to float32 as the
    backward kernels (and the TPU's, `flash_pallas.py:343-346`) compute
    them."""
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    return float(scale), float(scale * np.float32(LOG2E))


def _causal_mask(tq, tk, device):
    return torch.ones((tq, tk), dtype=torch.bool,
                      device=device).tril(diagonal=tk - tq)


def flash_attention_ref(q, k, v, causal: bool = False,
                        return_lse: bool = False):
    """The plain version of the kernel on (B, Tq, d) / (B, Tk, d): scores
    in float32 prescaled by log2(e)/sqrt(d), masked to NEG_INF, base-2
    softmax with masked lanes zeroed, P rounded to V's dtype before the
    P.V product, denominator floored at 1e-30. Returns out in q's dtype
    (and the natural-log lse in float32 when asked)."""
    tq, tk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale2(d)
    mask = (_causal_mask(tq, tk, q.device) if causal
            else torch.ones((tq, tk), dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp2(scores - m) * mask
    s = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (out / torch.clamp_min(s, 1e-30)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(s > 0.0, LN2 * m + torch.log(torch.clamp_min(s, 1e-30)),
                      torch.full_like(s, -NEG_INF))
    return out, lse[..., 0]


def _delta(out, do, g_lse=None):
    """D = rowsum(dO * out) - g_lse in float32, (B, Tq): the row term of
    dS = P * (dP - D). The JAX package computes it outside its kernels
    too (`flash_pallas.py:446-451`)."""
    dd = (do.float() * out.float()).sum(dim=-1)
    return dd if g_lse is None else dd - g_lse.float()


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal: bool = False,
                            g_lse=None):
    """The plain version of the backward kernels on (B, Tq, d) /
    (B, Tk, d), over the whole score matrix: S = q.k^T * scale * log2(e)
    in float32, masked to NEG_INF; P = exp2(S - lse * log2(e));
    dP = dO.v^T; dS = P * (dP - D); dQ = round(dS).k * scale,
    dV = round(P)^T.dO, dK = round(dS)^T.q * scale, where round() casts
    to the inputs' dtype first. Returns (dq, dk, dv) in q's, k's and v's
    dtypes. `g_lse` is the cotangent of the lse output, if any."""
    tq, tk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale, s2 = bwd_scales(d)
    dd = _delta(out, do, g_lse)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s2
    if causal:
        s = torch.where(_causal_mask(tq, tk, q.device), s,
                        torch.full_like(s, NEG_INF))
    p = torch.exp2(s - (lse.float() * LOG2E)[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - dd[..., None])
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_args(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in KERNEL_DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash kernel takes (B, T, d) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, d = q.shape
    if k.shape[0] != b or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head dim")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if b > 65535:
        raise ValueError(f"flash kernel grid takes at most 65535 batch*head "
                         f"rows, got {b}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k, v")
    _check_aligned(q, k, v)


def _check_aligned(*xs):
    """The bf16 kernels copy 16-byte chunks (cp.async): every bf16 operand
    must start on a 16-byte boundary (a fresh allocation does; a view at an
    odd offset may not)."""
    for x in xs:
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError("flash kernel needs 16-byte aligned bfloat16 "
                             "tensors, got one at an offset")


def _flash_forward(q, k, v, causal: bool, want_lse: bool):
    """(B, Tq, d) / (B, Tk, d) -> (out, lse or None). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    global launches
    if q.device.type == "cpu":
        if want_lse:
            return flash_attention_ref(q, k, v, causal, return_lse=True)
        return flash_attention_ref(q, k, v, causal), None
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    _check_kernel_args(q, k, v)
    b, tq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, tq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if b == 0 or tq == 0:
        return out, lse
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dl4j_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None, b, tq, k.shape[1], d,
            KERNEL_DTYPES[q.dtype], int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "dl4j_flash_fwd")
    if torch.cuda.is_current_stream_capturing():
        _captured.n = captured_launches() + 1
    else:
        launches += 1
    return out, lse


def _flash_backward(q, k, v, out, lse, do, causal: bool, g_lse=None):
    """(dq, dk, dv) of (B, Tq, d) / (B, Tk, d) attention from the saved
    forward (out, lse (B, Tq) float32) and the cotangents dO (and g_lse).
    CPU tensors take the plain version; CUDA tensors launch K2 then K3 or
    raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal, g_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    _check_kernel_args(q, k, v)
    b, tq, d = q.shape
    tk = k.shape[1]
    for name, x in (("out", out), ("dO", do)):
        if (x.shape != q.shape or x.dtype != q.dtype or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(f"flash backward needs a contiguous {name} "
                             f"shaped and typed like q, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    _check_aligned(do)
    if (lse.shape != (b, tq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash backward needs a contiguous float32 lse of "
                         f"shape {(b, tq)}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if b == 0 or tq == 0 or tk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dd = _delta(out, do, g_lse).contiguous()
    return (_launch_dq(q, k, v, do, lse, dd, causal),
            *_launch_dkv(q, k, v, do, lse, dd, causal))


def _launch_bwd(name, outs, q, k, v, do, lse, dd, causal):
    b, tq, d = q.shape
    with torch.cuda.device(q.device):
        err = getattr(_build.library(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), *(o.data_ptr() for o in outs), b,
            tq, k.shape[1], d, KERNEL_DTYPES[q.dtype], int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)


def _launch_dq(q, k, v, do, lse, dd, causal):
    """K2 on checked, non-empty CUDA inputs (D given): dQ."""
    global dq_launches
    dq = torch.empty_like(q)
    _launch_bwd("dl4j_flash_bwd_dq", (dq,), q, k, v, do, lse, dd, causal)
    dq_launches += 1
    return dq


def _launch_dkv(q, k, v, do, lse, dd, causal):
    """K3 on checked, non-empty CUDA inputs (D given): (dK, dV)."""
    global dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dl4j_flash_bwd_dkv", (dk, dv), q, k, v, do, lse, dd,
                causal)
    dkv_launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """(B, Tq, d) / (B, Tk, d) -> (out, lse), differentiable in both:
    K1 with its lse forward, K2 and K3 backward (the plain versions of
    both on the CPU). Never autograd through the plain forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_forward(q, k, v, causal, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        if torch.is_grad_enabled():
            # asked for a graph of the gradient (create_graph=True, e.g.
            # a Hessian-vector product): the kernels' backward is not
            # differentiable, and a product that silently left this part
            # out would be wrong
            raise RuntimeError(
                "flash attention is differentiable once: its backward "
                "(K2/K3) has no derivative, so no second derivative "
                "(create_graph=True) can pass through it")
        q, k, v, out, lse = ctx.saved_tensors
        g_out = (torch.zeros_like(out) if g_out is None
                 else g_out.contiguous())
        dq, dk, dv = _flash_backward(q, k, v, out, lse, g_out, ctx.causal,
                                     g_lse)
        return dq, dk, dv, None


def _flat(x):
    return x.reshape(-1, x.shape[-2], x.shape[-1]).contiguous()


def _attention(q, k, v, causal, want_lse):
    q3, k3, v3 = _flat(q), _flat(k), _flat(v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q3, k3, v3, bool(causal))
    else:
        out, lse = _flash_forward(q3, k3, v3, causal, want_lse)
    return out.reshape(q.shape), lse


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention. q: (..., Tq, d); k/v: (..., Tk, d). Returns
    (..., Tq, d) in q's dtype, differentiable in q, k and v. Sequence
    length is axis -2 (a 4-D (B, H, T, d) input's axis 1 is heads)."""
    return _attention(q, k, v, causal, want_lse=False)[0]


def flash_attention_with_lse(q, k, v, causal: bool = False):
    """Flash attention returning (out, lse): lse[i] = log sum_j exp(s_ij)
    per query row (natural log, scaled scores), float32 of shape
    (..., Tq), differentiable jointly with out. Fully-masked rows get
    out = 0 and lse = +1e30."""
    out, lse = _attention(q, k, v, causal, want_lse=True)
    return out, lse.reshape(q.shape[:-1])
