"""Paged-attention decode: the hand-written Hopper kernel and its plain
version. Counterpart of the JAX package's `attention/paged_pallas.py`.

`paged_attention` streams each decode slot's WRITTEN pages straight from
the block pool (the PagedAttention design) instead of gathering a dense
`(S, H, window, hd)` K/V window:

- a CUDA tensor launches the kernel `csrc/paged_decode.cu` (K4) —
  float32 or bfloat16, head dim 64 or 128 — or raises for anything else.
  K4 is split-page flash decoding: a split kernel computes a partial
  softmax `(m, l, acc)` per run of `pages_per_split(page_size)` pages of
  a slot, into float32 scratch the wrapper allocates, and a combine
  kernel merges each (slot, head)'s partials;
- a CPU tensor runs `paged_attention_ref`, the same masked base-2
  softmax over the gathered window in plain PyTorch. That is the test
  lane, as interpret mode is for the Pallas kernel.
  `paged_attention_split_ref` mirrors the kernel's partition and merge
  in plain PyTorch, so the CPU tests check that arithmetic too.

`resolve_decode_kernel` is the lane selector behind the
`kernel="auto"|"kernel"|"gather"` knob of `DecodeLoop` and the engine.
`launches` counts wrapper calls that launched the kernel (its split and
combine launches count once), never plain-version calls. A call made
while the current stream is capturing a CUDA graph records the kernel
without running it: it counts in the calling thread's
`captured_launches()` instead, and the graph's owner counts its replays.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import _build
from deeplearning4j_tpu_torch.attention.flash import (KERNEL_DTYPES, NEG_INF,
                                                      scale2)

#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128)
DECODE_KERNELS = ("auto", "kernel", "gather")
#: positions one split of the kernel covers when the page size divides it
SPLIT_POSITIONS = 64

#: kernel launches since import (chip_smoke.py resets and reads it)
launches = 0
#: per thread: launches recorded into CUDA graphs under capture
_captured = threading.local()

__all__ = ["paged_attention", "paged_attention_ref",
           "paged_attention_split_ref", "pages_per_split",
           "resolve_decode_kernel", "DECODE_KERNELS", "launches",
           "captured_launches"]


def captured_launches() -> int:
    """Kernel launches this thread has recorded into CUDA graphs under
    capture (they ran no kernel, so `launches` leaves them out)."""
    return getattr(_captured, "n", 0)


def pages_per_split(page_size: int) -> int:
    """Pages in one split of the kernel: SPLIT_POSITIONS positions' worth,
    and one page when a page is larger than that. It depends on the
    page size alone, never on the cursors, which live on the device."""
    return max(1, SPLIT_POSITIONS // page_size)


def n_splits(table_width: int, page_size: int) -> int:
    """Splits a slot's table is cut into (the kernel's third grid axis)."""
    return -(-table_width // pages_per_split(page_size))


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths):
    """The plain version of the kernel: gather each slot's pages into its
    logical window, mask key positions past the slot's cursor to NEG_INF,
    base-2 softmax in float32 with masked lanes zeroed, P rounded to V's
    dtype before the P.V product, denominator floored at 1e-30. Masked
    lanes contribute exactly 0, so pages past the frontier (trash or not)
    change nothing — the kernel simply never reads them."""
    s, h, hd = q.shape
    ps = k_pool.shape[2]
    window = page_table.shape[1] * ps
    pt = page_table.long()
    kg = k_pool[pt].permute(0, 2, 1, 3, 4).reshape(s, h, window, hd)
    vg = v_pool[pt].permute(0, 2, 1, 3, 4).reshape(s, h, window, hd)
    scores = torch.einsum("shd,shkd->shk", q.float(), kg.float()) * scale2(hd)
    mask = (torch.arange(window, device=q.device)[None, :]
            <= lengths.long()[:, None])[:, None, :]          # (S, 1, W)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp2(scores - m) * mask
    denom = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("shk,shkd->shd", p.to(v_pool.dtype).float(),
                       vg.float())
    return (out / denom).to(q.dtype)


def paged_attention_split_ref(q, k_pool, v_pool, page_table, lengths):
    """The kernel's split and merge in plain PyTorch. Each slot's window
    is cut into runs of `pages_per_split` pages; each run gives a partial
    (m, l, acc): its visible scores' max, the sum of exp2(score - m) and
    the P.V product with P rounded to V's dtype. A run with no visible
    position has m = NEG_INF, l = 0, acc = 0. The merge weighs run i by
    exp2(m_i - max m), and by exactly 0 where m_i <= NEG_INF / 2, and
    floors the merged l at 1e-30. Returns (out in q's dtype, the partials
    (S, H, n_splits, hd + 2) float32 laid out as the kernel's scratch:
    acc, then m, then l)."""
    s, h, hd = q.shape
    ps, width = k_pool.shape[2], page_table.shape[1]
    run = pages_per_split(ps) * ps
    n = n_splits(width, ps)
    window, pad = width * ps, n * run - width * ps
    pt = page_table.long()
    kg = k_pool[pt].permute(0, 2, 1, 3, 4).reshape(s, h, window, hd)
    vg = v_pool[pt].permute(0, 2, 1, 3, 4).reshape(s, h, window, hd)
    scores = torch.einsum("shd,shkd->shk", q.float(), kg.float()) * scale2(hd)
    mask = (torch.arange(window, device=q.device)[None, :]
            <= lengths.long()[:, None])[:, None, :]          # (S, 1, W)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    scores = F.pad(scores, (0, pad), value=NEG_INF).reshape(s, h, n, run)
    mask = F.pad(mask, (0, pad)).reshape(s, 1, n, run)
    vg = F.pad(vg, (0, 0, 0, pad)).reshape(s, h, n, run, hd)
    m = scores.amax(dim=-1)                                  # (S, H, n)
    p = torch.exp2(scores - m[..., None]) * mask
    l = p.sum(dim=-1)
    acc = torch.einsum("shnr,shnrd->shnd", p.to(v_pool.dtype).float(),
                       vg.float())
    w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                    torch.exp2(m - m.amax(dim=-1, keepdim=True)))
    denom = torch.clamp_min((w * l).sum(dim=-1), 1e-30)
    out = (w[..., None] * acc).sum(dim=2) / denom[..., None]
    partial = torch.cat([acc, m[..., None], l[..., None]], dim=-1)
    return out.to(q.dtype), partial


def _check_aligned(*xs):
    """The kernel reads q and copies K and V in 16-byte vectors, in both
    dtypes: q and the pools must start on a 16-byte boundary (a fresh
    allocation does; a view at an odd offset may not)."""
    for x in xs:
        if x.data_ptr() % 16:
            raise ValueError("paged kernel needs 16-byte aligned q and "
                             "pools, got one at an offset")


def _check_kernel_args(q, k_pool, v_pool, page_table, lengths):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in KERNEL_DTYPES or not (
            q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError(f"paged kernel takes float32 or bfloat16 q and "
                         f"pools of one dtype, got {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged kernel takes q (S, H, hd) and pools "
                         f"(n_pages + 1, H, page_size, hd), got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    s, h, hd = q.shape
    if k_pool.shape[1] != h or k_pool.shape[3] != hd:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if (page_table.dim() != 2 or page_table.shape[0] != s
            or page_table.shape[1] < 1 or tuple(lengths.shape) != (s,)):
        raise ValueError(f"page_table must be (S, P>=1) and lengths (S,) "
                         f"for S={s}, got {tuple(page_table.shape)}, "
                         f"{tuple(lengths.shape)}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged kernel head dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if s > 65535:
        raise ValueError(f"paged kernel grid takes at most 65535 slots, "
                         f"got {s}")
    splits = n_splits(page_table.shape[1], k_pool.shape[2])
    if splits > 65535:
        raise ValueError(f"paged kernel grid takes at most 65535 splits a "
                         f"slot, got {splits}")
    if not all(t.is_contiguous()
               for t in (q, k_pool, v_pool, page_table, lengths)):
        raise ValueError("paged kernel needs contiguous operands")
    _check_aligned(q, k_pool, v_pool)


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """Single-token paged attention over the block pool.

    q: (S, H, hd) — one decode query row per slot. k_pool/v_pool:
    (n_pages + 1, H, page_size, hd), last page = trash. page_table:
    (S, P) int32 pool indices (trash past each slot's allocation; the
    kernel does not bound-check them). lengths: (S,) int32 cursors —
    positions [0, lengths[s]] are attended, so the incoming token's K/V
    must already be written at its cursor. Returns (S, H, hd) in q's
    dtype."""
    global launches
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    _check_kernel_args(q, k_pool, v_pool, page_table, lengths)
    s, h, hd = q.shape
    ps, width = k_pool.shape[2], page_table.shape[1]
    out = torch.empty_like(q)
    if s == 0:
        return out
    # the split kernel's partials (acc, m, l), merged by the combine kernel
    partial = torch.empty((s, h, n_splits(width, ps), hd + 2),
                          dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dl4j_paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            partial.data_ptr(), s, h, ps, width, pages_per_split(ps), hd,
            KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "dl4j_paged_decode")
    if torch.cuda.is_current_stream_capturing():
        _captured.n = captured_launches() + 1
    else:
        launches += 1
    return out


def resolve_decode_kernel(kernel: str, cfg, page_size: int, device) -> str:
    """Resolve the `kernel="auto"|"kernel"|"gather"` knob to the lane
    `paged_decode_step` runs, once, at loop construction.

    - "gather": the plain version (`paged_attention_ref`), always.
    - "kernel": the kernel, always honoured. On a CPU device its wrapper
      runs `paged_attention_ref` — the test lane.
    - "auto": the kernel on a CUDA device, the gather path on the CPU.

    On a CUDA device the kernel lane raises here, at construction, when
    the config lies outside what the kernel takes (head dim 64 or 128,
    float32 or bfloat16, page_size >= 1): nothing gives way to the plain
    version while the tensors are on the card."""
    if kernel not in DECODE_KERNELS:
        raise ValueError(
            f"kernel must be one of {DECODE_KERNELS}, got {kernel!r}")
    dev = torch.device(device).type
    if kernel == "auto":
        if dev not in ("cuda", "cpu"):
            raise ValueError(f"kernel='auto' resolves on CUDA or CPU "
                             f"devices, got {device}")
        kernel = "kernel" if dev == "cuda" else "gather"
    if kernel == "kernel" and dev == "cuda":
        hd = cfg.d_model // cfg.n_heads
        if hd not in KERNEL_HEAD_DIMS:
            raise ValueError(f"paged kernel head dim must be one of "
                             f"{KERNEL_HEAD_DIMS}, got {hd}")
        if cfg.dtype not in KERNEL_DTYPES:
            raise ValueError(f"paged kernel takes float32 or bfloat16, "
                             f"got {cfg.dtype}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
    return kernel
