"""Paged KV cache: block-pool K/V storage for continuous-batching decode —
the counterpart of the JAX package's `serving/paged_kv.py`.

- per layer, one `(n_pages + 1, n_heads, page_size, head_dim)` pool for K
  and one for V. The LAST page is the **trash page**: inactive slots and
  padding rows direct their writes there, so no write needs a
  data-dependent shape. The host allocator never hands it out.
- a per-slot **page table** `(S, pages_per_slot)` of pool indices maps a
  slot's logical positions `[0, max_len)` onto physical pages;
  unallocated entries hold the trash index (their positions are masked
  out of attention by the slot's length).

Prefill runs the flash forward kernel (K1); each decode step runs the
paged decode kernel (K4) or its plain dense-gather version, and so does
each column of the widened speculative verify step (`paged_verify_step`).
The prefix cache's warm-tail prefill (`paged_prefill_ctx`) and its
copy-on-write fork (`copy_page`) are plain torch in both packages: no
TPU kernel carries them.

The pools are written IN PLACE (`index_put_` through advanced indexing)
where the JAX package's functional `.at[].set` builds new arrays, so
every function here returns the same pool object it was given, and the
pool's storage is never reallocated (the decode loop's captured CUDA
graphs read it at fixed addresses). Duplicate writes to the trash page (inactive slots, padding
rows) have an unspecified winner in both frameworks; the trash page is
never read unmasked.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.attention.flash import NEG_INF, flash_attention
from deeplearning4j_tpu_torch.attention.paged import (paged_attention,
                                                      paged_attention_ref)
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         _layer_norm)
from deeplearning4j_tpu_torch.serving.kv_cache import _ffn, _heads

__all__ = ["PagedKVPool", "init_paged_pool", "paged_kv_bytes",
           "pages_per_slot", "pages_for_tokens", "prompt_buckets",
           "paged_prefill", "paged_prefill_ctx", "paged_decode_step",
           "paged_verify_step", "copy_page", "decode_read_bytes",
           "extract_pages", "extract_page", "install_pages",
           "install_page"]


class PagedKVPool:
    """Per-block K/V page pools. `layers`: list (one per transformer
    block) of {"k", "v"} tensors of shape (n_pages + 1, n_heads,
    page_size, head_dim); index `n_pages` (the last page) is the trash
    page for masked writes."""

    __slots__ = ("layers",)

    def __init__(self, layers: List[dict]):
        self.layers = layers

    @property
    def page_size(self) -> int:
        return self.layers[0]["k"].shape[2]

    @property
    def n_pages(self) -> int:
        """Usable pages (the trash page is excluded)."""
        return self.layers[0]["k"].shape[0] - 1

    @property
    def trash_page(self) -> int:
        return self.layers[0]["k"].shape[0] - 1


def pages_per_slot(cfg: TransformerConfig, page_size: int) -> int:
    """Page-table width: pages covering the model's full window."""
    return -(-cfg.max_len // page_size)


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """Physical pages holding `n_tokens` written positions."""
    return -(-n_tokens // page_size)


def prompt_buckets(cfg: TransformerConfig, page_size: int
                   ) -> Tuple[int, ...]:
    """Prefill prompt-length buckets: page-multiple powers of two up to
    the full window."""
    top = pages_per_slot(cfg, page_size) * page_size
    buckets, b = [], page_size
    while b < top:
        buckets.append(b)
        b *= 2
    buckets.append(top)
    return tuple(buckets)


def _check_pool_args(n_pages: int, page_size: int) -> None:
    if n_pages < 1:
        raise ValueError(f"n_pages must be >= 1, got {n_pages}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")


def init_paged_pool(cfg: TransformerConfig, n_pages: int, page_size: int,
                    device=None) -> PagedKVPool:
    """Allocate the block pool (`n_pages` usable + 1 trash page per
    layer) on `device` (None = the CUDA device)."""
    _check_pool_args(n_pages, page_size)
    device = default_device(device)
    hd = cfg.d_model // cfg.n_heads
    shape = (n_pages + 1, cfg.n_heads, page_size, hd)
    layers = [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
               "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
              for _ in range(cfg.n_layers)]
    return PagedKVPool(layers)


def paged_kv_bytes(cfg: TransformerConfig, n_pages: int,
                   page_size: int) -> int:
    """Device memory the whole pool pins (including the trash page)."""
    _check_pool_args(n_pages, page_size)
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return (2 * cfg.n_layers * (n_pages + 1) * page_size
            * cfg.d_model * itemsize)


@torch.no_grad()
def paged_prefill(params, tokens, true_len, pool: PagedKVPool, page_ids,
                  cfg: TransformerConfig):
    """Run a BATCH of padded prompts (B, Tb) through every block,
    scattering each row's K/V into the pool pages listed in its
    `page_ids` row (shape (B, Tb/page_size); entries past a row's real
    pages, and every entry of a padding row, hold the trash index).
    `true_len` is (B,); returns (logits (B, vocab), each row at its own
    position `true_len - 1`, the pool)."""
    b, tb = tokens.shape
    ps = pool.page_size
    # a page-multiple bucket can overshoot max_len: clamp the position
    # ids so the overshoot rows (padding) reuse the last embedding
    pos_ids = torch.clamp_max(torch.arange(tb, device=tokens.device),
                              cfg.max_len - 1)
    x = params["embed"][tokens.long()] + params["pos"][pos_ids]
    flat_ids = page_ids.reshape(-1).long()                # (B * Tb/ps,)

    def pages(arr, like):
        # (B, H, Tb, hd) -> (B * Tb/ps pages, H, ps, hd)
        a = arr.to(like.dtype).reshape(b, cfg.n_heads, tb // ps, ps, -1)
        return a.transpose(1, 2).reshape(b * (tb // ps), cfg.n_heads, ps, -1)

    for p, layer in zip(params["blocks"], pool.layers):
        h = _layer_norm(p["ln1"], x)
        q = _heads(h, p["Wq"], cfg)
        k = _heads(h, p["Wk"], cfg)
        v = _heads(h, p["Wv"], cfg)
        att = flash_attention(q, k, v, True)
        att = att.transpose(1, 2).reshape(b, tb, cfg.d_model)
        x = x + att @ p["Wo"]
        x = _ffn(p, x)
        layer["k"][flat_ids] = pages(k, layer["k"])
        layer["v"][flat_ids] = pages(v, layer["v"])
    x = _layer_norm(params["ln_f"], x)
    # each row's LAST REAL position before the vocab projection
    last_x = x[torch.arange(b, device=x.device), true_len.long() - 1]
    return last_x @ params["embed"].T, pool


@torch.no_grad()
def copy_page(pool: PagedKVPool, src, dst) -> PagedKVPool:
    """Copy-on-write fork: duplicate ONE physical page (every layer's K
    and V rows) from pool index `src` into `dst`, in place."""
    for layer in pool.layers:
        layer["k"][dst].copy_(layer["k"][src])
        layer["v"][dst].copy_(layer["v"][src])
    return pool


@torch.no_grad()
def extract_pages(pool: PagedKVPool, pages: Sequence[int]) -> List[list]:
    """Host copies of the physical `pages` across every layer — the fleet
    KV plane's export read (serving/fleetkv.py). One `index_select` per
    layer tensor gathers the pages on the device, ONE copy brings them to
    the host; returns, per page, a list of (k, v) CPU tensors of shape
    (n_heads, page_size, head_dim), one pair per layer (views of that one
    host buffer). The caller orders the read after the writes it must
    see (decode_loop.DecodeLoop.kv_export)."""
    if not pages:
        return []
    dev = pool.layers[0]["k"].device
    idx = torch.tensor([int(p) for p in pages], dtype=torch.long,
                       device=dev)
    host = torch.stack([layer[name].index_select(0, idx)
                        for layer in pool.layers
                        for name in ("k", "v")]).cpu()
    # host: (2 * layers, pages, H, ps, hd)
    return [[(host[2 * li, j], host[2 * li + 1, j])
             for li in range(len(pool.layers))]
            for j in range(len(pages))]


def extract_page(pool: PagedKVPool, page: int) -> list:
    """`extract_pages` of one page: a list of (k, v) per layer."""
    return extract_pages(pool, [page])[0]


def _host_page(arr, like: torch.Tensor) -> torch.Tensor:
    """A shipped page (a CPU tensor, or a numpy array — a bfloat16 page
    as its raw `np.uint16` bits) as a CPU tensor of the pool's dtype."""
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        a = np.ascontiguousarray(arr)
        if like.dtype == torch.bfloat16 and a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    if t.dtype != like.dtype:
        raise ValueError(f"shipped page dtype {t.dtype} != pool dtype "
                         f"{like.dtype}")
    return t


@torch.no_grad()
def install_pages(pool: PagedKVPool, pages: Sequence[int],
                  chunks: Sequence) -> PagedKVPool:
    """Write shipped pages into the pool IN PLACE: `chunks[j][l] = (k,
    v)` (the `extract_pages` shape, CPU tensors or numpy arrays) lands at
    pool index `pages[j]`. One host-to-device copy of every page, then
    one `index_copy_` per layer tensor on the caller's stream: the pool
    keeps its storage, so the captured decode graphs that read its
    addresses stay valid."""
    if len(pages) != len(chunks):
        raise ValueError(f"{len(pages)} pages for {len(chunks)} chunks")
    if not pages:
        return pool
    want = tuple(pool.layers[0]["k"].shape[1:])
    like = pool.layers[0]["k"]
    per_tensor = [[] for _ in range(2 * len(pool.layers))]
    for chunk in chunks:
        if len(chunk) != len(pool.layers):
            raise ValueError(
                f"shipped page has {len(chunk)} layers, pool has "
                f"{len(pool.layers)}")
        for li, (k, v) in enumerate(chunk):
            for n, arr in enumerate((k, v)):
                t = _host_page(arr, like)
                if tuple(t.shape) != want:
                    raise ValueError(
                        f"shipped page shape {tuple(t.shape)} != pool "
                        f"page shape {want}")
                per_tensor[2 * li + n].append(t)
    dev = torch.stack([torch.stack(ts) for ts in per_tensor]).to(
        like.device)
    idx = torch.tensor([int(p) for p in pages], dtype=torch.long,
                       device=like.device)
    for li, layer in enumerate(pool.layers):
        layer["k"].index_copy_(0, idx, dev[2 * li])
        layer["v"].index_copy_(0, idx, dev[2 * li + 1])
    return pool


def install_page(pool: PagedKVPool, page: int, chunk) -> PagedKVPool:
    """`install_pages` of one page: `chunk[l] = (k, v)` per layer."""
    return install_pages(pool, [page], [chunk])


@torch.no_grad()
def paged_prefill_ctx(params, tokens, true_len, pool: PagedKVPool,
                      page_ids, ctx_table, ctx_len, cfg: TransformerConfig):
    """Prefill a batch of prompt TAILS whose prefix K/V already sits in
    pool pages (the prefix cache's warm path): row b's tokens are prompt
    positions `[ctx_len[b], ctx_len[b] + true_len[b])`, its cached prefix
    occupies the pages in `ctx_table[b]` (trash-padded, masked by
    `ctx_len`), and its tail K/V scatters into `page_ids[b]` exactly like
    `paged_prefill`. Returns (logits (B, vocab) at each row's last real
    tail position, the pool).

    Tails start on a page boundary (only FULL cached chunks are reused).
    Attention is a masked softmax in float32 over [gathered prefix ‖
    tail], as in the JAX package: tail queries see every real prefix
    position plus the causal window of the tail; masked lanes weigh
    exactly 0. Shared prefix pages are only read."""
    b, tb = tokens.shape
    ps = pool.page_size
    hd = cfg.d_model // cfg.n_heads
    w_ctx = ctx_table.shape[1] * ps
    dev = tokens.device
    ctx_len = ctx_len.long()
    pos_ids = torch.clamp_max(ctx_len[:, None]
                              + torch.arange(tb, device=dev), cfg.max_len - 1)
    x = params["embed"][tokens.long()] + params["pos"][pos_ids]
    flat_ids = page_ids.reshape(-1).long()
    ctab = ctx_table.long()
    # prefix cols real below ctx_len; tail cols causal within the tail
    m_ctx = (torch.arange(w_ctx, device=dev)[None, :]
             < ctx_len[:, None])[:, None, None, :]          # (B, 1, 1, Wc)
    m_self = (torch.arange(tb, device=dev)[None, :]
              <= torch.arange(tb, device=dev)[:, None])     # (Tb, Tb)
    scale = 1.0 / float(hd) ** 0.5

    def pages(arr, like):
        a = arr.to(like.dtype).reshape(b, cfg.n_heads, tb // ps, ps, -1)
        return a.transpose(1, 2).reshape(b * (tb // ps), cfg.n_heads, ps, -1)

    for p, layer in zip(params["blocks"], pool.layers):
        h = _layer_norm(p["ln1"], x)
        q = _heads(h, p["Wq"], cfg)                   # (B, H, Tb, hd)
        k = _heads(h, p["Wk"], cfg)
        v = _heads(h, p["Wv"], cfg)
        # the cached prefix: (B, Pc, H, ps, hd) -> (B, H, Wc, hd)
        kc = layer["k"][ctab].transpose(1, 2).reshape(b, cfg.n_heads, w_ctx,
                                                      hd)
        vc = layer["v"][ctab].transpose(1, 2).reshape(b, cfg.n_heads, w_ctx,
                                                      hd)
        qf = q.float()
        sc_ctx = torch.einsum("bhqd,bhkd->bhqk", qf, kc.float()) * scale
        sc_self = torch.einsum("bhqd,bhkd->bhqk", qf, k.float()) * scale
        sc = torch.cat([sc_ctx.masked_fill(~m_ctx, NEG_INF),
                        sc_self.masked_fill(~m_self, NEG_INF)], dim=-1)
        wts = torch.softmax(sc, dim=-1)
        vf = torch.cat([vc.float(), v.float()], dim=2)
        att = torch.einsum("bhqk,bhkd->bhqd", wts, vf)
        att = att.to(x.dtype).transpose(1, 2).reshape(b, tb, cfg.d_model)
        x = x + att @ p["Wo"]
        x = _ffn(p, x)
        layer["k"][flat_ids] = pages(k, layer["k"])
        layer["v"][flat_ids] = pages(v, layer["v"])
    x = _layer_norm(params["ln_f"], x)
    last_x = x[torch.arange(b, device=dev), true_len.long() - 1]
    return last_x @ params["embed"].T, pool


def decode_read_bytes(pool: PagedKVPool, lengths, table_width: int, *,
                      dense: bool = False) -> int:
    """Host-side accounting: KV bytes ONE decode token step must read
    for attention, summed over slots. Default (`dense=False`) is the
    streamed-kernel figure — K+V for each slot's written pages only,
    `min(floor(pos / page_size) + 1, table_width)` pages at cursor `pos`
    (the pages `paged_attention` reads, the trash-page read of an idle
    slot included). `dense=True` is the dense-gather figure: every slot
    touches its FULL page-table reservation."""
    layer = pool.layers[0]["k"]
    ps = pool.page_size
    page_bytes = layer.shape[1] * ps * layer.shape[3] * layer.element_size()
    if dense:
        pages = len(lengths) * int(table_width)
    else:
        pages = sum(min(int(pos) // ps + 1, int(table_width))
                    for pos in lengths)
    return 2 * len(pool.layers) * page_bytes * int(pages)


@torch.no_grad()
def paged_decode_step(params, tokens, pool: PagedKVPool, page_table,
                      lengths, active, cfg: TransformerConfig,
                      kernel: str = "gather"):
    """One decode step over S slots: embed `tokens` (S,), write each
    active slot's K/V at its own cursor (`lengths`) through the page
    table, attend over the slot's pages, return (logits (S, vocab), the
    pool).

    page_table (S, P) int32, lengths (S,) int32, active (S,) bool.
    Inactive slots write to the trash page and their logits are garbage
    the host ignores.

    `kernel` picks the attention read: "gather" runs the plain version
    `attention.paged.paged_attention_ref`, which materializes each slot's
    dense `(S, H, window, hd)` K/V window; "kernel" streams only the
    written pages from the pool through `attention.paged.paged_attention`
    (K4 on the card, the same plain version on the CPU). Resolve "auto"
    first with `attention.paged.resolve_decode_kernel`."""
    if kernel not in ("gather", "kernel"):
        raise ValueError(
            f"kernel must be 'gather' or 'kernel' here (resolve 'auto' "
            f"via attention.paged.resolve_decode_kernel), got {kernel!r}")
    attend = paged_attention if kernel == "kernel" else paged_attention_ref
    s = tokens.shape[0]
    d = cfg.d_model
    ps = pool.page_size
    trash = pool.trash_page
    n_p = page_table.shape[1]
    pos = lengths.long()                                # (S,)
    rows = torch.arange(s, device=pos.device)
    # physical destination of the incoming token's K/V; a cursor at or
    # past the window writes to trash instead of clamping into the
    # slot's LAST real page
    dest = torch.where(active & (pos // ps < n_p),
                       page_table[rows, torch.clamp_max(pos // ps, n_p - 1)]
                       .long(),
                       torch.full_like(pos, trash))
    offset = pos % ps
    # position-embedding lookup clamped like paged_prefill's
    pos_ids = torch.clamp_max(pos, cfg.max_len - 1)
    x = (params["embed"][tokens.long()] + params["pos"][pos_ids])[:, None, :]
    for p, layer in zip(params["blocks"], pool.layers):
        h = _layer_norm(p["ln1"], x)
        q = _heads(h, p["Wq"], cfg)                        # (S, H, 1, hd)
        # advanced indices split by a slice land in front: the indexed
        # view is (S, H, hd), the layout of k_new / v_new
        layer["k"][dest, :, offset, :] = _heads(h, p["Wk"], cfg)[:, :, 0, :] \
            .to(layer["k"].dtype)
        layer["v"][dest, :, offset, :] = _heads(h, p["Wv"], cfg)[:, :, 0, :] \
            .to(layer["v"].dtype)
        att = attend(q[:, :, 0, :].contiguous(), layer["k"], layer["v"],
                     page_table, lengths)
        x = x + att.to(x.dtype).reshape(s, 1, d) @ p["Wo"]
        x = _ffn(p, x)
    x = _layer_norm(params["ln_f"], x)
    return x[:, 0, :] @ params["embed"].T, pool


@torch.no_grad()
def paged_verify_step(params, tokens, pool: PagedKVPool, page_table,
                      lengths, widths, cfg: TransformerConfig,
                      kernel: str = "gather"):
    """The WIDENED decode step speculative verify rides: `tokens` is
    (S, W) — row s's column j is the token whose K/V belongs at cursor
    `lengths[s] + j` (column 0 the slot's pending token, columns 1..W-1
    the drafter's proposals). `widths` (S,) int32 is how many columns of
    each row are real (0 = idle slot; 1 = a plain step riding along).
    Returns (logits (S, W, vocab), the pool).

    Every real position writes its K/V through the page table; columns
    past a row's width, and cursors at or past the window, write to the
    trash page (their duplicate writes there are harmless: the trash
    page is never read unmasked). Column j attends to positions
    `<= lengths + j`, so logits[s, j] is the model's next-token
    distribution after the prefix extended by proposals 1..j.

    `kernel` mirrors `paged_decode_step`: "gather" runs one widened
    masked softmax in float32 over the dense window; "kernel" runs
    `attention.paged.paged_attention` (K4 on the card) once per column,
    at cursor `min(lengths + j, window - 1)`."""
    if kernel not in ("gather", "kernel"):
        raise ValueError(
            f"kernel must be 'gather' or 'kernel' here (resolve 'auto' "
            f"via attention.paged.resolve_decode_kernel), got {kernel!r}")
    s, w = tokens.shape
    d = cfg.d_model
    hd = d // cfg.n_heads
    ps = pool.page_size
    n_p = page_table.shape[1]
    window = n_p * ps
    dev = tokens.device
    cols = torch.arange(w, device=dev)
    pos = lengths.long()[:, None] + cols[None, :]            # (S, W)
    valid = cols[None, :] < widths.long()[:, None]           # (S, W)
    dest = torch.where(
        valid & (pos // ps < n_p),
        torch.gather(page_table.long(), 1, torch.clamp_max(pos // ps,
                                                           n_p - 1)),
        torch.full_like(pos, pool.trash_page))
    offset = pos % ps
    pos_ids = torch.clamp_max(pos, cfg.max_len - 1)
    x = params["embed"][tokens.long()] + params["pos"][pos_ids]  # (S, W, d)
    if kernel == "gather":
        # column j sees key positions <= lengths + j
        mask = (torch.arange(window, device=dev)[None, None, :]
                <= pos[:, :, None])[:, None]                 # (S, 1, W, win)
        pt = page_table.long()
        scale = 1.0 / float(hd) ** 0.5
    for p, layer in zip(params["blocks"], pool.layers):
        h = _layer_norm(p["ln1"], x)
        q = _heads(h, p["Wq"], cfg)                          # (S, H, W, hd)
        # advanced indices (S, W) split by a slice land in front: the
        # indexed view is (S, W, H, hd)
        layer["k"][dest, :, offset, :] = _heads(h, p["Wk"], cfg) \
            .transpose(1, 2).to(layer["k"].dtype)
        layer["v"][dest, :, offset, :] = _heads(h, p["Wv"], cfg) \
            .transpose(1, 2).to(layer["v"].dtype)
        if kernel == "kernel":
            # one single-query pass per column, each at its own cursor;
            # q[:, :, j, :] is a strided view, K4 takes contiguous q
            att = torch.stack([
                paged_attention(q[:, :, j, :].contiguous(), layer["k"],
                                layer["v"], page_table,
                                torch.clamp_max(lengths + j, window - 1))
                for j in range(w)], dim=2)                   # (S, H, W, hd)
        else:
            kg = layer["k"][pt].transpose(1, 2).reshape(s, cfg.n_heads,
                                                        window, hd)
            vg = layer["v"][pt].transpose(1, 2).reshape(s, cfg.n_heads,
                                                        window, hd)
            sc = torch.einsum("shqd,shkd->shqk", q.float(),
                              kg.float()) * scale
            wts = torch.softmax(sc.masked_fill(~mask, NEG_INF), dim=-1)
            att = torch.einsum("shqk,shkd->shqd", wts, vg.float())
        x = x + att.to(x.dtype).transpose(1, 2).reshape(s, w, d) @ p["Wo"]
        x = _ffn(p, x)
    x = _layer_norm(params["ln_f"], x)
    return x @ params["embed"].T, pool
