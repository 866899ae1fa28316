"""The PyTorch port's attention (deeplearning4j_tpu_torch/attention/) held
against the JAX package.

On the CPU the kernel wrappers run their plain versions
(`flash_attention_ref`, `paged_attention_ref`); those are compared with
the JAX package's Pallas kernels run through the Pallas interpreter, and
with its blockwise forms at ragged lengths the TPU kernel does not take.
Inputs are made with numpy from a seed and handed to both. Tolerance
1e-5: the same float32 function, summed in another order.

Tests marked `cuda` hold the CUDA kernels against their plain versions on
the card; they skip without one.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.attention import blockwise as jax_blockwise
from deeplearning4j_tpu.attention import flash_pallas as jax_flash
from deeplearning4j_tpu.attention import paged_pallas as jax_paged
from deeplearning4j_tpu_torch.attention import blockwise, flash, paged
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

TOL = 1e-5


def _qkv(seed, b, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, d)).astype(np.float32),
            rng.normal(size=(b, tk, d)).astype(np.float32),
            rng.normal(size=(b, tk, d)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(torch_out, jax_out, tol=TOL):
    np.testing.assert_allclose(torch_out.detach().numpy(),
                               np.asarray(jax_out), atol=tol, rtol=0)


# ------------------------------------------------------------- flash (K1)
class TestFlashForward:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("t", [128, 256])
    def test_matches_jax_kernel_interpret(self, t, causal):
        q, k, v = _qkv(t, 2, t, t, 32)
        ref = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal,
                                        interpret=True)
        _close(flash.flash_attention(_t(q), _t(k), _t(v), causal), ref)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("tq,tk", [(1, 1), (37, 37), (100, 100),
                                       (20, 50), (16, 128), (65, 65),
                                       (129, 129)])
    def test_ragged_and_short_q_match_blockwise(self, tq, tk, causal):
        """T with no 128-aligned tile (the TPU sends those to blockwise;
        the card's kernel takes them) and Tq < Tk (bottom-right causal
        alignment)."""
        q, k, v = _qkv(tq * 1000 + tk, 3, tq, tk, 16)
        ref = jax_blockwise.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        _close(flash.flash_attention(_t(q), _t(k), _t(v), causal), ref)

    def test_four_d_heads_layout(self):
        """(B, H, T, d): sequence is axis -2, heads ride the batch."""
        rng = np.random.default_rng(4)
        q, k, v = (rng.normal(size=(2, 3, 128, 16)).astype(np.float32)
                   for _ in range(3))
        ref = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), True, interpret=True)
        out = flash.flash_attention(_t(q), _t(k), _t(v), True)
        assert out.shape == (2, 3, 128, 16)
        _close(out, ref)

    def test_lse_with_sentinel_rows_matches_jax(self):
        """Causal Tq > Tk: the first Tq - Tk rows see no key — out 0 and
        lse +1e30 in both packages."""
        q, k, v = _qkv(7, 2, 256, 128, 32)
        ref_out, ref_lse = jax_flash.flash_attention_with_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
            interpret=True)
        out, lse = flash.flash_attention_with_lse(_t(q), _t(k), _t(v), True)
        assert lse.shape == (2, 256) and lse.dtype == torch.float32
        _close(out, ref_out)
        assert np.all(lse[:, :128].numpy() == -flash.NEG_INF)
        assert np.all(np.asarray(ref_lse)[:, :128] == -flash.NEG_INF)
        assert np.all(out[:, :128].numpy() == 0.0)
        _close(lse[:, 128:], np.asarray(ref_lse)[:, 128:], tol=1e-4)

    @pytest.mark.parametrize("causal", [False, True])
    def test_lse_ragged_matches_jax_blockwise(self, causal):
        q, k, v = _qkv(8, 2, 45, 45, 16)
        ref_out, ref_lse = jax_blockwise.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            return_lse=True)
        out, lse = flash.flash_attention_with_lse(_t(q), _t(k), _t(v),
                                                  causal)
        _close(out, ref_out)
        _close(lse, ref_lse)

    def test_bf16_ref_rounds_p_to_v_dtype_and_stays_close(self):
        q, k, v = _qkv(9, 2, 64, 64, 32)
        out = flash.flash_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                                    _t(v).bfloat16(), True)
        assert out.dtype == torch.bfloat16
        ref = jax_blockwise.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
        _close(out.float(), ref, tol=2e-2)

    def test_cpu_runs_plain_version_without_counting_a_launch(self):
        before = flash.launches
        q, k, v = _qkv(1, 1, 16, 16, 64)
        flash.flash_attention(_t(q), _t(k), _t(v), True)
        assert flash.launches == before

    def test_misaligned_bf16_operand_raises(self):
        """The bf16 kernels copy 16-byte chunks: a view one value in is
        refused before any launch."""
        x = torch.zeros(8 + 16 * 64, dtype=torch.bfloat16)
        flash._check_aligned(x[8:].view(1, 16, 64), x[1:].float())
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash._check_aligned(x[1:-7].view(1, 16, 64))

    def test_non_cpu_non_cuda_tensor_raises(self):
        q = torch.empty((1, 16, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA or CPU"):
            flash.flash_attention(q, q, q)


class TestBlockwise:
    @pytest.mark.parametrize("causal", [False, True])
    def test_blockwise_and_naive_match_jax(self, causal):
        q, k, v = _qkv(11, 2, 30, 70, 16)
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        ref_out, ref_lse = jax_blockwise.blockwise_attention(
            jq, jk, jv, causal=causal, block_size=32, return_lse=True)
        out, lse = blockwise.blockwise_attention(
            _t(q), _t(k), _t(v), causal=causal, block_size=32,
            return_lse=True)
        _close(out, ref_out)
        _close(lse, ref_lse)
        _close(blockwise.naive_attention(_t(q), _t(k), _t(v), causal),
               jax_blockwise.naive_attention(jq, jk, jv, causal))


# ------------------------------------------------------------- paged (K4)
def _paged_case(seed, dtype=np.float32, ps=4, n_p=6, n_pages=20,
                lengths=None):
    """Pool of `n_pages` pages + trash, `n_p` pages per slot. Slots
    (default): cursor 0, ps - 1, ps, a mid cursor, the last window
    position, a cursor past the window, and an idle slot (the last)
    whose table is all trash."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = [0, ps - 1, ps, 13, n_p * ps - 1, n_p * ps + 3, 0]
    s_n, h, hd = len(lengths), 2, 16
    trash = n_pages
    q = rng.normal(size=(s_n, h, hd)).astype(dtype)
    kp = rng.normal(size=(n_pages + 1, h, ps, hd)).astype(dtype)
    vp = rng.normal(size=(n_pages + 1, h, ps, hd)).astype(dtype)
    lengths = np.array(lengths, np.int32)
    table = np.full((s_n, n_p), trash, np.int32)
    perm = rng.permutation(n_pages)
    nxt = 0
    for i, pos in enumerate(lengths[:-1]):
        n_written = min(int(pos) // ps + 1, n_p)
        for j in range(n_written):
            table[i, j] = perm[nxt % n_pages]
            nxt += 1
    return q, kp, vp, table, lengths


def _split_case(seed, ps, n_p, dtype=np.float32):
    """Several splits a slot: cursors on split boundaries (run - 1, run,
    2 run - 1, 2 run), the last window position, one past it, far past
    it, a cursor inside the first split (every later split empty) and an
    idle all-trash slot."""
    run = paged.pages_per_split(ps) * ps
    window = n_p * ps
    lengths = [run - 1, run, 2 * run - 1, 2 * run, window - 1, window,
               window + 300, 5, 0]
    return _paged_case(seed, dtype, ps=ps, n_p=n_p, n_pages=96,
                       lengths=lengths)


#: (page_size, pages per slot): 3 splits of 4 pages, 3 of 8 (the last
#: short), and pages larger than a split (one page a split)
SPLIT_SHAPES = [(16, 12), (8, 20), (128, 3)]


class TestPagedAttention:
    @pytest.mark.parametrize("ps,n_p", SPLIT_SHAPES)
    def test_split_merge_matches_jax_kernel_and_plain(self, ps, n_p):
        """The kernel's split-and-merge arithmetic, in its plain mirror,
        against the JAX kernel in interpret mode and the plain version."""
        q, kp, vp, table, lengths = _split_case(ps * 100 + n_p, ps, n_p)
        ref = jax_paged.paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lengths), interpret=True)
        args = (_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
        out, partial = paged.paged_attention_split_ref(*args)
        n = -(-n_p // paged.pages_per_split(ps))
        assert n > 1 or ps > paged.SPLIT_POSITIONS
        assert partial.shape == (len(lengths), 2, n, 16 + 2)
        _close(out, ref)
        _close(out, paged.paged_attention_ref(*args).numpy())

    @pytest.mark.parametrize("ps,n_p", SPLIT_SHAPES)
    def test_split_partials_of_empty_splits_weigh_nothing(self, ps, n_p):
        """A split past a slot's last written page holds m = NEG_INF,
        l = 0, acc = 0; the merge gives it weight exactly 0, so nothing
        is NaN, and a split holding positions has l > 0."""
        q, kp, vp, table, lengths = _split_case(ps + n_p, ps, n_p)
        out, partial = paged.paged_attention_split_ref(
            _t(q), _t(kp), _t(vp), _t(table), _t(lengths))
        assert torch.isfinite(out).all() and torch.isfinite(partial).all()
        pps = paged.pages_per_split(ps)
        for i, pos in enumerate(lengths):
            last = max(0, min(int(pos) // ps, n_p - 1))
            for sp in range(partial.shape[2]):
                m, l = partial[i, :, sp, 16], partial[i, :, sp, 17]
                if sp * pps > last:
                    assert (m == paged.NEG_INF).all() and (l == 0).all()
                    assert (partial[i, :, sp, :16] == 0).all()
                else:
                    assert (l > 0).all() and (m > paged.NEG_INF / 2).all()

    def test_split_merge_bf16_stays_close_to_plain(self):
        q, kp, vp, table, lengths = _split_case(5, 16, 12)
        args = [_t(a) for a in (q, kp, vp)]
        args = [a.bfloat16() for a in args] + [_t(table), _t(lengths)]
        out, _ = paged.paged_attention_split_ref(*args)
        assert out.dtype == torch.bfloat16
        _close(out.float(), paged.paged_attention_ref(*args).float().numpy(),
               tol=2e-2)

    def test_misaligned_q_or_pool_raises(self):
        """The kernel reads q and copies K/V in 16-byte vectors, in both
        dtypes: a view one value in is refused before any launch."""
        for dtype, vals in ((torch.bfloat16, 8), (torch.float32, 4)):
            x = torch.zeros(vals + 2 * 16 * 64, dtype=dtype)
            ok = x[vals:].view(2, 16, 64)
            paged._check_aligned(ok, ok, ok)
            bad = x[1:1 + 2 * 16 * 64].view(2, 16, 64)
            for args in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
                with pytest.raises(ValueError, match="16-byte aligned"):
                    paged._check_aligned(*args)

    def test_matches_jax_kernel_interpret(self):
        q, kp, vp, table, lengths = _paged_case(0)
        ref = jax_paged.paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lengths), interpret=True)
        out = paged.paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(lengths))
        assert out.shape == q.shape and out.dtype == torch.float32
        _close(out, ref)

    def test_garbage_past_cursor_and_in_trash_is_never_read(self):
        """Whatever sits past each slot's cursor — page tails, pages past
        the frontier, the trash page — changes nothing."""
        q, kp, vp, table, lengths = _paged_case(1)
        out = paged.paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(lengths))
        kp2, vp2 = kp.copy(), vp.copy()
        ps = kp.shape[2]
        visible = set()
        for i, pos in enumerate(lengths):
            for p in range(min(int(pos), table.shape[1] * ps - 1) + 1):
                visible.add((int(table[i, p // ps]), p % ps))
        for page in range(kp.shape[0]):
            for off in range(ps):
                if (page, off) not in visible:
                    kp2[page, :, off] = 1e3
                    vp2[page, :, off] = -1e3
        out2 = paged.paged_attention(_t(q), _t(kp2), _t(vp2), _t(table),
                                     _t(lengths))
        _close(out2, out.numpy(), tol=0.0)

    def test_cpu_runs_plain_version_without_counting_a_launch(self):
        before = paged.launches
        q, kp, vp, table, lengths = _paged_case(2)
        paged.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
        assert paged.launches == before

    def test_resolve_decode_kernel_lanes(self):
        cfg = TransformerConfig(vocab_size=8, d_model=256, n_heads=2)
        assert paged.resolve_decode_kernel("auto", cfg, 16, "cpu") == "gather"
        assert paged.resolve_decode_kernel("auto", cfg, 16,
                                           "cuda") == "kernel"
        assert paged.resolve_decode_kernel("kernel", cfg, 16,
                                           "cpu") == "kernel"
        assert paged.resolve_decode_kernel("gather", cfg, 16,
                                           "cuda") == "gather"
        odd = TransformerConfig(vocab_size=8, d_model=96, n_heads=2)
        assert paged.resolve_decode_kernel("auto", odd, 16, "cpu") == "gather"
        # on the card nothing gives way to the plain version: a config
        # outside the kernel's envelope raises, under "auto" too
        for lane in ("auto", "kernel"):
            with pytest.raises(ValueError, match="head dim must be one of"):
                paged.resolve_decode_kernel(lane, odd, 16, "cuda")
        half = TransformerConfig(vocab_size=8, d_model=256, n_heads=2,
                                 dtype=torch.float16)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            paged.resolve_decode_kernel("auto", half, 16, "cuda")
        with pytest.raises(ValueError, match="CUDA or CPU"):
            paged.resolve_decode_kernel("auto", cfg, 16, "meta")
        with pytest.raises(ValueError, match="kernel must be one of"):
            paged.resolve_decode_kernel("pallas", cfg, 16, "cpu")


# ------------------------------------------------------- on the card only
#: the edges of the bf16 kernels' tiling (64-key tiles, 64-row warpgroups,
#: 128-row forward blocks): one row, a tile less or more one, Tq < Tk,
#: Tq > Tk (causal rows that see no key), at both head dims
EDGE_SHAPES = [(t, t, hd) for hd in (64, 128) for t in (1, 63, 65, 129, 1000)]
EDGE_SHAPES += [(tq, tk, hd) for hd in (64, 128)
                for tq, tk in ((64, 1024), (200, 37))]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tq,tk,hd", [(100, 100, 64), (128, 128, 128),
                                      (37, 200, 128)] + EDGE_SHAPES)
def test_flash_kernel_matches_plain_on_card(card, dtype, tol, tq, tk, hd):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, t, hd, generator=g).to(card, dtype)
               for t in (tq, tk, tk))
    for causal in (False, True):
        out, lse = flash.flash_attention_with_lse(q, k, v, causal)
        ref, ref_lse = flash.flash_attention_ref(q, k, v, causal, True)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= tol
        assert torch.allclose(lse, ref_lse, atol=1e-3, rtol=1e-5)
        # causal rows that see no key: exactly zero out, the +1e30 lse
        no_key = max(tq - tk, 0) if causal else 0
        assert (out[:, :no_key] == 0).all()
        assert (lse[:, :no_key] == -flash.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_matches_plain_on_card(card, dtype, tol):
    """The small case, then long cursors that cross several splits (on
    split boundaries, past the window, an idle slot), at both head dims
    and page sizes 16, 8 and 128."""
    cases = [(_paged_case(3), 8)]  # head dim 16 -> 128
    cases += [(_split_case(4 + ps, ps, n_p), rep)
              for ps, n_p in SPLIT_SHAPES for rep in (4, 8)]
    for (q, kp, vp, table, lengths), rep in cases:
        q, kp, vp = (torch.from_numpy(np.repeat(a, rep, axis=-1))
                     .to(card, dtype) for a in (q, kp, vp))
        table, lengths = _t(table).to(card), _t(lengths).to(card)
        out = paged.paged_attention(q, kp, vp, table, lengths)
        ref = paged.paged_attention_ref(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= tol
