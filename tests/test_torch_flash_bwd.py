"""The PyTorch port's flash backward (K2, K3) and its autograd Function,
held against the JAX package.

On the CPU `flash_attention` and `flash_attention_with_lse` take the
port's `torch.autograd.Function`, whose backward runs
`flash_attention_bwd_ref` (the plain version of K2 and K3) where the card
launches the kernels. Its gradients are compared with `jax.grad` through
the JAX package's custom vjp: the Pallas backward kernels in interpret
mode at 128-aligned T, the blockwise vjp at ragged T. Inputs and
cotangents are made with numpy from a seed and handed to both. float32
within 3e-5 (the same function summed in another order); bfloat16 within
2e-2 of the largest gradient (P and dS are rounded to bfloat16 before
their products in both).

Tests marked `cuda` hold K2 and K3 against their plain version on the
card; they skip without one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.attention import blockwise as jax_blockwise
from deeplearning4j_tpu.attention import flash_pallas as jax_flash
from deeplearning4j_tpu_torch.attention import blockwise, flash
from tests.test_torch_attention import EDGE_SHAPES

TOL = 3e-5
BF16_REL = 2e-2


def _inputs(seed, b, tq, tk, d):
    """q, k, v and the cotangents of out and lse."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, d)).astype(np.float32),
            rng.normal(size=(b, tk, d)).astype(np.float32),
            rng.normal(size=(b, tk, d)).astype(np.float32),
            rng.normal(size=(b, tq, d)).astype(np.float32),
            rng.normal(size=(b, tq)).astype(np.float32))


def _leaf(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype).requires_grad_()


def _port_grads(q, k, v, g_out, g_lse=None, causal=True,
                dtype=torch.float32):
    """Gradients of sum(out * g_out) [+ sum(lse * g_lse)] through the
    port's Function, in float32 numpy."""
    tq, tk, tv = _leaf(q, dtype), _leaf(k, dtype), _leaf(v, dtype)
    if g_lse is None:
        out = flash.flash_attention(tq, tk, tv, causal)
        obj = (out.float() * torch.from_numpy(g_out)).sum()
    else:
        out, lse = flash.flash_attention_with_lse(tq, tk, tv, causal)
        obj = ((out.float() * torch.from_numpy(g_out)).sum()
               + (lse * torch.from_numpy(g_lse)).sum())
    grads = torch.autograd.grad(obj, (tq, tk, tv))
    for g, x in zip(grads, (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape
    return [g.float().numpy() for g in grads]


def _jax_grads(fn, q, k, v, g_out, g_lse=None, dtype=jnp.float32):
    def obj(q, k, v):
        res = fn(q, k, v)
        if g_lse is None:
            return jnp.sum(res.astype(jnp.float32) * g_out)
        out, lse = res
        return jnp.sum(out.astype(jnp.float32) * g_out) + jnp.sum(lse * g_lse)

    grads = jax.grad(obj, argnums=(0, 1, 2))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _close(port, ref, tol=TOL):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


class TestGradsMatchJax:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("tq,tk", [(128, 128), (256, 256), (128, 256),
                                       (256, 128)])
    def test_matches_jax_kernels_interpret(self, tq, tk, causal):
        """Against the Pallas K2/K3 in interpret mode; Tq > Tk causal has
        rows that see no key."""
        q, k, v, g_out, _ = _inputs(tq + 7 * tk, 2, tq, tk, 32)
        ref = _jax_grads(lambda q, k, v: jax_flash.flash_attention(
            q, k, v, causal, interpret=True), q, k, v, g_out)
        _close(_port_grads(q, k, v, g_out, causal=causal), ref)

    def test_bfloat16_matches_jax_kernels_interpret(self):
        """bf16 inputs: both round P and dS to bf16 before their second
        products; grads within 2e-2 of the largest."""
        q, k, v, g_out, _ = _inputs(3, 2, 128, 128, 32)
        ref = _jax_grads(lambda q, k, v: jax_flash.flash_attention(
            q, k, v, True, interpret=True), q, k, v, g_out,
            dtype=jnp.bfloat16)
        port = _port_grads(q, k, v, g_out, dtype=torch.bfloat16)
        for a, b in zip(port, ref):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=BF16_REL * np.abs(b).max())

    def test_joint_out_and_lse_cotangent(self):
        """Cotangents into both outputs: the lse term folds into D, as
        the JAX vjp does (tests/test_attention.py joint-grad test)."""
        q, k, v, g_out, g_lse = _inputs(9, 1, 256, 256, 64)
        ref = _jax_grads(lambda q, k, v: jax_flash.flash_attention_with_lse(
            q, k, v, True, interpret=True), q, k, v, g_out, g_lse)
        _close(_port_grads(q, k, v, g_out, g_lse), ref)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("tq,tk", [(1, 1), (37, 37), (100, 100),
                                       (20, 50), (50, 20), (65, 65),
                                       (129, 129)])
    def test_ragged_matches_jax_blockwise_vjp(self, tq, tk, causal):
        """T with no 128-aligned tile: the TPU differentiates blockwise
        there, the card's kernels take them."""
        q, k, v, g_out, g_lse = _inputs(tq * 1000 + tk, 2, tq, tk, 16)
        ref = _jax_grads(lambda q, k, v: jax_blockwise.blockwise_attention(
            q, k, v, causal=causal), q, k, v, g_out)
        _close(_port_grads(q, k, v, g_out, causal=causal), ref)
        ref = _jax_grads(lambda q, k, v: jax_blockwise.blockwise_attention(
            q, k, v, causal=causal, return_lse=True), q, k, v, g_out, g_lse)
        _close(_port_grads(q, k, v, g_out, g_lse, causal=causal), ref)


class TestBackwardPlainVersion:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("tq,tk", [(33, 33), (16, 70), (70, 16)])
    def test_matches_autograd_of_the_plain_forward(self, tq, tk, causal):
        """flash_attention_bwd_ref against torch.autograd through
        flash_attention_ref, an independent derivation."""
        q, k, v, g_out, _ = _inputs(tq + tk, 3, tq, tk, 64)
        tq_, tk_, tv_ = _leaf(q), _leaf(k), _leaf(v)
        out = flash.flash_attention_ref(tq_, tk_, tv_, causal)
        ref = torch.autograd.grad(out, (tq_, tk_, tv_),
                                  torch.from_numpy(g_out))
        with torch.no_grad():
            out, lse = flash.flash_attention_ref(tq_, tk_, tv_, causal, True)
            got = flash.flash_attention_bwd_ref(
                tq_, tk_, tv_, out, lse, torch.from_numpy(g_out), causal)
        _close([g.numpy() for g in got], [g.numpy() for g in ref])

    def test_rows_that_see_no_key_get_exactly_zero_gradient(self):
        q, k, v, g_out, g_lse = _inputs(5, 2, 96, 40, 16)
        dq, dk, dv = _port_grads(q, k, v, g_out, g_lse, causal=True)
        assert np.all(dq[:, :56] == 0.0)
        assert np.abs(dq[:, 56:]).max() > 0
        # and those rows' cotangents reach no key either
        g_out[:, :56] = 1e3
        g_lse[:, :56] = -1e3
        _, dk2, dv2 = _port_grads(q, k, v, g_out, g_lse, causal=True)
        np.testing.assert_array_equal(dk2, dk)
        np.testing.assert_array_equal(dv2, dv)

    def test_blockwise_autograd_agrees(self):
        """The port's own blockwise form, differentiated by autograd,
        gives the same gradients (chip_smoke.py holds the float32 kernels
        to it on the card)."""
        q, k, v, g_out, _ = _inputs(6, 2, 100, 100, 64)
        tq_, tk_, tv_ = _leaf(q), _leaf(k), _leaf(v)
        out = blockwise.blockwise_attention(tq_, tk_, tv_, True,
                                            block_size=64)
        ref = torch.autograd.grad(out, (tq_, tk_, tv_),
                                  torch.from_numpy(g_out))
        _close(_port_grads(q, k, v, g_out), [g.numpy() for g in ref])


class TestAutogradFunction:
    def test_cpu_backward_runs_the_plain_version_through_the_function(
            self, monkeypatch):
        calls = []
        real = flash.flash_attention_bwd_ref

        def spy(*args):
            calls.append(len(args))
            return real(*args)

        monkeypatch.setattr(flash, "flash_attention_bwd_ref", spy)
        before = (flash.launches, flash.dq_launches, flash.dkv_launches)
        q, k, v, g_out, _ = _inputs(1, 1, 16, 16, 64)
        tq_, tk_, tv_ = _leaf(q), _leaf(k), _leaf(v)
        out = flash.flash_attention(tq_, tk_, tv_, True)
        names, fn = [], out.grad_fn
        while fn is not None:
            names.append(type(fn).__name__)
            fn = fn.next_functions[0][0] if fn.next_functions else None
        assert "_FlashAttentionBackward" in names, names
        torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(g_out))
        assert len(calls) == 1
        # plain-version calls are never counted as launches
        assert (flash.launches, flash.dq_launches,
                flash.dkv_launches) == before

    def test_lse_is_asked_for_only_when_a_gradient_is_needed(
            self, monkeypatch):
        asked = []
        real = flash._flash_forward

        def spy(q, k, v, causal, want_lse):
            asked.append(want_lse)
            return real(q, k, v, causal, want_lse)

        monkeypatch.setattr(flash, "_flash_forward", spy)
        q, k, v, _, _ = _inputs(2, 1, 16, 16, 64)
        flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
        with torch.no_grad():
            flash.flash_attention(_leaf(q), _leaf(k), _leaf(v))
        out = flash.flash_attention(_leaf(q), _leaf(k), _leaf(v))
        assert asked == [False, False, True]
        assert out.requires_grad

    def test_four_d_heads_layout_grads_keep_shapes(self):
        rng = np.random.default_rng(4)
        q, k, v = (_leaf(rng.normal(size=(2, 3, 40, 16)).astype(np.float32))
                   for _ in range(3))
        out, lse = flash.flash_attention_with_lse(q, k, v, True)
        assert out.shape == (2, 3, 40, 16) and lse.shape == (2, 3, 40)
        grads = torch.autograd.grad(out.sum() + lse.sum(), (q, k, v))
        assert all(g.shape == (2, 3, 40, 16) for g in grads)


# ------------------------------------------------------- on the card only
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("tq,tk,hd", [(100, 100, 64), (128, 128, 128),
                                      (37, 200, 128), (200, 37, 64)]
                         + EDGE_SHAPES)
def test_backward_kernels_match_plain_on_card(card, dtype, rel, tq, tk, hd):
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(4, t, hd, generator=g).to(card, dtype)
                   for t in (tq, tk, tk, tq))
    g_lse = torch.randn(4, tq, generator=g).to(card)
    for causal in (False, True):
        out, lse = flash.flash_attention_with_lse(q, k, v, causal)
        got = flash._flash_backward(q, k, v, out, lse, do, causal, g_lse)
        ref = flash.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                            g_lse)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            scale = max(b.float().abs().max().item(), 1.0)
            assert (a.float() - b.float()).abs().max().item() <= rel * scale
        # causal rows that see no key: exactly zero dQ
        no_key = max(tq - tk, 0) if causal else 0
        assert (got[0][:, :no_key] == 0).all()
