"""The PyTorch port's transformer LM training (`lm_loss`,
`make_train_step`, `init_velocity`, `fit_scan`) held against the JAX
package.

Weights are made by the JAX package from a seed and carried across as
numpy with `weights.params_from_jax`; both packages train on the same
tokens on the CPU. Sequences of 129 tokens put 128 positions through
attention, so the JAX side runs its Pallas K2/K3 in interpret mode and
the port its autograd Function with their plain version. Tolerances: the
loss within 1e-5; gradients within 2e-5 + 1e-4 * |g| (float32 through a
dozen products summed in another order; the tied embedding's gradient is
a scatter-add plus a product whose order differs from XLA's, so it gets
5e-5 + 1e-4 * |g|); parameters after a few steps within 2e-5.

The `cuda` test checks on the card that every attention weight gets its
gradient through the kernels; it skips without one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jax_tf
from deeplearning4j_tpu_torch.attention import flash
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.weights import (params_from_jax,
                                              params_to_numpy)

LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
EMBED_ATOL = 5e-5
PARAM_TOL = 2e-5
LR = 0.05

JAX_CFG = jax_tf.TransformerConfig(vocab_size=61, d_model=64, n_heads=2,
                                   n_layers=2, d_ff=128, max_len=128,
                                   interpret=True)
CFG = tf.TransformerConfig(vocab_size=61, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_len=128)


def _jax_params(seed=0):
    p = jax_tf.init_transformer_params(jax.random.PRNGKey(seed), JAX_CFG)
    # perturb the LN gains/biases and FFN biases away from 1/0
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), p)


def _to_port(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def _cyclic_tokens(n_batches, b, t, period=5, seed=0):
    """tokens[i] = (offset + i) % period — perfectly learnable (the JAX
    package's tests/test_transformer.py builds them the same way)."""
    rng = np.random.RandomState(seed)
    off = rng.randint(0, period, size=(n_batches, b, 1))
    return ((off + np.arange(t)[None, None, :]) % period).astype(np.int32)


def _assert_trees_close(port_tree, jax_tree, atol, rtol=0.0,
                        embed_atol=None):
    """Leaf by leaf, matched by path (JAX orders dict leaves by sorted
    key, the port by insertion)."""
    port = params_to_numpy(port_tree)
    paths = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(paths) == len(jax.tree_util.tree_leaves(port))
    for path, ref in paths:
        got = port
        for key in path:
            got = got[key.key if hasattr(key, "key") else key.idx]
        name = jax.tree_util.keystr(path)
        tol = embed_atol if name == "['embed']" and embed_atol else atol
        np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=rtol,
                                   err_msg=name)


class TestLossAndGradients:
    def test_loss_and_every_gradient_match_jax(self):
        jp = _jax_params(1)
        tp = _to_port(jp)
        tok = _tokens(1, 2, 129)
        ref_loss, ref_grads = jax.value_and_grad(jax_tf.lm_loss)(
            jp, jnp.asarray(tok), JAX_CFG)
        loss, grads = tf.lm_loss_and_grads(tp, torch.from_numpy(tok), CFG)
        assert loss.shape == () and loss.dtype == torch.float32
        assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL
        _assert_trees_close(grads, ref_grads, GRAD_ATOL, GRAD_RTOL,
                            embed_atol=EMBED_ATOL)

    def test_ragged_length_matches_jax_blockwise_vjp(self):
        """37 tokens: 36 positions, which the TPU differentiates through
        its blockwise vjp."""
        jp = _jax_params(2)
        tp = _to_port(jp)
        tok = _tokens(2, 3, 37)
        ref_loss, ref_grads = jax.value_and_grad(jax_tf.lm_loss)(
            jp, jnp.asarray(tok), JAX_CFG)
        loss, grads = tf.lm_loss_and_grads(tp, torch.from_numpy(tok), CFG)
        assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL
        _assert_trees_close(grads, ref_grads, GRAD_ATOL, GRAD_RTOL,
                            embed_atol=EMBED_ATOL)

    def test_params_keep_no_grad_and_no_graph(self):
        tp = _to_port(_jax_params(0))
        step = tf.make_train_step(CFG, lr=LR)
        v = tf.init_velocity(tp)
        leaves = tf._leaves(tp)
        tp2, v2, loss = step(tp, v, torch.from_numpy(_tokens(3, 2, 17)))
        assert tp2 is tp and v2 is v
        assert all(a is b for a, b in zip(tf._leaves(tp2), leaves))
        assert all(not p.requires_grad and p.grad_fn is None
                   for p in tf._leaves(tp2))
        assert loss.shape == () and not loss.requires_grad

    def test_init_velocity_is_float32_zeros_like_jax(self):
        jp = _jax_params(0)
        port = params_to_numpy(tf.init_velocity(_to_port(jp)))
        ref = jax_tf.init_velocity(jp)
        for a, b in zip(jax.tree_util.tree_leaves(port),
                        jax.tree_util.tree_leaves(ref)):
            assert a.dtype == np.float32 and a.shape == b.shape
            assert not a.any()


class TestTraining:
    def test_three_steps_and_fit_scan_match_jax(self):
        jp = _jax_params(4)
        tp = _to_port(jp)
        batches = np.stack([_tokens(10 + i, 2, 129) for i in range(3)])
        jstep = jax_tf.make_train_step(JAX_CFG, lr=LR)
        step = tf.make_train_step(CFG, lr=LR)
        jv, tv = jax_tf.init_velocity(jp), tf.init_velocity(tp)
        for tok in batches:
            jp, jv, jloss = jstep(jp, jv, jnp.asarray(tok))
            tp, tv, loss = step(tp, tv, torch.from_numpy(tok))
            assert abs(float(loss) - float(jloss)) <= LOSS_TOL
        _assert_trees_close(tp, jp, PARAM_TOL)
        _assert_trees_close(tv, jv, GRAD_ATOL, GRAD_RTOL,
                            embed_atol=EMBED_ATOL)

        jp2 = _jax_params(5)
        tp2 = _to_port(jp2)
        fit = batches[:2, :, :33]
        jp2, jlast = jax_tf.fit_scan(jp2, jnp.asarray(fit), JAX_CFG, lr=LR,
                                     epochs=2)
        tp2, last = tf.fit_scan(tp2, torch.from_numpy(fit), CFG, lr=LR,
                                epochs=2)
        assert abs(float(last) - float(jlast)) <= LOSS_TOL
        _assert_trees_close(tp2, jp2, PARAM_TOL)

    def test_jax_params_and_velocity_carry_across_and_continue(self):
        """A JAX (params, velocity) pair after 2 steps, carried across with
        params_from_jax, continues one step identically in both."""
        jp = _jax_params(6)
        jv = jax_tf.init_velocity(jp)
        jstep = jax_tf.make_train_step(JAX_CFG, lr=LR)
        for i in range(2):
            jp, jv, _ = jstep(jp, jv, jnp.asarray(_tokens(20 + i, 2, 129)))
        tp, tv = _to_port(jp), _to_port(jv)
        tok = _tokens(22, 2, 129)
        jp, jv, jloss = jstep(jp, jv, jnp.asarray(tok))
        tp, tv, loss = tf.make_train_step(CFG, lr=LR)(tp, tv,
                                                      torch.from_numpy(tok))
        assert abs(float(loss) - float(jloss)) <= LOSS_TOL
        _assert_trees_close(tp, jp, PARAM_TOL)
        _assert_trees_close(tv, jv, GRAD_ATOL, GRAD_RTOL,
                            embed_atol=EMBED_ATOL)

    def test_bfloat16_update_rounds_as_jax(self):
        """The cast to the param dtype comes before the product with lr,
        and lr is rounded to bf16: bit for bit the JAX update."""
        rng = np.random.default_rng(7)
        p = {"w": rng.normal(size=(64,)).astype(np.float32)}
        v = {"w": rng.normal(size=(64,)).astype(np.float32)}
        g = {"w": rng.normal(size=(64,)).astype(np.float32)}
        jp = {"w": jnp.asarray(p["w"], jnp.bfloat16)}
        jg = {"w": jnp.asarray(g["w"], jnp.bfloat16)}
        ref_p, ref_v = jax_tf._sgd_momentum_update(
            jp, {"w": jnp.asarray(v["w"])}, jg, 0.01)
        tp = params_from_jax({"w": np.asarray(jp["w"])}, device="cpu")
        tv = params_from_jax(v, device="cpu")
        tg = params_from_jax({"w": np.asarray(jg["w"])}, device="cpu")
        tf._sgd_momentum_update(tp, tv, tg, 0.01)
        assert tp["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp["w"].float().numpy(),
                                      np.asarray(ref_p["w"], np.float32))
        np.testing.assert_array_equal(tv["w"].numpy(), np.asarray(ref_v["w"]))

    def test_fit_scan_learns_cyclic_sequence(self):
        """The port's counterpart of the JAX package's
        tests/test_transformer.py::test_fit_scan_learns_cyclic_sequence."""
        cfg = tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, max_len=64)
        params = tf.init_transformer_params(0, cfg, device="cpu")
        batches = torch.from_numpy(_cyclic_tokens(4, 8, 32))
        first = float(tf.lm_loss(params, batches[0], cfg))
        params, last = tf.fit_scan(params, batches, cfg, lr=0.1, epochs=30)
        assert float(last) < 0.2 < first, (first, float(last))

    def test_fit_scan_needs_a_batch_and_an_epoch(self):
        params = tf.init_transformer_params(0, CFG, device="cpu")
        batches = torch.from_numpy(_tokens(0, 1, 2, 9))
        with pytest.raises(ValueError, match="epochs >= 1"):
            tf.fit_scan(params, batches, CFG, epochs=0)
        with pytest.raises(ValueError, match="at least one batch"):
            tf.fit_scan(params, batches[:0], CFG)

    def test_cpu_training_counts_no_kernel_launch(self):
        before = (flash.launches, flash.dq_launches, flash.dkv_launches)
        params = tf.init_transformer_params(0, CFG, device="cpu")
        tf.fit_scan(params, torch.from_numpy(_tokens(1, 1, 2, 20)), CFG)
        assert (flash.launches, flash.dq_launches,
                flash.dkv_launches) == before


# ------------------------------------------------------- on the card only
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_attention_weights_get_gradients_through_the_kernels(card):
    """Regression: the kernel's output once had no grad_fn on the card,
    so Wq, Wk, Wv and ln1 silently got no gradient."""
    cfg = tf.TransformerConfig(vocab_size=64, d_model=256, n_heads=2,
                               n_layers=2, d_ff=512, max_len=128)
    params = tf.init_transformer_params(0, cfg, device=card)
    before = (flash.launches, flash.dq_launches, flash.dkv_launches)
    _, grads = tf.lm_loss_and_grads(
        params, torch.from_numpy(_tokens(0, 2, 101)).to(card), cfg)
    for block in grads["blocks"]:
        for name in ("Wq", "Wk", "Wv"):
            assert block[name] is not None
            assert block[name].abs().max().item() > 0, name
        assert block["ln1"]["g"].abs().max().item() > 0
        assert block["ln1"]["b"].abs().max().item() > 0
    after = (flash.launches, flash.dq_launches, flash.dkv_launches)
    assert [a - b for a, b in zip(after, before)] == [cfg.n_layers] * 3
