"""The PyTorch port's layer-network building blocks held against the JAX
package: activations, losses, weight initialisers, dropout, the
preprocessors, and the dense, output, conv and self_attention layers.

Inputs and parameters are made with numpy from a seed and handed to both
packages; both run float32 on the CPU (the JAX self_attention layer runs
its flash call in interpret mode, which at these lengths takes the
blockwise form, as its own tests do; the port runs the kernels' plain
versions). Tolerances: forward within 1e-5; gradients within
2e-5 + 1e-4 * |g| (float32 summed in another order). Random draws cannot
match jax's, so initialisers are checked by their statistics and
dropout by its keep rate.

The `cuda` tests run the self_attention layer on the card; they skip
without one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.models import conv as jax_conv  # noqa: F401
from deeplearning4j_tpu.nn import layers as jax_layers
from deeplearning4j_tpu.nn import preprocessors as jax_pp
from deeplearning4j_tpu.ops import activations as jax_act
from deeplearning4j_tpu.ops import initializers as jax_init
from deeplearning4j_tpu.ops import losses as jax_losses
from deeplearning4j_tpu_torch.attention import flash
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn import layers, preprocessors
from deeplearning4j_tpu_torch.ops import activations, initializers, losses
from deeplearning4j_tpu_torch.ops.products import matmul_f32

FWD_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, ref, atol=FWD_TOL, rtol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(ref, dtype=np.float32),
                               atol=atol, rtol=rtol)


def _grad_close(got, ref):
    _close(got, ref, GRAD_ATOL, GRAD_RTOL)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ activations
@pytest.mark.parametrize("name", sorted(activations.ACTIVATIONS))
def test_activation_and_its_gradient_match_jax(name):
    rng = _rng(1)
    x = rng.normal(size=(6, 9)).astype(np.float32) * 2
    if name == "sqrt":
        x = np.abs(x) + 0.1
    else:
        # exact ties: hardtanh's and maxout's gradient splits 0.5/0.5
        # there, abs's is 1 at 0
        x[0, :5] = (-1.0, 0.0, 1.0, -1.0, 1.0)
    w = rng.normal(size=x.shape).astype(np.float32)
    ref = jax_act.apply_activation(name, jnp.asarray(x))
    ref_g = jax.grad(lambda a: jnp.sum(
        jax_act.apply_activation(name, a) * w))(jnp.asarray(x))
    xt = _t(x, grad=True)
    out = activations.apply_activation(name, xt)
    (g,) = torch.autograd.grad((out * _t(w)).sum(), xt)
    _close(out, ref)
    _grad_close(g, ref_g)


def test_activation_names_are_the_jax_packages():
    assert sorted(activations.ACTIVATIONS) == sorted(jax_act.ACTIVATIONS)
    with pytest.raises(ValueError, match="Unknown activation"):
        activations.apply_activation("nope", torch.zeros(2))


# ----------------------------------------------------------------- losses
def _loss_inputs(seed, name):
    rng = _rng(seed)
    logits = rng.normal(size=(7, 5)).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if name in ("mcxent", "negativeloglikelihood", "expll"):
        labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 7)]
    else:
        labels = rng.uniform(size=(7, 5)).astype(np.float32)
    return labels, p.astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(losses.LOSS_FUNCTIONS))
def test_loss_and_its_gradient_match_jax(name, weighted):
    labels, p = _loss_inputs(2, name)
    w = np.array([1, 0, 1, 1, 0.5, 0, 1], np.float32) if weighted else None
    jfn = jax_losses.loss_fn(name)
    jw = None if w is None else jnp.asarray(w)
    ref, ref_g = jax.value_and_grad(
        lambda o: jfn(jnp.asarray(labels), o, jw))(jnp.asarray(p))
    pt = _t(p, grad=True)
    out = losses.loss_fn(name)(_t(labels), pt, None if w is None else _t(w))
    (g,) = torch.autograd.grad(out, pt)
    assert out.shape == ()
    _close(out, ref)
    _grad_close(g, ref_g)


def test_probability_clip_splits_a_tie_as_jnp_clip_does():
    """p exactly at EPS or 1 - EPS: jnp.clip halves the gradient there."""
    p = np.array([losses.EPS, 1.0 - losses.EPS, 0.5, 1.0, 0.0],
                 np.float32)
    w = np.arange(1.0, 6.0, dtype=np.float32)
    ref = jax.grad(lambda a: jnp.sum(
        jnp.clip(a, jax_losses.EPS, 1.0 - jax_losses.EPS) * w))(
            jnp.asarray(p))
    pt = _t(p, grad=True)
    (g,) = torch.autograd.grad((losses._clip(pt) * _t(w)).sum(), pt)
    _close(g, ref, atol=0.0)
    assert float(g[0]) == 0.5 and float(g[1]) == 1.0


def test_all_masked_batch_scores_zero_like_jax():
    labels, p = _loss_inputs(3, "mcxent")
    w = np.zeros((7,), np.float32)
    ref = jax_losses.mcxent(jnp.asarray(labels), jnp.asarray(p),
                            jnp.asarray(w))
    out = losses.mcxent(_t(labels), _t(p), _t(w))
    assert float(out) == 0.0 == float(ref)


def test_loss_names_are_the_jax_packages():
    assert sorted(losses.LOSS_FUNCTIONS) == sorted(jax_losses.LOSS_FUNCTIONS)
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.loss_fn("nope")


# ----------------------------------------------------------- initialisers
SCHEMES = [("vi", None), ("zero", None), ("size", None), ("uniform", None),
           ("normalized", None), ("distribution", None),
           ("distribution", {"type": "normal", "mean": 0.5, "std": 0.2}),
           ("distribution", {"type": "uniform", "lower": -2.0,
                             "upper": 3.0})]


@pytest.mark.parametrize("shape", [(96, 64), (5, 5, 6, 16)])
@pytest.mark.parametrize("scheme,dist", SCHEMES)
def test_initialiser_statistics_match_jax(scheme, dist, shape):
    ref = np.asarray(jax_init.init_weights(jax.random.PRNGKey(0), shape,
                                           scheme, dist))
    got = initializers.init_weights(torch.Generator().manual_seed(0), shape,
                                    scheme, dist).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    spread = max(float(ref.std()), 1e-12)
    n = ref.size
    assert abs(got.mean() - ref.mean()) <= 5 * spread / np.sqrt(n) + 1e-12
    assert got.std() == pytest.approx(ref.std(), rel=0.05, abs=1e-12)
    if scheme != "distribution" or (dist or {}).get("type") == "uniform":
        # bounded schemes: the same range, nearly reached
        assert got.min() >= ref.min() - 0.02 * spread
        assert got.max() <= ref.max() + 0.02 * spread
        assert got.min() <= ref.min() + 0.05 * spread + 1e-12
        assert got.max() >= ref.max() - 0.05 * spread - 1e-12


def test_initialiser_is_seeded_and_rejects_unknown_scheme():
    a = initializers.init_weights(torch.Generator().manual_seed(3), (4, 5))
    b = initializers.init_weights(torch.Generator().manual_seed(3), (4, 5))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Unknown weight init"):
        initializers.init_weights(torch.Generator(), (2, 2), "nope")


# ---------------------------------------------------------------- dropout
@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    x = torch.ones(200, 200)
    out = layers.apply_dropout(torch.Generator().manual_seed(1), x, rate)
    kept = out != 0
    assert float(kept.float().mean()) == pytest.approx(1 - rate, abs=0.01)
    assert torch.allclose(out[kept], torch.full_like(out[kept],
                                                     1 / (1 - rate)))
    ref = np.asarray(jax_layers.apply_dropout(jax.random.PRNGKey(1),
                                              jnp.ones((200, 200)), rate))
    assert float((ref != 0).mean()) == pytest.approx(1 - rate, abs=0.01)


def test_dropout_is_off_without_generator_or_training():
    x = torch.ones(8, 8)
    assert layers.apply_dropout(None, x, 0.5) is x
    assert layers.apply_dropout(torch.Generator(), x, 0.5,
                                training=False) is x
    assert layers.apply_dropout(torch.Generator(), x, 0.0) is x


# ---------------------------------------------------------- preprocessors
def _pp_pairs():
    return [
        (preprocessors.ReshapePreProcessor([4, 6]),
         jax_pp.ReshapePreProcessor([4, 6]), (3, 24)),
        (preprocessors.ConvolutionInputPreProcessor(4, 3, 2),
         jax_pp.ConvolutionInputPreProcessor(4, 3, 2), (3, 24)),
        (preprocessors.ConvolutionPostProcessor(),
         jax_pp.ConvolutionPostProcessor(), (3, 4, 3, 2)),
        (preprocessors.BinomialSamplingPreProcessor(),
         jax_pp.BinomialSamplingPreProcessor(), (3, 24)),
        (preprocessors.AggregatePreProcessor(
            [preprocessors.ReshapePreProcessor([24]),
             preprocessors.ConvolutionInputPreProcessor(2, 6, 2)]),
         jax_pp.AggregatePreProcessor(
             [jax_pp.ReshapePreProcessor([24]),
              jax_pp.ConvolutionInputPreProcessor(2, 6, 2)]), (3, 4, 6)),
    ]


@pytest.mark.parametrize("idx", range(5))
def test_preprocessor_matches_jax_and_keeps_its_wire_form(idx):
    port, ref, shape = _pp_pairs()[idx]
    x = _rng(idx).uniform(size=shape).astype(np.float32)
    _close(port(_t(x)), ref(jnp.asarray(x)), atol=0.0)
    assert port.registry_name == ref.registry_name
    assert port.serializable_args() == ref.serializable_args()


def test_binomial_sampling_draws_bernoulli_from_a_generator():
    p = torch.full((400, 100), 0.3)
    s = preprocessors.BinomialSamplingPreProcessor()(
        p, rng=torch.Generator().manual_seed(0))
    assert set(s.unique().tolist()) == {0.0, 1.0}
    assert float(s.mean()) == pytest.approx(0.3, abs=0.01)


# ----------------------------------------------------------------- layers
def _conf(**kw):
    return NeuralNetConfiguration(**kw)


def _jconf(**kw):
    return JConf(**kw)


def _both(layer_name, seed, **kw):
    """(port layer, JAX layer, params as numpy) for one conf."""
    port = layers.make_layer(_conf(layer=layer_name, **kw), device="cpu")
    ref = jax_layers.make_layer(_jconf(layer=layer_name, **kw))
    rng = _rng(seed)
    params = {name: (0.3 * rng.normal(size=shape)).astype(np.float32)
              for name, shape in ref.param_shapes().items()}
    return port, ref, params


def _layer_parity(port, ref, params, x, fn_port, fn_ref):
    """Forward and the gradient of sum(out * w) in every parameter and
    the input."""
    out_ref = fn_ref(ref, {k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x))
    w = _rng(9).normal(size=np.shape(out_ref)).astype(np.float32)

    def ref_scalar(p, xx):
        return jnp.sum(fn_ref(ref, p, xx) * w)

    ref_gp, ref_gx = jax.grad(ref_scalar, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: _t(v, grad=True) for k, v in params.items()}
    tx = _t(x, grad=True)
    out = fn_port(port, tp, tx)
    names = sorted(tp)
    grads = torch.autograd.grad((out * _t(w)).sum(), [tp[n] for n in names]
                                + [tx])
    _close(out, out_ref)
    for n, g in zip(names, grads):
        _grad_close(g, ref_gp[n])
    _grad_close(grads[-1], ref_gx)


@pytest.mark.parametrize("act", ["relu", "tanh", "softmax"])
def test_dense_layer_matches_jax(act):
    port, ref, params = _both("dense", 1, n_in=12, n_out=7,
                              activation_function=act)
    x = _rng(2).normal(size=(5, 12)).astype(np.float32)
    _layer_parity(port, ref, params, x,
                  lambda l, p, xx: l.activate(p, xx),
                  lambda l, p, xx: l.activate(p, xx))


def test_output_layer_loss_matches_jax():
    port, ref, params = _both("output", 3, n_in=10, n_out=4,
                              activation_function="softmax",
                              loss_function="mcxent")
    x = _rng(4).normal(size=(6, 10)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[_rng(5).integers(0, 4, 6)]
    _layer_parity(port, ref, params, x,
                  lambda l, p, xx: l.loss(p, xx, _t(y)),
                  lambda l, p, xx: l.loss(p, xx, jnp.asarray(y)))


@pytest.mark.parametrize("stride", [[2, 2], [3, 2]])
def test_conv_layer_matches_jax(stride):
    port, ref, params = _both("conv", 6, filter_size=[3, 2], stride=stride,
                              num_in_feature_maps=3, num_feature_maps=5,
                              activation_function="relu")
    x = _rng(7).normal(size=(2, 9, 8, 3)).astype(np.float32)
    _layer_parity(port, ref, params, x,
                  lambda l, p, xx: l.activate(p, xx),
                  lambda l, p, xx: l.activate(p, xx))


def test_conv_pool_splits_tied_gradients_like_jax():
    """1x1 filter of ones, zero bias: every pooling window is a tie of
    equal values, whose gradient jax splits evenly."""
    port, ref, _ = _both("conv", 0, filter_size=[1, 1], stride=[2, 2],
                         num_in_feature_maps=1, num_feature_maps=1,
                         activation_function="linear")
    params = {"W": np.ones((1, 1, 1, 1), np.float32),
              "b": np.zeros((1,), np.float32)}
    x = np.ones((1, 4, 4, 1), np.float32)
    x[0, 2:, 2:, 0] = [[2, 5], [5, 1]]
    _layer_parity(port, ref, params, x,
                  lambda l, p, xx: l.activate(p, xx),
                  lambda l, p, xx: l.activate(p, xx))
    tx = _t(x, grad=True)
    out = port.activate({k: _t(v) for k, v in params.items()}, tx)
    (g,) = torch.autograd.grad(out.sum(), tx)
    assert torch.allclose(g[0, :2, :2, 0], torch.full((2, 2), 0.25))
    assert g[0, 2:, 2:, 0].tolist() == [[0.0, 0.5], [0.5, 0.0]]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_self_attention_layer_matches_jax(heads, causal):
    port, ref, params = _both("self_attention", 8, n_in=12, n_out=16,
                              n_heads=heads, causal=causal)
    x = _rng(9).normal(size=(3, 10, 12)).astype(np.float32)
    _layer_parity(port, ref, params, x,
                  lambda l, p, xx: l.activate(p, xx),
                  lambda l, p, xx: l.activate(p, xx))


def test_layers_keep_the_jax_parameter_names_and_shapes():
    for name, kw in (("dense", dict(n_in=6, n_out=3)),
                     ("output", dict(n_in=6, n_out=3)),
                     ("conv", dict(filter_size=[5, 5], stride=[2, 2],
                                   num_in_feature_maps=6,
                                   num_feature_maps=16)),
                     ("self_attention", dict(n_in=12, n_out=16,
                                             n_heads=2))):
        port = layers.make_layer(_conf(layer=name, **kw), device="cpu")
        ref = jax_layers.make_layer(_jconf(layer=name, **kw))
        got = {n: tuple(p.shape) for n, p in port.param_dict().items()}
        assert got == ref.param_shapes()
        assert list(got) == sorted(got)
        table = port.init_params(torch.Generator().manual_seed(0))
        for n, p in table.items():
            if port.is_bias(n):
                assert not p.any()


def test_registry_names_and_unported_layers():
    layers.make_layer(_conf(layer="dense", n_in=2, n_out=2), device="cpu")
    for name in ("rbm", "autoencoder", "recursive_autoencoder"):
        layers.make_layer(_conf(layer=name, n_in=2, n_out=2), device="cpu")
    assert {"dense", "output", "conv", "convolution", "self_attention",
            "rbm", "autoencoder", "recursive_autoencoder"} <= set(
                layers.LAYER_REGISTRY)
    with pytest.raises(ValueError, match="Unknown layer type"):
        layers.make_layer(_conf(layer="nope"), device="cpu")
    from deeplearning4j_tpu_torch.models import LSTM

    assert layers.NOT_PORTED == {}
    assert type(layers.make_layer(_conf(layer="lstm", n_in=2, n_out=2),
                                  device="cpu")) is LSTM


def test_bf16_product_keeps_a_float32_result_on_the_cpu():
    """On the CPU a bfloat16 product is the float32 product of the
    bfloat16 values, as XLA's dot with preferred_element_type=float32."""
    rng = _rng(11)
    a = rng.normal(size=(6, 40)).astype(np.float32)
    b = rng.normal(size=(40, 3)).astype(np.float32)
    ref = jnp.dot(jnp.asarray(a).astype(jnp.bfloat16),
                  jnp.asarray(b).astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    out = matmul_f32(_t(a).bfloat16(), _t(b).bfloat16())
    assert out.dtype == torch.float32
    _close(out, ref)


# ------------------------------------------------------- on the card only
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_self_attention_layer_trains_through_the_kernels(card):
    conf = _conf(layer="self_attention", n_in=28, n_out=128, n_heads=1,
                 compute_dtype="bfloat16")
    layer = layers.make_layer(conf, device=card)
    layer.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(16, 28, 28, generator=torch.Generator().manual_seed(1))
    before = (flash.launches, flash.dq_launches, flash.dkv_launches)
    out = layer(x.to(card))
    grads = torch.autograd.grad(out.square().sum(),
                                list(layer.param_dict().values()))
    after = (flash.launches, flash.dq_launches, flash.dkv_launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    for name, g in zip(layer.param_dict(), grads):
        assert torch.isfinite(g).all() and g.abs().max().item() > 0, name


@pytest.mark.cuda
def test_self_attention_head_dim_outside_the_kernels_raises(card):
    conf = _conf(layer="self_attention", n_in=28, n_out=64, n_heads=2)
    with pytest.raises(ValueError, match="head dim"):
        layers.make_layer(conf, device=card)
