"""The PyTorch port's LSTM (deeplearning4j_tpu_torch/models/lstm.py) held
against the JAX package's `models/lstm.py`.

Parameters and inputs are made with numpy from a seed and handed to both
packages, float32 on the CPU unless a test says otherwise. Tolerances:
outputs and losses within 1e-5; gradients within 2e-5 + 1e-4 * |g|
(float32 summed in another order); params after 3 SGD steps within
1e-5; beam search returns the same tokens with log-probabilities within
1e-5. The bf16-product tests hold the port to the JAX package's bf16
product (float32 accumulation) within 1e-4. Dropout draws cannot match
jax's, so dropout is checked by its keep rate.

The `cuda` test runs the layer on the card against the CPU; it skips
without one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.models.lstm import LSTM as JLSTM
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.models import LSTM
from deeplearning4j_tpu_torch.nn import layers

FWD_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
BF16_TOL = 1e-4
D, N_OUT, T, B = 8, 6, 10, 3


def _confs(**kw):
    base = dict(layer="lstm", n_in=D, n_out=N_OUT,
                activation_function="tanh", loss_function="mcxent")
    base.update(kw)
    return NeuralNetConfiguration(**base), JConf(**base)


def _pair(seed=0, **kw):
    """(port layer, JAX layer, params as numpy) for one conf."""
    c, jc = _confs(**kw)
    port, ref = layers.make_layer(c, device="cpu"), JLSTM(jc)
    rng = np.random.default_rng(seed)
    params = {name: (0.3 * rng.normal(size=shape)).astype(np.float32)
              for name, shape in ref.param_shapes().items()}
    return port, ref, params


def _t(p, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _onehot(seed, lead):
    idx = np.random.default_rng(seed).integers(0, N_OUT, lead)
    return np.eye(N_OUT, dtype=np.float32)[idx]


def _close(got, ref, atol=FWD_TOL, rtol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------------- registry
def test_lstm_resolves_and_nothing_is_left_unported():
    assert layers.NOT_PORTED == {}
    port, ref, _ = _pair()
    assert type(port) is LSTM
    got = {n: tuple(p.shape) for n, p in port.param_dict().items()}
    assert got == ref.param_shapes() == {"R": (1 + 2 * D, 4 * D),
                                         "Wd": (D, N_OUT), "bd": (1, N_OUT)}
    table = port.init_params(torch.Generator().manual_seed(0))
    assert not table["bd"].any() and table["R"].std() > 0
    jtable = ref.init_params(jax.random.PRNGKey(0))
    assert not np.asarray(jtable["bd"]).any()


# -------------------------------------------------------------- forward
@pytest.mark.parametrize("shape", [(T, D), (B, T, D), (1, D), (B, 1, D)])
def test_activate_matches_jax(shape):
    port, ref, p = _pair(1)
    x = _x(2, shape)
    got = port.activate(_t(p), torch.tensor(x))
    want = ref.activate(_j(p), jnp.asarray(x))
    assert tuple(got.shape) == want.shape == (*shape[:-1], N_OUT)
    _close(got, want)
    _close(port.hidden_sequence(_t(p), torch.tensor(x)),
           ref.hidden_sequence(_j(p), jnp.asarray(x)))


@pytest.mark.parametrize("act", ["sigmoid", "relu"])
def test_non_tanh_activation_takes_h_equals_o_times_c(act):
    port, ref, p = _pair(3, activation_function=act)
    x = _x(4, (B, T, D))
    _close(port.activate(_t(p), torch.tensor(x)),
           ref.activate(_j(p), jnp.asarray(x)))
    # the branch really differs from tanh's
    tanh_port, _, _ = _pair(3)
    assert not torch.allclose(port.activate(_t(p), torch.tensor(x)),
                              tanh_port.activate(_t(p), torch.tensor(x)))


def test_cell_matches_jax():
    port, ref, p = _pair(5)
    x, h, c = (_x(s, (B, D)) for s in (6, 7, 8))
    got = port.cell(_t(p), *(torch.tensor(a) for a in (x, h, c)))
    want = ref.cell(_j(p), *(jnp.asarray(a) for a in (x, h, c)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shape", [(T, D), (B, T, D)])
def test_bf16_products_match_jax(shape):
    port, ref, p = _pair(9, compute_dtype="bfloat16")
    x = _x(10, shape)
    _close(port.activate(_t(p), torch.tensor(x)),
           ref.activate(_j(p), jnp.asarray(x)), atol=BF16_TOL)
    y = _onehot(11, shape[:-1])
    _close(port.loss(_t(p), torch.tensor(x), torch.tensor(y)),
           ref.loss(_j(p), jnp.asarray(x), jnp.asarray(y)), atol=BF16_TOL)


# ----------------------------------------------------------- loss, grads
LOSSES = ["mcxent", "negativeloglikelihood", "mse", "squared_loss"]


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("batched", [False, True])
def test_loss_and_gradients_match_jax(loss, batched):
    port, ref, p = _pair(12, loss_function=loss)
    shape = (B, T, D) if batched else (T, D)
    x, y = _x(13, shape), _onehot(14, shape[:-1])
    tp = _t(p, grad=True)
    got = port.loss(tp, torch.tensor(x), torch.tensor(y))
    want = ref.loss(_j(p), jnp.asarray(x), jnp.asarray(y))
    _close(got, want)
    grads = torch.autograd.grad(got, list(tp.values()))
    jgrads = jax.grad(ref.loss)(_j(p), jnp.asarray(x), jnp.asarray(y))
    for name, g in zip(tp, grads):
        _close(g, jgrads[name], GRAD_ATOL, GRAD_RTOL)


def test_weights_mask_the_example_axis_as_jax_does():
    port, ref, p = _pair(15)
    x, y = _x(16, (4, T, D)), _onehot(17, (4, T))
    w = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    tp = _t(p, grad=True)
    got = port.loss(tp, torch.tensor(x), torch.tensor(y),
                    weights=torch.tensor(w))
    want = ref.loss(_j(p), jnp.asarray(x), jnp.asarray(y),
                    weights=jnp.asarray(w))
    _close(got, want)
    # rows of weight 0 change nothing: the loss of the kept rows alone
    kept = port.loss(_t(p), torch.tensor(x[::2]), torch.tensor(y[::2]),
                     weights=torch.ones(2))
    _close(got, kept.detach())
    grads = torch.autograd.grad(got, list(tp.values()))
    jgrads = jax.grad(lambda q: ref.loss(q, jnp.asarray(x), jnp.asarray(y),
                                         weights=jnp.asarray(w)))(_j(p))
    for name, g in zip(tp, grads):
        _close(g, jgrads[name], GRAD_ATOL, GRAD_RTOL)


def test_three_sgd_steps_match_jax():
    port, ref, p = _pair(18)
    pattern = [0, 1, 2, 3, 2, 1] * 3
    x = np.eye(D, dtype=np.float32)[pattern[:-1]]
    y = np.eye(N_OUT, dtype=np.float32)[pattern[1:]]
    tp, jp = _t(p, grad=True), _j(p)
    grad_fn = jax.grad(ref.loss)
    for _ in range(3):
        loss = port.loss(tp, torch.tensor(x), torch.tensor(y))
        grads = torch.autograd.grad(loss, list(tp.values()))
        with torch.no_grad():
            for v, g in zip(tp.values(), grads):
                v.sub_(0.5 * g)
        jg = grad_fn(jp, jnp.asarray(x), jnp.asarray(y))
        jp = {k: jp[k] - 0.5 * jg[k] for k in jp}
    for name in p:
        _close(tp[name], jp[name])
    with torch.no_grad():
        assert float(port.loss(tp, torch.tensor(x), torch.tensor(y))) < \
            float(port.loss(_t(p), torch.tensor(x), torch.tensor(y)))


def test_dropout_draws_one_mask_over_the_input():
    port, _, p = _pair(19, dropout=0.25)
    x = torch.ones((64, T, D))
    gen = torch.Generator().manual_seed(0)
    seen = []
    orig = port._unroll

    def spy(params, xs, h, c):
        seen.append(xs)
        return orig(params, xs, h, c)

    port._unroll = spy
    port.activate(_t(p), x, rng=gen, training=True)
    kept = (seen[0] != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    assert torch.allclose(seen[0][seen[0] != 0], torch.tensor(1 / 0.75))
    port.activate(_t(p), x, rng=gen, training=False)
    assert torch.equal(seen[1], x)


# ------------------------------------------------------------- streaming
@pytest.mark.parametrize("batched", [False, True])
def test_run_stream_chunks_carry_and_match_jax(batched):
    port, ref, p = _pair(20)
    shape = (B, 12, D) if batched else (12, D)
    x = _x(21, shape)
    full, (h, c) = port.run_stream(_t(p), torch.tensor(x))
    jfull, (jh, jc) = ref.run_stream(_j(p), jnp.asarray(x))
    _close(full, jfull)
    _close(h, jh)
    _close(c, jc)
    _close(full, port.activate(_t(p), torch.tensor(x)).detach())
    out1, carry = port.run_stream(_t(p), torch.tensor(x[..., :5, :]))
    out2, _ = port.run_stream(_t(p), torch.tensor(x[..., 5:, :]),
                              carry=carry)
    _close(torch.cat([out1, out2], dim=-2), jfull)


def test_run_stream_refuses_other_ranks_as_jax_does():
    port, ref, p = _pair(22)
    for shape in [(D,), (1, 2, T, D)]:
        with pytest.raises(ValueError) as got:
            port.run_stream(_t(p), torch.zeros(shape))
        with pytest.raises(ValueError) as want:
            ref.run_stream(_j(p), jnp.zeros(shape))
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ beam search
@pytest.mark.parametrize("beam,steps,start", [(3, 5, 1), (5, 8, 2),
                                              (2, 1, 3)])
def test_beam_search_tokens_match_jax(beam, steps, start):
    c, jc = _confs(n_out=D)
    port, ref = layers.make_layer(c, device="cpu"), JLSTM(jc)
    rng = np.random.default_rng(23 + start)
    p = {name: (0.5 * rng.normal(size=shape)).astype(np.float32)
         for name, shape in ref.param_shapes().items()}
    ws = np.eye(D, dtype=np.float32)
    got = port.predict(_t(p), ws[start], ws, beam_size=beam, n_steps=steps)
    want = ref.predict(_j(p), jnp.asarray(ws[start]), jnp.asarray(ws),
                       beam_size=beam, n_steps=steps)
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([lp for _, lp in got],
                               [lp for _, lp in want], atol=1e-5)
    assert [lp for _, lp in got] == sorted((lp for _, lp in got),
                                           reverse=True)


def test_beam_search_stops_at_the_stop_token_as_jax_does():
    c, jc = _confs(n_out=D)
    port, ref = layers.make_layer(c, device="cpu"), JLSTM(jc)
    p = {name: np.zeros(shape, np.float32)
         for name, shape in ref.param_shapes().items()}
    p["bd"][0, 0] = 5.0  # token 0 (the stop token) dominates
    ws = np.eye(D, dtype=np.float32)
    got = port.predict(_t(p), ws[1], ws, beam_size=2, n_steps=6)
    want = ref.predict(_j(p), jnp.asarray(ws[1]), jnp.asarray(ws),
                       beam_size=2, n_steps=6)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert got[0][0] == [0]


# ----------------------------------------------------------------- card
@pytest.mark.cuda
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c, _ = _confs()
    cpu = layers.make_layer(c, device="cpu")
    card = layers.make_layer(c, device="cuda")
    rng = np.random.default_rng(24)
    p = {n: (0.3 * rng.normal(size=s)).astype(np.float32)
         for n, s in cpu.param_shapes().items()}
    x, y = _x(25, (B, T, D)), _onehot(26, (B, T))
    tc = _t(p, grad=True)
    tg = {k: v.detach().cuda().requires_grad_() for k, v in tc.items()}
    lc = cpu.loss(tc, torch.tensor(x), torch.tensor(y))
    lg = card.loss(tg, torch.tensor(x).cuda(), torch.tensor(y).cuda())
    _close(lg.cpu(), lc.detach())
    for g, w in zip(torch.autograd.grad(lg, list(tg.values())),
                    torch.autograd.grad(lc, list(tc.values()))):
        _close(g.cpu(), w, GRAD_ATOL, GRAD_RTOL)
    out, _ = card.run_stream(tg, torch.tensor(x).cuda())
    _close(out.cpu(), cpu.run_stream(tc, torch.tensor(x))[0])
