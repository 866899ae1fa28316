"""Unsupervised feature detectors: RBM, denoising AutoEncoder, recursive
AE, the counterpart of the JAX package's `models/pretrain.py`.

Parity: reference core/models/featuredetectors/rbm/RBM.java (CD-k via
Gibbs sampling with the 4 visible x 4 hidden unit-type matrix:
contrastiveDivergence :105, gradient :114, sampleHiddenGivenVisible
:240, gibbhVh :292, propUp :344, propDown :389, freeEnergy :222),
autoencoder/AutoEncoder.java (encode :62, decode :79, gradient with
binomial corruption :111), recursive/RecursiveAutoEncoder.java, and
core/nn/layers/BasePretrainNetwork.java (getCorruptedInput :95,
applySparsity :64).

Each model exposes one scalar `pretrain_loss(params, x, generator)`
that the solver differentiates with autograd, as the JAX package does
with `jax.grad`:

* RBM: CD-k is not the gradient of a loss, so the surrogate energy is
  used: the Gibbs chain runs outside the gradient (under
  `torch.no_grad()`, the JAX package's `stop_gradient` on every
  sample), then loss = mean_energy(v0, h0) - mean_energy(vk, hk), whose
  parameter gradient is the positive-minus-negative phase moments for
  every unit-type pair (the bilinear energy is shared).
* Rectified hidden units use relu, and gaussian means are `pre`, as in
  the JAX package (not the reference's clamp at 1.0 and `2*pre+noise`).
* The samplers draw from the explicit `torch.Generator` they are given,
  on the tensors' device; the draws cannot equal jax's, so the sampled
  paths are held to the JAX package by their statistics.

The products are plain float32 `@` in the parameter dtype, as the JAX
package's (`models/pretrain.py:89`, `:103`, `:208`), which never uses
`compute_dtype` here; they do not go through `ops/products.py`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.layers import (BaseLayer, apply_dropout,
                                                register_layer)
from deeplearning4j_tpu_torch.ops.activations import apply_activation
from deeplearning4j_tpu_torch.ops.losses import loss_fn


def binomial_corruption(gen: Optional[torch.Generator], x,
                        corruption_level: float):
    """Zero each element with probability `corruption_level` (reference
    BasePretrainNetwork.getCorruptedInput :95)."""
    keep = torch.rand(x.shape, generator=gen, device=x.device,
                      dtype=x.dtype) < 1.0 - corruption_level
    return x * keep


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0), no linear cut-over
    return torch.logaddexp(x, torch.zeros_like(x))


class BasePretrainLayer(BaseLayer):
    """Shared machinery for {W, b (hidden), vb (visible)} energy and
    autoencoder models (reference BasePretrainNetwork +
    PretrainParamInitializer)."""

    def param_shapes(self) -> Dict[str, tuple]:
        c = self.conf
        return {"W": (c.n_in, c.n_out), "b": (1, c.n_out), "vb": (1, c.n_in)}

    # subclasses implement pretrain_loss(params, x, generator) -> scalar
    def reconstruct(self, params, x):
        raise NotImplementedError

    def sparsity_penalty(self, hidden_mean):
        """Pull the mean hidden activation toward conf.sparsity (the
        reference's applySparsity bias nudge, BasePretrainNetwork.java:64,
        as a differentiable penalty)."""
        c = self.conf
        if c.sparsity == 0.0:
            return 0.0
        return torch.square(hidden_mean.mean(dim=0) - c.sparsity).sum()


@register_layer("rbm")
class RBM(BasePretrainLayer):
    """Restricted Boltzmann Machine with CD-k.

    Unit types (conf.visible_unit x conf.hidden_unit), mirroring
    RBM.java's VisibleUnit {BINARY, GAUSSIAN, SOFTMAX, LINEAR} and
    HiddenUnit {BINARY, GAUSSIAN, SOFTMAX, RECTIFIED}.
    """

    # ------------------------------------------------------------ propagation
    def prop_up(self, params, v):
        """Hidden mean given visible (reference propUp :344)."""
        pre = v @ params["W"] + params["b"]
        h = self.conf.hidden_unit
        if h == "binary":
            return torch.sigmoid(pre)
        if h == "rectified":
            return torch.relu(pre)
        if h == "gaussian":
            return pre
        if h == "softmax":
            return torch.softmax(pre, dim=-1)
        raise ValueError(f"Unknown hidden unit {h!r}")

    def prop_down(self, params, h):
        """Visible mean given hidden (reference propDown :389)."""
        pre = h @ params["W"].T + params["vb"]
        v = self.conf.visible_unit
        if v == "binary":
            return torch.sigmoid(pre)
        if v in ("gaussian", "linear"):
            return pre
        if v == "softmax":
            return torch.softmax(pre, dim=-1)
        raise ValueError(f"Unknown visible unit {v!r}")

    # --------------------------------------------------------------- sampling
    def sample_h_given_v(self, params, v, gen):
        """(mean, sample) of hidden given visible (reference
        sampleHiddenGivenVisible :240)."""
        mean = self.prop_up(params, v)
        h = self.conf.hidden_unit
        if h == "binary":
            sample = torch.bernoulli(mean, generator=gen)
        elif h == "rectified":
            # NReLU: mean + N(0, sigmoid(mean)) clipped at 0
            noise = torch.randn(mean.shape, generator=gen,
                                device=mean.device, dtype=mean.dtype)
            sample = torch.relu(mean + noise * torch.sqrt(torch.sigmoid(mean)))
        elif h == "gaussian":
            sample = mean + torch.randn(mean.shape, generator=gen,
                                        device=mean.device, dtype=mean.dtype)
        else:  # softmax: the reference uses the probabilities as the sample
            sample = mean
        return mean, sample

    def sample_v_given_h(self, params, h, gen):
        """(mean, sample) of visible given hidden (reference
        sampleVisibleGivenHidden :309)."""
        mean = self.prop_down(params, h)
        v = self.conf.visible_unit
        if v == "binary":
            sample = torch.bernoulli(mean, generator=gen)
        elif v in ("gaussian", "linear"):
            sample = mean + torch.randn(mean.shape, generator=gen,
                                        device=mean.device, dtype=mean.dtype)
        else:  # softmax
            sample = mean
        return mean, sample

    def gibbs_vhv(self, params, h, gen):
        """One h -> v -> h Gibbs step (reference gibbhVh :292)."""
        v_mean, v_sample = self.sample_v_given_h(params, h, gen)
        h_mean, h_sample = self.sample_h_given_v(params, v_sample, gen)
        return (v_mean, v_sample), (h_mean, h_sample)

    # ----------------------------------------------------------------- energy
    def free_energy(self, params, v):
        """-log sum_h exp(-E(v, h)) for binary hidden (reference
        freeEnergy :222)."""
        wx_b = v @ params["W"] + params["b"]
        v_term = (v * params["vb"]).sum(dim=-1)
        h_term = _softplus(wx_b).sum(dim=-1)
        return -h_term - v_term

    def _mean_energy(self, params, v, h):
        """Bilinear energy <E(v, h)> whose parameter gradient reproduces
        the CD moment statistics for every unit type."""
        e = ((v * params["vb"]).sum(dim=-1) + (h * params["b"]).sum(dim=-1)
             + ((v @ params["W"]) * h).sum(dim=-1))
        return -e.mean()

    # ------------------------------------------------------------------- loss
    def pretrain_loss(self, params, x, gen: Optional[torch.Generator]):
        """CD-k surrogate loss (reference gradient() :114): the chain runs
        without a graph, so autograd gives exactly the (negative-phase -
        positive-phase) moments."""
        with torch.no_grad():
            h0_mean, h = self.sample_h_given_v(params, x, gen)
            v_sample = x
            for _ in range(max(1, self.conf.k)):
                (_, v_sample), (h_mean, h) = self.gibbs_vhv(params, h, gen)
        loss = (self._mean_energy(params, x, h0_mean)
                - self._mean_energy(params, v_sample, h_mean))
        if self.conf.sparsity != 0.0:
            loss = loss + self.sparsity_penalty(self.prop_up(params, x))
        return loss

    # -------------------------------------------------------------- inference
    def reconstruct(self, params, x):
        """propUp then propDown (reference transform :433)."""
        return self.prop_down(params, self.prop_up(params, x))

    def activate(self, params, x, *, rng: Optional[torch.Generator] = None,
                 training: bool = False):
        """Forward activation inside a stacked net: the hidden mean."""
        act = self.prop_up(params, x)
        return apply_dropout(rng, act, self.conf.dropout, training)


@register_layer("autoencoder")
class AutoEncoder(BasePretrainLayer):
    """Denoising autoencoder with tied weights (reference
    AutoEncoder.java: encode :62, decode :79, gradient :111)."""

    def encode(self, params, x):
        return apply_activation(self.conf.activation_function,
                                x @ params["W"] + params["b"])

    def decode(self, params, y):
        return apply_activation(self.conf.activation_function,
                                y @ params["W"].T + params["vb"])

    def reconstruct(self, params, x):
        return self.decode(params, self.encode(params, x))

    def pretrain_loss(self, params, x, gen: Optional[torch.Generator]):
        """The configured loss of the reconstruction of the corrupted
        input against the clean input (reference gradient :111)."""
        c = self.conf
        corrupted = (binomial_corruption(gen, x, c.corruption_level)
                     if c.corruption_level > 0 else x)
        y = self.encode(params, corrupted)
        z = self.decode(params, y)
        return loss_fn(c.loss_function)(x, z) + self.sparsity_penalty(y)

    def activate(self, params, x, *, rng: Optional[torch.Generator] = None,
                 training: bool = False):
        act = self.encode(params, x)
        return apply_dropout(rng, act, self.conf.dropout, training)


@register_layer("recursive_autoencoder")
class RecursiveAutoEncoder(BaseLayer):
    """Recursive autoencoder folding a sequence of rows (reference
    recursive/RecursiveAutoEncoder.java).

    h_0 = x_0;  h_i = act([x_i ; h_{i-1}] @ W + c);
    y_i = act(h_i @ U + bU) reconstructs [x_i ; h_{i-1}].
    Loss = mean over steps of 0.5 * mean((y_i - [x_i; h_{i-1}])^2)
    (reference scoreSnapShot). The fold is a Python loop over the rows
    (the JAX package's `lax.scan`).

    Parameter names follow RecursiveParamInitializer: W/c encoder, U/bU
    decoder. The hidden size is n_in, so the recursion composes.
    """

    def param_shapes(self) -> Dict[str, tuple]:
        n = self.conf.n_in
        return {"W": (2 * n, n), "c": (1, n), "U": (n, 2 * n),
                "bU": (1, 2 * n)}

    def _encode(self, params, combined):
        return apply_activation(self.conf.activation_function,
                                combined @ params["W"] + params["c"])

    def _decode(self, params, hidden):
        return apply_activation(self.conf.activation_function,
                                hidden @ params["U"] + params["bU"])

    def _fold(self, params, x):
        """x: (seq, n_in) -> (final hidden, mean loss, hiddens (seq-1,
        n_in))."""
        if x.shape[0] < 2:
            raise ValueError(
                "RecursiveAutoEncoder needs a sequence of >= 2 rows to fold; "
                f"got shape {tuple(x.shape)}")
        h = x[0]
        hs, losses = [], []
        for i in range(1, x.shape[0]):
            combined = torch.cat([x[i], h], dim=-1)
            h = self._encode(params, combined[None, :])[0]
            y = self._decode(params, h[None, :])[0]
            losses.append(0.5 * torch.square(y - combined).mean())
            hs.append(h)
        return h, torch.stack(losses).mean(), torch.stack(hs)

    def pretrain_loss(self, params, x, gen: Optional[torch.Generator] = None):
        _, loss, _ = self._fold(params, x)
        return loss

    def activate(self, params, x, *, rng: Optional[torch.Generator] = None,
                 training: bool = False):
        """The hidden representation at every fold step: (seq-1, n_in)."""
        _, _, hs = self._fold(params, x)
        return hs
