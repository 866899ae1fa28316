"""LSTM sequence model with beam-search decoding, the counterpart of the
JAX package's `models/lstm.py`.

Parity: reference core/models/classifiers/lstm/LSTM.java — `activate`
unrolled IFOG-gate loop (:159-232), `lstmTick` single-step cell,
`predict` + `BeamSearch` (:234-330), params from LSTMParamInitializer
(core/nn/params/LSTMParamInitializer.java:33-46: "recurrentweights"
(1 + nIn + nHidden, 4*nHidden) with the bias folded in as the leading row,
"decoderweights" (nHidden, nOut), "decoderbias").

Design: the JAX package's `lax.scan` over time is a Python loop over T
here, and its `vmap` over a batch is the batch dimension of each step's
product: a step is one `(B, 1+2d) x (1+2d, 4d)` product in
`conf.compute_dtype` with a float32 result (`ops/products.py`), cast to
the input's dtype, then the gates. Gradients come from autograd through
the loop. Gate layout matches the reference: [i | f | o] sigmoid, [g]
tanh; c_t = i*g + f*c_{t-1}; h_t = o * tanh(c_t) (o*c_t when the
activation is not tanh). The decoder `hs @ Wd + bd` runs in the
parameter dtype. Hidden size == n_in (LSTMParamInitializer.java:41 sets
hiddenSize = nIn). `bd` is zero-initialised (a name starting with "b"
is a bias).

Beam search keeps its bookkeeping on the host, as the JAX package does:
each tick's log-probabilities are copied to the host and ranked by
`np.argsort(-logprobs)`, and the beams cut by `heapq.nlargest`, so ties
break as they do there.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.layers import (BaseLayer, apply_dropout,
                                                register_layer, torch_dtype)
from deeplearning4j_tpu_torch.ops.losses import loss_fn
from deeplearning4j_tpu_torch.ops.products import matmul_f32


@register_layer("lstm")
class LSTM(BaseLayer):
    def _dims(self) -> Tuple[int, int]:
        d = self.conf.n_in  # hidden size == input size (reference parity)
        return d, self.conf.n_out

    def param_shapes(self) -> Dict[str, tuple]:
        d, n_out = self._dims()
        return {"R": (1 + 2 * d, 4 * d),  # [bias row; x_t; h_{t-1}] -> IFOG
                "Wd": (d, n_out),
                "bd": (1, n_out)}

    # ---------------------------------------------------------------- cell
    def cell(self, params, x_t, h_prev, c_prev):
        """One LSTM tick (reference lstmTick) on (..., n_in) inputs:
        returns (h, c)."""
        d, _ = self._dims()
        cd = torch_dtype(self.conf.compute_dtype)
        h_in = torch.cat([torch.ones_like(x_t[..., :1]), x_t, h_prev],
                         dim=-1)
        ifog = matmul_f32(h_in.to(cd), params["R"].to(cd)).to(x_t.dtype)
        gates = torch.sigmoid(ifog[..., :3 * d])
        i, f, o = gates[..., :d], gates[..., d:2 * d], gates[..., 2 * d:]
        g = torch.tanh(ifog[..., 3 * d:])
        c_new = i * g + f * c_prev
        if self.conf.activation_function == "tanh":
            h_new = o * torch.tanh(c_new)
        else:
            h_new = o * c_new
        return h_new, c_new

    # ------------------------------------------------------------- forward
    def _input(self, params, x) -> torch.Tensor:
        """An input as a tensor on the parameters' device; float64
        narrows to float32 (as jnp.asarray does)."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x), device=params["R"].device)
        return x.float() if x.dtype == torch.float64 else x

    def _unroll(self, params, x, h, c):
        """Run the cell over the time axis (-2) of x: (T, n_in) or
        (B, T, n_in) -> (hidden sequence like x with d columns, (h, c))."""
        hs = []
        for t in range(x.shape[-2]):
            h, c = self.cell(params, x[..., t, :], h, c)
            hs.append(h)
        return torch.stack(hs, dim=-2), (h, c)

    def _zeros(self, x) -> torch.Tensor:
        d, _ = self._dims()
        return torch.zeros((*x.shape[:-2], d), dtype=x.dtype,
                           device=x.device)

    @staticmethod
    def _decode(params, hs):
        return hs @ params["Wd"] + params["bd"]

    def hidden_sequence(self, params, x):
        """Hidden states per timestep: (T, d) or (B, T, d)."""
        x = self._input(params, x)
        zeros = self._zeros(x)
        return self._unroll(params, x, zeros, zeros)[0]

    def activate(self, params, x, *, rng: Optional[torch.Generator] = None,
                 training: bool = False):
        """Decoded outputs per timestep: (T, n_out) or (B, T, n_out)
        (reference activate :159 — which drops the first timestep; all T
        are emitted so labels align 1:1 with inputs). Dropout, when
        training with a generator, draws one mask over the whole input."""
        x = apply_dropout(rng, self._input(params, x), self.conf.dropout,
                          training)
        zeros = self._zeros(x)
        return self._decode(params, self._unroll(params, x, zeros, zeros)[0])

    def loss(self, params, x, labels, *, rng=None, training: bool = False,
             weights=None):
        """Sequence loss under the configured loss function; labels
        (T, n_out) or (B, T, n_out) align with activate(). `weights`
        (leading dim) masks device-feed padding rows — batched input
        only, where the leading dim is the example axis."""
        out = self.activate(params, x, rng=rng, training=training)
        if self.conf.loss_function in ("mcxent", "negativeloglikelihood"):
            out = torch.softmax(out, dim=-1)
        return loss_fn(self.conf.loss_function)(labels, out, weights)

    # --------------------------------------------------------- streaming
    @torch.no_grad()
    def run_stream(self, params, x, carry=None):
        """Decoded outputs AND the final recurrent state: x (T, n_in) or
        (B, T, n_in) -> (outputs matching activate(), (h, c) carry). Feed
        the returned carry back as `carry=` to continue a stream across
        calls — the chunked/streaming inference primitive (same cell math
        as activate, which always starts from zeros)."""
        x = self._input(params, x)
        if x.dim() not in (2, 3):
            raise ValueError(
                f"run_stream expects (T, n_in) or (B, T, n_in), got "
                f"shape {tuple(x.shape)}")
        if carry is None:
            zeros = self._zeros(x)
            carry = (zeros, zeros)
        hs, carry = self._unroll(params, x, *carry)
        return self._decode(params, hs), carry

    # ---------------------------------------------------------- decoding
    @torch.no_grad()
    def predict(self, params, x_init, ws, beam_size: int = 5,
                n_steps: int = 20, stop_token: int = 0
                ) -> List[Tuple[List[int], float]]:
        """Beam-search decode (reference predict :234 + BeamSearch :256).

        `x_init`: (n_in,) start input; `ws`: (vocab, n_in) token
        embeddings. Returns [(token ids, log prob)] sorted best-first.
        """
        d, _ = self._dims()
        x_init = self._input(params, x_init)
        ws = self._input(params, ws)

        def tick(x_t, h, c):
            h_new, c_new = self.cell(params, x_t[None, :], h[None, :],
                                     c[None, :])
            y = self._decode(params, h_new)
            return y[0], h_new[0], c_new[0]

        def host_logprobs(y) -> np.ndarray:
            return torch.log_softmax(y, dim=-1).float().cpu().numpy()

        zeros = torch.zeros((d,), dtype=x_init.dtype, device=x_init.device)
        # Seed the beams from the model's prediction AFTER x_init: the
        # first tick's distribution picks the first tokens.
        y, h, c = tick(x_init, zeros, zeros)
        logprobs = host_logprobs(y)
        top = np.argsort(-logprobs)[:beam_size]
        beams = [(float(logprobs[idx]), [int(idx)], h, c) for idx in top]
        for _ in range(n_steps - 1):
            candidates = []
            for logp, seq, h, c in beams:
                if seq[-1] == stop_token:
                    candidates.append((logp, seq, h, c))
                    continue
                y, h2, c2 = tick(ws[seq[-1]], h, c)
                logprobs = host_logprobs(y)
                top = np.argsort(-logprobs)[:beam_size]
                for idx in top:
                    candidates.append((logp + float(logprobs[idx]),
                                       seq + [int(idx)], h2, c2))
            beams = heapq.nlargest(beam_size, candidates, key=lambda b: b[0])
            if all(b[1][-1] == stop_token for b in beams):
                break
        return [(seq, logp) for logp, seq, _, _ in
                sorted(beams, key=lambda b: -b[0])]
