"""Viterbi decoder for smoothing observed label sequences.

Parity: reference core/util/Viterbi.java:31-192 — a fixed two-parameter
markov chain over the label states: emission log-prob is log(pCorrect)
when a state matches the observed label and log((1-pCorrect)/(states-1))
otherwise; transition log-prob is log(metaStability) for staying in the
same state and log((1-metaStability)/(states-1)) for switching. `decode`
accepts either an outcome-index sequence or a binary (one-hot) label
matrix and returns (best path log-prob, decoded state sequence).

The reference's backpointer matrix was never filled (Viterbi.java:77-105
computes `pointers` but only writes zeros) and its probability formulas
dropped parentheses (`1 - pCorrect / states - 1`); both are alpha-era
bugs, deliberately not reproduced — this is the intended algorithm.

The port's counterpart of the JAX package's `utils/viterbi.py`. The JAX
package's jitted `lax.scan` pair (the forward max-product pass, then the
reverse backtrace) becomes two torch loops over the frames on a device,
in float32 as there: `torch.max(dim=0)` gives the best predecessor, ties
to the first index as `jnp.argmax` does. The path stays on the device
until the one read at the end. Backends of `viterbi_path`: JAX's
`"numpy"` is kept as it is (host float64); JAX's `"jax"` becomes
`"torch"` (the device loops on `device=`, None = the card).
`Viterbi.decode` runs the device loops, as the JAX package's runs its
jitted scan.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device

def _viterbi_general(log_init: torch.Tensor, log_trans: torch.Tensor,
                     log_emits: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """General-HMM max-product decode on the tensors' device:
    `log_init` (S,), `log_trans` (S, S) row->col, `log_emits` (T, S)
    per-frame emission log-probs. Returns the best path's log-prob (1,)
    and the state path (T,), both still on the device."""
    T = log_emits.shape[0]
    v = log_init + log_emits[0]
    pointers = []
    for t in range(1, T):
        scores = v.unsqueeze(1) + log_trans
        best, best_prev = scores.max(dim=0)
        v = best + log_emits[t]
        pointers.append(best_prev)
    # one-element index tensors throughout: no index is read to the host
    last = torch.argmax(v).reshape(1)
    path = [last]
    state = last
    for ptr_row in reversed(pointers):
        state = ptr_row.index_select(0, state)
        path.append(state)
    return v.index_select(0, last), torch.cat(path[::-1])


def _viterbi_decode(observed: torch.Tensor, states: int,
                    log_p_correct: float, log_p_incorrect: float,
                    log_stay: float, log_switch: float):
    """The 2-parameter smoothing chain, lowered onto the general-table
    decoder above: uniform init, stay/switch transition matrix, and
    match/mismatch emissions materialized per frame (float32)."""
    dev = observed.device
    f32 = torch.float32
    trans = torch.full((states, states), log_switch, dtype=f32, device=dev)
    trans.fill_diagonal_(log_stay)
    init = torch.full((states,), -math.log(states), dtype=f32, device=dev)
    match = observed.unsqueeze(1) == torch.arange(states, device=dev)
    emits = torch.where(match, torch.tensor(log_p_correct, dtype=f32,
                                            device=dev),
                        torch.tensor(log_p_incorrect, dtype=f32,
                                     device=dev))
    return _viterbi_general(init, trans, emits)


def _viterbi_np(log_init, log_trans, log_emits):
    """Numpy twin of _viterbi_general for host-side callers: for small
    tables (PoS tagging natural sentences of every length) a host loop
    beats a device launch a frame."""
    T, S = log_emits.shape
    v = log_init + log_emits[0]
    pointers = np.empty((T - 1, S), np.int64)
    for t in range(1, T):
        scores = v[:, None] + log_trans
        pointers[t - 1] = scores.argmax(axis=0)
        v = scores.max(axis=0) + log_emits[t]
    path = np.empty(T, np.int64)
    path[-1] = int(v.argmax())
    for t in range(T - 2, -1, -1):
        path[t] = pointers[t, path[t + 1]]
    return float(v.max()), path


def _read(logp: torch.Tensor, path: torch.Tensor) -> Tuple[float, np.ndarray]:
    """(log-prob, path) in one device-to-host copy."""
    host = torch.cat([path.to(torch.float64),
                      logp.reshape(1).to(torch.float64)]).cpu().numpy()
    return float(np.float32(host[-1])), host[:-1].astype(np.int64)


def viterbi_path(log_init, log_trans, log_emits, backend: str = "numpy",
                 device=None) -> Tuple[float, np.ndarray]:
    """Decode the most likely state path for a general HMM.
    Returns (best path log-prob, state index sequence).

    backend='numpy' (default) runs the host loop in float64 — right for
    small tables at many distinct lengths; backend='torch' (the JAX
    package's 'jax') runs the float32 loops on `device` (None = the
    card) — right for long streams."""
    log_emits_np = np.asarray(log_emits, np.float64)
    if log_emits_np.ndim != 2 or log_emits_np.shape[0] == 0:
        raise ValueError("log_emits must be (frames, states), frames >= 1")
    if backend == "numpy":
        return _viterbi_np(np.asarray(log_init, np.float64),
                           np.asarray(log_trans, np.float64), log_emits_np)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    dev = default_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return _read(*_viterbi_general(f32(log_init), f32(log_trans),
                                   f32(log_emits)))


class Viterbi:
    """See module docstring; constructor mirrors Viterbi(possibleLabels).
    `device` (None = the card, raising without one) runs the decode."""

    def __init__(self, possible_labels, meta_stability: float = 0.9,
                 p_correct: float = 0.99, device=None):
        self.device = default_device(device)
        self.possible_labels = np.asarray(possible_labels).ravel()
        self.states = int(self.possible_labels.shape[0])
        if self.states < 2:
            raise ValueError("Viterbi needs at least 2 states")
        self.meta_stability = meta_stability
        self.p_correct = p_correct

    def decode(self, labels,
               binary_label_matrix: bool = True) -> Tuple[float, np.ndarray]:
        """Returns (log-prob of the best path, decoded outcome sequence).

        `labels`: (frames, states) one-hot matrix when binary_label_matrix
        (reference toOutcomesFromBinaryLabelMatrix via argmax) else a
        1-D outcome-index sequence.
        """
        labels = np.asarray(labels)
        if labels.ndim == 2 and binary_label_matrix:
            observed = labels.argmax(axis=-1)
        else:
            observed = labels.ravel().astype(np.int64)
        if observed.shape[0] == 0:
            raise ValueError("Cannot decode an empty sequence")
        n = self.states
        logp, path = _viterbi_decode(
            torch.as_tensor(observed.astype(np.int64), device=self.device),
            n, math.log(self.p_correct),
            math.log((1.0 - self.p_correct) / (n - 1)),
            math.log(self.meta_stability),
            math.log((1.0 - self.meta_stability) / (n - 1)))
        return _read(logp, path)
