"""GloVe: co-occurrence counting + weighted least-squares embedding.

Parity: reference nlp/models/glove/ — `CoOccurrences` (windowed
co-occurrence counting with 1/distance weighting, CoOccurrences.java:355),
`GloveWeightLookupTable` (AdaGrad weighted-LSQ update, the f(X)=min(1,
(X/xMax)^alpha) weighting) and `Glove` (shuffled co-occurrence training,
Glove.java:57,:106-160). The port's counterpart of the JAX package's
`nlp/glove.py`.

Design: `CoOccurrences.calc` is the JAX package's host numpy, so the
(i, j, X_ij) triples are identical. They upload once and stay on the
device. An epoch keeps the JAX package's order: a permutation (from a
generator on the device, or given), the wrap-around pad
`perm[arange(n_pad) % n]`, then one AdaGrad step a batch over the
weighted-LSQ loss `0.5 * sum(f(x) * err^2) / B`: gathers in, the
gradients written out and summed per row by `index_add_` into dense
(V, D) / (V,) gradients, then per parameter `a += g * g` (accumulators
start at 1e-8) and `p -= lr * g / sqrt(a)`. Nothing inside an epoch reads
from the device; `train_epochs` reads back once, at its end.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    CollectionSentenceIterator,
    SentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab
from deeplearning4j_tpu_torch.nlp.word2vec import WordVectors, read_back

log = logging.getLogger(__name__)

#: the parameters' names, in the order the epoch updates them
PARAM_NAMES = ("w", "c", "bw", "bc")


class CoOccurrences:
    """Windowed co-occurrence counts weighted by 1/distance
    (reference CoOccurrences.java)."""

    def __init__(self, sentences: SentenceIterator,
                 tokenizer_factory: TokenizerFactory,
                 cache: VocabCache, window: int = 5,
                 symmetric: bool = True):
        self.sentences = sentences
        self.tokenizer_factory = tokenizer_factory
        self.cache = cache
        self.window = window
        self.symmetric = symmetric
        self._rows = np.empty(0, np.int32)
        self._cols = np.empty(0, np.int32)
        self._vals = np.empty(0, np.float32)

    def calc(self) -> "CoOccurrences":
        """Vectorized windowed counting: the corpus becomes ONE index
        array with -1 sentence separators; for each offset d the pair
        streams are sliced arrays (validity = no separator within the
        window, via a cumulative separator count), and aggregation is a
        sort-free np.unique over packed (row*V + col) keys. The
        reference's per-token loop (CoOccurrences.java) is O(corpus)
        Python dict updates — this handles a 10M-token corpus in
        seconds instead of minutes."""
        chunks = []
        sep = np.asarray([-1], np.int64)
        for sentence in self.sentences:
            toks = self.tokenizer_factory.tokenize(sentence)
            idxs = [self.cache.index_of(t) for t in toks]
            idxs = [i for i in idxs if i >= 0]
            if idxs:
                chunks.append(np.asarray(idxs, np.int64))
                chunks.append(sep)
        if not chunks:
            return self
        seq = np.concatenate(chunks)
        v = max(self.cache.num_words(), 1)
        n_sep = np.cumsum(seq < 0)
        keys_list, w_list = [], []
        for off in range(1, self.window + 1):
            if off >= seq.size:
                break
            # window unbroken: no separator strictly inside (i, i+off]
            # AND the left element itself is not a separator (the cumsum
            # difference does not count position i)
            valid = (n_sep[off:] - n_sep[:-off]) == 0
            valid &= seq[:-off] >= 0
            a = seq[:-off][valid]
            b = seq[off:][valid]
            if a.size == 0:
                continue
            w = np.full(a.size, 1.0 / off, np.float64)  # 1/distance
            keys_list.append(a * v + b)
            w_list.append(w)
            if self.symmetric:
                keys_list.append(b * v + a)
                w_list.append(w)
        if not keys_list:
            return self
        keys = np.concatenate(keys_list)
        weights = np.concatenate(w_list)
        uniq, inverse = np.unique(keys, return_inverse=True)
        sums = np.bincount(inverse, weights=weights)
        self._rows = (uniq // v).astype(np.int32)
        self._cols = (uniq % v).astype(np.int32)
        self._vals = sums.astype(np.float32)
        return self

    @property
    def counts(self) -> Dict[Tuple[int, int], float]:
        """READ-ONLY dict view of the counts, rebuilt on every access
        (small-corpus convenience; the training path uses triples()
        arrays directly). Mutating the returned dict does NOT write back
        into the accumulator — modify via count()/accumulate instead."""
        return defaultdict(float, {
            (int(r), int(c)): float(x)
            for r, c, x in zip(self._rows, self._cols, self._vals)})

    def triples(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._rows, self._cols, self._vals


def glove_epoch(params: Dict[str, torch.Tensor],
                accum: Dict[str, torch.Tensor], rows: torch.Tensor,
                cols: torch.Tensor, vals: torch.Tensor, perm: torch.Tensor,
                batch_size: int, lr: float, x_max: float,
                alpha: float) -> torch.Tensor:
    """One shuffled AdaGrad epoch over the triples, in place on `params`
    and `accum` ({"w", "c", "bw", "bc"}). `perm` is a permutation of the
    n triples on their device; the epoch pads it to whole batches by
    wrap-around (`perm[arange(n_pad) % n]`). Returns the last batch's
    loss as a 0-d device tensor; reads nothing from the device."""
    n, B = rows.numel(), batch_size
    n_pad = (n + B - 1) // B * B
    order = perm
    if n_pad != n:
        order = perm[torch.arange(n_pad, device=perm.device) % n]
    rb = rows[order].view(-1, B)
    cb = cols[order].view(-1, B)
    xb = vals[order].view(-1, B)
    # per-triple constants, element for element the JAX step's
    log_x = torch.log(xb)
    fx = torch.clamp_max((xb / x_max) ** alpha, 1.0)
    w, c, bw, bc = (params[k] for k in PARAM_NAMES)
    accums = [accum[k] for k in PARAM_NAMES]
    ps = [w, c, bw, bc]
    loss = None
    for i in range(rb.shape[0]):
        r, cc = rb[i], cb[i]
        wr, wc = w[r], c[cc]
        err = (wr * wc).sum(dim=1) + bw[r] + bc[cc] - log_x[i]
        g = fx[i] * err / B                     # dLoss / dpred
        g_w = torch.zeros_like(w).index_add_(0, r, g.unsqueeze(1) * wc)
        g_c = torch.zeros_like(c).index_add_(0, cc, g.unsqueeze(1) * wr)
        g_bw = torch.zeros_like(bw).index_add_(0, r, g)
        g_bc = torch.zeros_like(bc).index_add_(0, cc, g)
        grads = [g_w, g_c, g_bw, g_bc]
        torch._foreach_addcmul_(accums, grads, grads)
        steps = torch._foreach_mul(grads, lr)
        torch._foreach_div_(steps, torch._foreach_sqrt(accums))
        torch._foreach_sub_(ps, steps)
        if i == rb.shape[0] - 1:
            loss = 0.5 * (fx[i] * err * err).sum() / B
    return loss


class Glove(WordVectors):
    """GloVe trainer (reference Glove.java builder semantics: layerSize,
    xMax, alpha, learningRate, iterations, window, minWordFrequency).
    `device` (None = the card, raising without one) holds the
    parameters, the accumulators and the triples."""

    def __init__(self, sentences=None, *, layer_size: int = 100,
                 window: int = 5, min_word_frequency: float = 1.0,
                 iterations: int = 5, learning_rate: float = 0.05,
                 x_max: float = 100.0, alpha: float = 0.75,
                 batch_size: int = 8192, seed: int = 123,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 device=None):
        self.device = default_device(device)
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.iterations = iterations
        self.lr = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.seed = seed
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        if isinstance(sentences, SentenceIterator):
            self.sentence_iter = sentences
        elif sentences is not None:
            self.sentence_iter = CollectionSentenceIterator(list(sentences))
        else:
            self.sentence_iter = None
        self.vocab = VocabCache()
        self.co: Optional[CoOccurrences] = None
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._accum: Optional[Dict[str, torch.Tensor]] = None
        self._triples = None
        self._device_triples = None
        self._epoch_gen: Optional[torch.Generator] = None

    def prepare(self) -> "Glove":
        """Corpus pass: vocab + co-occurrence counting (reference
        Glove.java :106 CoOccurrences.calc) and parameter init (w and c
        uniform in +-0.5/dim from `torch.Generator` seeded by `seed`,
        drawn on the CPU and moved). Split from training so repeated
        train_epochs calls (resumed training, benchmarks) don't re-mine
        the corpus."""
        build_vocab(self.sentence_iter, self.tokenizer_factory,
                    self.min_word_frequency, self.vocab)
        self.co = CoOccurrences(self.sentence_iter, self.tokenizer_factory,
                                self.vocab, window=self.window).calc()
        rows, cols, vals = self.co.triples()
        if rows.size == 0:
            raise ValueError("No co-occurrences (corpus too small)")
        self._triples = (rows, cols, vals)
        v, d = self.vocab.num_words(), self.layer_size
        gen = torch.Generator().manual_seed(self.seed)

        def uniform():
            u = torch.rand((v, d), generator=gen, dtype=torch.float32)
            return (u * (1.0 / d) - 0.5 / d).to(self.device)

        self._params = {"w": uniform(), "c": uniform(),
                        "bw": torch.zeros(v, device=self.device),
                        "bc": torch.zeros(v, device=self.device)}
        # per-parameter AdaGrad accumulators (GloveWeightLookupTable parity)
        self._accum = {k: torch.full_like(p, 1e-8)
                       for k, p in self._params.items()}
        # the shuffle's own stream, on the device
        self._epoch_gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 0x5e)
        self._device_triples = None  # re-prepare invalidates the cache
        return self

    def device_triples(self) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """The triples on the device (rows and cols int64, values
        float32), uploaded at the first call and kept."""
        if self._triples is None:
            raise ValueError("call prepare() before train_epochs()")
        if self._device_triples is None:
            rows, cols, vals = self._triples
            self._device_triples = (
                torch.from_numpy(rows).to(self.device, torch.int64),
                torch.from_numpy(cols).to(self.device, torch.int64),
                torch.from_numpy(vals).to(self.device))
        return self._device_triples

    def run_epochs(self, n_epochs: int,
                   perms: Optional[Sequence] = None) -> torch.Tensor:
        """n shuffled epochs with no read from the device; the last
        batch's loss as a 0-d device tensor. `perms`, if given, holds
        each epoch's permutation of the triples (numpy or tensors) in
        place of the device generator's."""
        if n_epochs < 1:
            raise ValueError(f"n_epochs must be >= 1, got {n_epochs}")
        if perms is not None and len(perms) != n_epochs:
            raise ValueError(f"{len(perms)} permutations for "
                             f"{n_epochs} epochs")
        rows, cols, vals = self.device_triples()
        loss = None
        for e in range(n_epochs):
            if perms is None:
                perm = torch.randperm(rows.numel(), generator=self._epoch_gen,
                                      device=self.device)
            else:
                perm = perms[e]
                if not isinstance(perm, torch.Tensor):
                    perm = torch.from_numpy(np.array(perm))
                perm = perm.to(self.device, torch.int64)
            loss = glove_epoch(self._params, self._accum, rows, cols, vals,
                               perm, self.batch_size, self.lr, self.x_max,
                               self.alpha)
        return loss

    def train_epochs(self, n_epochs: int,
                     perms: Optional[Sequence] = None) -> float:
        """Run n shuffled epochs over the prepared co-occurrence triples
        and refresh the WordVectors view (syn0 = w + c), reading back
        once. Returns the final batch loss."""
        if self._triples is None:
            raise ValueError("call prepare() before train_epochs()")
        loss = self.run_epochs(n_epochs, perms)
        syn0, final = read_back(self._params["w"] + self._params["c"], loss)
        WordVectors.__init__(self, self.vocab, syn0)
        return final

    def fit(self) -> "Glove":
        self.prepare()
        loss = self.train_epochs(self.iterations)
        log.info("glove trained: %d triples, final loss %.4f",
                 self._triples[0].size, loss)
        return self
