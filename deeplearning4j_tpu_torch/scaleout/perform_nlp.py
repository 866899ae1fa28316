"""Distributed NLP performers: Word2Vec / GloVe / WordCount jobs over the
scaleout runtime, the counterpart of the JAX package's
`scaleout/perform_nlp.py`.

Parity: reference nlp/scaleout/perform —
`Word2VecPerformer` (Word2VecPerformer.java:88-140: train sentence jobs
against shared syn0/syn1, alpha decayed from the tracker's
NUM_WORDS_SO_FAR counter :91-:115, emit Word2VecResult DELTAS),
`GlovePerformer` (GlovePerformer.java + GloveWork/GloveResult: co-occurrence
batch jobs against shared w/c tables), and
`WordCountWorkPerformer` + `WordCountJobAggregator` (scaleout/perform/text/:
count words per job, Counter-merge aggregation).

Design: each job trains a batch on the performer's device (the conf's
"device" key; none = the CUDA device, raising without one) through the
same steps the single-process models use — `nlp/word2vec.py`'s
`SkipGramStep` for Word2Vec, and for GloVe one AdaGrad step of the
weighted least squares written out here. Only packed table vectors and
small counters cross the control plane. Delta results (new - old
tables) let the master apply averaged deltas onto the current model, so
concurrent workers compose like the reference's hogwild-with-averaging
instead of last-write-wins.

Host traffic of a job: the pairs are mined on the host (the JAX
package's numpy code and seeds) and uploaded once per mined chunk; the
tables stay on the device, the delta is taken there and copied to the
host once, as one float32 vector. Nothing inside the batch loop reads
from the device. Word2Vec draws its negatives from a generator on the
device, or takes them from the caller (`perform(job, negatives=...)`,
one (batch_pairs, negative) array per batch), which is how a test hands
in the JAX package's draws.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.scaleout.api import (Job, JobAggregator,
                                                   WorkerPerformer)

#: tracker counter key (reference Word2VecPerformer.NUM_WORDS_SO_FAR)
NUM_WORDS_SO_FAR = "word2vec_num_words_so_far"


def _flat(tables: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tables packed in name order, as one new tensor on their
    device."""
    return torch.cat([t.reshape(-1) for _, t in sorted(tables.items())])


def _unflat(packed, like: Dict[str, torch.Tensor],
            device) -> Dict[str, torch.Tensor]:
    """A packed host vector as tables shaped like `like`, uploaded in one
    copy."""
    flat = torch.from_numpy(np.ascontiguousarray(packed, np.float32)).to(
        device)
    out, offset = {}, 0
    for name, t in sorted(like.items()):
        out[name] = flat[offset:offset + t.numel()].view(t.shape)
        offset += t.numel()
    if offset != flat.numel():
        raise ValueError(f"packed vector has {flat.numel()} entries, the "
                         f"tables {offset}")
    return out


class Word2VecWorkPerformer(WorkerPerformer):
    """Train skip-gram on each job's sentence batch; result = table deltas.

    conf keys: `vocab` (VocabCache.to_dict()), `layer_size`, `window`,
    `negative`, `learning_rate`, `min_learning_rate`, `total_words`
    (expected corpus words x iterations, drives alpha decay), `sample`,
    `batch_pairs`, `seed`, `device`.
    """

    DEVICE = "device"

    def __init__(self, device=None):
        self.device = device
        self._w2v = None
        self._tracker = None
        self.alpha0 = 0.025
        self.min_alpha = 1e-4
        self.total_words = 1.0

    def bind_tracker(self, tracker) -> None:
        """Runtime hook: the live StateTracker drives alpha decay
        (reference Word2VecPerformer gets the tracker injected)."""
        self._tracker = tracker

    def setup(self, conf: Dict[str, Any]) -> None:
        from deeplearning4j_tpu_torch.nlp.huffman import max_code_length
        from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
        from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

        self.device = default_device(conf.get(self.DEVICE, self.device))
        self._w2v = Word2Vec(
            layer_size=int(conf.get("layer_size", 100)),
            window=int(conf.get("window", 5)),
            negative=int(conf.get("negative", 0)),
            learning_rate=float(conf.get("learning_rate", 0.025)),
            min_learning_rate=float(conf.get("min_learning_rate", 1e-4)),
            sample=float(conf.get("sample", 0.0)),
            batch_pairs=int(conf.get("batch_pairs", 4096)),
            seed=int(conf.get("seed", 123)),
            device=self.device,
        )
        self._w2v.vocab = VocabCache.from_dict(conf["vocab"])
        self._w2v._code_len = max(1, max_code_length(self._w2v.vocab))
        self._w2v.reset_weights()
        self.alpha0 = self._w2v.alpha
        self.min_alpha = self._w2v.min_alpha
        self.total_words = float(conf.get(
            "total_words", self._w2v.vocab.total_word_count))
        self._rng = np.random.RandomState(self._w2v.seed)

    # ------------------------------------------------------------- packing
    def _tables(self) -> Dict[str, torch.Tensor]:
        if self._w2v is None:
            raise RuntimeError("setup() not called")
        return self._w2v._tables()

    def pack(self) -> np.ndarray:
        """The tables as one float32 host vector (one copy)."""
        return _flat(self._tables()).cpu().numpy()

    def _install(self, packed: np.ndarray) -> None:
        for name, t in _unflat(packed, self._tables(), self.device).items():
            setattr(self._w2v, name, t)

    # ------------------------------------------------------------- perform
    def perform(self, job: Job,
                negatives: Optional[Sequence] = None) -> None:
        """job.work: list of sentences. Trains locally, result = delta.
        `negatives`, if given, holds each batch's (batch_pairs, negative)
        draws in batch order, in place of the device generator's."""
        from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
            CollectionSentenceIterator)

        w2v = self._w2v
        if w2v is None:
            raise RuntimeError("setup() not called")
        step = w2v._step()
        w2v.sentence_iter = CollectionSentenceIterator(list(job.work))
        tables = self._tables()
        before = _flat(tables)  # a copy on the device
        B = w2v.batch_pairs
        words_in_job = 0
        batch = 0
        for centers, contexts, n_words in w2v._iter_pair_chunks(self._rng):
            words_in_job += n_words
            # alpha from the CLUSTER-WIDE words counter (reference :91)
            so_far = (self._tracker.count(NUM_WORDS_SO_FAR)
                      if self._tracker is not None else 0.0)
            alpha = max(self.min_alpha,
                        self.alpha0 * (1.0 - so_far / self.total_words))
            cs, xs = w2v._indices(centers), w2v._indices(contexts)
            for lo in range(0, cs.numel(), B):
                bc, bx = cs[lo:lo + B], xs[lo:lo + B]
                n = bc.numel()
                if n < B:  # a short batch is padded as the JAX package's
                    pad = torch.arange(B - n, device=self.device) % max(1, n)
                    bc = torch.cat([bc, bc[pad]])
                    bx = torch.cat([bx, bx[pad]])
                if negatives is None:
                    ng = step.draw(B, w2v._neg_gen)
                else:
                    ng = w2v._indices(negatives[batch]).reshape(
                        B, w2v.negative)
                step(tables, bc, bx, ng, alpha)
                batch += 1
        if self._tracker is not None and words_in_job:
            self._tracker.increment(NUM_WORDS_SO_FAR, float(words_in_job))
        # DELTA (reference Word2VecResult): taken on the device, one copy
        job.result = (_flat(tables) - before).cpu().numpy()

    def update(self, *args: Any) -> None:
        """Install the master's current packed tables."""
        self._install(np.asarray(args[0]))

    # convenience for tests / consumers
    def word_vectors(self):
        from deeplearning4j_tpu_torch.nlp.word2vec import WordVectors
        return WordVectors(self._w2v.vocab, self._w2v.syn0)


def glove_job_step(params: Dict[str, torch.Tensor],
                   accum: Dict[str, torch.Tensor], rows: torch.Tensor,
                   cols: torch.Tensor, vals: torch.Tensor, lr: float,
                   x_max: float, alpha: float) -> torch.Tensor:
    """One AdaGrad step of GloVe's weighted least squares over a job's
    triples, in place on `params` and `accum` ({"w", "c", "bw", "bc"}):

        loss = 0.5 * sum(f(x) (w_r . c_c + bw_r + bc_c - log x)^2) / B,
        f(x) = min(1, (x / x_max)^alpha),
        a += g^2;  p -= lr * g / sqrt(a)

    over the dense per-row gradients (rows no triple touches do not
    move), as the JAX performer's `value_and_grad` step. Returns the
    loss as a 0-d device tensor; reads nothing from the device."""
    w, c, bw, bc = params["w"], params["c"], params["bw"], params["bc"]
    B = rows.numel()
    wr, wc = w[rows], c[cols]
    err = (wr * wc).sum(dim=1) + bw[rows] + bc[cols] - torch.log(vals)
    fx = torch.clamp_max((vals / x_max) ** alpha, 1.0)
    g = fx * err / B                                 # dLoss / dpred
    grads = {"w": torch.zeros_like(w).index_add_(0, rows,
                                                 g.unsqueeze(1) * wc),
             "c": torch.zeros_like(c).index_add_(0, cols,
                                                 g.unsqueeze(1) * wr),
             "bw": torch.zeros_like(bw).index_add_(0, rows, g),
             "bc": torch.zeros_like(bc).index_add_(0, cols, g)}
    names = sorted(params)
    ps = [params[k] for k in names]
    accums = [accum[k] for k in names]
    gs = [grads[k] for k in names]
    torch._foreach_addcmul_(accums, gs, gs)
    steps = torch._foreach_mul(gs, lr)
    torch._foreach_div_(steps, torch._foreach_sqrt(accums))
    torch._foreach_sub_(ps, steps)
    return 0.5 * (fx * err * err).sum() / B


class GloveWorkPerformer(WorkerPerformer):
    """Train GloVe on each job's co-occurrence triple batch; result = delta.

    conf keys: `vocab`, `layer_size`, `learning_rate`, `x_max`, `alpha`,
    `seed`, `device`. job.work: dict {rows, cols, vals} index arrays.
    The initial tables are uniform in +-0.5/dim from a `torch.Generator`
    seeded by `seed`, drawn on the CPU and moved (the JAX package draws
    them from `jax.random`; `weights.glove_work_state_from_jax` installs
    those)."""

    DEVICE = "device"

    def __init__(self, device=None):
        self.device = device
        self._params = None
        self._accum = None
        self.conf: Dict[str, Any] = {}

    def setup(self, conf: Dict[str, Any]) -> None:
        self.conf = dict(conf)
        self.device = default_device(conf.get(self.DEVICE, self.device))
        v = len(conf["vocab"]["words"])
        d = int(conf.get("layer_size", 50))
        self.lr = float(conf.get("learning_rate", 0.05))
        self.x_max = float(conf.get("x_max", 100.0))
        self.alpha = float(conf.get("alpha", 0.75))
        gen = torch.Generator().manual_seed(int(conf.get("seed", 123)))

        def uniform():
            u = torch.rand((v, d), generator=gen, dtype=torch.float32)
            return (u * (1.0 / d) - 0.5 / d).to(self.device)

        self._params = {"w": uniform(), "c": uniform(),
                        "bw": torch.zeros(v, device=self.device),
                        "bc": torch.zeros(v, device=self.device)}
        self._accum = {k: torch.full_like(p, 1e-8)
                       for k, p in self._params.items()}

    def pack(self) -> np.ndarray:
        return _flat(self._params).cpu().numpy()

    def _install(self, packed: np.ndarray) -> None:
        self._params = _unflat(packed, self._params, self.device)

    def perform(self, job: Job) -> None:
        if self._params is None:
            raise RuntimeError("setup() not called")
        work = job.work

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device)

        before = _flat(self._params)
        glove_job_step(self._params, self._accum,
                       up(work["rows"], np.int64), up(work["cols"], np.int64),
                       up(work["vals"], np.float32), self.lr, self.x_max,
                       self.alpha)
        job.result = (_flat(self._params) - before).cpu().numpy()

    def update(self, *args: Any) -> None:
        self._install(np.asarray(args[0]))


class WordCountWorkPerformer(WorkerPerformer):
    """Count words in each job's sentence batch (reference
    WordCountWorkPerformer — the distributed vocab-building primitive).
    Host code."""

    def __init__(self):
        from deeplearning4j_tpu_torch.nlp.tokenization import (
            DefaultTokenizerFactory)
        self.tokenizer_factory = DefaultTokenizerFactory()

    def setup(self, conf: Dict[str, Any]) -> None:
        pass

    def perform(self, job: Job) -> None:
        counts: Counter = Counter()
        for sentence in job.work:
            counts.update(self.tokenizer_factory.tokenize(sentence))
        job.result = dict(counts)

    def update(self, *args: Any) -> None:
        pass


class WordCountJobAggregator(JobAggregator):
    """Counter-merge aggregation (reference WordCountJobAggregator): wave
    counts merge INTO the running totals held as the current model."""

    def __init__(self):
        self.counts: Counter = Counter()

    def accumulate(self, job: Job) -> None:
        if job.result:
            self.counts.update(job.result)

    def aggregate(self) -> Optional[Dict[str, float]]:
        return dict(self.counts) if self.counts else None

    @staticmethod
    def apply(current, aggregated) -> Dict[str, float]:
        merged = Counter(current or {})
        merged.update(aggregated)
        return dict(merged)


class DeltaAveragingAggregator(JobAggregator):
    """Average delta vectors; publication applies `current + mean(delta)`
    (reference Word2VecJobAggregator semantics over Word2VecResult).
    Host numpy, float64 sums as the JAX package's."""

    def __init__(self):
        self._sum: Optional[np.ndarray] = None
        self._n = 0

    def accumulate(self, job: Job) -> None:
        if job.result is None:
            return
        r = np.asarray(job.result, np.float64)
        self._sum = r if self._sum is None else self._sum + r
        self._n += 1

    def aggregate(self) -> Optional[np.ndarray]:
        if self._sum is None:
            return None
        return (self._sum / self._n).astype(np.float32)

    @staticmethod
    def apply(current, aggregated) -> np.ndarray:
        if current is None:
            # publishing a bare delta would replace every worker's init
            # with near-zero garbage on the first replication
            raise ValueError(
                "DeltaAveragingAggregator needs the runtime constructed "
                "with initial_params (deltas apply onto a current model)")
        return np.asarray(current) + aggregated


__all__ = ["NUM_WORDS_SO_FAR", "Word2VecWorkPerformer", "GloveWorkPerformer",
           "WordCountWorkPerformer", "WordCountJobAggregator",
           "DeltaAveragingAggregator", "glove_job_step"]
