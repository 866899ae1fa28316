"""Distributed corpus->vectors pipeline over the multi-process runtime,
the counterpart of the JAX package's `scaleout/text_pipeline.py`.

Parity: the reference builds Word2Vec vocab DISTRIBUTED before training —
Spark `TextPipeline` (spark/dl4j-spark-nlp/.../text/TextPipeline.java:
tokenize RDD -> word counts -> vocab cache) feeding `Word2VecPerformer`
(nlp/.../scaleout/perform/models/word2vec/Word2VecPerformer.java:88-140),
with `WordCountWorkPerformer` + Counter-merge aggregation as the counting
primitive (nlp/.../scaleout/perform/text/).

Design: two phases over the SAME control plane —

1. **count**: sentence-batch jobs -> `WordCountWorkPerformer` on worker
   processes -> `WordCountJobAggregator` Counter-merges each wave into
   the tracker's current model; the final merged counts come back to the
   driver.
2. **train**: the driver builds the `VocabCache` (+ Huffman codes) from
   those counts, seeds the packed embedding tables, and runs
   `Word2VecWorkPerformer` jobs whose averaged deltas land on the
   current model — no prebuilt vocab ever enters the run config from
   outside.

Worker processes join each phase by run name (`<run>-vocab`, then
`<run>-train`) via the standard launcher CLI (`python -m
deeplearning4j_tpu_torch.scaleout.launcher worker`); `ClusterSetup`
(scaleout/provision.py) can start them on provisioned hosts. The
counting is host code; the training runs on `device` (None = the CUDA
device, raising without one), which goes into the train phase's
performer conf, so every worker trains there and the driver seeds and
reads the tables there too.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.huffman import build_huffman
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.scaleout.api import CollectionJobIterator
from deeplearning4j_tpu_torch.scaleout.launcher import MultiProcessMaster
from deeplearning4j_tpu_torch.scaleout.perform_nlp import (
    DeltaAveragingAggregator,
    Word2VecWorkPerformer,
    WordCountJobAggregator,
)
from deeplearning4j_tpu_torch.scaleout.registry import ConfigRegistry

log = logging.getLogger(__name__)


def vocab_from_counts(counts: Dict[str, float],
                      min_word_frequency: float = 1.0) -> VocabCache:
    """Merged word counts -> VocabCache with Huffman codes (the driver
    half of the reference TextPipeline -> InMemoryLookupCache hand-off)."""
    cache = VocabCache()
    for word, count in counts.items():
        cache.add_token(word, float(count))
    cache.truncate(min_word_frequency)
    build_huffman(cache)
    return cache


def sentence_batches(sentences: Sequence[str], batch: int,
                     passes: int = 1) -> List[List[str]]:
    out = [list(sentences[i:i + batch])
           for i in range(0, len(sentences), batch)]
    return out * passes


class DistributedWord2Vec:
    """Raw corpus -> trained word vectors across worker PROCESSES, with
    the vocab itself built by the cluster (phase 1) rather than shipped
    in from outside.

    The driver (this class) hosts both phase masters; workers join each
    phase's run name (`<run>-vocab`, `<run>-train`) with the standard
    `python -m deeplearning4j_tpu_torch.scaleout.launcher worker` CLI.
    `device` is where the train phase's tables live, in every worker and
    in the driver.
    """

    def __init__(self, sentences: Sequence[str], *, run_name: str,
                 registry: ConfigRegistry, n_workers: int = 2,
                 sentences_per_job: int = 100, passes: int = 1,
                 min_word_frequency: float = 1.0, layer_size: int = 100,
                 window: int = 5, negative: int = 0,
                 learning_rate: float = 0.025, batch_pairs: int = 4096,
                 seed: int = 123, host: str = "127.0.0.1",
                 status_port: Optional[int] = None, device=None):
        self.sentences = list(sentences)
        self.run_name = run_name
        self.registry = registry
        self.n_workers = n_workers
        self.sentences_per_job = sentences_per_job
        self.passes = passes
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window = window
        self.negative = negative
        self.learning_rate = learning_rate
        self.batch_pairs = batch_pairs
        self.seed = seed
        self.host = host
        self.status_port = status_port
        self.device = None if device is None else str(device)
        self.vocab: Optional[VocabCache] = None
        self.counts: Optional[Dict[str, float]] = None

    # ------------------------------------------------------ phase 1: count
    def count_words(self, timeout: float = 120.0) -> Dict[str, float]:
        """Run the word-count phase (`<run>-vocab`); returns merged
        counts once every batch has been counted by some worker."""
        master = MultiProcessMaster(
            CollectionJobIterator(
                sentence_batches(self.sentences, self.sentences_per_job)),
            run_name=f"{self.run_name}-vocab",
            registry=self.registry,
            performer_class=("deeplearning4j_tpu_torch.scaleout."
                             "perform_nlp.WordCountWorkPerformer"),
            n_workers=self.n_workers,
            host=self.host,
            status_port=self.status_port,
            aggregator_factory=WordCountJobAggregator,
        )
        counts = master.run(timeout=timeout)
        if not counts:
            raise RuntimeError("word-count phase produced no counts")
        self.counts = dict(counts)
        log.info("distributed vocab: %d distinct words, %.0f tokens",
                 len(self.counts), sum(self.counts.values()))
        return self.counts

    def build_vocab(self) -> VocabCache:
        if self.counts is None:
            raise ValueError("count_words() first (or pass counts)")
        self.vocab = vocab_from_counts(self.counts, self.min_word_frequency)
        return self.vocab

    # ------------------------------------------------------ phase 2: train
    def _train_conf(self) -> Dict[str, Any]:
        assert self.vocab is not None
        return {
            "vocab": self.vocab.to_dict(),
            "layer_size": self.layer_size,
            "window": self.window,
            "negative": self.negative,
            "learning_rate": self.learning_rate,
            "total_words": self.vocab.total_word_count * self.passes,
            "batch_pairs": self.batch_pairs,
            "seed": self.seed,
            "device": self.device,
        }

    def train(self, timeout: float = 300.0):
        """Run the training phase (`<run>-train`); returns WordVectors
        built from the averaged final tables."""
        if self.vocab is None:
            self.build_vocab()
        conf = self._train_conf()
        seed_performer = Word2VecWorkPerformer()
        seed_performer.setup(conf)
        initial = seed_performer.pack()
        master = MultiProcessMaster(
            CollectionJobIterator(
                sentence_batches(self.sentences, self.sentences_per_job,
                                 self.passes)),
            run_name=f"{self.run_name}-train",
            registry=self.registry,
            performer_class=("deeplearning4j_tpu_torch.scaleout."
                             "perform_nlp.Word2VecWorkPerformer"),
            performer_conf=conf,
            n_workers=self.n_workers,
            host=self.host,
            status_port=self.status_port,
            aggregator_factory=DeltaAveragingAggregator,
            initial_params=initial,
        )
        final = master.run(timeout=timeout)
        if final is None:
            raise RuntimeError("training phase produced no model")
        seed_performer.update(np.asarray(final))
        return seed_performer.word_vectors()

    def fit(self, timeout: float = 300.0):
        """corpus -> counts -> vocab -> vectors (workers must join each
        phase as it opens — e.g. ClusterSetup-provisioned hosts running
        the launcher CLI against `<run>-vocab` then `<run>-train`)."""
        self.count_words(timeout=timeout)
        self.build_vocab()
        return self.train(timeout=timeout)
