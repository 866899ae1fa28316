"""The port's distributed NLP performers
(`deeplearning4j_tpu_torch.scaleout.perform_nlp`) on the CPU.

The JAX package's `tests/test_perform_nlp.py` case for case on the port
(two workers learning topic structure from averaged Word2Vec deltas, a
job's result being the delta, GloVe deltas lowering the loss, the word
count's Counter merge), then parity with the JAX package on the same
conf, vocab, sentences and tables made from a numpy seed:

- one `Word2VecWorkPerformer` job with negative sampling (JAX's
  negatives replayed from its key chain, `uni_table[jax.random.randint(
  k, (B, neg), 0, 2**20)]`, and handed to the port's `perform`) and one
  with hierarchical softmax, JAX's tables carried across
  (`weights.word2vec_tables_from_jax`): each table's delta within
  STEP_TOL (1e-5) of its largest |entry|;
- one `GloveWorkPerformer` job from JAX's initial tables
  (`weights.glove_work_state_from_jax`): within 1e-5 the same way;
- `DeltaAveragingAggregator` and `WordCountJobAggregator` on the same
  jobs: equal to JAX's.

Every performer's conf carries `"device": "cpu"`; without it the port's
performers take the card, which raises here.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from deeplearning4j_tpu_torch.nlp.huffman import build_huffman
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import build_vocab
from deeplearning4j_tpu_torch.scaleout.api import CollectionJobIterator, Job
from deeplearning4j_tpu_torch.scaleout.perform_nlp import (
    NUM_WORDS_SO_FAR,
    DeltaAveragingAggregator,
    GloveWorkPerformer,
    Word2VecWorkPerformer,
    WordCountJobAggregator,
    WordCountWorkPerformer,
)
from deeplearning4j_tpu_torch.scaleout.runtime import DistributedRuntime
from deeplearning4j_tpu_torch.weights import (glove_work_state_from_jax,
                                              word2vec_tables_from_jax)

CPU = "cpu"
STEP_TOL = 1e-5  # tests/test_torch_nlp.py's one-step tolerance


def topic_sentences(n_reps=30):
    base = [
        "the cat sat on the mat",
        "the dog sat on the rug",
        "the cat and the dog play in the yard",
        "a furry cat chases a furry dog",
        "the king wears the crown in the castle",
        "the queen wears the crown in the castle",
        "a royal king and a royal queen sit on the throne",
    ]
    return base * n_reps


def built_vocab(sentences, min_freq=3.0):
    cache = build_vocab(sentences, DefaultTokenizerFactory(), min_freq)
    build_huffman(cache)
    return cache


def _fresh_performer(conf):
    p = Word2VecWorkPerformer()
    p.setup(conf)
    return p


# ------------------------------------------- the JAX package's cases
class TestDistributedWord2Vec:
    def test_two_workers_learn_topic_structure(self):
        """Sentence jobs fan out over the runtime, averaged deltas land
        on the current model. Every performer starts from the JAX
        performer's initial tables for this seed: the outcome of this
        corpus depends on the start in either package (seeds 1-8 fail
        for 2 of 8 starts in JAX, for others with the port's own draws),
        and from the same start the port lands where JAX does."""
        from deeplearning4j_tpu.scaleout import perform_nlp as jperform

        sentences = topic_sentences()
        vocab = built_vocab(sentences)
        conf = {"vocab": vocab.to_dict(), "layer_size": 32, "window": 3,
                "negative": 0, "learning_rate": 0.1,
                "total_words": vocab.total_word_count * 4,
                "batch_pairs": 512, "seed": 7, "device": CPU}
        batches = [sentences[i:i + 35]
                   for i in range(0, len(sentences), 35)] * 4

        jseed = jperform.Word2VecWorkPerformer()
        jseed.setup({k: v for k, v in conf.items() if k != "device"})
        initial = jseed.pack()

        def start():
            p = _fresh_performer(conf)
            p.update(initial)
            return p

        seed_performer = start()
        runtime = DistributedRuntime(
            CollectionJobIterator(batches),
            performer_factory=start,
            n_workers=2,
            aggregator_factory=DeltaAveragingAggregator,
            initial_params=initial,
        )
        final = runtime.run(timeout=300.0)
        assert final is not None and final.shape == initial.shape
        # the words counter drove alpha decay
        assert runtime.tracker.count(NUM_WORDS_SO_FAR) > 0
        seed_performer.update(final)
        wv = seed_performer.word_vectors()
        assert wv.similarity("cat", "dog") > wv.similarity("cat", "king")

    def test_delta_results_not_full_tables(self):
        sentences = topic_sentences(5)
        vocab = built_vocab(sentences)
        conf = {"vocab": vocab.to_dict(), "layer_size": 16, "window": 3,
                "negative": 0, "learning_rate": 0.05,
                "total_words": vocab.total_word_count, "batch_pairs": 256,
                "seed": 1, "device": CPU}
        performer = _fresh_performer(conf)
        before = performer.pack()
        job = Job(work=sentences[:20], worker_id="w0")
        performer.perform(job)
        # result is the delta, so before + delta == after
        assert job.result.dtype == np.float32
        np.testing.assert_allclose(before + job.result, performer.pack(),
                                   atol=1e-5)
        assert np.abs(job.result).max() > 0  # training moved something


class TestDistributedGlove:
    def test_delta_training_reduces_loss(self):
        from deeplearning4j_tpu_torch.nlp.glove import CoOccurrences
        from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
            CollectionSentenceIterator)

        sentences = topic_sentences()
        vocab = built_vocab(sentences)
        co = CoOccurrences(CollectionSentenceIterator(sentences),
                           DefaultTokenizerFactory(), vocab, window=3).calc()
        rows, cols, vals = co.triples()
        rng = np.random.RandomState(0)
        conf = {"vocab": vocab.to_dict(), "layer_size": 16,
                "learning_rate": 0.05, "seed": 3, "device": CPU}

        def glove_jobs(n_jobs=12, size=256):
            out = []
            for _ in range(n_jobs):
                sel = rng.randint(0, rows.size, size)
                out.append({"rows": rows[sel], "cols": cols[sel],
                            "vals": vals[sel]})
            return out

        def make():
            p = GloveWorkPerformer()
            p.setup(conf)
            return p

        seed_perf = make()
        initial = seed_perf.pack()
        runtime = DistributedRuntime(
            CollectionJobIterator(glove_jobs()),
            performer_factory=make, n_workers=2,
            aggregator_factory=DeltaAveragingAggregator,
            initial_params=initial)
        final = runtime.run(timeout=300.0)
        assert final is not None

        def glove_loss(packed, perf):
            perf._install(packed)
            p = {k: v.numpy() for k, v in perf._params.items()}
            w, c = p["w"][rows], p["c"][cols]
            pred = (w * c).sum(1) + p["bw"][rows] + p["bc"][cols]
            err = pred - np.log(vals)
            fx = np.minimum(1.0, vals / 100.0) ** 0.75
            return float(0.5 * np.mean(fx * err * err))

        assert glove_loss(final, seed_perf) < glove_loss(initial, seed_perf)


class TestWordCount:
    def test_counter_merge_aggregation(self):
        sentences = ["the cat", "the dog", "a cat"]
        jobs = [[s] for s in sentences]
        runtime = DistributedRuntime(
            CollectionJobIterator(jobs),
            performer_factory=WordCountWorkPerformer,
            n_workers=2,
            aggregator_factory=WordCountJobAggregator)
        final = runtime.run(timeout=60.0)
        assert final == {"the": 2, "cat": 2, "dog": 1, "a": 1}


# ------------------------------------------------- parity with JAX
def _jax_vocab_dict(sentences, min_freq=3.0):
    from deeplearning4j_tpu.nlp import huffman as jhuffman
    from deeplearning4j_tpu.nlp import tokenization as jtok
    from deeplearning4j_tpu.nlp import vocab as jvocab

    cache = jvocab.build_vocab(sentences, jtok.DefaultTokenizerFactory(),
                               min_freq)
    jhuffman.build_huffman(cache)
    return cache.to_dict()


def _split(vec, shapes):
    out, off = {}, 0
    for name, shape in sorted(shapes.items()):
        n = int(np.prod(shape))
        out[name] = vec[off:off + n].reshape(shape)
        off += n
    return out


def _rel(a, b, table) -> float:
    """max |a - b| over the largest |entry| of `table` (the JAX table
    after the job): the one-step test's measure."""
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / max(np.abs(table).max(), 1e-30))


def _jax_negatives(jperf, sentences):
    """The negatives JAX's perform() draws, batch by batch: its pairs
    mined from a copy of its RandomState, its key split once a batch."""
    from deeplearning4j_tpu.nlp.sentence_iterator import \
        CollectionSentenceIterator as JIter

    w2v = jperf._w2v
    rng = np.random.RandomState()
    rng.set_state(jperf._rng.get_state())
    w2v.sentence_iter = JIter(list(sentences))
    B, neg = w2v.batch_pairs, w2v.negative
    uni = w2v._unigram_table()
    key = w2v._key
    out = []
    for centers, _, _ in w2v._iter_pair_chunks(rng):
        for _ in range(0, centers.size, B):
            key, k = jax.random.split(key)
            draws = jax.random.randint(k, (B, neg), 0, uni.shape[0])
            out.append(np.array(uni[draws]))
    return out


@pytest.mark.parametrize("negative", [5, 0], ids=["ns", "hs"])
def test_word2vec_job_delta_matches_jax(negative):
    from deeplearning4j_tpu.scaleout import perform_nlp as jperform

    corpus = topic_sentences(4)
    conf = {"vocab": _jax_vocab_dict(corpus), "layer_size": 16,
            "window": 3, "negative": negative, "learning_rate": 0.05,
            "batch_pairs": 128, "seed": 5}
    jperf = jperform.Word2VecWorkPerformer()
    jperf.setup(dict(conf))
    perf = Word2VecWorkPerformer()
    perf.setup(dict(conf, device=CPU))
    tables = {k: np.asarray(v) for k, v in jperf._tables().items()}
    word2vec_tables_from_jax(perf._w2v, tables)
    job_sentences = corpus[:12]
    negs = _jax_negatives(jperf, job_sentences) if negative else None
    assert negs is None or len(negs) >= 2  # more than one batch, padded
    jjob = Job(work=list(job_sentences), worker_id="w0")
    tjob = Job(work=list(job_sentences), worker_id="w0")
    jperf.perform(jjob)
    perf.perform(tjob, negatives=negs)
    shapes = {k: v.shape for k, v in tables.items()}
    jd, td = _split(jjob.result, shapes), _split(tjob.result, shapes)
    assert tjob.result.dtype == np.float32
    assert tjob.result.shape == jjob.result.shape
    for name in shapes:
        after = tables[name] + jd[name]
        assert _rel(jd[name], td[name], after) <= STEP_TOL, name
    assert np.abs(jd["syn0"]).max() > 0


def test_glove_job_delta_matches_jax():
    from deeplearning4j_tpu.scaleout import perform_nlp as jperform

    corpus = topic_sentences(4)
    conf = {"vocab": _jax_vocab_dict(corpus), "layer_size": 12,
            "learning_rate": 0.05, "seed": 4}
    v = len(conf["vocab"]["words"])
    rng = np.random.RandomState(7)
    work = {"rows": rng.randint(0, v, 300), "cols": rng.randint(0, v, 300),
            "vals": (rng.rand(300) * 20 + 0.5).astype(np.float32)}
    jperf = jperform.GloveWorkPerformer()
    jperf.setup(dict(conf))
    perf = GloveWorkPerformer()
    perf.setup(dict(conf, device=CPU))
    glove_work_state_from_jax(
        perf, {k: np.asarray(p) for k, p in jperf._params.items()})
    np.testing.assert_array_equal(perf.pack(), jperf.pack())
    jjob, tjob = Job(work=work, worker_id="w"), Job(work=work, worker_id="w")
    jperf.perform(jjob)
    perf.perform(tjob)
    shapes = {k: tuple(p.shape) for k, p in jperf._params.items()}
    jd, td = _split(jjob.result, shapes), _split(tjob.result, shapes)
    for name in shapes:
        assert np.abs(jd[name]).max() > 0, name
        after = np.asarray(jperf._params[name])  # the table after the job
        assert _rel(jd[name], td[name], after) <= 1e-5, name


def test_aggregators_equal_jax_on_the_same_jobs():
    from deeplearning4j_tpu.scaleout import perform_nlp as jperform

    rng = np.random.RandomState(3)
    results = [rng.randn(50).astype(np.float32) for _ in range(3)]
    ours, theirs = DeltaAveragingAggregator(), \
        jperform.DeltaAveragingAggregator()
    for r in results + [None]:
        ours.accumulate(Job(work=None, worker_id="w", result=r))
        theirs.accumulate(Job(work=None, worker_id="w", result=r))
    agg = ours.aggregate()
    np.testing.assert_array_equal(agg, theirs.aggregate())
    current = rng.randn(50).astype(np.float32)
    np.testing.assert_array_equal(
        DeltaAveragingAggregator.apply(current, agg),
        jperform.DeltaAveragingAggregator.apply(current, agg))
    with pytest.raises(ValueError, match="initial_params"):
        DeltaAveragingAggregator.apply(None, agg)

    sentences = topic_sentences(1) + ["Hello, World! a b", "  spaced\tout "]
    ours, theirs = WordCountJobAggregator(), \
        jperform.WordCountJobAggregator()
    tperf, jperf = WordCountWorkPerformer(), \
        jperform.WordCountWorkPerformer()
    for s in sentences:
        tj, jj = Job(work=[s], worker_id="w"), Job(work=[s], worker_id="w")
        tperf.perform(tj)
        jperf.perform(jj)
        assert tj.result == jj.result
        ours.accumulate(tj)
        theirs.accumulate(jj)
    assert ours.aggregate() == theirs.aggregate()
    assert WordCountJobAggregator.apply({"the": 1}, ours.aggregate()) == \
        jperform.WordCountJobAggregator.apply({"the": 1},
                                              theirs.aggregate())


def test_no_device_means_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    conf = {"vocab": built_vocab(topic_sentences(2)).to_dict()}
    for cls in (Word2VecWorkPerformer, GloveWorkPerformer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls().setup(conf)
