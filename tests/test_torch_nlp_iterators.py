"""The PyTorch port's text iterators and helpers held against the JAX
package's: `nlp/documents.py` (document iterators, InvertedIndex),
`nlp/vectorizers.py`, `nlp/windows.py`, `nlp/word2vec_iterator.py`,
`utils/viterbi.py`, `utils/disk_based_queue.py` and `utils/math_utils.py`.

Inputs are made with numpy from a seed and handed to both packages, on
the CPU. Everything here is exact: documents and postings, mini-batches
(the same seeded subsampling), vectorizer matrices, windows and window
vectors, the queue's files byte for byte, Viterbi paths (the port's
float32 device loops against JAX's jitted scan, and the numpy backend in
both) and their log-probabilities, the DataSet batches of
Word2VecDataSetIterator / Word2VecDataFetcher over the same vectors, and
every math helper's value. The `cuda` test decodes on the card against
the numpy backend; it skips without one.
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import documents as jdocs
from deeplearning4j_tpu.nlp import sentence_iterator as jsent
from deeplearning4j_tpu.nlp import vectorizers as jvec
from deeplearning4j_tpu.nlp import windows as jwin
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu.nlp import word2vec_iterator as jw2vit
from deeplearning4j_tpu.utils import disk_based_queue as jqueue
from deeplearning4j_tpu.utils import math_utils as jmath
from deeplearning4j_tpu.utils import viterbi as jvit
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nlp import documents as tdocs
from deeplearning4j_tpu_torch.nlp import sentence_iterator as tsent
from deeplearning4j_tpu_torch.nlp import vectorizers as tvec
from deeplearning4j_tpu_torch.nlp import windows as twin
from deeplearning4j_tpu_torch.nlp import word2vec_iterator as tw2vit
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import disk_based_queue as tqueue
from deeplearning4j_tpu_torch.utils import math_utils as tmath
from deeplearning4j_tpu_torch.utils import viterbi as tvit
from deeplearning4j_tpu_torch.weights import word2vec_tables_from_jax

CPU = "cpu"


def zipf_docs(n_docs=40, vocab=60, seed=0, length=15):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    toks = rng.choice(vocab, size=(n_docs, length), p=p / p.sum())
    return [" ".join(f"w{t}" for t in row) for row in toks]


def corpus_tree(root):
    for label in ("pos", "neg"):
        d = root / label
        d.mkdir()
        for i in range(2):
            (d / f"{i}.txt").write_text(f"{label} document {i}")
    return str(root)


# ------------------------------------------------------------- documents
@pytest.mark.parametrize("kind", ["file", "label_aware"])
def test_document_iterators_match_jax(tmp_path, kind):
    root = corpus_tree(tmp_path)
    cls = {"file": "FileDocumentIterator",
           "label_aware": "LabelAwareDocumentIterator"}[kind]
    ji, ti = getattr(jdocs, cls)(root), getattr(tdocs, cls)(root)
    got, want = [], []
    while ti.has_next():
        doc = ti.next_document()
        got.append((doc, ti.current_label() if kind == "label_aware"
                    else None))
    while ji.has_next():
        doc = ji.next_document()
        want.append((doc, ji.current_label() if kind == "label_aware"
                     else None))
    assert got == want and len(got) == 4
    ti.reset()
    assert [d for d, _ in got] == list(ti)
    with pytest.raises(ValueError):
        getattr(tdocs, cls)(str(tmp_path / "missing"))


@pytest.mark.parametrize("sample", [0.0, 0.05, 0.5])
def test_inverted_index_matches_jax(sample):
    docs = [d.split() for d in zipf_docs()]
    ji = jdocs.InvertedIndex(sample=sample, seed=3)
    ti = tdocs.InvertedIndex(sample=sample, seed=3)
    for idx in (ji, ti):
        for d, words in enumerate(docs):
            idx.add_words_to_doc(d, words, label=f"l{d % 3}")
        idx.add_words_to_doc(len(docs) + 2, ["late", "w1"])  # a gap
        idx.add_label_for_doc(0, "extra")
    assert ti.num_documents() == ji.num_documents()
    np.testing.assert_array_equal(ti.all_docs(), ji.all_docs())
    for d in range(ti.num_documents()):
        assert ti.document(d) == ji.document(d)
        assert ti.document_with_label(d) == ji.document_with_label(d)
        assert ti.document_with_labels(d) == ji.document_with_labels(d)
        np.testing.assert_array_equal(ti.document_indices(d),
                                      ji.document_indices(d))
    for w in ["w0", "w1", "w7", "late", "unseen"]:
        np.testing.assert_array_equal(ti.documents(w), ji.documents(w))
    assert list(ti.batch_iter(7)) == list(ji.batch_iter(7))
    assert list(ti.mini_batches(16)) == list(ji.mini_batches(16))
    assert ti.sample() == ji.sample()
    ti.cleanup()
    assert ti.num_documents() == 0


# ----------------------------------------------------------- vectorizers
@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
@pytest.mark.parametrize("min_freq", [1, 3])
def test_vectorizers_match_jax(cls, min_freq):
    docs = zipf_docs()
    a = getattr(tvec, cls)(min_word_frequency=min_freq).fit_transform(docs)
    b = getattr(jvec, cls)(min_word_frequency=min_freq).fit_transform(docs)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- windows
class _Vectors:
    """A table both packages' window_as_vector read the same way."""

    def __init__(self, words, seed=0):
        self.words = list(words)
        self.syn0 = np.random.RandomState(seed).randn(
            len(words), 4).astype(np.float32)

    def get_word_vector(self, w):
        return self.syn0[self.words.index(w)] if w in self.words else None


class _Tagger:
    def tag(self, tokens):
        return [t.upper() for t in tokens]


class _Lexicon:
    def classify_tokens(self, tokens):
        return "long" if sum(map(len, tokens)) > 8 else None


@pytest.mark.parametrize("size", [1, 3, 5])
def test_windows_match_jax(size):
    tokens = "the cat sat on the mat today".split()
    vecs = _Vectors(tokens[:4])
    for jw, tw in zip(jwin.windows(tokens, size, label="x"),
                      twin.windows(tokens, size, label="x")):
        assert (tw.words, tw.focus_index, tw.label, tw.focus_word()) == \
            (jw.words, jw.focus_index, jw.label, jw.focus_word())
        np.testing.assert_array_equal(twin.window_as_vector(tw, vecs),
                                      jwin.window_as_vector(jw, vecs))
    spans = {(1, 3): "ANIMAL"}
    for jw, tw in zip(jwin.annotate_windows(tokens, size, _Tagger(),
                                            _Lexicon(), spans),
                      twin.annotate_windows(tokens, size, _Tagger(),
                                            _Lexicon(), spans)):
        assert (tw.words, tw.tags, tw.label, tw.focus_tag()) == \
            (jw.words, jw.tags, jw.label, jw.focus_tag())
    with pytest.raises(ValueError):
        twin.windows(tokens, 4)


@pytest.mark.parametrize("text", [
    "the <ANIMAL> big cat </ANIMAL> sat",
    "<B-LOC> new york </B-LOC> is <X_2> big </X_2>",
    "no labels here",
    "<A> open",
    "close </A>",
    "<A> <B> nested </B> </A>",
    "<A> mismatched </B>",
])
def test_string_with_labels_matches_jax(text):
    try:
        want = jwin.string_with_labels(text)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            twin.string_with_labels(text)
        return
    assert twin.string_with_labels(text) == want


# ----------------------------------------------------------- disk queue
def test_disk_queue_round_trips_and_bytes_match_jax(tmp_path):
    items = [{"words": ["a", "b"], "focus": 1, "label": None},
             np.arange(6, dtype=np.float32).reshape(2, 3),
             [1, 2.5, "x", {"k": (1, 2)}], "plain", 7]
    jq = jqueue.DiskBasedQueue(str(tmp_path / "j"))
    with tqueue.DiskBasedQueue(str(tmp_path / "t")) as tq:
        for it in items:
            jq.add(it)
            tq.add(it)
        assert tq.size() == len(tq) == len(items) and not tq.is_empty()
        for jp, tp in zip(jq._paths, tq._paths):
            with open(jp, "rb") as f, open(tp, "rb") as g:
                assert g.read() == f.read()
        assert tq.peek() == tq.element() == items[0]
        got = [tq.poll() for _ in range(2)]
        assert got[0] == items[0]
        np.testing.assert_array_equal(got[1], items[1])
        assert tq.remove() == [1, 2.5, "x", {"k": (1, 2)}]
        assert list(tq) == ["plain", 7]
        assert tq.poll() is None and tq.peek() is None
        with pytest.raises(IndexError):
            tq.remove()
        with pytest.raises(IndexError):
            tq.element()
        tq.add_all([torch.arange(3), 1])
        np.testing.assert_array_equal(tq.remove(), np.arange(3))
        tq.clear()
        assert tq.is_empty() and os.listdir(tq.dir) == []
    assert not os.path.exists(str(tmp_path / "t"))
    jq.close()


# -------------------------------------------------------------- Viterbi
def sequences(n=64, seed=0, states=4):
    rng = np.random.RandomState(seed)
    for i in range(n):
        t = 1 + rng.randint(0, 40)
        yield rng.randint(0, states, size=t)


@pytest.mark.parametrize("states,meta,p", [(2, 0.9, 0.99), (4, 0.9, 0.99),
                                           (5, 0.6, 0.7)])
def test_viterbi_decode_matches_jax(states, meta, p):
    jv = jvit.Viterbi(np.arange(states), meta_stability=meta, p_correct=p)
    tv = tvit.Viterbi(np.arange(states), meta_stability=meta, p_correct=p,
                      device=CPU)
    for obs in sequences(states=states):
        want = jv.decode(obs, binary_label_matrix=False)
        got = tv.decode(obs, binary_label_matrix=False)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0] == want[0]
        onehot = np.eye(states)[obs]
        np.testing.assert_array_equal(tv.decode(onehot)[1],
                                      jv.decode(onehot)[1])


def hmm(seed, states=5, t=30):
    rng = np.random.RandomState(seed)
    return (np.log(rng.dirichlet(np.ones(states))),
            np.log(rng.dirichlet(np.ones(states), size=states)),
            np.log(rng.dirichlet(np.ones(states), size=t)))


@pytest.mark.parametrize("seed", range(4))
def test_viterbi_path_backends_match_jax(seed):
    li, lt, le = hmm(seed, t=1 + 13 * seed)
    jl, jp = jvit.viterbi_path(li, lt, le, backend="jax")
    tl, tp = tvit.viterbi_path(li, lt, le, backend="torch", device=CPU)
    np.testing.assert_array_equal(tp, jp)
    assert tl == jl
    nl, npath = jvit.viterbi_path(li, lt, le, backend="numpy")
    ol, opath = tvit.viterbi_path(li, lt, le)
    np.testing.assert_array_equal(opath, npath)
    assert ol == nl
    np.testing.assert_array_equal(opath, jp)


def test_viterbi_ties_take_the_first_state_and_refusals():
    flat = np.zeros((6, 3))
    want = jvit.viterbi_path(np.zeros(3), np.zeros((3, 3)), flat,
                             backend="jax")
    got = tvit.viterbi_path(np.zeros(3), np.zeros((3, 3)), flat,
                            backend="torch", device=CPU)
    np.testing.assert_array_equal(got[1], want[1])
    assert not got[1].any()
    with pytest.raises(ValueError, match="backend"):
        tvit.viterbi_path(np.zeros(3), np.zeros((3, 3)), flat,
                          backend="xla", device=CPU)
    with pytest.raises(ValueError, match="frames"):
        tvit.viterbi_path(np.zeros(3), np.zeros((3, 3)), np.zeros((0, 3)))
    with pytest.raises(ValueError, match="2 states"):
        tvit.Viterbi([0], device=CPU)
    with pytest.raises(ValueError, match="empty"):
        tvit.Viterbi([0, 1], device=CPU).decode(np.zeros(0),
                                                binary_label_matrix=False)


@pytest.mark.cuda
def test_viterbi_on_the_card_matches_numpy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in range(8):
        li, lt, le = hmm(seed, t=64)
        got = tvit.viterbi_path(li, lt, le, backend="torch")
        np.testing.assert_array_equal(got[1],
                                      tvit.viterbi_path(li, lt, le)[1])
    v, c = tvit.Viterbi(np.arange(4)), tvit.Viterbi(np.arange(4), device=CPU)
    for obs in sequences(states=4):
        np.testing.assert_array_equal(v.decode(obs, False)[1],
                                      c.decode(obs, False)[1])


# ------------------------------------------------ Word2Vec DataSet bridge
SENTS = (["the cat sat on the mat"] * 6 + ["stocks fell on the market"] * 6)
LABELED = [("animals", "the cat sat on the mat"),
           ("finance", "stocks fell on the market"),
           ("animals", "the cat sat")]


def fitted_vectors():
    """The JAX package's fitted vectors, and the port's Word2Vec holding
    the same table (carried across, then its host view refreshed)."""
    kw = dict(layer_size=16, window=3, min_word_frequency=1, negative=2,
              iterations=1, seed=0)
    j = jw2v.Word2Vec(SENTS, **kw).fit()
    t = Word2Vec(SENTS, device=CPU, **kw)
    t.build_vocab()
    word2vec_tables_from_jax(t, {"syn0": np.asarray(j.syn0),
                                 "syn1neg": np.asarray(j.syn1neg)})
    t.refresh_vectors()
    return j, t


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("batch", [4, 64])
def test_dataset_iterator_matches_jax(spill, batch):
    j, t = fitted_vectors()
    ji = jw2vit.Word2VecDataSetIterator(
        j, jsent.LabelAwareSentenceIterator(LABELED),
        labels=["animals", "finance"], batch=batch, spill_to_disk=spill)
    ti = tw2vit.Word2VecDataSetIterator(
        t, tsent.LabelAwareSentenceIterator(LABELED),
        labels=["animals", "finance"], batch=batch, spill_to_disk=spill)
    assert ti.input_columns() == ji.input_columns() == 16 * 3
    assert ti.total_outcomes() == 2
    total = 0
    while ji.has_next():
        a, b = ji.next(), ti.next()
        np.testing.assert_array_equal(b.features, a.features)
        np.testing.assert_array_equal(b.labels, a.labels)
        total += b.num_examples
    assert not ti.has_next() and total == 6 + 5 + 3
    with pytest.raises(StopIteration):
        ti.next()
    ti.reset()
    assert ti.has_next()
    with pytest.raises(NotImplementedError):
        ti.total_examples()


def test_dataset_iterator_unknown_label_raises():
    _, t = fitted_vectors()
    it = tw2vit.Word2VecDataSetIterator(
        t, tsent.LabelAwareSentenceIterator(LABELED), labels=["animals"],
        batch=64)
    with pytest.raises(ValueError, match="finance"):
        while it.has_next():
            it.next()


def test_data_fetcher_matches_jax(tmp_path):
    for label, lines in [("animals", ["the cat sat on the mat",
                                      "the dog sat on the rug"]),
                         ("finance", ["stocks fell on the market"])]:
        d = tmp_path / label
        d.mkdir()
        (d / "doc.txt").write_text("\n".join(lines) + "\n")
    corpus = ["the cat sat on the mat the dog sat on the rug "
              "stocks fell on the market"] * 10
    kw = dict(layer_size=8, window=3, min_word_frequency=1, iterations=1,
              seed=0)
    j = jw2v.Word2Vec(corpus, **kw).fit()
    t = Word2Vec(corpus, device=CPU, **kw)
    t.build_vocab()
    word2vec_tables_from_jax(t, {"syn0": np.asarray(j.syn0),
                                 "syn1": np.asarray(j.syn1)})
    t.refresh_vectors()
    a = jw2vit.Word2VecDataFetcher(j, str(tmp_path), batch=64).next()
    f = tw2vit.Word2VecDataFetcher(t, str(tmp_path), batch=64)
    assert f.total_outcomes() == 2
    b = f.next()
    assert b.features.shape == (6 + 6 + 5, 8 * 3)
    np.testing.assert_array_equal(b.features, a.features)
    np.testing.assert_array_equal(b.labels, a.labels)


def test_end_to_end_classification_with_viterbi():
    """The JAX package's pipeline case on the port: an MLP on window
    vectors, its per-window predictions smoothed by Viterbi; the smoothed
    path equals JAX's viterbi_smooth on the same predictions."""
    _, t = fitted_vectors()
    it = tw2vit.Word2VecDataSetIterator(
        t, tsent.LabelAwareSentenceIterator(LABELED),
        labels=["animals", "finance"], batch=64)
    ds = it.next()
    conf = (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(it.input_columns()).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(60).use_adagrad(False)
            .list(2).hidden_layer_sizes([16])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=2)
            .pretrain(False).build())
    net = MultiLayerNetwork(conf, device=CPU)
    net.fit(ds.features, ds.labels)
    probs = net.output(ds.features).detach().numpy()
    noisy = probs.copy()
    noisy[2] = 1.0 - noisy[2]
    smoothed = tw2vit.viterbi_smooth(noisy[:6], device=CPU)
    assert smoothed.shape == (6,)
    truth = np.argmax(ds.labels[:6], axis=1)
    assert (smoothed == truth).mean() >= 5 / 6
    np.testing.assert_array_equal(smoothed, jw2vit.viterbi_smooth(noisy[:6]))
    with pytest.raises(ValueError):
        tw2vit.viterbi_smooth(np.ones(5), device=CPU)


# ------------------------------------------------------------ math_utils
VEC = [0.5, 1.5, -2.0, 3.25, 0.0]
POS = [0.1, 0.2, 0.3, 0.4]
Y = [1.0, 2.5, 2.0, 4.5, 3.0]
MATH_CASES = [
    ("normalize", (3.0, 1.0, 5.0)), ("clamp", (7, 0, 5)),
    ("discretize", (0.37, 0.0, 1.0, 10)), ("next_pow_2", (37,)),
    ("sigmoid", (0.3,)), ("kronecker_delta", (2.0, 2.0)),
    ("factorial", (6.0,)), ("permutation", (6.0, 2.0)),
    ("combination", (6.0, 2.0)), ("hypotenuse", (3.0, 4.0)),
    ("prob_to_log_odds", (0.25,)), ("round_double", (3.14159, 2)),
    ("vector_length", (VEC,)), ("sum_of_squares", (VEC,)),
    ("sum_", (VEC,)), ("times", (VEC[:4],)),
    ("sum_of_products", (VEC, Y)), ("variance", (VEC,)),
    ("min_", (VEC,)), ("max_", (VEC,)), ("max_index", (VEC,)),
    ("normalize_to_one", (POS,)), ("logs2probs", (VEC,)),
    ("log2", (8.0,)), ("entropy", (POS,)), ("information", (POS,)),
    ("idf", (10.0, 3.0)), ("tf", (4,)), ("tfidf", (0.5, 0.25)),
    ("string_similarity", ("night", "nacht")),
    ("correlation", (VEC, Y)), ("ss_reg", (VEC, Y)),
    ("ss_error", (VEC, Y)), ("ss_total", (VEC, Y)),
    ("squared_loss", (VEC, Y, 0.5, 1.5)), ("w_1", (VEC, Y, 5)),
    ("w_0", (VEC, Y, 5)), ("error_for", (2.0, 1.5)),
    ("root_means_squared_error", (VEC, Y)),
    ("determination_coefficient", (VEC, Y, 5)),
    ("adjusted_r_squared", (0.8, 2, 20)),
]


@pytest.mark.parametrize("name,args", MATH_CASES,
                         ids=[c[0] for c in MATH_CASES])
def test_math_utils_match_jax(name, args):
    want = getattr(jmath, name)(*args)
    got = getattr(tmath, name)(*args)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args", [("binomial", (10, 0.3)),
                                       ("uniform", (-1.0, 2.0)),
                                       ("prob_round", (2.4,))])
def test_math_utils_random_helpers_match_jax(name, args):
    def call(mod, seed):
        rng, fn = np.random.RandomState(seed), getattr(mod, name)
        return fn(*args, rng) if name == "prob_round" else fn(rng, *args)

    for seed in range(5):
        assert call(tmath, seed) == call(jmath, seed)
