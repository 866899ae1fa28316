"""The PyTorch port's word-vector stack (deeplearning4j_tpu_torch/nlp/:
tokenization, sentence iterators, vocab, Huffman, Word2Vec, GloVe,
ParagraphVectors, serializer) held against the JAX package's `nlp/`.

Inputs are corpora made with numpy from a seed and handed to both
packages, on the CPU. Exact: tokens, vocab order and counts (ties
included), Huffman codes and points, the unigram table, keep
probabilities, mined pairs, ParagraphVectors' chunk order,
co-occurrence triples, serializer bytes (and each package's file loads
in the other).

Tolerances (float32, relative to the largest |entry| of each table):
one Word2Vec step within 1e-5, with the JAX package's tables carried
across (`weights.word2vec_tables_from_jax`) and the negatives JAX draws
for the step's key (`uni_table[jax.random.randint(k, (B, neg), 0,
2**20)]`) injected into the port's; a `train_pairs` run (chunks, tail,
tiling), an HS `fit` end to end and two GloVe epochs (JAX's
`jax.random.permutation` orders, `weights.glove_state_from_jax`) within
1e-4. The cases of the JAX package's `tests/test_nlp.py` then run on the
port itself (topic structure, tiling up, unknown words, PV retrieval).
`device=None` raises without a card. The `cuda` tests hold the card
against the CPU on the same inputs; they skip without one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import huffman as jhuffman
from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import sentence_iterator as jsent
from deeplearning4j_tpu.nlp import serializer as jser
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu_torch.nlp import (
    BagOfWordsVectorizer,
    CollectionSentenceIterator,
    CoOccurrences,
    DefaultTokenizerFactory,
    Glove,
    LabelAwareSentenceIterator,
    LineSentenceIterator,
    NGramTokenizerFactory,
    ParagraphVectors,
    TfidfVectorizer,
    Word2Vec,
    WhitespaceTokenizerFactory,
    build_huffman,
    load_word_vectors,
    save_word_vectors,
)
from deeplearning4j_tpu_torch.nlp import sentence_iterator as tsent
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi
from deeplearning4j_tpu_torch.weights import (glove_state_from_jax,
                                              word2vec_tables_from_jax)

STEP_TOL = 1e-5   # one step, relative to the largest |entry|
RUN_TOL = 1e-4    # a train_pairs run, a fit or two epochs, the same way
CPU = "cpu"


def toy_corpus(n_reps=40):
    """Two topic clusters so embeddings have signal (the JAX package's
    tests/test_nlp.py corpus)."""
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


def zipf_corpus(n_tokens=3000, vocab=300, seed=0, sent_len=12):
    """Zipfian sentences (many count ties in the tail), from a seed."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    toks = rng.choice(vocab, size=n_tokens, p=p / p.sum())
    return [" ".join(f"w{t}" for t in toks[i:i + sent_len])
            for i in range(0, n_tokens, sent_len)]


def labeled_pairs():
    corpus = toy_corpus(20)
    return ([("animals", s) for s in corpus[:3 * 20]]
            + [("royalty", s) for s in corpus[3 * 20:]])


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def jax_tables(model) -> dict:
    return {k: np.asarray(getattr(model, k)) for k in
            ("syn0", "syn1", "syn1neg") if getattr(model, k) is not None}


def w2v_pair(corpus, **kw):
    """The same Word2Vec in both packages, vocab built, the port's
    tables carried from JAX's fresh ones."""
    j = jw2v.Word2Vec(corpus, **kw)
    j.build_vocab()
    j.reset_weights()
    t = Word2Vec(corpus, device=CPU, **kw)
    t.build_vocab()
    word2vec_tables_from_jax(t, jax_tables(j))
    return j, t


def jax_negatives(key, shape, uni):
    draws = jax.random.randint(key, shape, 0, uni.shape[0])
    return np.asarray(uni[draws])


# ------------------------------------------------------------------ text
TEXTS = ["Hello, World! It's me.", "a b c d", "  spaced\tout  words\n",
         "Ünïcode café's naïve-ness, 3.14 and x_y", ""]


@pytest.mark.parametrize("factory", ["default", "whitespace", "ngram",
                                     "stem", "ws_pre"])
def test_tokenizers_match_jax(factory):
    def make(mod):
        return {"default": lambda: mod.DefaultTokenizerFactory(),
                "whitespace": lambda: mod.WhitespaceTokenizerFactory(),
                "ngram": lambda: mod.NGramTokenizerFactory(1, 3),
                "stem": lambda: mod.DefaultTokenizerFactory(
                    mod.stem_ending_preprocessor),
                "ws_pre": lambda: mod.WhitespaceTokenizerFactory(
                    lambda t: t.strip(",!").lower())}[factory]()
    for text in TEXTS + zipf_corpus(200):
        assert make(ttok).tokenize(text) == make(jtok).tokenize(text)


def test_sentence_iterators_match_jax(tmp_path):
    (tmp_path / "a.txt").write_text("line one\n\nline two\n")
    sub = tmp_path / "d"
    sub.mkdir()
    (sub / "b.txt").write_text("third\nfourth\n")
    pairs = [("pos", "good"), ("neg", "bad")]
    for mod_j, mod_t, make in (
            (jsent, tsent, lambda m: m.CollectionSentenceIterator(
                ["one", "two"])),
            (jsent, tsent, lambda m: m.LineSentenceIterator(
                str(tmp_path / "a.txt"))),
            (jsent, tsent, lambda m: m.FileSentenceIterator(str(tmp_path))),
            (jsent, tsent, lambda m: m.LabelAwareSentenceIterator(pairs))):
        ji, ti = make(mod_j), make(mod_t)
        assert list(ti) == list(ji) and list(ti) == list(ji)
    ti, ji = tsent.LabelAwareSentenceIterator(pairs), \
        jsent.LabelAwareSentenceIterator(pairs)
    got = []
    while ti.has_next():
        got.append((ti.next_sentence(), ti.current_label()))
    want = []
    while ji.has_next():
        want.append((ji.next_sentence(), ji.current_label()))
    assert got == want


# ------------------------------------------------------------ vocab, tree
@pytest.mark.parametrize("min_freq", [1, 2, 3])
@pytest.mark.parametrize("corpus", ["toy", "zipf"])
def test_vocab_and_huffman_match_jax(min_freq, corpus):
    sents = toy_corpus(3) if corpus == "toy" else zipf_corpus()
    jc = jvocab.build_vocab(sents, jtok.DefaultTokenizerFactory(), min_freq)
    tc = build_vocab(sents, DefaultTokenizerFactory(), min_freq)
    assert tc.words() == jc.words()  # index order, count ties included
    assert [v.count for v in tc.vocab_words()] == \
        [v.count for v in jc.vocab_words()]
    assert (tc.total_word_count, tc.num_docs) == \
        (jc.total_word_count, jc.num_docs)
    assert all(tc.doc_frequency(w) == jc.doc_frequency(w)
               for w in jc.words())
    jhuffman.build_huffman(jc)
    build_huffman(tc)
    for a, b in zip(jc.vocab_words(), tc.vocab_words()):
        assert (a.word, a.index, a.codes, a.points) == \
            (b.word, b.index, b.codes, b.points)
    assert tc.to_dict() == jc.to_dict()
    back = jvocab.VocabCache.from_dict(tc.to_dict())
    assert back.to_dict() == jc.to_dict()
    assert VocabCache.from_dict(jc.to_dict()).to_dict() == tc.to_dict()


def test_huffman_single_word_and_empty():
    for words in ([], ["only"]):
        jc, tc = jvocab.VocabCache(), VocabCache()
        for c in (jc, tc):
            for w in words:
                c.add_token(w)
                c.add_word_to_index(w)
        jhuffman.build_huffman(jc)
        build_huffman(tc)
        assert [(v.codes, v.points) for v in tc.vocab_words()] == \
            [(v.codes, v.points) for v in jc.vocab_words()]


# -------------------------------------------------------- host-side mining
@pytest.mark.parametrize("sample", [0.0, 1e-3])
@pytest.mark.parametrize("window", [2, 5])
def test_tables_and_mined_pairs_match_jax(sample, window):
    kw = dict(layer_size=8, window=window, min_word_frequency=1,
              negative=5, sample=sample, seed=4)
    j = jw2v.Word2Vec(zipf_corpus(), **kw)
    t = Word2Vec(zipf_corpus(), device=CPU, **kw)
    j.build_vocab()
    t.build_vocab()
    np.testing.assert_array_equal(t._unigram_table(),
                                  np.asarray(j._unigram_table()))
    for a, b in zip(t._codes_points(), j._codes_points()):
        np.testing.assert_array_equal(a, b)
    if sample:
        np.testing.assert_array_equal(t._keep_probs(), j._keep_probs())
    jc, jx = j.mine_pairs()
    tc, tx = t.mine_pairs()
    assert tc.dtype == np.int32 and tc.size > 0
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tx, jx)
    # the chunked stream too, chunk by chunk
    for (a, b, n), (c, d, m) in zip(
            t._iter_pair_chunks(np.random.RandomState(2), chunk_tokens=500),
            j._iter_pair_chunks(np.random.RandomState(2), chunk_tokens=500)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        assert n == m


def test_paragraph_vectors_chunk_order_matches_jax():
    kw = dict(layer_size=8, window=3, min_word_frequency=3, seed=5)
    j = jpv.ParagraphVectors(labeled_pairs(), **kw)
    t = ParagraphVectors(labeled_pairs(), device=CPU, **kw)
    j.build_vocab()
    t.build_vocab()
    assert t.vocab.words() == j.vocab.words()
    assert t.labels == j.labels
    js = list(j._iter_pair_chunks(np.random.RandomState(0), chunk_tokens=64))
    ts = list(t._iter_pair_chunks(np.random.RandomState(0), chunk_tokens=64))
    assert len(ts) == len(js) > 2
    for (a, b, n), (c, d, m) in zip(ts, js):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        assert n == m


# ------------------------------------------------------------ Word2Vec step
@pytest.mark.parametrize("negative", [0, 5])
def test_one_step_matches_jax(negative):
    """One batch on JAX's tables with syn1 / syn1neg made non-zero (both
    sides of the split loss move), then one from zero (JAX's gradient
    at z == 0). Tolerance STEP_TOL of each table's largest |entry|."""
    B = 256
    j, t = w2v_pair(zipf_corpus(), layer_size=16, window=3,
                    min_word_frequency=1, negative=negative, seed=2,
                    batch_pairs=B)
    c, x = j.mine_pairs()
    c, x = c[:B], x[:B]
    name = "syn1neg" if negative else "syn1"
    step, _ = j._build_step()
    uni = j._unigram_table()
    for warm in (True, False):
        tabs = jax_tables(j)
        if warm:
            tabs[name] = np.asarray(jax.random.normal(
                jax.random.PRNGKey(1), tabs[name].shape)) * 0.1
        word2vec_tables_from_jax(t, tabs)
        key = jax.random.PRNGKey(9)
        new, jloss = step({k: jnp.asarray(v) for k, v in tabs.items()},
                          jnp.asarray(c), jnp.asarray(x), jnp.float32(0.05),
                          key)
        negs = (jax_negatives(key, (B, negative), uni) if negative
                else np.zeros((B, 0), np.int64))
        tl = t._step()(t._tables(), torch.from_numpy(c.astype(np.int64)),
                       torch.from_numpy(x.astype(np.int64)),
                       torch.from_numpy(negs.astype(np.int64)), 0.05,
                       with_loss=True)
        for k in tabs:
            assert rel_err(new[k], getattr(t, k)) <= STEP_TOL, (warm, k)
            if warm or k == name:  # from zero rows syn0 cannot move
                assert rel_err(new[k], tabs[k]) > 100 * STEP_TOL
        assert abs(float(tl) - float(jloss)) <= STEP_TOL * abs(float(jloss))


def test_untouched_rows_do_not_move():
    j, t = w2v_pair(zipf_corpus(), layer_size=8, window=2,
                    min_word_frequency=1, negative=3, seed=2,
                    batch_pairs=64)
    before = {k: v.clone() for k, v in t._tables().items()}
    c = np.zeros(64, np.int64)
    x = np.ones(64, np.int64)
    negs = np.full((64, 3), 2, np.int64)
    # twice: the first step moves no syn0 row (syn1neg starts at zero)
    for _ in range(2):
        t.train_pairs(c, x, alpha=0.1, negatives=negs)
    for k, v in before.items():
        moved = (getattr(t, k) != v).any(dim=1).nonzero().ravel().tolist()
        assert set(moved) <= {0, 1, 2}, k
        assert k == "syn1neg" or moved  # syn0 row 1 moved


@pytest.mark.parametrize("negative", [0, 4])
def test_train_pairs_matches_jax(negative):
    """Whole chunks, tail batches and the remainder dropped; with HS
    also a sub-batch input tiled up. The JAX package's keys are replayed
    (`split` a chunk, then CB keys; `split` a tail batch) so the port
    gets the negatives JAX draws (a tiled batch draws fresh negatives
    for its copies in JAX, the copies' own in the port, so the tiling
    case runs with HS). RUN_TOL."""
    B, CB = 64, 3
    j, t = w2v_pair(zipf_corpus(), layer_size=16, window=3,
                    min_word_frequency=1, negative=negative, seed=6,
                    batch_pairs=B, chunk_batches=CB)
    c, x = j.mine_pairs()
    n = 2 * B * CB + 2 * B + 17
    assert c.size > n + 40
    uni = j._unigram_table()

    def replay(key, total):
        negs = []
        full = total // (B * CB) * (B * CB)
        for _ in range(full // (B * CB)):
            key, k = jax.random.split(key)
            for kk in jax.random.split(k, CB):
                negs.append(jax_negatives(kk, (B, negative), uni))
        for _ in range((total - full) // B):
            key, k = jax.random.split(key)
            negs.append(jax_negatives(k, (B, negative), uni))
        dropped = np.zeros(((total - full) % B, negative), np.int64)
        return np.concatenate(negs + [dropped])

    segments = [(0, n)] + ([(n, n + 40)] if negative == 0 else [])
    for lo, hi in segments:
        negs = replay(j._key, hi - lo) if negative else None
        jn = j.train_pairs(c[lo:hi], x[lo:hi], alpha=0.05)
        tn = t.train_pairs(c[lo:hi], x[lo:hi], alpha=0.05, negatives=negs)
        assert tn == jn
        for k, v in jax_tables(j).items():
            assert rel_err(v, getattr(t, k)) <= RUN_TOL, (lo, k)
    assert t.pairs_trained == j.pairs_trained == \
        2 * B * CB + 2 * B + (40 if negative == 0 else 0)
    assert t.last_loss.shape == () and torch.isfinite(t.last_loss)


def test_hs_fit_matches_jax_end_to_end():
    """HS draws no random numbers on the device: from JAX's starting
    syn0, `fit` (mining thread, shuffles, chunks, decaying alpha, tail,
    tiling, 3 iterations) lands within RUN_TOL."""
    kw = dict(layer_size=16, window=3, min_word_frequency=1, negative=0,
              iterations=3, learning_rate=0.1, batch_pairs=64,
              chunk_batches=4, seed=3)
    j, t = w2v_pair(toy_corpus(10), **kw)
    j.fit()
    t.fit()
    assert t.pairs_trained == j.pairs_trained
    assert isinstance(t.syn0, np.ndarray)
    assert rel_err(j.syn0, t.syn0) <= RUN_TOL
    assert rel_err(j.syn1, t.syn1) <= RUN_TOL
    assert abs(t.similarity("cat", "dog") - j.similarity("cat", "dog")) \
        <= 1e-3


# ---------------------------------------------------------------- GloVe
def pool_corpus(n=300, seed=0):
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "horse", "bird", "fish"]
    royals = ["king", "queen", "prince", "duke", "crown"]
    return [" ".join(rng.choice(animals if rng.rand() < 0.5 else royals, 6))
            for _ in range(n)]


@pytest.mark.parametrize("window,symmetric", [(2, True), (4, True),
                                              (3, False)])
def test_cooccurrence_triples_match_jax(window, symmetric):
    sents = zipf_corpus(2000) + ["a b c", "a b", ""]
    jc = jvocab.build_vocab(sents, jtok.DefaultTokenizerFactory())
    tc = build_vocab(sents, DefaultTokenizerFactory())
    jco = jglove.CoOccurrences(jsent.CollectionSentenceIterator(sents),
                               jtok.DefaultTokenizerFactory(), jc,
                               window=window, symmetric=symmetric).calc()
    tco = CoOccurrences(CollectionSentenceIterator(sents),
                        DefaultTokenizerFactory(), tc, window=window,
                        symmetric=symmetric).calc()
    for a, b in zip(tco.triples(), jco.triples()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert dict(tco.counts) == dict(jco.counts)


def glove_pair(**kw):
    corpus = pool_corpus()
    j = jglove.Glove(corpus, **kw).prepare()
    t = Glove(corpus, device=CPU, **kw).prepare()
    glove_state_from_jax(t, {k: np.asarray(v) for k, v in j._params.items()})
    return j, t


def test_two_glove_epochs_match_jax():
    """JAX's own permutations (its epoch key split per epoch), a batch
    that does not divide the triples (wrap-around pad). RUN_TOL."""
    j, t = glove_pair(layer_size=8, window=4, min_word_frequency=3,
                      batch_size=16, seed=11)
    n = j._triples[0].size
    assert n % 16
    key, perms = j._epoch_key, []
    for _ in range(2):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, n)))
    jl = j.train_epochs(2)
    tl = t.train_epochs(2, perms=perms)
    assert abs(tl - jl) <= RUN_TOL * abs(jl)
    for k in ("w", "c", "bw", "bc"):
        assert rel_err(j._params[k], t._params[k]) <= RUN_TOL, k
        assert rel_err(j._accum[k], t._accum[k]) <= RUN_TOL, k
    assert rel_err(j.syn0, t.syn0) <= RUN_TOL


def test_glove_state_carries_accumulators():
    j, t = glove_pair(layer_size=4, window=2, min_word_frequency=3,
                      batch_size=64, seed=1)
    j.train_epochs(1)
    glove_state_from_jax(t, {k: np.asarray(v) for k, v in j._params.items()},
                         {k: np.asarray(v) for k, v in j._accum.items()})
    for k in ("w", "bc"):
        np.testing.assert_array_equal(t._accum[k].numpy(),
                                      np.asarray(j._accum[k]))
    with pytest.raises(ValueError):
        glove_state_from_jax(t, {"w": np.zeros(2)})


# ------------------------------------------------------------ serializer
@pytest.mark.parametrize("binary", [False, True])
def test_serializer_bytes_and_cross_loading(tmp_path, binary):
    j = jw2v.Word2Vec(toy_corpus(1), layer_size=8, iterations=1,
                      seed=1).fit()
    t = Word2Vec(toy_corpus(1), layer_size=8, iterations=1, seed=1,
                 device=CPU)
    t.build_vocab()
    word2vec_tables_from_jax(t, jax_tables(j))
    t.refresh_vectors()
    ext = "bin" if binary else "txt"
    jp, tp = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
    jser.save_word_vectors(j, str(jp), binary=binary)
    save_word_vectors(t, str(tp), binary=binary)
    assert tp.read_bytes() == jp.read_bytes()
    # a table still on the device (after train_pairs) saves the same way
    word2vec_tables_from_jax(t, jax_tables(j))
    assert isinstance(t.syn0, torch.Tensor)
    save_word_vectors(t, str(tp), binary=binary)
    assert tp.read_bytes() == jp.read_bytes()
    a = load_word_vectors(str(jp), binary=binary)
    b = jser.load_word_vectors(str(tp), binary=binary)
    assert a.vocab.words() == b.vocab.words() == j.vocab.words()
    np.testing.assert_array_equal(a.syn0, b.syn0)
    if binary:
        np.testing.assert_array_equal(a.syn0, np.asarray(j.syn0))


def test_serializer_round_trip_on_the_port(tmp_path):
    w2v = Word2Vec(toy_corpus(1), layer_size=8, iterations=1, seed=1,
                   device=CPU).fit()
    for binary in (False, True):
        path = str(tmp_path / ("v.bin" if binary else "v.txt"))
        save_word_vectors(w2v, path, binary=binary)
        loaded = load_word_vectors(path, binary=binary)
        assert loaded.vocab.num_words() == w2v.vocab.num_words()
        for w in ["the", "cat"]:
            np.testing.assert_allclose(loaded.get_word_vector(w),
                                       w2v.get_word_vector(w), atol=1e-4)


# --------------------------------------- the JAX package's cases, on the port
# The JAX package's topic cases hold at seed 7 from ITS initial tables;
# over seeds 1-8 the HS case fails 3 in either package (each from its
# own draw), so the port's HS cases start from JAX's tables for the same
# seed (`w2v_pair`): HS draws nothing else, and the port then retraces
# JAX's run. Negative sampling's draws differ between the packages, so
# that case runs from the port's own initial tables.
@pytest.mark.parametrize("negative,lr,batch_pairs",
                         [(0, 0.1, 2048), (5, 0.1, 256)])
def test_skipgram_learns_topic_structure(negative, lr, batch_pairs):
    kw = dict(layer_size=32, window=3, min_word_frequency=3, iterations=40,
              learning_rate=lr, negative=negative, batch_pairs=batch_pairs,
              seed=7)
    w2v = (w2v_pair(toy_corpus(), **kw)[1] if negative == 0
           else Word2Vec(toy_corpus(), device=CPU, **kw)).fit()
    assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "king")
    assert w2v.similarity("king", "queen") > w2v.similarity("king", "mat")
    in_topic = np.mean([w2v.similarity(a, b) for a, b in
                        [("cat", "dog"), ("king", "queen")]])
    cross = np.mean([w2v.similarity(a, b) for a, b in
                     [("cat", "king"), ("cat", "queen"),
                      ("dog", "king"), ("dog", "queen")]])
    assert in_topic > cross + 0.1


def test_words_nearest_and_unknown_word():
    w2v = Word2Vec(toy_corpus(), layer_size=16, window=3,
                   min_word_frequency=3, iterations=8, seed=3,
                   device=CPU).fit()
    names = [w for w, _ in w2v.words_nearest("cat", n=5)]
    assert "cat" not in names and len(names) == 5
    assert not w2v.has_word("zebra")
    assert w2v.get_word_vector("zebra") is None
    assert np.isnan(w2v.similarity("zebra", "cat"))
    assert w2v.words_nearest("zebra") == []


def test_mine_pairs_train_pairs_public_surface():
    _, w2v = w2v_pair(toy_corpus(), layer_size=32, window=3,
                      min_word_frequency=3, learning_rate=0.1,
                      batch_pairs=2048, seed=7)
    centers, contexts = w2v.mine_pairs()
    assert centers.size == contexts.size > 0
    assert centers.dtype == np.int32
    assert centers.max() < w2v.vocab.num_words() and centers.min() >= 0
    rng = np.random.RandomState(0)
    # device-resident pairs pass through (one int64 conversion a call)
    c_dev = torch.from_numpy(centers)
    x_dev = torch.from_numpy(contexts)
    trained = 0
    for i in range(40):
        perm = torch.from_numpy(rng.permutation(centers.size))
        trained += w2v.train_pairs(c_dev[perm], x_dev[perm],
                                   alpha=0.1 * (1 - i / 40))
    assert trained >= 40 * (centers.size // w2v.batch_pairs
                            * w2v.batch_pairs)
    w2v.refresh_vectors()
    assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "king")


def test_train_pairs_smaller_than_one_batch_tiles_up():
    w2v = Word2Vec(toy_corpus(2), layer_size=8, window=2,
                   min_word_frequency=1, batch_pairs=4096, seed=1,
                   device=CPU)
    centers, contexts = w2v.mine_pairs()
    assert 0 < centers.size < w2v.batch_pairs
    assert w2v.train_pairs(centers, contexts) == centers.size


def test_fit_needs_sentences_and_pairs():
    with pytest.raises(ValueError, match="needs sentences"):
        Word2Vec(device=CPU).fit()
    w2v = Word2Vec(["a"], min_word_frequency=5, device=CPU)
    with pytest.raises(RuntimeError, match="fit"):
        w2v.similarity("a", "a")


def test_glove_learns_topic_structure():
    glove = Glove(pool_corpus(), layer_size=8, window=4,
                  min_word_frequency=3, iterations=200, learning_rate=0.05,
                  seed=11, device=CPU).fit()
    assert glove.similarity("cat", "dog") > glove.similarity("cat", "king")
    assert glove.similarity("king", "queen") > \
        glove.similarity("queen", "fish")


def test_glove_refusals():
    g = Glove(pool_corpus(20), device=CPU)
    with pytest.raises(ValueError, match="prepare"):
        g.train_epochs(1)
    g.prepare()
    with pytest.raises(ValueError, match="n_epochs"):
        g.train_epochs(0)
    with pytest.raises(ValueError, match="permutations"):
        g.train_epochs(2, perms=[np.arange(3)])
    with pytest.raises(ValueError, match="co-occurrences"):
        Glove(["solo"], device=CPU).prepare()


def test_paragraph_vectors_labels_embed_near_their_words():
    pv = ParagraphVectors(labeled_pairs(), layer_size=32, window=3,
                          min_word_frequency=3, iterations=10,
                          learning_rate=0.05, seed=5, device=CPU).fit()
    assert pv.label_vector("animals") is not None
    assert (pv.similarity_to_label("cat", "animals")
            > pv.similarity_to_label("cat", "royalty"))
    assert pv.nearest_labels("queen")[0][0] == "royalty"
    assert pv.nearest_labels("zebra") == []


def test_paragraph_vectors_from_label_aware_iterator():
    it = LabelAwareSentenceIterator(labeled_pairs())
    pv = ParagraphVectors(it, layer_size=8, window=3, min_word_frequency=3,
                          seed=5, device=CPU)
    pv.build_vocab()
    assert pv.labels == ["animals", "royalty"]
    assert pv.vocab.contains("__label__animals")
    kinds = [n == 0 for _, _, n in
             pv._iter_pair_chunks(np.random.RandomState(0), chunk_tokens=64)]
    first_label = kinds.index(True)
    last_base = len(kinds) - 1 - kinds[::-1].index(False)
    assert first_label < last_base


def test_line_iterator_and_whitespace_tokenizer_feed_word2vec(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_text("alpha beta gamma delta\n" * 30)
    w2v = Word2Vec(LineSentenceIterator(str(p)), layer_size=8, window=2,
                   min_word_frequency=1, iterations=2, seed=0,
                   tokenizer_factory=WhitespaceTokenizerFactory(),
                   device=CPU).fit()
    assert w2v.has_word("alpha") and w2v.syn0.shape == (4, 8)
    assert NGramTokenizerFactory(1, 2).tokenize("a b c") == \
        ["a", "b", "c", "a_b", "b_c"]


def test_vectorizers_on_the_port():
    docs = ["the cat", "the dog", "cat cat"]
    v = BagOfWordsVectorizer().fit(docs)
    m = v.transform(docs)
    assert m.shape == (3, v.vocab.num_words())
    assert m[2, v.vocab.index_of("cat")] == 2.0
    t = TfidfVectorizer().fit(["the cat", "the dog", "the bird"])
    m = t.transform(["the cat", "the dog", "the bird"])
    assert m[0, t.vocab.index_of("the")] < m[0, t.vocab.index_of("cat")]


# ------------------------------------------------------------ device policy
@pytest.mark.parametrize("make", [
    lambda: Word2Vec(toy_corpus(1)),
    lambda: Glove(toy_corpus(1)),
    lambda: ParagraphVectors(labeled_pairs()),
    lambda: Viterbi([0, 1]),
], ids=["Word2Vec", "Glove", "ParagraphVectors", "Viterbi"])
def test_default_device_is_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("negative", [0, 5])
def test_train_pairs_card_matches_cpu(card, negative):
    B, CB = 512, 4
    kw = dict(layer_size=32, window=3, min_word_frequency=1,
              negative=negative, batch_pairs=B, chunk_batches=CB, seed=2)
    cpu = Word2Vec(zipf_corpus(20000), device=CPU, **kw)
    gpu = Word2Vec(zipf_corpus(20000), device=card, **kw)
    c, x = cpu.mine_pairs()
    gpu.build_vocab()
    n = B * CB
    rng = np.random.RandomState(0)
    negs = rng.randint(0, cpu.vocab.num_words(), (n, negative))
    assert cpu.train_pairs(c[:n], x[:n], alpha=0.05, negatives=negs) == \
        gpu.train_pairs(c[:n], x[:n], alpha=0.05, negatives=negs)
    for k in ("syn0", "syn1", "syn1neg"):
        if getattr(cpu, k) is not None:
            assert rel_err(getattr(cpu, k).numpy(), getattr(gpu, k)) \
                <= RUN_TOL, k


@pytest.mark.cuda
def test_glove_epoch_card_matches_cpu(card):
    kw = dict(layer_size=16, window=4, min_word_frequency=3,
              batch_size=64, seed=1)
    cpu = Glove(pool_corpus(), device=CPU, **kw).prepare()
    gpu = Glove(pool_corpus(), device=card, **kw).prepare()
    perm = np.random.RandomState(0).permutation(cpu._triples[0].size)
    a = cpu.train_epochs(1, perms=[perm])
    b = gpu.train_epochs(1, perms=[perm])
    assert abs(a - b) <= RUN_TOL * abs(a)
    assert rel_err(cpu.syn0, gpu.syn0) <= RUN_TOL
