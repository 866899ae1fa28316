"""The PyTorch port's HMM POS tagger and sentiment lexicon
(deeplearning4j_tpu_torch/nlp/pos.py, nlp/sentiment.py) held against the
JAX package's, on the CPU, and `nlp/windows.annotate_windows` with the
port's own tagger and lexicon.

Both modules are host code (the tagger decodes with the port's
`utils/viterbi.viterbi_path`, numpy backend). Exact: tags on seeded
tagged corpora (seen and unseen words, every signature bucket), the
emission, transition and initial tables, lexicon scores, classes and a
SentiWordNet file's parse. The cases of the JAX package's
`tests/test_pos_sentiment.py` for the tagger, the lexicon and window
annotation then run on the port.
"""

from __future__ import annotations

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import pos as jpos
from deeplearning4j_tpu.nlp import sentiment as jsent
from deeplearning4j_tpu.nlp import windows as jwin
from deeplearning4j_tpu_torch.nlp.pos import HmmPosTagger
from deeplearning4j_tpu_torch.nlp.sentiment import (NEGATION_WORDS,
                                                    SentimentLexicon,
                                                    class_for_score)
from deeplearning4j_tpu_torch.nlp.windows import (annotate_windows,
                                                  string_with_labels, windows)

TAGGED = [
    [("the", "DT"), ("cat", "NN"), ("sat", "VB")],
    [("a", "DT"), ("dog", "NN"), ("ran", "VB")],
    [("the", "DT"), ("bird", "NN"), ("sang", "VB")],
    [("a", "DT"), ("horse", "NN"), ("jumped", "VB")],
    [("the", "DT"), ("cat", "NN"), ("ran", "VB")],
]

TAGS = ("DT", "NN", "VB", "JJ", "RB", "CD", "NNP")
SUFFIX_WORDS = ["walking", "jumped", "quickly", "cats", "nation", "city",
                "famous", "hopeful", "biggest", "runner", "final", "active"]


def seeded_tagged(seed, n_sents=60):
    """Tagged sentences from a seeded tag grammar: DT (JJ) NN VB (RB),
    numbers as CD and capitalised names as NNP; words drawn per tag from
    small pools with suffixed forms, many of them seen once."""
    rng = np.random.RandomState(seed)
    pools = {"DT": ["the", "a", "this"], "NN": ["cat", "dog", "nation",
                                              "city", "runner"],
             "VB": ["sat", "ran", "jumped", "walks"],
             "JJ": ["big", "famous", "hopeful", "active"],
             "RB": ["quickly", "slowly", "there"],
             "CD": ["3", "42", "1999"], "NNP": ["Alice", "Paris"]}
    out = []
    for _ in range(n_sents):
        sent = []
        if rng.rand() < 0.2:
            sent.append((pools["NNP"][rng.randint(2)], "NNP"))
        else:
            sent.append((pools["DT"][rng.randint(3)], "DT"))
            if rng.rand() < 0.4:
                sent.append((pools["JJ"][rng.randint(4)], "JJ"))
            if rng.rand() < 0.2:
                sent.append((pools["CD"][rng.randint(3)], "CD"))
            sent.append((pools["NN"][rng.randint(5)], "NN"))
        sent.append((pools["VB"][rng.randint(4)], "VB"))
        if rng.rand() < 0.5:
            sent.append((pools["RB"][rng.randint(3)], "RB"))
        if rng.rand() < 0.1:
            word = f"w{rng.randint(10 ** 6)}ing"  # a singleton
            sent.append((word, "VB"))
        out.append(sent)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("smoothing", [0.1, 1.0])
def test_tagger_matches_jax(seed, smoothing):
    corpus = seeded_tagged(seed)
    jt = jpos.HmmPosTagger(smoothing).train(corpus)
    tt = HmmPosTagger(smoothing).train(corpus)
    assert tt.tags == jt.tags
    np.testing.assert_array_equal(tt._log_trans, jt._log_trans)
    np.testing.assert_array_equal(tt._log_init, jt._log_init)
    np.testing.assert_array_equal(tt._fallback, jt._fallback)
    assert set(tt._log_emit) == set(jt._log_emit)
    for w, row in jt._log_emit.items():
        np.testing.assert_array_equal(tt._log_emit[w], row)
    rng = np.random.RandomState(seed + 100)
    probes = [[w for w, _ in s] for s in seeded_tagged(seed + 50, 30)]
    probes += [list(rng.choice(SUFFIX_WORDS + ["Zed", "77", "xyz"],
                               size=rng.randint(1, 8)))
               for _ in range(20)]
    for toks in probes:
        assert tt.tag(toks) == jt.tag(toks)
        assert tt.tag_sentence(toks) == jt.tag_sentence(toks)


def test_lexicon_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(40)]
    scores = {w: float(s) for w, s in zip(words, rng.uniform(-1, 1, 40))}
    jl = jsent.SentimentLexicon(scores)
    tl = SentimentLexicon(scores)
    for _ in range(50):
        toks = list(rng.choice(words + ["not", "Could", "x"],
                               size=rng.randint(0, 9)))
        assert tl.score_tokens(toks) == jl.score_tokens(toks)
        assert tl.classify_tokens(toks) == jl.classify_tokens(toks)
    for s in np.linspace(-1.2, 1.2, 49).tolist() + [0.0, 0.25, -0.25,
                                                   0.75, -0.75]:
        assert class_for_score(s) == jsent.class_for_score(s)
    assert NEGATION_WORDS == jsent.NEGATION_WORDS
    lines = ["# header", "a\t1\t0.5\t0.0\tfine#1 good#2",
             "a\t2\t0.0\t0.25\tfine#3", "n\t3\t0.125\t0.0\tdog#1",
             "v\t4\t0.25\t0.5\tfine#2 bad#x", "r\t5\t\t\tskip#1",
             "n\t6\t0.1\t0.3\tzero#0"]
    p = tmp_path / "swn.txt"
    p.write_text("\n".join(lines) + "\n")
    a = SentimentLexicon.from_sentiwordnet(str(p))
    b = jsent.SentimentLexicon.from_sentiwordnet(str(p))
    assert a.scores == b.scores


class TestHmmPosTagger:
    def test_tags_seen_sentence(self):
        t = HmmPosTagger().train(TAGGED)
        assert t.tag(["the", "dog", "sat"]) == ["DT", "NN", "VB"]

    def test_unknown_word_uses_signature(self):
        t = HmmPosTagger().train(TAGGED)
        # 'zebra' unseen: DT _ VB context + <unk> bucket => NN
        assert t.tag(["the", "zebra", "ran"]) == ["DT", "NN", "VB"]
        # '-ed' suffix signature learned from singleton 'jumped'
        assert t.tag(["the", "cat", "walked"]) == ["DT", "NN", "VB"]

    def test_tag_sentence_pairs(self):
        t = HmmPosTagger().train(TAGGED)
        assert t.tag_sentence(["a", "cat"]) == [("a", "DT"), ("cat", "NN")]

    def test_retrain_replaces_model(self):
        t = HmmPosTagger().train(TAGGED)
        # retrain with a DIFFERENT tag alphabet (4 tags): stale emission
        # rows from the first corpus must not survive
        t.train([
            [("up", "ADV"), ("cat", "NOUN"), ("sat", "VERB")],
            [("down", "ADV"), ("dog", "NOUN"), ("ran", "VERB"),
             ("fast", "ADJ")],
        ])
        assert t.tag(["up", "cat", "sat"]) == ["ADV", "NOUN", "VERB"]
        # 'the' was only in the FIRST corpus: must fall back, not crash
        assert len(t.tag(["the", "cat"])) == 2

    def test_empty_and_untrained(self):
        t = HmmPosTagger().train(TAGGED)
        assert t.tag([]) == []
        with pytest.raises(RuntimeError, match="untrained"):
            HmmPosTagger().tag(["x"])
        with pytest.raises(ValueError, match="2 distinct"):
            HmmPosTagger().train([[("a", "X")]])
        with pytest.raises(ValueError, match="at least one"):
            HmmPosTagger().train([])


class TestSentimentLexicon:
    def test_score_and_negation_flip(self):
        lex = SentimentLexicon({"good": 0.5, "bad": -0.5})
        assert lex.score_tokens(["good", "movie"]) == pytest.approx(0.5)
        # SWN3 rule: ANY negation word flips the whole sentence score
        assert lex.score_tokens(["not", "good"]) == pytest.approx(-0.5)
        assert "not" in NEGATION_WORDS

    def test_class_bands_are_monotone(self):
        series = [1.0, 0.5, 0.1, 0.0, -0.1, -0.5, -1.0]
        names = [class_for_score(s) for s in series]
        assert names == ["strong_positive", "positive", "weak_positive",
                         "neutral", "weak_negative", "negative",
                         "strong_negative"]

    def test_sentiwordnet_parse_harmonic_weighting(self, tmp_path):
        # word 'fine' with senses rank1 (pos .5) and rank3 (neg -.25):
        # score = (.5/1 + (-.25)/3) / (1 + 1/2 + 1/3)  — the reference
        # normalizes over ALL slots up to max rank (gap rank2 counts)
        p = tmp_path / "swn.txt"
        p.write_text(
            "# comment line\n"
            "a\t001\t0.5\t0.0\tfine#1\n"
            "a\t002\t0.0\t0.25\tfine#3\n"
            "n\t003\t0.125\t0.0\tdog#1\n"
            "a\t004\t\t\tskipped#1\n")
        lex = SentimentLexicon.from_sentiwordnet(str(p))
        expected = (0.5 / 1 - 0.25 / 3) / (1 + 0.5 + 1 / 3)
        assert lex.extract("fine") == pytest.approx(expected)
        assert lex.scores["fine#a"] == pytest.approx(expected)
        assert lex.extract("dog") == pytest.approx(0.125)
        assert lex.extract("skipped") == 0.0


class TestContextLabels:
    def test_annotate_windows_tags_and_labels(self):
        t = HmmPosTagger().train(TAGGED)
        lex = SentimentLexicon({"sang": 0.4})
        toks, spans = string_with_labels("the <A> bird </A> sang")
        wins = annotate_windows(toks, 3, tagger=t, lexicon=lex,
                                span_labels=spans)
        # precedence: span label wins; the lexicon classifies the rest
        assert [w.label for w in wins] == ["neutral", "A", "positive"]
        assert wins[1].focus_tag() == "NN"
        # tags align through the <s>/</s> padding (pads -> None)
        assert wins[0].tags == [None, "DT", "NN"]
        # without span labels the lexicon classifies the window
        wins2 = annotate_windows(toks, 3, lexicon=lex)
        assert wins2[2].label == "positive"

    def test_annotate_matches_plain_windows_layout(self):
        toks = ["a", "b", "c", "d"]
        plain = windows(toks, 3)
        annot = annotate_windows(toks, 3)
        assert [w.words for w in annot] == [w.words for w in plain]
        assert all(w.label is None for w in annot)

    @pytest.mark.parametrize("size", [3, 5])
    def test_annotate_windows_matches_jax_with_each_packages_models(
            self, size):
        corpus = seeded_tagged(3)
        scores = {"famous": 0.5, "hopeful": 0.3, "slowly": -0.4,
                  "big": 0.1}
        toks = "the famous runner ran slowly there with <X> Alice </X> " \
               "not hopeful"
        jt, jspans = jwin.string_with_labels(toks)
        tt, tspans = string_with_labels(toks)
        assert (tt, tspans) == (jt, jspans)
        got = annotate_windows(tt, size, tagger=HmmPosTagger().train(corpus),
                               lexicon=SentimentLexicon(scores),
                               span_labels=tspans)
        want = jwin.annotate_windows(
            jt, size, tagger=jpos.HmmPosTagger().train(corpus),
            lexicon=jsent.SentimentLexicon(scores), span_labels=jspans)
        assert [(w.words, w.tags, w.label, w.focus_tag()) for w in got] \
            == [(w.words, w.tags, w.label, w.focus_tag()) for w in want]
