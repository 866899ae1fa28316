"""The port's distributed corpus->vectors pipeline
(`deeplearning4j_tpu_torch.scaleout.text_pipeline`) on the CPU, the JAX
package's `tests/test_text_pipeline.py` case for case: vocab built BY the
cluster, then trained, across real port worker processes (`python -m
deeplearning4j_tpu_torch.scaleout.launcher worker`) — no prebuilt vocab
anywhere in the run config; `device="cpu"` goes into the train conf.
Plus: the vocab from counts equals JAX's, and the run configs name the
port's performers."""

import os
import subprocess
import sys

from deeplearning4j_tpu_torch.scaleout.registry import ConfigRegistry
from deeplearning4j_tpu_torch.scaleout.text_pipeline import (
    DistributedWord2Vec,
    sentence_batches,
    vocab_from_counts,
)

from tests.test_multiprocess import REPO_ROOT
from tests.test_torch_perform_nlp import topic_sentences


class TestVocabFromCounts:
    def test_truncate_and_huffman(self):
        counts = {"the": 10.0, "cat": 5.0, "dog": 4.0, "rare": 1.0}
        vocab = vocab_from_counts(counts, min_word_frequency=2.0)
        assert not vocab.contains("rare")
        assert vocab.num_words() == 3
        assert vocab.word_at(0) == "the"  # descending-count indexing
        assert vocab.total_word_count == 20.0  # pre-truncate token mass
        # Huffman codes assigned (shortest for the most frequent word)
        the = vocab.word_for("the")
        cat = vocab.word_for("cat")
        assert the.codes and cat.codes
        assert len(the.codes) <= len(cat.codes)

    def test_sentence_batches_passes(self):
        b = sentence_batches(["a", "b", "c"], 2, passes=2)
        assert b == [["a", "b"], ["c"], ["a", "b"], ["c"]]


class TestCorpusToVectorsMultiProcess:
    def test_raw_corpus_to_vectors_no_prebuilt_vocab(self, tmp_path,
                                                      monkeypatch):
        """VERDICT r3 #6 'done' bar: MultiProcessMaster takes a raw
        corpus to trained vectors; the vocab is counted by worker
        processes (phase 1) and only then built by the driver."""
        from deeplearning4j_tpu.scaleout import perform_nlp as jperform
        from deeplearning4j_tpu_torch.scaleout import text_pipeline as tp

        class FromJaxStart(tp.Word2VecWorkPerformer):
            """The driver's seed performer starts from the JAX performer's
            initial tables for the same conf (the workers replicate the
            current model before their first job): this corpus's outcome
            depends on the start in either package, see
            tests/test_torch_perform_nlp.py."""

            def setup(self, conf):
                super().setup(conf)
                j = jperform.Word2VecWorkPerformer()
                j.setup({k: v for k, v in conf.items() if k != "device"})
                self.update(j.pack())

        monkeypatch.setattr(tp, "Word2VecWorkPerformer", FromJaxStart)
        sentences = topic_sentences(12)
        registry_root = str(tmp_path / "registry")
        dw2v = DistributedWord2Vec(
            sentences,
            run_name="corpus2vec",
            registry=ConfigRegistry(registry_root),
            n_workers=2,
            sentences_per_job=21,
            passes=4,
            min_word_frequency=3.0,
            layer_size=32,
            window=3,
            negative=0,
            learning_rate=0.1,
            batch_pairs=512,
            seed=7,
            device="cpu",
        )

        env = dict(os.environ,
                   PYTHONPATH=REPO_ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   CUDA_VISIBLE_DEVICES="")

        def launch(run, wid, reg_timeout):
            return subprocess.Popen(
                [sys.executable, "-m",
                 "deeplearning4j_tpu_torch.scaleout.launcher", "worker",
                 "--registry", registry_root, "--run", run,
                 "--worker-id", wid,
                 "--registration-timeout", str(reg_timeout)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

        # both phases' workers launch up front; the train-phase pair
        # polls the registry until the driver opens `corpus2vec-train`
        procs = [launch("corpus2vec-vocab", f"count-{i}", 60)
                 for i in range(2)]
        procs += [launch("corpus2vec-train", f"train-{i}", 240)
                  for i in range(2)]
        try:
            wv = dw2v.fit(timeout=240.0)
            for p in procs:
                out, _ = p.communicate(timeout=120)
                assert p.returncode == 0, out.decode()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()

        # the cluster counted the corpus correctly
        assert dw2v.counts["the"] == sum(
            s.split().count("the") for s in sentences)
        # rare words fell to the frequency floor
        assert not dw2v.vocab.contains("chases") or (
            dw2v.vocab.word_frequency("chases") >= 3.0)
        # trained vectors carry topic structure (animals vs royalty)
        assert wv.similarity("cat", "dog") > wv.similarity("cat", "king")


def test_vocab_from_counts_equals_jax():
    from deeplearning4j_tpu.scaleout import text_pipeline as jtp

    counts = {"the": 10.0, "cat": 5.0, "dog": 5.0, "a": 4.0, "rare": 1.0,
              "tie": 4.0}
    for floor in (1.0, 2.0, 5.0):
        assert vocab_from_counts(counts, floor).to_dict() == \
            jtp.vocab_from_counts(counts, floor).to_dict()
    assert sentence_batches(list("abcde"), 2, passes=3) == \
        jtp.sentence_batches(list("abcde"), 2, passes=3)


def test_run_configs_name_the_port_performers(tmp_path, monkeypatch):
    """Both phases publish a `deeplearning4j_tpu_torch.*` performer (the
    port's launcher refuses the JAX package's), and the train conf
    carries the device."""
    from deeplearning4j_tpu_torch.scaleout import text_pipeline as tp

    seen = []

    class Master:
        def __init__(self, jobs, **kw):
            seen.append(kw)

        def run(self, timeout):
            kw = seen[-1]
            if kw["performer_class"].endswith("WordCountWorkPerformer"):
                return {"cat": 3.0, "dog": 3.0, "the": 6.0}
            return kw["initial_params"]

    monkeypatch.setattr(tp, "MultiProcessMaster", Master)
    dw2v = DistributedWord2Vec(["the cat", "the dog"], run_name="r",
                               registry=ConfigRegistry(str(tmp_path)),
                               layer_size=8, device="cpu")
    wv = dw2v.fit()
    assert [kw["performer_class"] for kw in seen] == [
        "deeplearning4j_tpu_torch.scaleout.perform_nlp."
        "WordCountWorkPerformer",
        "deeplearning4j_tpu_torch.scaleout.perform_nlp."
        "Word2VecWorkPerformer"]
    assert seen[1]["performer_conf"]["device"] == "cpu"
    assert wv.syn0.shape == (3, 8)
