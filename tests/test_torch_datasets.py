"""The PyTorch port's data readers, generators, async iterator and native
runtime held against the JAX package's, on the same files and seeds.

Every reader and iterator of `deeplearning4j_tpu_torch/datasets/` (CSV,
list, line and image record readers, the record -> DataSet bridge with
integer, string, fixed, regression and reconstruction labels, curves,
moving windows, LFW and the image vectorizer) gives arrays and labels
exactly equal to the JAX package's; the generated data
(`synthetic_curves`, `synthetic_lfw`) is byte-equal for the same seed.
`AsyncDataSetIterator` keeps the JAX package's order, reset, retry and
backoff, error relay, MemoryError fast path, stuck-producer refusal and
close, and trains a network through the DeviceFeed bit-equal to the list
path. The native library (`read_csv`, `read_idx`, `BatchQueue`) agrees
with the JAX loader byte for byte, is built under `build/native/`, and
its numpy fallbacks give the same results.
"""

from __future__ import annotations

import gzip
import os
import tarfile
import threading
import time
import zipfile
from pathlib import Path

import jax  # noqa: F401  (the JAX package's modules need it loaded)
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu_torch.datasets as pds
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets import api as japi
from deeplearning4j_tpu.datasets import curves as jcurves
from deeplearning4j_tpu.datasets import moving_window as jmw
from deeplearning4j_tpu.datasets import records as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.runtime import native_loader as jnative
from deeplearning4j_tpu.utils import archive as jarchive
from deeplearning4j_tpu.utils import image_loader as jimg
from deeplearning4j_tpu.utils import moving_window_matrix as jmwm
from deeplearning4j_tpu_torch.datasets import api as papi
from deeplearning4j_tpu_torch.datasets import curves as pcurves
from deeplearning4j_tpu_torch.datasets import moving_window as pmw
from deeplearning4j_tpu_torch.datasets import records as prec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.runtime import native_loader as pnative
from deeplearning4j_tpu_torch.utils import archive as parchive
from deeplearning4j_tpu_torch.utils import image_loader as pimg
from deeplearning4j_tpu_torch.utils import moving_window_matrix as pmwm

REPO = Path(__file__).resolve().parents[1]
BOTH = {"jax": (jds, japi), "port": (pds, papi)}


def _same(got, want):
    """Equal DataSet sequences: every array equal, dtype and all."""
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in ((g.features, w.features), (g.labels, w.labels)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _drain(it):
    out = []
    while it.has_next():
        out.append(it.next())
    return out


def _same_error(fn_port, fn_jax, exc=ValueError):
    with pytest.raises(exc) as got:
        fn_port()
    with pytest.raises(exc) as want:
        fn_jax()
    assert str(got.value) == str(want.value)


def test_exports_cover_the_jax_package():
    names = [n for n in dir(jds) if not n.startswith("_")
             and not isinstance(getattr(jds, n), type(os))]
    missing = [n for n in names if not hasattr(pds, n)]
    assert not missing and "AsyncDataSetIterator" in names


# --------------------------------------------------------------- records
def _write(path, rows):
    path.write_text("".join(",".join(map(str, r)) + "\n" for r in rows))
    return str(path)


def _csv_rows(seed, n=11, cols=3, labels=None):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(n, cols)), 4)
    lab = (labels or [0, 1, 2])
    return [[*row, lab[i % len(lab)]] for i, row in enumerate(x)]


READER_CASES = {
    "int_labels": (dict(labels=None), dict(num_possible_labels=3)),
    "string_labels": (dict(labels=["setosa", "virginica", "versicolor"]),
                      dict(num_possible_labels=3)),
    "fixed_label_order": (dict(labels=["b", "a", "c"]),
                          dict(num_possible_labels=3,
                               labels=["c", "b", "a"])),
    "label_first": (dict(labels=None), dict(label_index=0,
                                            num_possible_labels=None)),
    "regression": (dict(labels=None), dict(num_possible_labels=None)),
    "reconstruction": (dict(labels=None), dict(label_index=None)),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
@pytest.mark.parametrize("batch", [4, 11])
def test_record_reader_iterator_matches_jax(tmp_path, case, batch):
    data_kw, it_kw = READER_CASES[case]
    path = _write(tmp_path / "d.csv", _csv_rows(1, **data_kw))
    its = [rec.RecordReaderDataSetIterator(rec.CSVRecordReader(path),
                                           batch, **it_kw)
           for rec in (prec, jrec)]
    for it in its:
        assert it.input_columns() in (3, 4)
    _same(_drain(its[0]), _drain(its[1]))
    port, ref = its
    assert port.label_map == ref.label_map
    assert (port.input_columns(), port.total_outcomes(),
            port.total_examples()) == (ref.input_columns(),
                                       ref.total_outcomes(),
                                       ref.total_examples())
    _same([port.load_all()], [ref.load_all()])


def test_csv_skip_lines_delimiter_and_csv_iterator(tmp_path):
    rows = _csv_rows(2, n=9)
    path = tmp_path / "h.tsv"
    path.write_text("a\tb\tc\tlabel\n" + "".join(
        "\t".join(map(str, r)) + "\n" for r in rows))
    got, want = (
        rec.RecordReaderDataSetIterator(
            rec.CSVRecordReader(str(path), "\t", skip_lines=1), 4,
            num_possible_labels=3) for rec in (prec, jrec))
    _same(_drain(got), _drain(want))
    plain = _write(tmp_path / "p.csv", rows)
    _same(_drain(pds.CSVDataSetIterator(plain, 5, num_classes=3)),
          _drain(jds.CSVDataSetIterator(plain, 5, num_classes=3)))
    _same(_drain(pds.CSVDataSetIterator(plain, 5, label_index=None)),
          _drain(jds.CSVDataSetIterator(plain, 5, label_index=None)))


def test_list_and_line_readers_match_jax(tmp_path):
    records = [[0.5, "1.5", "cat"], [2, 3.25, "dog"], [-1, 0, "cat"]]
    for batch in (1, 2, 5):
        _same(_drain(prec.RecordReaderDataSetIterator(
                  prec.ListRecordReader(records), batch,
                  num_possible_labels=2)),
              _drain(jrec.RecordReaderDataSetIterator(
                  jrec.ListRecordReader(records), batch,
                  num_possible_labels=2)))
    a = tmp_path / "a.txt"
    b = tmp_path / "b.txt"
    a.write_text("1.5\n\n2.5\n")
    b.write_text("3\n")
    port = prec.LineRecordReader([str(a), str(b)])
    ref = jrec.LineRecordReader([str(a), str(b)])
    assert list(port.records()) == list(ref.records()) == \
        [["1.5"], ["2.5"], ["3"]]
    assert port.count() is None and prec.ListRecordReader(records).count() \
        == 3


def test_reader_refusals_match_jax(tmp_path):
    four = _write(tmp_path / "four.csv",
                  _csv_rows(3, n=8, labels=["a", "b", "c", "d"]))
    _same_error(
        lambda: _drain(prec.RecordReaderDataSetIterator(
            prec.CSVRecordReader(four), 8, num_possible_labels=3)),
        lambda: _drain(jrec.RecordReaderDataSetIterator(
            jrec.CSVRecordReader(four), 8, num_possible_labels=3)))
    big = _write(tmp_path / "big.csv", _csv_rows(4, n=6, labels=[0, 5]))
    _same_error(
        lambda: _drain(prec.RecordReaderDataSetIterator(
            prec.CSVRecordReader(big), 6, num_possible_labels=3)),
        lambda: _drain(jrec.RecordReaderDataSetIterator(
            jrec.CSVRecordReader(big), 6, num_possible_labels=3)))
    _same_error(lambda: pds.CSVDataSetIterator(big, 2),
                lambda: jds.CSVDataSetIterator(big, 2))
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    _same_error(
        lambda: prec.RecordReaderDataSetIterator(
            prec.CSVRecordReader(str(empty))).input_columns(),
        lambda: jrec.RecordReaderDataSetIterator(
            jrec.CSVRecordReader(str(empty))).input_columns())


def test_load_all_of_an_empty_stream_and_the_cached_width(tmp_path):
    empty = tmp_path / "empty.csv"
    empty.write_text("\n")
    for rec in (prec, jrec):
        ds = rec.RecordReaderDataSetIterator(
            rec.CSVRecordReader(str(empty)), 4).load_all()
        assert ds.features.shape == ds.labels.shape == (0, 0)
        assert ds.features.dtype == np.float32
    path = _write(tmp_path / "d.csv", _csv_rows(5, n=5))
    widths = []
    for rec in (prec, jrec):
        it = rec.RecordReaderDataSetIterator(rec.CSVRecordReader(path), 2,
                                             num_possible_labels=3)
        _drain(it)  # the width is learned from the first record, cached
        widths.append((it.input_columns(), it.total_examples()))
    assert widths[0] == widths[1] == (3, 5)


# -------------------------------------------------------------- generated
@pytest.mark.parametrize("n,seed", [(5, 0), (17, 3)])
def test_synthetic_curves_byte_equal(n, seed):
    got = pcurves.synthetic_curves(n, seed)
    want = jcurves.synthetic_curves(n, seed)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    _same(_drain(pds.CurvesDataSetIterator(4, n, seed=seed)),
          _drain(jds.CurvesDataSetIterator(4, n, seed=seed)))


def test_curves_from_a_local_npz(tmp_path):
    path = tmp_path / "curves.npz"
    feats = np.random.default_rng(6).random((7, 784)).astype(np.float32)
    np.savez(path, features=feats)
    got = pds.CurvesDataSetIterator(3, 7, path=str(path))
    want = jds.CurvesDataSetIterator(3, 7, path=str(path))
    assert got.input_columns() == want.input_columns() == 784
    _same(_drain(got), _drain(want))


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("window", [(2, 2), (3, 2), (4, 5)])
def test_moving_windows_match_jax(rotate, window):
    m = np.arange(20, dtype=np.float32).reshape(4, 5)
    for flat in (False, True):
        got = pmwm.MovingWindowMatrix(m, *window, add_rotate=rotate) \
            .windows(flattened=flat)
        want = jmwm.MovingWindowMatrix(m, *window, add_rotate=rotate) \
            .windows(flattened=flat)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_moving_window_iterator_and_refusals_match_jax():
    rng = np.random.default_rng(7)
    feats = rng.random((3, 36)).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[[0, 1, 1]]
    got = pmw.MovingWindowDataSetIterator(
        5, papi.DataSet(feats, labels), 6, 6, 4, 4)
    want = jmw.MovingWindowDataSetIterator(
        5, japi.DataSet(feats, labels), 6, 6, 4, 4)
    assert got.num_examples() == want.num_examples() == 3 * 9 * 4
    _same(_drain(got), _drain(want))
    m = np.zeros((3, 3))
    _same_error(lambda: pmwm.MovingWindowMatrix(m, 4, 1),
                lambda: jmwm.MovingWindowMatrix(m, 4, 1))
    _same_error(lambda: pmwm.MovingWindowMatrix(np.zeros(3), 1, 1),
                lambda: jmwm.MovingWindowMatrix(np.zeros(3), 1, 1))


# ------------------------------------------------------------ images, LFW
def _lfw_pair(tmp_path, **kw):
    port = pds.synthetic_lfw(str(tmp_path / "port"), **kw)
    ref = jds.synthetic_lfw(str(tmp_path / "jax"), **kw)
    return port, ref


def _tree_bytes(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kw", [dict(), dict(num_people=3,
                                              images_per_person=2,
                                              height=12, width=10, seed=4)])
def test_synthetic_lfw_byte_equal_and_iterators_match(tmp_path, kw):
    port, ref = _lfw_pair(tmp_path, **kw)
    assert _tree_bytes(port) == _tree_bytes(ref)
    h, w = kw.get("height", 28), kw.get("width", 28)
    got = pds.LFWDataSetIterator(3, port, height=h, width=w)
    want = jds.LFWDataSetIterator(3, ref, height=h, width=w)
    assert (got.input_columns(), got.total_outcomes()) == \
        (want.input_columns(), want.total_outcomes())
    _same(_drain(got), _drain(want))
    fetcher = pds.LFWDataFetcher(port, h, w)
    jfetcher = jds.LFWDataFetcher(ref, h, w)
    _same([fetcher.fetch(5), fetcher.fetch(5)],
          [jfetcher.fetch(5), jfetcher.fetch(5)])


def test_lfw_from_a_tgz_and_the_missing_path(tmp_path):
    port, _ = _lfw_pair(tmp_path, num_people=2, images_per_person=2)
    archive = tmp_path / "lfw.tgz"
    with tarfile.open(archive, "w:gz") as t:
        t.add(port, arcname="lfw")
    got = pds.LFWLoader(str(archive)).get_all_images()
    want = jds.LFWLoader(str(archive)).get_all_images()
    _same([got], [want])
    with pytest.raises(FileNotFoundError, match="synthetic_lfw"):
        pds.LFWLoader(str(tmp_path / "nope"))


def test_image_reader_vectorizer_and_loader_match_jax(tmp_path):
    port, _ = _lfw_pair(tmp_path, num_people=2, images_per_person=3)
    got = list(prec.ImageRecordReader(port, 14, 14).records())
    want = list(jrec.ImageRecordReader(port, 14, 14).records())
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g[-1] == w[-1]
        np.testing.assert_array_equal(np.asarray(g[:-1]), np.asarray(w[:-1]))
    img = str(sorted(Path(port).rglob("*.png"))[0])
    for mode in ("binarize", "normalize", None):
        pv = pds.ImageVectorizer(img, 4, 2)
        jv = jds.ImageVectorizer(img, 4, 2)
        if mode:
            pv, jv = getattr(pv, mode)(), getattr(jv, mode)()
        _same([pv.vectorize()], [jv.vectorize()])
    for gray in (True, False):
        np.testing.assert_array_equal(
            pimg.ImageLoader(9, 7, grayscale=gray).as_matrix(img),
            jimg.ImageLoader(9, 7, grayscale=gray).as_matrix(img))
    assert pimg.ImageLoader(9, 7, grayscale=False).shape == (9, 7, 3)
    _same_error(lambda: pimg.ImageLoader().shape,
                lambda: jimg.ImageLoader().shape)
    (tmp_path / "none").mkdir()
    _same_error(lambda: prec.ImageRecordReader(str(tmp_path / "none")),
                lambda: jrec.ImageRecordReader(str(tmp_path / "none")))


def test_archives_unpack_as_the_jax_package_does(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_text("alpha")
    zpath = tmp_path / "x.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(src / "a.txt", "dir/a.txt")
    tpath = tmp_path / "x.tar.gz"
    with tarfile.open(tpath, "w:gz") as t:
        t.add(src / "a.txt", arcname="dir/a.txt")
    gpath = tmp_path / "a.txt.gz"
    with gzip.open(gpath, "wb") as g:
        g.write(b"alpha")
    for path in (zpath, tpath, gpath):
        parchive.unzip_file_to(str(path), str(tmp_path / "p" / path.name))
        jarchive.unzip_file_to(str(path), str(tmp_path / "j" / path.name))
        assert _tree_bytes(tmp_path / "p" / path.name) == \
            _tree_bytes(tmp_path / "j" / path.name)
    evil = tmp_path / "evil.zip"
    with zipfile.ZipFile(evil, "w") as z:
        z.writestr("../escape.txt", "x")
    _same_error(lambda: parchive.unzip_file_to(str(evil),
                                               str(tmp_path / "e1")),
                lambda: jarchive.unzip_file_to(str(evil),
                                               str(tmp_path / "e1")))
    _same_error(lambda: parchive.unzip_file_to("x.rar", str(tmp_path)),
                lambda: jarchive.unzip_file_to("x.rar", str(tmp_path)))


# ------------------------------------------------------ async iterator
def _list_source(api, n=64, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    return api.ListDataSetIterator(
        api.DataSet(rng.rand(n, 4).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]),
        batch_size=batch)


def _scripted_source(api, script, n_batches=3, make=None):
    """A source whose next() follows `script(i, attempt)`: return None to
    deliver batch i (`make(i)` -> (features, labels), by default a 4 x 2
    block of i + 1), or an exception to raise; `attempts` counts
    calls."""

    class Scripted(api.DataSetIterator):
        def __init__(self):
            super().__init__(batch_size=4, num_examples=4 * n_batches)
            self._i = 0
            self._tries = {}
            self.attempts = 0

        def input_columns(self):
            return 2

        def total_outcomes(self):
            return 2

        def reset(self):
            self._i = 0

        def has_next(self):
            return self._i < n_batches

        def next(self, num=None):
            self.attempts += 1
            tries = self._tries.get(self._i, 0)
            self._tries[self._i] = tries + 1
            err = script(self._i, tries)
            if err is not None:
                raise err
            self._i += 1
            if make is not None:
                return api.DataSet(*make(self._i - 1))
            z = np.full((4, 2), self._i, np.float32)
            return api.DataSet(z, z)

    return Scripted()


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_async_order_reset_and_close(pkg):
    ds_mod, api = BOTH[pkg]
    expected = _drain(_list_source(api))
    it = ds_mod.AsyncDataSetIterator(_list_source(api), capacity=2)
    _same(_drain(it), expected)
    assert (it.input_columns(), it.total_outcomes()) == (4, 3)
    it.reset()
    _same(_drain(it), expected)
    first = it.next() if it.has_next() else None
    assert first is None
    it.close()
    it.reset()  # close then reset is a clean restart
    _same(_drain(it), expected)
    it.close()


def test_async_streams_equal_across_packages():
    got = _drain(pds.AsyncDataSetIterator(_list_source(papi, 50, 8, 3)))
    want = _drain(jds.AsyncDataSetIterator(_list_source(japi, 50, 8, 3)))
    _same(got, want)


RETRY_CASES = {
    # name: (script, retries, expected values or exception type, attempts)
    "recovers": (lambda i, t: IOError(f"blip {i}") if t < 2 else None, 3,
                 [1.0, 2.0, 3.0], 9),
    "budget_exhausted": (lambda i, t: IOError(f"blip {i}") if t < 5
                         else None, 2, IOError, 3),
    "off_by_default": (lambda i, t: IOError(f"blip {i}") if t < 1
                       else None, 0, IOError, 1),
    "memory_error_fast_path": (lambda i, t: MemoryError("oom"), 5,
                               MemoryError, 1),
    "mid_stream_relay": (lambda i, t: RuntimeError("disk died")
                         if i == 2 else None, 0, RuntimeError, 3),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_async_retry_and_error_relay_match_jax(case):
    script, retries, expect, attempts = RETRY_CASES[case]
    seen = {}
    for pkg, (ds_mod, api) in BOTH.items():
        src = _scripted_source(api, script)
        it = ds_mod.AsyncDataSetIterator(src, retries=retries,
                                         backoff=0.001)
        got = []
        if isinstance(expect, list):
            got = _drain(it)
        else:
            with pytest.raises(expect) as err:
                while it.has_next():
                    got.append(it.next())
            got.append(str(err.value))
        it.close()
        seen[pkg] = ([g if isinstance(g, str) else float(g.features[0, 0])
                      for g in got], src.attempts)
    assert seen["port"] == seen["jax"]
    if isinstance(expect, list):
        assert seen["port"][0] == expect
    assert seen["port"][1] == attempts


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_async_reset_interrupts_backoff_and_refuses_a_stuck_producer(pkg):
    ds_mod, api = BOTH[pkg]
    it = ds_mod.AsyncDataSetIterator(
        _scripted_source(api, lambda i, t: IOError("flaky")), retries=10,
        backoff=30.0, reset_timeout=5.0)
    time.sleep(0.2)  # the producer is parked in its first 30 s backoff
    t0 = time.perf_counter()
    it.reset()
    assert time.perf_counter() - t0 < 5.0
    it.close()

    release = threading.Event()

    def blocked(i, tries):
        release.wait(10.0)
        return None

    it = ds_mod.AsyncDataSetIterator(_scripted_source(api, blocked),
                                     reset_timeout=0.2)
    time.sleep(0.1)
    with pytest.raises(RuntimeError, match="producer thread still running"):
        it.reset()
    release.set()
    it._producer.join(5.0)
    assert not it._producer.is_alive()
    it.close()


def _iris_nets():
    conf = (JConf.builder().lr(0.1).n_in(4).activation_function("tanh")
            .num_iterations(1).list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())
    jnet = JNet(conf)
    pnet = MultiLayerNetwork.from_config_json(
        jnet.to_json(), params=np.asarray(jnet.params()), device="cpu")
    return pnet, jnet


def test_async_through_device_feed_trains_as_the_list_path():
    """fit over DeviceFeed(AsyncDataSetIterator) leaves the params
    bit-equal to fit over the plain list iterator (same DeviceFeed
    underneath), and within 1e-5 of the JAX package's async fit."""
    pnet, jnet = _iris_nets()
    pref = pnet.clone()
    src = _list_source(papi, n=72, batch=32, seed=4)
    feed = pds.DeviceFeed(pds.AsyncDataSetIterator(src), device="cpu")
    pnet.fit(feed, epochs=2)
    pref.fit(_list_source(papi, n=72, batch=32, seed=4), epochs=2)
    assert torch.equal(pnet.params(), pref.params())
    jnet.fit(jds.AsyncDataSetIterator(_list_source(japi, n=72, batch=32,
                                                   seed=4)), epochs=2)
    np.testing.assert_allclose(pnet.params().numpy(),
                               np.asarray(jnet.params()), atol=1e-5)
    feed.close()


def test_a_producer_error_relays_to_fit():
    """A source error after one good batch reaches fit() on the consumer
    thread (the feed's look-ahead pulls it before the first step)."""
    pnet, _ = _iris_nets()

    def script(i, tries):
        return RuntimeError("shard 1 unreadable") if i == 1 else None

    def make(i):
        rows = np.random.default_rng(i).random((4, 4)).astype(np.float32)
        return rows, np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]

    feed = pds.DeviceFeed(pds.AsyncDataSetIterator(
        _scripted_source(papi, script, make=make)), device="cpu")
    with pytest.raises(RuntimeError, match="shard 1 unreadable"):
        pnet.fit(feed)
    feed.close()


# ---------------------------------------------------------------- native
def test_native_library_is_built_under_build_native():
    assert pnative.native_available()
    path = pnative.library_path()
    assert path.is_relative_to(REPO / "build" / "native")
    assert path.parent.name == pnative.library_dir().name
    assert not any((REPO / "deeplearning4j_tpu_torch").rglob("*.so"))


CSV_TEXTS = {
    "plain": "1.5,2,3\n4,5.25,-6\n",
    "no_trailing_newline": "1,2\n3,4",
    "crlf_and_spaces": "1, 2 ,3\r\n 4,5,6\r\n",
    "blank_lines": "\n1,2\n\n3,4\n\n",
    "exponents": "1e-3,2.5E2\n-0.0,7\n",
}


@pytest.mark.parametrize("case", sorted(CSV_TEXTS))
def test_read_csv_matches_the_jax_loader(tmp_path, case):
    path = tmp_path / "d.csv"
    path.write_text(CSV_TEXTS[case])
    got, want = pnative.read_csv(str(path)), jnative.read_csv(str(path))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text", ["1,2\n3\n", "a,b\n1,2\n", ""])
def test_read_csv_refusals_match_the_jax_loader(tmp_path, text):
    path = tmp_path / "bad.csv"
    path.write_text(text)
    _same_error(lambda: pnative.read_csv(str(path)),
                lambda: jnative.read_csv(str(path)))


def _write_idx(path, arr):
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 0x08, arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())
    return str(path)


@pytest.mark.parametrize("shape", [(9,), (4, 3), (5, 7, 2), (2, 3, 2, 2)])
def test_read_idx_matches_the_jax_loader(tmp_path, shape):
    arr = np.random.default_rng(8).integers(0, 256, shape).astype(np.uint8)
    path = _write_idx(tmp_path / "a.idx", arr)
    for got in (pnative.read_idx(path), pnative._read_idx_numpy(path)):
        np.testing.assert_array_equal(got, jnative.read_idx(path))
        assert got.dtype == np.uint8


def test_read_idx_refusals_match_the_jax_loader(tmp_path):
    bad = tmp_path / "bad.idx"
    bad.write_bytes(b"\x01\x02\x03\x04garbage")
    _same_error(lambda: pnative.read_idx(str(bad)),
                lambda: jnative.read_idx(str(bad)))
    path = _write_idx(tmp_path / "t.idx", np.ones((4, 4), np.uint8))
    with open(path, "r+b") as f:
        f.truncate(14)
    _same_error(lambda: pnative.read_idx(path),
                lambda: jnative.read_idx(path))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (2, 3, 4),
                                   (2, 1, 3, 2)])
def test_batch_queue_round_trip_and_wire_format(shape):
    arr = np.random.default_rng(9).normal(size=shape)  # float64 in
    assert np.array_equal(pnative.BatchQueue._pack(arr),
                          jnative.BatchQueue._pack(arr))
    q, jq = pnative.BatchQueue(2), jnative.BatchQueue(2)
    assert q.push(arr) and jq.push(arr) and q.size() == 1
    got, want = q.pop(), jq.pop()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (arr.shape or (1,))
    np.testing.assert_array_equal(got, want)
    q.close()
    assert q.pop() is None and not q.push(arr)


def test_batch_queue_refuses_five_dims_as_jax_does():
    arr = np.zeros((1, 1, 1, 1, 2))
    _same_error(lambda: pnative.BatchQueue().push(arr),
                lambda: jnative.BatchQueue().push(arr))


def test_batch_queue_threads_and_close_unblocks():
    q = pnative.BatchQueue(2)
    out = []

    def consume():
        while (item := q.pop()) is not None:
            out.append(int(item[0]))

    t = threading.Thread(target=consume)
    t.start()
    for i in range(50):
        assert q.push(np.full(3, i))
    q.close()
    t.join(10.0)
    assert not t.is_alive() and out == list(range(50))


def test_numpy_fallbacks_give_the_same_results(tmp_path, monkeypatch):
    path = tmp_path / "d.csv"
    path.write_text(CSV_TEXTS["plain"])
    idx = _write_idx(tmp_path / "a.idx", np.arange(12).reshape(3, 4))
    native = (pnative.read_csv(str(path)), pnative.read_idx(idx))
    monkeypatch.setattr(pnative, "_load", lambda: None)
    assert not pnative.native_available()
    np.testing.assert_array_equal(pnative.read_csv(str(path)), native[0])
    np.testing.assert_array_equal(pnative.read_idx(idx), native[1])
    q = pnative.BatchQueue(2)
    q.push(np.ones((2, 2)))
    np.testing.assert_array_equal(q.pop(), np.ones((2, 2), np.float32))
    q.close()
    assert q.pop() is None
    ds = _drain(pds.AsyncDataSetIterator(_list_source(papi)))
    _same(ds, _drain(_list_source(papi)))
