"""The PyTorch port's host utilities (deeplearning4j_tpu_torch/utils/
serialization.py, string_grid.py, interop.py) held against the JAX
package's, on the CPU.

Exact: each package reads the other's serialized bytes (and writes the
same bytes for numpy payloads; torch tensors go in as numpy), string
grids and clusters built from the same seeded rows, and DataSet
interchange. The cases of the JAX package's `tests/test_utils.py`
(`TestStringGrid`, `TestSerialization`, `TestInterop`) then run on the
port, with `to_device(ds, "cpu")` in place of its jax case.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.utils import interop as jinterop
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu.utils import string_grid as jgrid
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.utils import (from_bytes, read_object,
                                            save_object, to_bytes)
from deeplearning4j_tpu_torch.utils import interop
from deeplearning4j_tpu_torch.utils import string_grid as tgrid

PAYLOADS = [
    {"a": np.eye(3), "b": [1, 2, {"c": "x"}], "d": None},
    {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
     "i": np.array([1, 2, 3], np.int64), "t": (1.5, "s", [True, False])},
    [np.zeros((0, 2)), {"nested": {"deep": np.ones(2, np.float16)}}],
]


# ----------------------------------------------------- parity with the JAX
@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_serialized_bytes_cross_both_ways(i, tmp_path):
    obj = PAYLOADS[i]
    ours, theirs = to_bytes(obj), jser.to_bytes(obj)
    assert ours == theirs

    def same(a, b):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a == b

    same(jser.from_bytes(ours), obj)
    same(from_bytes(theirs), obj)
    path = save_object(obj, str(tmp_path / "o.bin"))
    same(jser.read_object(path), obj)
    jpath = jser.save_object(obj, str(tmp_path / "j.bin"))
    same(read_object(jpath), obj)


def test_tensors_serialize_as_numpy():
    t = {"p": torch.arange(6, dtype=torch.float32).view(2, 3),
         "h": [torch.ones(2, dtype=torch.int64)]}
    back = jser.from_bytes(to_bytes(t))
    np.testing.assert_array_equal(back["p"], np.arange(6).reshape(2, 3))
    assert back["p"].dtype == np.float32
    assert back["h"][0].dtype == np.int64
    assert to_bytes(t) == jser.to_bytes(
        {"p": t["p"].numpy(), "h": [t["h"][0].numpy()]})


def _rows(seed, n=30):
    rng = np.random.RandomState(seed)
    names = ["McDonalds", "mcdonalds", "Mc Donalds", "KFC", "kfc!",
             "Café Nero", "cafe nero", "Burger King", "king burger"]
    return [f"{names[rng.randint(len(names))]},{rng.randint(5)},"
            f"{['x', 'y', ''][rng.randint(3)]}" for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_string_grid_matches_jax(seed):
    rows = _rows(seed)
    g, j = tgrid.StringGrid(",", rows), jgrid.StringGrid(",", rows)
    assert g.to_lines() == j.to_lines()
    col = g.get_column(0)
    assert tgrid.StringCluster(col).get_clusters() == \
        jgrid.StringCluster(col).get_clusters()
    keyer, jkeyer = tgrid.FingerPrintKeyer(), jgrid.FingerPrintKeyer()
    assert [keyer.key(s) for s in col] == [jkeyer.key(s) for s in col]
    for grid in (g, j):
        grid.dedupe_by_cluster(0)
        grid.remove_rows_with_empty_column(2)
        grid.sort_by(1)
        grid.append_to_each("!", 2)
    assert g.to_lines() == j.to_lines()
    assert g.map_by_primary_key(0) == j.map_by_primary_key(0)
    assert g.get_rows_with_duplicate_values_in_column(1).rows == \
        j.get_rows_with_duplicate_values_in_column(1).rows
    pairs = [f"{a},{b}" for a, b in zip(col, reversed(col))]
    gs, js = tgrid.StringGrid(",", pairs), jgrid.StringGrid(",", pairs)
    for t in (0.2, 0.5, 0.9):
        assert gs.get_all_with_similarity(t, 0, 1).rows == \
            js.get_all_with_similarity(t, 0, 1).rows


def test_interop_matches_jax():
    rng = np.random.RandomState(1)
    f = rng.rand(5, 3).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[[0, 3, 1, 1, 2]]
    ds = DataSet(f, y)
    ours = interop.to_labeled_points(ds)
    theirs = jinterop.to_labeled_points(DataSet(f, y))
    assert [p[0] for p in ours] == [p[0] for p in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    back = interop.from_labeled_points(theirs, 4)
    np.testing.assert_array_equal(back.labels, y)
    assert set(interop.__all__) == (set(jinterop.__all__) - {"to_jax"}) \
        | {"to_device"}


# --------------------------------------- tests/test_utils.py on the port
class TestSerialization:
    def test_round_trip(self, tmp_path):
        obj = {"a": np.eye(3), "b": [1, 2, {"c": "x"}], "d": None}
        path = save_object(obj, str(tmp_path / "obj.bin"))
        loaded = read_object(path)
        np.testing.assert_array_equal(loaded["a"], np.eye(3))
        assert loaded["b"] == [1, 2, {"c": "x"}]
        assert loaded["d"] is None


class TestStringGrid:
    """reference StringGrid/StringCluster/FingerPrintKeyer (core/util)."""

    def test_fingerprint_keyer(self):
        k = tgrid.FingerPrintKeyer()
        assert k.key("Two words") == k.key("WORDS two!")
        assert k.key("  Café  ") == "cafe"
        assert k.key("a b a") == "a b"  # uniquified + sorted
        with pytest.raises(ValueError, match="single string"):
            k.key(None)

    def test_string_cluster(self):
        c = tgrid.StringCluster(["McDonalds", "mcdonalds", "McDonalds",
                                 "Burger"])
        clusters = c.get_clusters()
        assert len(c) == 2
        assert clusters[0] == {"McDonalds": 2, "mcdonalds": 1}
        assert c.canonical("mcdonalds") == "McDonalds"
        assert c.canonical("unseen") == "unseen"

    def _grid(self):
        return tgrid.StringGrid(",", ["a,1,x", "b,2,y", "a,3,", "c,2,z"])

    def test_grid_io_and_columns(self, tmp_path):
        g = self._grid()
        assert len(g) == 4
        assert g.get_column(0) == ["a", "b", "a", "c"]
        path = str(tmp_path / "grid.csv")
        g.write_lines_to(path)
        g2 = tgrid.StringGrid.from_file(path, ",")
        assert g2.to_lines() == g.to_lines()
        with pytest.raises(ValueError, match="columns"):
            g.append_line("only,two")

    def test_row_and_column_surgery(self):
        g = self._grid()
        g.remove_rows_with_empty_column(2)
        assert len(g) == 3
        g.select(1, "2")
        assert len(g.select(1, "2")) == 2
        g.sort_by(1)
        assert [r[1] for r in g.rows] == ["1", "2", "2"]
        g.swap(0, 1)
        assert g.rows[0][1] == "a"
        g.remove_columns(2)
        assert g.num_columns == 2
        g.prepend_to_each("<", 0)
        g.append_to_each(">", 0)
        assert g.rows[0][0] == "<1>"

    def test_split_and_merge(self):
        g = tgrid.StringGrid(",", ["a|b,1", "c|d,2"])
        g.split(0, "|")
        assert g.num_columns == 3
        assert g.rows[0] == ["a", "b", "1"]
        g.merge(0, 1)
        assert g.rows[0] == ["ab", "1"]

    def test_duplicates_and_primary_key(self):
        g = self._grid()
        dupes = g.get_rows_with_duplicate_values_in_column(0)
        assert len(dupes) == 2
        by_key = g.map_by_primary_key(0)
        assert len(by_key["a"]) == 2

    def test_similarity_filtering(self):
        g = tgrid.StringGrid(",", ["kitten,kitten", "kitten,dog"])
        close = g.get_all_with_similarity(0.9, 0, 1)
        assert len(close) == 1
        g.filter_by_similarity(0.9, 0, 1)
        assert len(g) == 1

    def test_dedupe_by_cluster(self):
        g = tgrid.StringGrid(",", ["McDonalds,1", "mcdonalds,2",
                                   "McDonalds,3", "KFC,4"])
        g.dedupe_by_cluster(0)
        assert g.get_column(0) == ["McDonalds", "McDonalds",
                                   "McDonalds", "KFC"]


class TestInterop:
    """MLLibUtil.java parity: DataSet <-> numpy/torch/device/LabeledPoint."""

    def _ds(self):
        rng = np.random.RandomState(0)
        f = rng.rand(6, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[[0, 1, 2, 1, 0, 2]]
        return DataSet(f, y)

    def test_numpy_round_trip(self):
        ds = self._ds()
        f, y = interop.to_numpy(ds)
        ds2 = interop.from_numpy(f, y)
        np.testing.assert_array_equal(ds2.features, ds.features)
        np.testing.assert_array_equal(ds2.labels, ds.labels)
        with pytest.raises(ValueError, match="rows"):
            interop.from_numpy(f, y[:3])

    def test_torch_round_trip_shares_memory(self):
        ds = self._ds()
        tf, ty = interop.to_torch(ds)
        assert isinstance(tf, torch.Tensor) and tf.shape == (6, 4)
        ds2 = interop.from_torch(tf, ty)
        np.testing.assert_array_equal(ds2.features, ds.features)
        # zero-copy is BEST-EFFORT: it holds for contiguous host numpy
        # arrays (this case); non-contiguous/device arrays get copied
        tf[0, 0] = 42.0
        assert np.asarray(ds.features)[0, 0] == 42.0
        nc = DataSet(np.ones((4, 6), np.float32).T,
                     np.eye(6, 3, dtype=np.float32))
        tf2, _ = interop.to_torch(nc)
        tf2[0, 0] = 7.0
        assert nc.features[0, 0] == 1.0  # copy: no write-through

    def test_device_tensors(self):
        f, y = interop.to_device(self._ds(), "cpu")
        assert isinstance(f, torch.Tensor) and f.shape == (6, 4)
        assert f.device.type == "cpu" and y.shape == (6, 3)
        # a DataSet of tensors comes back to numpy the same way
        ds = DataSet(f, y)
        np.testing.assert_array_equal(interop.to_numpy(ds)[0],
                                      self._ds().features)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                interop.to_device(self._ds())

    def test_labeled_points_round_trip(self):
        ds = self._ds()
        pts = interop.to_labeled_points(ds)
        assert [p[0] for p in pts] == [0, 1, 2, 1, 0, 2]
        ds2 = interop.from_labeled_points(pts, num_labels=3)
        np.testing.assert_array_equal(ds2.features, ds.features)
        np.testing.assert_array_equal(ds2.labels, ds.labels)
        with pytest.raises(ValueError, match="outside"):
            interop.from_labeled_points([(5, [1.0])], num_labels=3)
        with pytest.raises(ValueError, match="no labeled points"):
            interop.from_labeled_points([], num_labels=3)
        with pytest.raises(ValueError, match="one-hot"):
            interop.to_labeled_points(DataSet(ds.features,
                                              np.zeros(6, np.float32)))
