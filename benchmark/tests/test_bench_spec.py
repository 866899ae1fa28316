"""BENCHMARK.json against the rules for its keys, names and limits,
and every file a cell names found by its name."""

import json
import re

import pytest

from harness import common

BENCH = json.loads((common.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


def test_names_units_and_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name_and_reports_enough(cell):
    spec = common.Spec(cell)
    e2e = [m["name"] for m in spec.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer
    moves = {m["moves"] for m in spec.per_layer}
    assert moves <= set(e2e)
    kind = spec.traffic["kind"]
    assert (common.HARNESS_DIR / f"{kind}.py").is_file()
    assert callable(common.runner(kind).run)
    if kind == "serve":
        model = common.served_model(spec.config)
        assert (common.MODELS_DIR / f"{spec.config['model_type']}.py") \
            .is_file()
        for fn in ("dims", "make_params", "make_engine", "reference_params",
                   "served_gaps"):
            assert callable(getattr(model, fn)), fn
        dm = model.dims(spec.config)
        assert {"vocab_size", "max_len"} <= set(dm)
    assert spec.limits
    for m in spec.per_layer:
        assert callable(common.metric_reader(m["name"]))


def test_every_config_is_used_and_a_file_of_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        data = common.load_config(c["file"])
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
