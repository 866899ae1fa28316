"""The PyTorch port's command line (deeplearning4j_tpu_torch/cli.py) and
held-out evaluation (eval/holdout.py) held against the JAX package's.

Both CLIs run in-process on the same Iris CSV, the port with `--device
cpu`. Parity of `train` is shown from a common start: both train from
`init.ckpt`, an `.npz` written by the JAX package's DefaultModelSaver
(the packages draw fresh parameters from different generators). Limits:
trained params within 1e-5; `test`'s metrics equal; `predict`'s class
ids identical; `eval --json` equal but for path and seconds; `checkpoint
inspect --json` equal but for `dir` and `saved_at`; the `--resume auto`
flow gives the same step numbers and final params within 1e-5 (and in
the port bit-equal to the uninterrupted run, as it is in the JAX
package). Each refusal exits 2 with the JAX CLI's message; checkpoints
written by either CLI load in the other; what is not ported exits 2
naming its ROADMAP item; `--device cuda` exits 2 without a card.
`evaluate_via_fleet` runs against a stub `/predict` endpoint that sheds
once with 503 + Retry-After.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax  # noqa: F401  (the JAX package's modules need it loaded)
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.iris import load_iris
from deeplearning4j_tpu.eval import holdout as jholdout
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.scaleout.checkpoint import DefaultModelSaver as JSaver
from deeplearning4j_tpu_torch import cli as pcli
from deeplearning4j_tpu_torch.checkpoint import list_steps
from deeplearning4j_tpu_torch.eval import holdout as pholdout
from deeplearning4j_tpu_torch.scaleout.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
PARAM_TOL = 1e-5
DEVICE_COMMANDS = ("train", "test", "predict", "eval", "serve", "fleet",
                   "pipeline")


def run(pkg, *argv):
    """(rc, stdout, stderr) of one in-process CLI call; the port's
    network commands get `--device cpu`."""
    argv = [str(a) for a in argv]
    if pkg == "port" and argv[0] in DEVICE_COMMANDS:
        argv += ["--device", "cpu"]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = (pcli if pkg == "port" else jcli).main(argv)
    return rc, out.getvalue(), err.getvalue()


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def params(path):
    net, _ = load_checkpoint(str(path), device="cpu")
    return net.params().numpy()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The shared workspace: the Iris CSVs, the conf, the JAX-written
    init.ckpt, and each package's 2-epoch iterator-path training run."""
    d = tmp_path_factory.mktemp("cli")
    x, y = load_iris()
    x, labels = np.asarray(x), np.argmax(np.asarray(y), 1)
    np.savetxt(d / "iris.csv", np.hstack([x, labels[:, None]]),
               delimiter=",", fmt="%.4f")
    np.savetxt(d / "iris_features.csv", x, delimiter=",", fmt="%.4f")
    conf = (JConf.builder().lr(0.1).n_in(4).activation_function("tanh")
            .num_iterations(20).use_adagrad(False)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())
    (d / "conf.json").write_text(conf.to_json())
    JSaver(str(d / "init.ckpt")).save(JNet(conf))
    w = {"dir": d, "csv": d / "iris.csv", "features": d / "iris_features.csv",
         "conf": d / "conf.json", "init": d / "init.ckpt"}
    for pkg in ("jax", "port"):
        rc, out, err = run(pkg, "train", "-i", w["csv"], "-m", w["init"],
                           "-o", d / f"{pkg}.ckpt", "--epochs", 2,
                           "--batch-size", 50, "--checkpoint-dir",
                           d / f"{pkg}_ck")
        assert rc == 0, err
        w[pkg] = {"ckpt": d / f"{pkg}.ckpt", "ck": d / f"{pkg}_ck",
                  "summary": last_json(out)}
    return w


# ----------------------------------------------------------------- train
def test_train_iterator_path_matches_jax(ws):
    np.testing.assert_allclose(params(ws["port"]["ckpt"]),
                               params(ws["jax"]["ckpt"]), atol=PARAM_TOL)
    got, want = ws["port"]["summary"], ws["jax"]["summary"]
    assert sorted(got) == sorted(want) == ["saved", "score"]
    assert abs(got["score"] - want["score"]) < PARAM_TOL
    assert list_steps(str(ws["port"]["ck"])) == \
        list_steps(str(ws["jax"]["ck"])) == [4, 5, 6]


@pytest.mark.parametrize("epochs", [1, 3])
def test_train_arrays_path_matches_jax(ws, tmp_path, epochs):
    outs = {}
    for pkg in ("jax", "port"):
        rc, out, err = run(pkg, "train", "-i", ws["csv"], "-m", ws["init"],
                           "-o", tmp_path / f"{pkg}.ckpt", "--epochs",
                           epochs, "--checkpoint-dir", tmp_path / pkg)
        assert rc == 0, err
        outs[pkg] = last_json(out)
        assert list_steps(str(tmp_path / pkg)) == \
            list(range(1, epochs + 1))
    np.testing.assert_allclose(params(tmp_path / "port.ckpt"),
                               params(tmp_path / "jax.ckpt"),
                               atol=PARAM_TOL)
    assert abs(outs["port"]["score"] - outs["jax"]["score"]) < PARAM_TOL


# ------------------------------------------------------ test and predict
@pytest.mark.parametrize("model", ["jax_ckpt", "port_ckpt", "jax_dir",
                                   "port_dir"])
def test_test_metrics_equal_jax(ws, model):
    pkg, kind = model.split("_")
    path = ws[pkg]["ckpt" if kind == "ckpt" else "ck"]
    got = run("port", "test", "-i", ws["csv"], "-m", path)
    want = run("jax", "test", "-i", ws["csv"], "-m", path)
    assert got[0] == want[0] == 0
    assert last_json(got[1]) == last_json(want[1])
    assert got[1] == want[1]  # Evaluation.stats() text as well
    assert last_json(got[1])["f1"] > 0.7


@pytest.mark.parametrize("how", ["file", "stdout", "labelled"])
def test_predict_class_ids_identical(ws, tmp_path, how):
    outs = []
    for pkg in ("jax", "port"):
        argv = ["predict", "-m", ws["port"]["ckpt"], "-i",
                ws["csv"] if how == "labelled" else ws["features"]]
        if how == "labelled":
            argv += ["--label-columns", 1]
        if how != "stdout":
            argv += ["-o", tmp_path / f"{pkg}.txt"]
        rc, out, err = run(pkg, *argv)
        assert rc == 0, err
        text = out if how == "stdout" else \
            (tmp_path / f"{pkg}.txt").read_text()
        if how != "stdout":
            assert last_json(out) == {"saved": str(tmp_path / f"{pkg}.txt"),
                                      "n": 150}
        outs.append(text)
    assert outs[0] == outs[1]
    ids = [int(v) for v in outs[1].split()]
    assert len(ids) == 150 and set(ids) <= {0, 1, 2}


def test_a_fresh_conf_gives_the_jax_formats(ws):
    """From a conf .json each package draws its own parameters, so only
    the formats and shapes are compared."""
    got = run("port", "predict", "-i", ws["features"], "-m", ws["conf"])
    want = run("jax", "predict", "-i", ws["features"], "-m", ws["conf"])
    assert got[0] == want[0] == 0
    assert len(got[1].splitlines()) == len(want[1].splitlines()) == 150
    assert set(got[1].split()) <= {"0", "1", "2"}
    got = run("port", "test", "-i", ws["csv"], "-m", ws["conf"])
    want = run("jax", "test", "-i", ws["csv"], "-m", ws["conf"])
    assert sorted(last_json(got[1])) == sorted(last_json(want[1]))


# ------------------------------------------------------ eval, inspect
@pytest.mark.parametrize("model,extra", [("port_ck", []),
                                         ("jax_ck", ["--step", 5]),
                                         ("port_ckpt", []),
                                         ("jax_ckpt", [])])
def test_eval_json_matches_jax(ws, model, extra):
    pkg, kind = model.split("_")
    path = ws[pkg][kind]
    outs = []
    for who in ("jax", "port"):
        rc, out, err = run(who, "eval", "-m", path, "--data", ws["csv"],
                           "--json", *extra)
        assert rc == 0, err
        outs.append(last_json(out))
    for o in outs:
        assert o.pop("path") == str(path)
        assert o.pop("eval_seconds") >= 0
    assert outs[0] == outs[1]
    assert outs[1]["step"] == (5 if extra else
                               (6 if kind == "ck" else None))


@pytest.mark.parametrize("step", [None, 5])
def test_checkpoint_inspect_json_matches_jax(ws, step):
    extra = [] if step is None else ["--step", step]
    outs = []
    for pkg in ("jax", "port"):
        rc, out, err = run(pkg, "checkpoint", "inspect", ws[pkg]["ck"],
                           "--json", *extra)
        assert rc == 0, err
        outs.append(last_json(out))
    for pkg, o in zip(("jax", "port"), outs):
        assert o.pop("dir") == str(ws[pkg]["ck"])
        assert o.pop("saved_at") > 0
    assert outs[0] == outs[1]
    assert outs[1]["step"] == (step or 6) and outs[1]["steps"] == [4, 5, 6]
    human = [run(pkg, "checkpoint", "inspect", ws["port"]["ck"])[1]
             for pkg in ("jax", "port")]
    tables = [h[h.index("\nleaf"):] for h in human]
    assert tables[0] == tables[1] and "params/0/W" in tables[1]


# ---------------------------------------------------------------- resume
def test_resume_auto_flow_matches_jax(ws, tmp_path):
    seen = {}
    for pkg in ("jax", "port"):
        ck = tmp_path / f"{pkg}_ck"
        common = ["-i", ws["csv"], "-m", ws["init"], "--batch-size", 50,
                  "--checkpoint-dir", ck]
        rc, _, err = run(pkg, "train", *common, "-o",
                         tmp_path / f"{pkg}1.ckpt", "--epochs", 1)
        assert rc == 0, err
        first = list_steps(str(ck))
        rc, out, err = run(pkg, "train", *common, "-o",
                           tmp_path / f"{pkg}r.ckpt", "--epochs", 2,
                           "--resume", "auto")
        assert rc == 0, err
        lines = [json.loads(line) for line in out.strip().splitlines()]
        assert lines[0].pop("resuming") == str(ck)
        seen[pkg] = (first, lines, list_steps(str(ck)))
    assert seen["port"][0] == seen["jax"][0] == [1, 2, 3]
    assert seen["port"][2] == seen["jax"][2] == [4, 5, 6]
    resumed, summary = seen["port"][1]
    assert resumed == seen["jax"][1][0] == {
        "step": 3, "iterator_position": 3, "epoch": 0}
    assert summary["resumed_from"] == seen["jax"][1][1]["resumed_from"] == 3
    np.testing.assert_allclose(params(tmp_path / "portr.ckpt"),
                               params(tmp_path / "jaxr.ckpt"),
                               atol=PARAM_TOL)
    # the resumed run is bit-equal to the uninterrupted 2-epoch run, as
    # it is in the JAX package
    np.testing.assert_array_equal(params(tmp_path / "portr.ckpt"),
                                  params(ws["port"]["ckpt"]))
    np.testing.assert_array_equal(params(tmp_path / "jaxr.ckpt"),
                                  params(ws["jax"]["ckpt"]))


def test_resume_auto_on_an_empty_dir_starts_fresh(ws, tmp_path):
    outs = []
    for pkg in ("jax", "port"):
        rc, out, err = run(pkg, "train", "-i", ws["csv"], "-m", ws["init"],
                           "-o", tmp_path / f"{pkg}.ckpt", "--batch-size",
                           50, "--checkpoint-dir", tmp_path / f"{pkg}_ck",
                           "--resume", "auto")
        assert rc == 0, err
        outs.append(json.loads(out.splitlines()[0]))
    assert outs[0] == outs[1] and outs[1]["resuming"] is None
    np.testing.assert_allclose(params(tmp_path / "port.ckpt"),
                               params(tmp_path / "jax.ckpt"), atol=PARAM_TOL)


# --------------------------------------------------------------- refusals
def _torn_dir(root):
    step = root / "step_0000000004"
    step.mkdir(parents=True)
    (step / "manifest.json").write_text("{}")
    return root


REFUSALS = {
    "train_without_labels": lambda w, t: [
        "train", "-i", w["csv"], "-m", w["conf"], "-o", t / "m.ckpt",
        "--label-columns", 0],
    "test_without_labels": lambda w, t: [
        "test", "-i", w["csv"], "-m", w["conf"], "--label-columns", 0],
    "checkpoint_every_without_dir": lambda w, t: [
        "train", "-i", w["csv"], "-m", w["conf"], "-o", t / "m.ckpt",
        "--checkpoint-every", 2],
    "resume_auto_without_dir": lambda w, t: [
        "train", "-i", w["csv"], "-m", w["conf"], "-o", t / "m.ckpt",
        "--resume", "auto"],
    "resume_torn_only_dir": lambda w, t: [
        "train", "-i", w["csv"], "-m", w["conf"], "-o", t / "m.ckpt",
        "--batch-size", 50, "--checkpoint-dir", _torn_dir(t / "torn"),
        "--resume", "auto"],
    "predict_width_mismatch": lambda w, t: [
        "predict", "-i", w["csv"], "-m", w["conf"], "-o", t / "p.txt"],
    "inspect_missing_dir": lambda w, t: [
        "checkpoint", "inspect", t / "nothing"],
    "eval_missing_data": lambda w, t: [
        "eval", "-m", w["conf"], "--data", t / "missing.csv"],
    "eval_unlabelled": lambda w, t: [
        "eval", "-m", w["conf"], "--data", w["csv"], "--label-columns", 0],
}
KEYWORDS = {"train_without_labels": "requires labels",
            "test_without_labels": "requires labels",
            "checkpoint_every_without_dir": "--checkpoint-dir",
            "resume_auto_without_dir": "--checkpoint-dir",
            "resume_torn_only_dir": "torn",
            "predict_width_mismatch": "label-columns",
            "inspect_missing_dir": "no committed",
            "eval_missing_data": "eval failed",
            "eval_unlabelled": "label_columns >= 1"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(ws, tmp_path, case):
    results = []
    for pkg in ("jax", "port"):
        sub = tmp_path / pkg
        sub.mkdir()
        results.append(run(pkg, *REFUSALS[case](ws, sub)))
    (jrc, _, jerr), (rc, _, err) = results
    assert rc == jrc == 2
    assert KEYWORDS[case] in err and KEYWORDS[case] in jerr
    assert err.replace(str(tmp_path / "port"), "T") == \
        jerr.replace(str(tmp_path / "jax"), "T")
    assert not (tmp_path / "port" / "m.ckpt").exists()


def test_missing_required_flags_exit_as_jax_does():
    for main in (pcli.main, jcli.main):
        with pytest.raises(SystemExit) as e, \
                contextlib.redirect_stderr(io.StringIO()):
            main(["train", "-i", "x.csv"])
        assert e.value.code == 2


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["ckpt", "ck"])
def test_a_checkpoint_of_one_cli_tests_in_the_other(ws, direction, kind):
    writer, reader = direction.split("_to_")
    path = ws[writer][kind]
    got = run(reader, "test", "-i", ws["csv"], "-m", path)
    ref = run(writer, "test", "-i", ws["csv"], "-m", path)
    assert got[0] == ref[0] == 0
    assert last_json(got[1]) == last_json(ref[1])


# ------------------------------------- the program store's flags, device
#: the JAX CLI's `--compile-cache` argvs, refused by the port until its
#: program store (compilecache/) came; every one is taken now
UNPORTED = {
    "fleet": ["fleet", "-m", "m.ckpt", "--compile-cache", "auto"],
    "pipeline": ["pipeline", "--checkpoint-dir", "ck", "--compile-cache",
                 "auto"],
    "--compile-cache": ["train", "-i", "d.csv", "-m", "c.json", "-o",
                        "m.ckpt", "--compile-cache", "auto"],
}


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_commands_exit_2_naming_their_item(what, ws, tmp_path):
    """Nothing of the JAX CLI is left unported: each of these argvs
    parses in both CLIs, and the port takes `--compile-cache`: `auto`
    co-locates the store with the command's checkpoint/model directory
    when there is one (and is a no-op without), a path activates it
    there and exports it to children, `off` does nothing. `train` then
    runs with it and leaves its train step's signature in the store."""
    from deeplearning4j_tpu_torch import compilecache as cc

    argv = UNPORTED[what]
    jcli.build_parser().parse_args(argv)  # a JAX argv ...
    args = pcli.build_parser().parse_args(argv)  # ... parses in the port
    assert args.compile_cache == "auto"
    anchor = tmp_path / "anchor"
    anchor.mkdir()
    cc.deactivate()
    try:
        assert pcli._activate_compile_cache("off", str(anchor)) is None
        assert pcli._activate_compile_cache(
            "auto", str(tmp_path / "missing")) is None
        got = pcli._activate_compile_cache(args.compile_cache, str(anchor))
        assert got == os.path.join(str(anchor), "compile_cache")
        assert os.environ[cc.CACHE_ENV] == got
    finally:
        cc.deactivate()
    if what != "--compile-cache":
        return
    store = tmp_path / "store"
    try:
        rc, out, err = run("port", "train", "-i", ws["csv"], "-m",
                           ws["conf"], "-o", tmp_path / "m.ckpt",
                           "--compile-cache", store)
        assert rc == 0, err
        assert cc.active_dir() == str(store)
        assert cc.stats()["entries"] >= 1 and cc.stats()["misses"] >= 1
    finally:
        cc.deactivate()


@pytest.mark.parametrize("flag,value", [("--compile-cache", "auto"),
                                        ("--compile-cache", "cache"),
                                        ("--warmup-plan", "plan.json")])
def test_serve_refuses_the_compile_cache_and_plan_files(flag, value, ws,
                                                        tmp_path):
    """serve takes `--compile-cache` and `--warmup-plan PATH` (refused
    until the program store came): the announce line names the active
    store (none for `auto` next to a model FILE) and the plan path, and
    the smoke server records its plan there on the way out."""
    from deeplearning4j_tpu_torch import compilecache as cc

    argv = ["serve", "-m", "m.ckpt", flag, value, "--smoke"]
    jcli.build_parser().parse_args(argv)
    argv[2] = str(ws["conf"])
    if value != "auto":
        argv[4] = str(tmp_path / value)
    cc.deactivate()
    try:
        rc, out, err = run("port", *argv)
    finally:
        cc.deactivate()
    assert rc == 0, err
    announce = last_json(out)
    if flag == "--warmup-plan":
        assert announce["warmup_plan"] == argv[4]
        assert announce["compile_cache"] is None
        assert os.path.exists(argv[4])  # recorded after the warmup
    elif value == "auto":
        assert announce["compile_cache"] is None
        assert announce["warmup_plan"] is None
    else:
        assert announce["compile_cache"] == argv[4]
        assert announce["warmup_plan"].startswith(
            os.path.join(argv[4], "plans"))


def test_the_parser_takes_every_jax_subcommand_and_flag():
    def options(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {name: {s for a in p._actions for s in a.option_strings}
                for name, p in sub.choices.items()}

    port, ref = options(pcli.build_parser()), options(jcli.build_parser())
    assert sorted(port) == sorted(ref)
    for name in ref:
        extra = {"--device"} if name in DEVICE_COMMANDS else set()
        assert port[name] == ref[name] | extra, name


@pytest.mark.parametrize("command", ["train", "test", "predict", "eval",
                                     "explicit"])
def test_device_cuda_exits_2_without_a_card(ws, tmp_path, command):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"train": ["train", "-i", ws["csv"], "-m", ws["conf"], "-o",
                      tmp_path / "m.ckpt"],
            "test": ["test", "-i", ws["csv"], "-m", ws["conf"]],
            "predict": ["predict", "-i", ws["features"], "-m", ws["conf"]],
            "eval": ["eval", "-m", ws["conf"], "--data", ws["csv"]],
            "explicit": ["test", "-i", ws["csv"], "-m", ws["conf"],
                         "--device", "cuda"]}[command]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pcli.main([str(a) for a in argv])
    assert rc == 2 and out.getvalue() == ""
    assert "no CUDA device" in err.getvalue()
    assert not os.listdir(tmp_path)


def test_a_subprocess_run_gives_the_in_process_metrics(ws):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "test", "-i",
         str(ws["csv"]), "-m", str(ws["port"]["ckpt"]), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO), env=env)
    assert res.returncode == 0, res.stderr
    assert last_json(res.stdout) == last_json(
        run("port", "test", "-i", ws["csv"], "-m", ws["port"]["ckpt"])[1])


# ----------------------------------------------------------------- holdout
@pytest.mark.parametrize("n_classes", [None, 3, 5])
def test_load_holdout_csv_matches_jax(ws, n_classes):
    got = pholdout.load_holdout_csv(str(ws["csv"]), 1, n_classes)
    want = jholdout.load_holdout_csv(str(ws["csv"]), 1, n_classes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for args in ((0, None), (1, 2)):
        with pytest.raises(ValueError) as e1:
            pholdout.load_holdout_csv(str(ws["csv"]), *args)
        with pytest.raises(ValueError) as e2:
            jholdout.load_holdout_csv(str(ws["csv"]), *args)
        assert str(e1.value) == str(e2.value)


class _Stub(BaseHTTPRequestHandler):
    """/predict: sheds the first request with 503 + Retry-After, then
    answers one-hot of the argmax of each row's first three features;
    `status` other than 503 answers every request with it."""

    status = 503
    seen = []

    def do_POST(self):  # noqa: N802 (http.server's name)
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).seen.append((self.path, self.headers.get("X-Priority"),
                                body.get("priority")))
        if type(self).status is not None:
            status, type(self).status = type(self).status, (
                None if type(self).status == 503 else type(self).status)
            payload = json.dumps({"error": "overloaded",
                                  "retry_after_ms": 50}).encode()
            self.send_response(status)
            self.send_header("Retry-After", "1")
        else:
            x = np.asarray(body["inputs"], np.float32)
            out = np.eye(3)[np.argmax(x[:, :3], axis=1)]
            payload = json.dumps({"outputs": out.tolist()}).encode()
            self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *args):
        pass


@contextlib.contextmanager
def _stub(status):
    handler = type("Stub", (_Stub,), {"status": status, "seen": []})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", handler
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10.0)


def test_evaluate_via_fleet_honours_a_shed_and_matches_jax(ws):
    outs = []
    for mod in (jholdout, pholdout):
        with _stub(503) as (url, handler):
            out = mod.evaluate_via_fleet(url, str(ws["csv"]), n_classes=3,
                                         batch_size=64)
            assert out.pop("path") == url
            assert handler.seen == [("/predict", "batch", "batch")] * 4
        assert out.pop("eval_seconds") > 0
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[1]["shed_retries"] == 1 and outs[1]["n"] == 150
    assert outs[1]["via"] == "fleet" and outs[1]["tier"] == "batch"


def test_evaluate_via_fleet_raises_on_an_error_as_jax_does(ws):
    msgs = []
    for mod in (jholdout, pholdout):
        with _stub(500) as (url, _):
            with pytest.raises(RuntimeError) as e:
                mod.evaluate_via_fleet(url, str(ws["csv"]))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "answered 500" in msgs[1]
