"""The PyTorch port's `train --elastic N` and `watchdog` (deeplearning4j_
tpu_torch/cli.py) held against the JAX CLI's contract, on the CPU:
tests/test_cli.py's `test_train_elastic_smoke` and tests/test_controlplane.
py's `TestWatchdogCLI`, run through `python -m
deeplearning4j_tpu_torch.cli` with `--device cpu` (which the elastic path
passes into every worker's performer conf). Without `--device cpu` and
with no card the command exits 2 before it spawns anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deeplearning4j_tpu_torch import cli as pcli
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets.iris import load_iris

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_LIMIT = 300  # seconds a CLI subprocess may take


def _conf_json():
    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(2).use_adagrad(False).momentum(0.0)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build().to_json())


@pytest.fixture
def iris_files(tmp_path):
    x, y = load_iris()
    data = np.hstack([np.asarray(x),
                      np.argmax(np.asarray(y), axis=1)[:, None]])
    csv = str(tmp_path / "iris.csv")
    np.savetxt(csv, data, delimiter=",", fmt="%.6f")
    conf = str(tmp_path / "econf.json")
    with open(conf, "w") as f:
        f.write(_conf_json())
    return csv, conf


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def _cli(*argv, timeout=CLI_LIMIT):
    return subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT)


@pytest.mark.elastic
def test_train_elastic_smoke(tmp_path, iris_files, capsys):
    """`train --elastic N` drives the TrainingSupervisor end to end
    from the CLI: N spawned workers on the CPU, every job folded, model
    saved (and loadable)."""
    from deeplearning4j_tpu_torch.scaleout.checkpoint import \
        load_checkpoint

    csv, conf = iris_files
    out_path = str(tmp_path / "elastic.ckpt")
    assert pcli.main(["train", "-i", csv, "-m", conf,
                      "-o", out_path, "--elastic", "2", "--epochs", "1",
                      "--batch-size", "50",
                      "--checkpoint-dir", str(tmp_path / "eck"),
                      "--run-timeout", "240", "--device", "cpu"]) == 0
    summary = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["saved"] == out_path
    assert summary["workers"] == 2
    assert summary["folded"] == summary["jobs"] == 3  # ceil(150/50)
    assert summary["respawns"] == 0
    assert set(summary) >= {"score", "waves", "evictions", "resumes",
                            "incarnation", "adopted"}
    net, _ = load_checkpoint(out_path, device="cpu")
    x, y = load_iris()
    assert net.score(x, y) == pytest.approx(summary["score"], abs=1e-6)


@pytest.mark.elastic
def test_watchdog_wraps_an_elastic_train_to_the_end(tmp_path, iris_files):
    csv, conf = iris_files
    out_path = str(tmp_path / "w.ckpt")
    out = _cli("watchdog", "--max-restarts", "2", "--backoff", "0.05",
               "--", "train", "--elastic", "2", "-i", csv, "-m", conf,
               "-o", out_path, "--batch-size", "30", "--epochs", "2",
               "--state-dir", str(tmp_path / "state"),
               "--checkpoint-dir", str(tmp_path / "ck"),
               "--run-timeout", "240", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-4000:]
    lines = _json_lines(out.stdout)
    assert any(e.get("watchdog_done") and e["restarts"] == 0
               for e in lines)
    summary = [e for e in lines if "saved" in e][-1]
    assert summary["folded"] == summary["jobs"] == 10
    assert summary["incarnation"] == 0 and summary["adopted"] == 0
    assert os.path.exists(out_path)
    # a clean finish clears the journal
    assert not os.path.exists(str(tmp_path / "state"
                                  / "supervisor.journal"))


def test_train_elastic_without_a_card_exits_2_before_spawning(
        tmp_path, iris_files, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would start")
    csv, conf = iris_files
    rc = pcli.main(["train", "-i", csv, "-m", conf,
                    "-o", str(tmp_path / "m.ckpt"), "--elastic", "2",
                    "--checkpoint-dir", str(tmp_path / "ck")])
    assert rc == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "ck"))


def test_train_elastic_resume_auto_without_checkpoint_dir_refuses(
        tmp_path, iris_files, capsys):
    csv, conf = iris_files
    assert pcli.main(["train", "-i", csv, "-m", conf,
                      "-o", str(tmp_path / "m.ckpt"), "--elastic", "2",
                      "--resume", "auto", "--device", "cpu"]) == 2
    assert "--checkpoint-dir" in capsys.readouterr().err


def test_elastic_and_watchdog_argv_of_the_jax_cli_parse():
    from deeplearning4j_tpu import cli as jcli

    argvs = [["train", "-i", "d.csv", "-m", "c.json", "-o", "m.ckpt",
              "--elastic", "3", "--max-respawns", "1",
              "--straggler-factor", "2.5", "--status-port", "0",
              "--run-timeout", "60", "--state-dir", "s"],
             ["watchdog", "--max-restarts", "4", "--backoff", "0.5",
              "--backoff-max", "8", "--stop-grace", "3", "--", "train",
              "--elastic", "2"]]
    for argv in argvs:
        ours = vars(pcli.build_parser().parse_args(argv))
        theirs = vars(jcli.build_parser().parse_args(argv))
        for key in theirs:
            if key not in ("fn", "device"):
                assert ours[key] == theirs[key], key
        assert ours["fn"].__name__ == theirs["fn"].__name__


class TestWatchdogCLI:
    def _run(self, *argv, timeout=120):
        return _cli("watchdog", *argv, timeout=timeout)

    def test_success_exits_clean_with_zero_restarts(self, tmp_path):
        from deeplearning4j_tpu_torch.checkpoint import format as ckfmt

        ck = str(tmp_path / "ck")
        ckfmt.write_checkpoint(ck, 1, {"iterator_position": 1})
        out = self._run("--max-restarts", "3", "--backoff", "0.05",
                        "--", "checkpoint", "inspect", ck, "--json")
        assert out.returncode == 0, out.stderr
        lines = _json_lines(out.stdout)
        assert any(e.get("watchdog_done") and e["restarts"] == 0
                   for e in lines)

    def test_failure_restarts_with_backoff_then_gives_up(self,
                                                         tmp_path):
        out = self._run("--max-restarts", "2", "--backoff", "0.05",
                        "--", "checkpoint", "inspect",
                        str(tmp_path / "missing"))
        assert out.returncode != 0
        lines = _json_lines(out.stdout)
        restarts = [e for e in lines if "watchdog_restart" in e]
        assert [e["watchdog_restart"] for e in restarts] == [1, 2]
        assert restarts[1]["backoff_s"] > restarts[0]["backoff_s"]
        assert any(e.get("watchdog_gave_up") for e in lines)
        assert len([e for e in lines if "watchdog_child" in e]) == 3

    def test_refuses_to_wrap_nothing_or_itself(self):
        out = self._run("--", timeout=60)
        assert out.returncode == 2
        out = self._run("--", "watchdog", "--", "x", timeout=60)
        assert out.returncode == 2
