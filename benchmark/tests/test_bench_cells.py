"""Each runner run end to end on the CPU at a tiny size (the look for a
chip skipped), and with the timed path broken underneath: every fault a
cell can have turns `correct` false."""

import json

import pytest
import torch

import run
import tiny

CPU = torch.device("cpu")


def _run(capsys, spec, seed=2**33 + 1, seconds=0.8, trace=0):
    rc = run.main(["--workload", spec.name, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  device=CPU, spec=spec)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    res = json.loads(out[-1])
    assert list(res)[-1] == "checks"
    return res


# ------------------------------------------------------------- serving
def test_batch_decode_cell(capsys):
    res = _run(capsys, tiny.serve_spec())
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    assert res["metrics"]["serve_tokens_per_s"]["value"] > 0
    assert res["checks"]["max_logit_gap"]["value"] == 0.0


def test_queue_stamps_one_time_a_token():
    from harness import serve

    stamps = []
    q = serve.StampedQueue(stamps)
    for tok in (5, 6, 7):
        q.put(tok)
    assert len(stamps) == 3 and stamps == sorted(stamps)
    assert [q.get_nowait() for _ in range(3)] == [5, 6, 7]


def test_traced_serving_run_reads_its_layers(capsys):
    res = _run(capsys, tiny.serve_spec(), trace=1)
    assert res["correct"]
    # no device on the CPU: the device's readers find nothing to read
    assert {"slot_occupancy.batch", "decode_step_ms.batch",
            "serve_mfu.batch"} <= set(res["metrics"])
    assert "k4_roofline.batch" not in res["metrics"]
    assert "device_idle.batch" not in res["metrics"]
    # within a step's tokens at each end of a short window
    assert 0 < res["metrics"]["slot_occupancy.batch"]["value"] <= 105
    assert set(res["device"]) >= {"busy_s", "window_s"}


def test_fault_token_altered_where_produced(capsys, monkeypatch):
    from deeplearning4j_tpu_torch.serving import decode_loop

    orig = decode_loop.GenerationStream._emit

    def altered(self, token):
        n = len(self._generated)
        orig(self, (token + 1) % tiny.GPT_TINY["vocab_size"]
             if n % 5 == 4 else token)

    monkeypatch.setattr(decode_loop.GenerationStream, "_emit", altered)
    res = _run(capsys, tiny.serve_spec())
    assert not res["correct"]
    assert not res["checks"]["max_logit_gap"]["ok"]


@pytest.mark.parametrize("where", ["b1"])
def test_fault_gain_or_bias_dropped(capsys, monkeypatch, where):
    # the other gains and biases move the tiny model's logits too little
    # to show at this width in every run: test_bench_control reads them
    # at a wider one
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

    real = InferenceEngine.for_transformer.__func__

    def dropped(cls, params, *args, **kwargs):
        norms = [params] + params["blocks"]
        if where in ("b1", "b2"):
            for b in params["blocks"]:
                b[where] = torch.zeros_like(b[where])
        for holder in norms:
            for k in [k for k in holder if k.startswith("ln")]:
                if where == "ln_bias":
                    holder[k] = dict(holder[k],
                                     b=torch.zeros_like(holder[k]["b"]))
                elif where == "ln_gain":
                    holder[k] = dict(holder[k],
                                     g=torch.ones_like(holder[k]["g"]))
        return real(cls, params, *args, **kwargs)

    monkeypatch.setattr(InferenceEngine, "for_transformer",
                        classmethod(dropped))
    res = _run(capsys, tiny.serve_spec(sample_tokens=120))
    assert not res["checks"]["max_logit_gap"]["ok"], res["checks"]


# ------------------------------------------------------ data parallel
def test_dp_cell(capsys):
    res = _run(capsys, tiny.dp_spec())
    assert res["correct"] and res["device"]["count"] == 4
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_traced_dp_run(capsys):
    res = _run(capsys, tiny.dp_spec(), trace=1)
    assert res["correct"]
    assert "train_mfu.dp4" in res["metrics"]
    # no device on the CPU: its readers find nothing to read
    assert "allreduce_ms.dp4" not in res["metrics"]
    assert set(res["device"]) >= {"busy_s", "window_s"}


def _dp_fault(monkeypatch, name):
    from deeplearning4j_tpu_torch.parallel import data_parallel as dp

    cls = dp.DataParallelTrainer
    if name == "state_unchanged":
        def step(self, x, labels, n_valid=None):
            params, state = self._params()
            score, grads, count = self._grads(params, x, labels, n_valid)
            return score
        monkeypatch.setattr(cls, "_step", torch.no_grad()(step))
    elif name == "half_batch":
        orig = cls._loss

        def loss(self, params, x, labels, weights):
            h = x.shape[0] // 2
            return orig(self, params, x[:h], labels[:h],
                        None if weights is None else weights[:h])
        monkeypatch.setattr(cls, "_loss", loss)
    elif name == "no_exchange":
        monkeypatch.setattr(cls, "_reduce",
                            lambda self, score, grads: score.reshape(()))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "no_exchange"])
def test_dp_faults(capsys, monkeypatch, fault):
    _dp_fault(monkeypatch, fault)
    res = _run(capsys, tiny.dp_spec())
    assert not res["correct"], res["checks"]
