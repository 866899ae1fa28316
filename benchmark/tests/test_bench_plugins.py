"""Cells found by file: a traffic kind's runner is `harness/<kind>.py`
and a served configuration's model is `models/<model_type>.py`. A new
served model joins through a file of its own, with no edit to the
harness; an unknown kind or model_type exits naming the files there
are; and GPT-2 through `models/gpt2.py` serves and is judged exactly as
the functions that module wraps do."""

import json

import pytest
import torch

import run
import tiny
from harness import common, lm, serve, weights
from reference import gpt2 as ref
from reference.fp8 import strict_float32

CPU = torch.device("cpu")
SEED = 2**33 + 5

#: GPT-2 under another model_type, its sizes under other keys and a
#: serving key of its own, so that nothing of the harness's GPT-2 path
#: could stand in for it
PLUGIN = '''"""GPT-2 served under another model_type."""

from harness import lm, weights
from reference import gpt2 as ref


def dims(config):
    return lm.dims({"vocab_size": config["vocab_size"],
                    "n_embd": config["hidden_size"],
                    "n_head": config["num_attention_heads"],
                    "n_layer": config["num_hidden_layers"],
                    "n_positions": config["max_position_embeddings"]})


def make_params(dims, seed, device, dtype):
    return weights.gpt2_params(dims, seed, device, dtype)


def make_engine(params, dims, dtype, device, serving):
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

    return InferenceEngine.for_transformer(
        params, lm.transformer_config(dims, dtype), device=device,
        decode_slots=serving["slots"], page_size=serving["page_size"],
        kv_pages=serving["kv_pages"], horizon=serving["plugin_horizon"])


def reference_params(dims, seed, device, dtype):
    return weights.to_float32(make_params(dims, seed, device, dtype))


def served_gaps(params32, dims, prompt, served, precision="float32",
                ref_logits=None):
    return ref.served_gaps(params32, dims["n_heads"], prompt, served,
                           precision, ref_logits)
'''


def _main(spec, seconds=0.8):
    return run.main(["--workload", spec.name, "--seed", str(SEED),
                     "--seconds", str(seconds), "--trace", "0"],
                    device=CPU, spec=spec)


def test_a_served_model_joins_by_a_file_of_its_own(capsys, monkeypatch,
                                                   tmp_path):
    (tmp_path / "gpt2_renamed.py").write_text(PLUGIN)
    monkeypatch.setattr(common, "MODELS_DIR", tmp_path)
    g = tiny.GPT_TINY
    spec = tiny.serve_spec()
    spec.config = {"model_type": "gpt2_renamed",
                   "vocab_size": g["vocab_size"], "hidden_size": g["n_embd"],
                   "num_attention_heads": g["n_head"],
                   "num_hidden_layers": g["n_layer"],
                   "max_position_embeddings": g["n_positions"],
                   "torch_dtype": "float32",
                   "serving": {"slots": 4, "page_size": 16, "kv_pages": 64,
                               "plugin_horizon": 1}}
    assert _main(spec) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["metrics"]["serve_tokens_per_s"]["value"] > 0
    assert res["checks"]["max_logit_gap"]["value"] == 0.0


@pytest.mark.parametrize("model_type", ["no_such_model", None])
def test_unknown_model_type_names_the_model_files(model_type):
    spec = tiny.serve_spec()
    spec.config = dict(spec.config, model_type=model_type)
    if model_type is None:
        del spec.config["model_type"]
    with pytest.raises(SystemExit) as e:
        _main(spec)
    msg = str(e.value.code)
    assert repr(model_type) in msg and "'gpt2'" in msg
    assert "__init__" not in msg


def test_unknown_traffic_kind_names_the_runners():
    spec = tiny.serve_spec(kind="no_such_kind")
    with pytest.raises(SystemExit) as e:
        _main(spec)
    msg = str(e.value.code)
    assert "'no_such_kind'" in msg
    assert "'serve'" in msg and "'train_dp'" in msg
    # modules without a `run` are no runners
    assert "'common'" not in msg and "'traffic'" not in msg
    assert common.runner_kinds() == ["serve", "train_dp"]


def test_gpt2_module_serves_and_judges_as_the_calls_it_wraps():
    spec = tiny.serve_spec()
    cfg, mix = spec.config, spec.traffic
    served = serve.Served(spec, SEED, CPU, {})
    w = serve.drive(served, mix, SEED, 0.8)
    picked = serve.sample(w["client"], SEED, int(mix["sample_tokens"]))
    w["client"].cancel_rest()
    served.close()
    assert picked
    strict_float32()
    params32 = served.reference_params()
    gaps, judged = serve.widest_gaps(served.model, params32, served.dm,
                                     picked, ("float32", "fp8"))

    dm = lm.dims(cfg)
    assert served.dm == dm
    direct32 = weights.to_float32(weights.gpt2_params(dm, SEED, CPU,
                                                      torch.float32))
    ours, theirs = weights.leaves(params32), weights.leaves(direct32)
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(ours, theirs))

    # the same prompts served by the engine built by the direct call
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

    s = cfg["serving"]
    engine = InferenceEngine.for_transformer(
        weights.gpt2_params(dm, SEED, CPU, torch.float32),
        lm.transformer_config(dm, torch.float32), device=CPU,
        decode_slots=int(s["slots"]), page_size=int(s["page_size"]),
        kv_pages=int(s["kv_pages"]), prefix_cache=bool(s["prefix_cache"]),
        horizon=int(s["horizon"]))
    try:
        streams = [engine.generate_stream(r.prompt, r.max_tokens)
                   for r in picked]
        direct_tokens = [st.result(timeout=120) for st in streams]
    finally:
        engine.close()
    served_tokens = [r.stream.result(timeout=0) for r in picked]
    assert served_tokens == direct_tokens

    worst, count = {"float32": 0.0, "fp8": 0.0}, 0
    for r, toks in zip(picked, served_tokens):
        ref_logits = None
        for p in worst:
            g, ref_logits = ref.served_gaps(direct32, dm["n_heads"],
                                            r.prompt.tolist(), toks, p,
                                            ref_logits)
            worst[p] = max(worst[p], float(g.max()))
        count += len(toks)
    assert gaps == worst and judged == count
