"""The controls that set each limit's upper end: the reference computed
in float8 (one step below the configurations' bfloat16) and the faults
planted in the reference put in the program's place read well above
the limits, here at sizes a test run holds. The same readings at the
cells' own sizes come from `benchmark/control.py` on the card (the
`cuda` tests below)."""

import json
import subprocess
import sys

import pytest
import torch

import tiny
from harness import checks, common, train_dp, weights
from reference import gpt2 as ref

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_moves_served_tokens(seed):
    ref.strict_float32()
    dm = {"vocab_size": 16384, "d_model": 256, "n_heads": 4, "n_layers": 4,
          "d_ff": 1024, "max_len": 512}
    p = weights.to_float32(weights.gpt2_params(dm, seed, CPU,
                                               torch.float32))
    toks = torch.randint(0, 16384, (448,),
                         generator=torch.Generator().manual_seed(seed))
    toks = toks.tolist()
    g8, _ = ref.served_gaps(p, 4, toks[:64], toks[64:], "fp8")
    # far above the tiny serving cells' limit
    assert float(g8.max()) > 10 * tiny.serve_spec().limits["max_logit_gap"]


def _dropped(params, where):
    """A copy of `params` with one kind of gain or bias dropped."""
    q = {"embed": params["embed"], "pos": params["pos"],
         "ln_f": dict(params["ln_f"]),
         "blocks": [dict(b) for b in params["blocks"]]}
    for holder in [q] + q["blocks"]:
        for k in [k for k in holder if k.startswith("ln")]:
            holder[k] = dict(holder[k])
            if where == "ln_bias":
                holder[k]["b"] = torch.zeros_like(holder[k]["b"])
            elif where == "ln_gain":
                holder[k]["g"] = torch.ones_like(holder[k]["g"])
    if where in ("b1", "b2"):
        for b in q["blocks"]:
            b[where] = torch.zeros_like(b[where])
    return q


@pytest.mark.parametrize("where", ["b1", "b2", "ln_bias", "ln_gain"])
def test_a_dropped_gain_or_bias_moves_served_tokens(where):
    # the tokens a program that drops it would put first, each judged by
    # its gap below the reference's best, against the serving cell's limit
    ref.strict_float32()
    dm = {"vocab_size": 8192, "d_model": 256, "n_heads": 4, "n_layers": 8,
          "d_ff": 1024, "max_len": 512}
    p = weights.to_float32(weights.gpt2_params(dm, 3, CPU, torch.float32))
    toks = torch.randint(0, 8192, (1, 384),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        good = ref.logits(p, toks, 4)[0, 64:]
        chosen = ref.logits(_dropped(p, where), toks, 4)[0, 64:].argmax(-1)
    gap = good.max(-1).values - good.gather(-1, chosen[:, None])[:, 0]
    limit = common.load_limits("gpt2-medium.serve.batch_decode")
    assert float(gap.max()) > limit["max_logit_gap"]


@pytest.mark.parametrize("variant", [
    {"precision": "fp8"},
    {"keep_rows": list(range(128))},
    {"keep_rows": list(range(64)), "grad_scale": 0.25}])
def test_dp_control_and_faults_exceed_the_limits(variant):
    spec = tiny.dp_spec()
    cfg, mix = spec.config, spec.traffic
    refr = train_dp.reference_readings(cfg, mix, 5, CPU)
    got = train_dp.reference_readings(cfg, mix, 5, CPU, **variant)
    gaps = {"loss_gap": checks.loss_gap(got["loss"], refr["loss"]),
            "first_grad_gap": checks.norm_gap(got["grad"], refr["grad"]),
            "change_gap": checks.norm_gap(
                got["change"], refr["change"],
                checks.moving_leaves(refr["grad"]))}
    assert any(gaps[k] > 10 * spec.limits[k] for k in gaps), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gpt2-medium.serve.batch_decode"])
def test_serving_control_at_cell_size(cuda_device, cell):
    out = subprocess.run(
        [sys.executable, str(common.BENCH_DIR / "control.py"), "--workload",
         cell, "--seeds", "101,202,303", "--seconds", "10"],
        capture_output=True, text=True, check=True, cwd=common.ROOT)
    limit = common.load_limits(cell)["max_logit_gap"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert r["program_gap"] < limit < r["control_gap"], r


@pytest.mark.cuda
def test_dp_control_at_cell_size(cuda_device):
    cell = "mnist-mlp.train.dp4"
    out = subprocess.run(
        [sys.executable, str(common.BENCH_DIR / "control.py"), "--workload",
         cell, "--seeds", "101,202,303"],
        capture_output=True, text=True, check=True, cwd=common.ROOT)
    limits = common.load_limits(cell)
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        for variant in ("control_fp8", "half_batch", "no_exchange"):
            assert any(r[variant][k] > limits[k] for k in limits), r
