"""The traffic generator: deterministic for a seed, the same set of
sizes and gaps for every seed, lengths inside their stated ranges."""

import numpy as np
import pytest

from harness import common, traffic

MIXES = sorted(p.stem for p in (common.BENCH_DIR / "traffic").glob("*.json"))
SERVE = [m for m in MIXES if common.load_traffic(m)["kind"] == "serve"]


@pytest.mark.parametrize("mix", SERVE)
def test_same_seed_same_requests(mix):
    spec = common.load_traffic(mix)
    a = traffic.serve_requests(spec, 50257, 2**33 + 5, 200)
    b = traffic.serve_requests(spec, 50257, 2**33 + 5, 200)
    c = traffic.serve_requests(spec, 50257, 2**33 + 6, 200)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_tokens ==
               y.max_tokens for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("mix", SERVE)
def test_lengths_stay_in_range_and_every_seed_gets_the_same_set(mix):
    spec = common.load_traffic(mix)
    n = 4 * traffic.STRATA
    sets = []
    for seed in (1, 2**31 + 3, 2**40):
        reqs = traffic.serve_requests(spec, 50257, seed, n)
        plens = [len(r.prompt) for r in reqs]
        olens = [r.max_tokens for r in reqs]
        assert min(plens) >= spec["prompt"]["low"]
        assert max(plens) <= spec["prompt"]["high"]
        assert min(olens) >= spec["output"]["low"]
        assert max(olens) <= spec["output"]["high"]
        assert all(0 <= t < 50257 for r in reqs for t in r.prompt)
        sets.append((sorted(plens), sorted(olens)))
    assert sets[0] == sets[1] == sets[2]


def test_quantiles_of_each_distribution():
    assert traffic.quantile({"dist": "fixed", "value": 7}, 0.3) == 7
    assert traffic.quantile({"dist": "uniform", "low": 10, "high": 20},
                            0.5) == 15
    lu = {"dist": "loguniform", "low": 64, "high": 256}
    assert traffic.quantile(lu, 0.5) == 128
    ln = {"dist": "lognormal", "median": 384, "sigma": 0.5, "low": 128,
          "high": 768}
    assert traffic.quantile(ln, 0.5) == 384
    assert traffic.quantile(ln, 1e-9) == 128
    with pytest.raises(ValueError):
        traffic.quantile({"dist": "zipf"}, 0.5)


def test_a_closed_mix_draws_more_than_a_run_finishes():
    spec = common.load_traffic("batch_decode")
    reqs = traffic.serve_requests(spec, 50257, 3)
    # 64 slots hold ~600 of these requests in a 30 s window
    assert len(reqs) == traffic.MAX_REQUESTS >= 2000
