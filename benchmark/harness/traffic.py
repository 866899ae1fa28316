"""The one traffic generator: it reads a mix's parameters (a dict from
`traffic/<name>.json`) and makes its requests or batches from a seed.

Every seed gets the same set of sizes in another order: a length is a
quantile of its distribution, taken from a grid of STRATA evenly spaced
quantiles, and each run of STRATA consecutive requests holds the whole
grid, shuffled by the seed. Token ids are drawn from the seed.

Distributions (`{"dist": ...}`): `loguniform` (low, high), `uniform`
(low, high), `lognormal` (median, sigma, clipped to low..high) and
`fixed` (value).
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

#: points of the quantile grid a block of requests holds
STRATA = 64
#: requests a closed mix draws: more than a run's slots can finish
MAX_REQUESTS = 4096


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use (`stream`) of a seed."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])


def quantile(dist: dict, q: float) -> int:
    kind = dist["dist"]
    if kind == "fixed":
        return int(dist["value"])
    if kind == "uniform":
        v = dist["low"] + q * (dist["high"] - dist["low"])
    elif kind == "loguniform":
        lo, hi = math.log(dist["low"]), math.log(dist["high"])
        v = math.exp(lo + q * (hi - lo))
    elif kind == "lognormal":
        v = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(q))
        v = min(max(v, dist["low"]), dist["high"])
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return int(round(v))


def stratified(dist: dict, n: int, strata: int, rng) -> np.ndarray:
    """n lengths: block after block of the `strata`-point quantile grid,
    each block in its own shuffled order."""
    grid = np.array([quantile(dist, (i + 0.5) / strata)
                     for i in range(strata)], np.int64)
    blocks = -(-n // strata)
    return np.concatenate([grid[rng.permutation(strata)]
                           for _ in range(blocks)])[:n]


class Request:
    """One generation request and what the client saw of it."""

    __slots__ = ("idx", "prompt", "max_tokens", "sent", "stream", "times",
                 "seen", "finished", "failed")

    def __init__(self, idx, prompt, max_tokens):
        self.idx = idx
        self.prompt = prompt
        self.max_tokens = int(max_tokens)
        self.sent = None        # host clock at submit
        self.stream = None
        self.times = []         # host clock at which each token was seen
        self.seen = 0
        self.finished = None    # host clock when seen done
        self.failed = False


def serve_requests(mix: dict, vocab: int, seed: int,
                   n: int = MAX_REQUESTS) -> list:
    """The first n requests of a serving mix: prompts of unique seeded
    ids and their output budgets."""
    plens = stratified(mix["prompt"], n, STRATA, rng_for(seed, 1))
    olens = stratified(mix["output"], n, STRATA, rng_for(seed, 2))
    ids = rng_for(seed, 3).integers(0, vocab, size=int(plens.sum()),
                                    dtype=np.int64)
    out, off = [], 0
    for i in range(n):
        out.append(Request(i, ids[off:off + plens[i]].astype(np.int32),
                           olens[i]))
        off += plens[i]
    return out
