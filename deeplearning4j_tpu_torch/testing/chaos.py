"""Seeded, deterministic fault injection with named injection points.

The checkpoint writer grew an ad-hoc `between_files` crash hook; every
other drill in docs/FAULT_TOLERANCE.md and docs/FLEET.md injected its
fault by hand (kill a process here, close a socket there). This module
generalizes that into ONE registry the whole stack shares: production
code calls `chaos.hit("point.name")` at its injection points (a no-op
costing one attribute load while no plan is active), and a test, soak,
or bench activates a `ChaosPlan` — a seeded schedule of `Rule`s — to
make named points misbehave deterministically.

Injection points shipped today (`POINTS` below): socket faults on the
serving HTTP front end (accept-then-hang, slow-loris-shaped delays,
mid-stream reset on `/generate`), IO faults in the sharded checkpoint
writer (shard write / atomic-rename errors — the `between_files` drill,
generalized), and numeric faults (NaN-poisoned host batches feeding the
training guardian's non-finite defense). Process faults (SIGKILL /
SIGSTOP for hung replicas / SIGCONT) don't need an in-process point —
the `sigstop`/`sigcont`/`sigkill` helpers act on `ReplicaSpawner`
processes from the driving test or bench (`bench.py chaos`).

Determinism and replay: each rule draws from its OWN `random.Random`
seeded by `(plan.seed, rule index, point)`, and fires against the
POINT-LOCAL hit ordinal — so a rule's schedule depends only on the plan
spec and how many times its point was hit, never on other rules or
points. Every firing is recorded (`plan.log()`); `plan.replay_rules()`
converts a recorded schedule into exact-ordinal `at=` rules, so a
failing randomized soak replays bit-for-bit from its failure log.

Per-process activation: spawned replica servers participate by env —
`ReplicaSpawner(env={**os.environ, **chaos.env_spec(rules, seed=7)})`
serializes the plan into `DL4J_TPU_CHAOS`, and the child process
activates it on first `hit()`. Every firing also counts into the
`dl4j_chaos_injected{point=,kind=}` telemetry series, so a drill's /metrics
scrape shows exactly what was injected (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["ChaosError", "ChaosReset", "Rule", "ChaosPlan", "POINTS",
           "KINDS", "ENV_VAR", "activate", "deactivate", "active",
           "configure", "hit", "maybe_nan", "env_spec",
           "sigstop", "sigcont", "sigkill"]

ENV_VAR = "DL4J_TPU_CHAOS"

#: rule kinds — "error"/"reset" raise at the point ("reset" asks the
#: site for a hard connection reset), "hang"/"delay" sleep there, "nan"
#: asks the site to poison its array (`maybe_nan`)
KINDS = ("error", "hang", "delay", "reset", "nan")

#: the named injection points production code carries today. hit() on a
#: name outside this table still works (new sites register by use);
#: the table is the documentation contract (docs/FAULT_TOLERANCE.md).
POINTS = {
    "server.accept": "serving HTTP front end, before any POST route "
                     "runs (accept-then-hang, errors before a reply)",
    "server.read": "after the request body is slurped (slow-loris-"
                   "shaped handler delays)",
    "server.predict": "before /predict admission into the batcher",
    "server.generate": "before /generate admission into the decode loop",
    "generate.midstream": "between streamed /generate chunks (in-band "
                          "error or hard socket reset mid-stream)",
    "decode.step": "decode loop, at the top of every scheduler pass "
                   "(tick) — a delay rule paces decode itself so SLO "
                   "drills can hold slot occupancy open; an error "
                   "fails every in-flight stream loudly",
    "decode.fork": "decode loop's copy-on-write page fork, after the "
                   "destination page is claimed (possibly by evicting "
                   "a cached prefix page) but before the device copy "
                   "— drills prove mid-fork faults leave pool-page "
                   "accounting balanced",
    "router.forward": "fleet router, before forwarding to a replica",
    "router.stream_resume": "fleet router, before each mid-stream "
                            "/generate failover attempt (after a "
                            "replica died/hung with the stream "
                            "partially delivered, before the "
                            "continuation is re-admitted on a "
                            "survivor — error = a resume that "
                            "fails, driving the bounded-attempts/"
                            "in-band-error fallback)",
    "checkpoint.write": "before each checkpoint shard file write",
    "checkpoint.rename": "before each atomic rename publish "
                         "(manifest, COMMITTED marker)",
    "train.batch": "host training batch before H2D (NaN poison "
                   "feeding the guardian's non-finite defense)",
    "worker.spawn": "supervised training worker entrypoint, before it "
                    "registers (error = spawn crash, delay = slow boot "
                    "— exercises the supervisor's respawn/backoff)",
    "worker.step": "supervised training worker, before each job's fit "
                   "(hang = hung-but-heartbeating worker for the "
                   "progress watermark, delay = deterministic "
                   "straggler, error = job failure/retry)",
    "worker.heartbeat": "supervised training worker's progress "
                        "reporter, before each progress line (hang/"
                        "delay silence the telemetry plane)",
    "worker.reconnect": "supervised training worker's supervisor-"
                        "reconnect loop, before each rejoin attempt "
                        "after the control plane vanished (error = "
                        "a worker that fails to rejoin and exits; "
                        "delay = slow re-announce)",
    "supervisor.journal": "training control-plane journal "
                          "(utils/statefile.py), fired with op=write "
                          "before the tmp write and op=rename before "
                          "the commit rename — an injected error at "
                          "ANY ordinal leaves the previous committed "
                          "journal in place (crash-atomicity drills)",
    "fleet.journal": "serving control-plane journal (the fleet/router "
                     "twin of supervisor.journal; same write/rename "
                     "ordinals and atomicity contract)",
    "fleet.kv_ship": "fleet KV page shipping (serving/fleetkv.py), "
                     "fired with role=export on the donor before its "
                     "pinned pages are read out, and role=fetch on "
                     "the receiver before it dials the donor — an "
                     "error/reset/hang ANYWHERE here must leave the "
                     "receiver falling back to plain prefill with a "
                     "bit-identical stream and both pools' page "
                     "accounting balanced (a hang on the export side "
                     "holds the donor's pins open, proving eviction "
                     "cannot consume a page mid-serialization)",
    "fleet.kv_summary": "replica affinity-summary build, before the "
                        "trie heads are hashed for /readyz — a fault "
                        "here degrades the replica to no-affinity "
                        "placement, never to unready",
    "compile.cache_write": "persistent AOT program store "
                           "(compilecache/store.py), fired with "
                           "op=write before the tmp entry write and "
                           "op=rename before the commit rename — an "
                           "error at ANY ordinal loses only that cache "
                           "entry (the process keeps its compiled "
                           "program; the next boot recompiles), and a "
                           "torn write is CRC-quarantined, never "
                           "loaded (docs/WARMUP.md)",
    "compile.cache_read": "persistent AOT program store, before each "
                          "entry read at load time — an error degrades "
                          "that program to a plain cold compile, "
                          "never a serve/train failure",
    "pipeline.watch": "deployment controller's checkpoint-directory "
                      "scan, before each poll's committed-step listing "
                      "(errors = an unreadable checkpoint root the "
                      "watcher must survive and retry)",
    "pipeline.eval": "deployment controller's eval gate, before the "
                     "held-out evaluation of a candidate runs (errors "
                     "leave the candidate pending — an eval that could "
                     "not run is NOT a failed eval, docs/PIPELINE.md)",
    "pipeline.promote": "deployment controller, before the canary "
                        "rolling reload is driven (errors mid-decision "
                        "leave the fleet on exactly one champion — the "
                        "journal resumes the promotion)",
    "controller.journal": "deployment controller journal (the deploy-"
                          "plane twin of supervisor.journal; same "
                          "write/rename ordinals and atomicity "
                          "contract)",
}


class ChaosError(RuntimeError):
    """An injected fault (kind="error"). Sites let it propagate like
    any real failure — that is the point."""


class ChaosReset(ChaosError):
    """An injected hard-reset (kind="reset"): the site should abort its
    connection abruptly (RST, not FIN) — a ChaosError for sites without
    a socket to reset."""


class Rule:
    """One fault rule bound to one injection point.

    `prob` fires per point-hit from the rule's own seeded RNG; `times`
    caps total firings; `after` skips the first N hits; `at` (explicit
    hit ordinals) overrides prob/after — the replay mechanism. `delay_s`
    sizes "delay" sleeps, `hang_s` sizes "hang" (default: effectively
    forever on request timescales)."""

    def __init__(self, point: str, kind: str, *, prob: float = 1.0,
                 times: Optional[int] = None, after: int = 0,
                 at: Optional[Sequence[int]] = None,
                 delay_s: float = 0.05, hang_s: float = 3600.0,
                 message: Optional[str] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown chaos kind {kind!r} "
                             f"(have {KINDS})")
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        self.point = str(point)
        self.kind = kind
        self.prob = float(prob)
        self.times = None if times is None else int(times)
        self.after = int(after)
        self.at = None if at is None else frozenset(int(i) for i in at)
        self.delay_s = float(delay_s)
        self.hang_s = float(hang_s)
        self.message = message

    def to_dict(self) -> dict:
        out: Dict[str, Any] = {"point": self.point, "kind": self.kind}
        if self.prob != 1.0:
            out["prob"] = self.prob
        if self.times is not None:
            out["times"] = self.times
        if self.after:
            out["after"] = self.after
        if self.at is not None:
            out["at"] = sorted(self.at)
        if self.delay_s != 0.05:
            out["delay_s"] = self.delay_s
        if self.hang_s != 3600.0:
            out["hang_s"] = self.hang_s
        if self.message is not None:
            out["message"] = self.message
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Rule":
        return cls(**d)

    def __repr__(self) -> str:
        return f"Rule({self.to_dict()!r})"


class ChaosPlan:
    """A seeded set of rules plus the firing log.

    Thread-safe: concurrent hits serialize on one lock, and each point
    keeps its own hit ordinal — a rule's decision for (point, ordinal)
    is a pure function of the plan spec, so a recorded log replays
    exactly (`replay_rules`) even when the original run was driven by
    concurrent request threads."""

    def __init__(self, rules: Sequence[Union[Rule, dict]],
                 seed: int = 0):
        self.seed = int(seed)
        self.rules: List[Rule] = [
            r if isinstance(r, Rule) else Rule.from_dict(r)
            for r in rules]
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fired = [0] * len(self.rules)
        self._log: List[dict] = []
        self._started = time.monotonic()
        # one RNG per rule, seeded by (plan seed, rule index, point):
        # rule i's draw for its point's n-th hit never depends on other
        # rules, other points, or wall-clock interleaving
        self._rngs = [random.Random(f"{self.seed}:{i}:{r.point}")
                      for i, r in enumerate(self.rules)]

    # ------------------------------------------------------- decisions
    def decide(self, point: str) -> Optional[Rule]:
        """Advance `point`'s hit ordinal and return the first rule that
        fires for it (or None). Called by `hit()`."""
        with self._lock:
            n = self._hits.get(point, 0)
            self._hits[point] = n + 1
            for i, rule in enumerate(self.rules):
                if rule.point != point:
                    continue
                if rule.times is not None and self._fired[i] >= rule.times:
                    continue
                if rule.at is not None:
                    fire = n in rule.at
                else:
                    if n < rule.after:
                        continue
                    # draw even at prob 1.0: the RNG stream position
                    # stays a function of the ordinal alone
                    draw = self._rngs[i].random()
                    fire = draw < rule.prob or rule.prob >= 1.0
                if fire:
                    self._fired[i] += 1
                    self._log.append({
                        "point": point, "kind": rule.kind, "hit": n,
                        "rule": i,
                        "t_s": round(time.monotonic() - self._started,
                                     4)})
                    return rule
            return None

    # ------------------------------------------------------ inspection
    def log(self) -> List[dict]:
        """Every firing so far (point, kind, point-local hit ordinal,
        rule index) — the failure log a soak prints on assert."""
        with self._lock:
            return [dict(e) for e in self._log]

    def hits(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hits)

    def fired(self) -> int:
        with self._lock:
            return sum(self._fired)

    def replay_rules(self) -> List[Rule]:
        """Rules that reproduce this plan's recorded schedule exactly:
        each original rule becomes an `at=` rule pinned to the ordinals
        it fired on. `ChaosPlan(plan.replay_rules())` fires the same
        faults at the same hits, whatever the seed."""
        by_rule: Dict[int, List[int]] = {}
        for entry in self.log():
            by_rule.setdefault(entry["rule"], []).append(entry["hit"])
        out = []
        for i, ords in sorted(by_rule.items()):
            src = self.rules[i]
            out.append(Rule(src.point, src.kind, at=ords,
                            delay_s=src.delay_s, hang_s=src.hang_s,
                            message=src.message))
        return out

    def spec(self) -> dict:
        """JSON-serializable plan spec (the `DL4J_TPU_CHAOS` payload)."""
        return {"seed": self.seed,
                "rules": [r.to_dict() for r in self.rules]}


# ------------------------------------------------------- process faults
def _pid(proc) -> int:
    return proc if isinstance(proc, int) else proc.pid


def sigstop(proc) -> None:
    """Freeze a replica process (hung-but-TCP-alive: the kernel keeps
    accepting connections into the listen backlog, the process never
    answers — the failure mode the circuit breaker exists for)."""
    os.kill(_pid(proc), signal.SIGSTOP)


def sigcont(proc) -> None:
    """Thaw a SIGSTOP'd process (the recovery half of the drill)."""
    os.kill(_pid(proc), signal.SIGCONT)


def sigkill(proc) -> None:
    """Hard-kill (the crash fault the fleet's eviction drills use)."""
    os.kill(_pid(proc), signal.SIGKILL)


# ---------------------------------------------------- module activation
_active: Optional[ChaosPlan] = None
_env_checked = False
_state_lock = threading.Lock()
_counters: Dict[Tuple[str, str], Any] = {}


def active() -> Optional[ChaosPlan]:
    """The live plan, bootstrapping from `DL4J_TPU_CHAOS` once (how a
    spawned replica process joins a drill)."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        with _state_lock:
            if not _env_checked:
                _env_checked = True
                raw = os.environ.get(ENV_VAR)
                if raw:
                    spec = json.loads(raw)
                    _active = ChaosPlan(spec.get("rules", []),
                                        seed=spec.get("seed", 0))
    return _active


def activate(plan: ChaosPlan) -> ChaosPlan:
    global _active
    with _state_lock:
        _active = plan
    return plan


def deactivate() -> Optional[ChaosPlan]:
    """Deactivate and return the plan (its log survives for replay)."""
    global _active, _env_checked
    with _state_lock:
        plan, _active = _active, None
        _env_checked = True  # an explicit deactivate beats the env
    return plan


def configure(rules: Sequence[Union[Rule, dict]],
              seed: int = 0) -> ChaosPlan:
    """Build and activate a plan in one call (tests/soaks)."""
    return activate(ChaosPlan(rules, seed=seed))


def env_spec(rules: Sequence[Union[Rule, dict]],
             seed: int = 0) -> Dict[str, str]:
    """Env-var dict that activates this plan in a spawned process:
    `ReplicaSpawner(env={**os.environ, **chaos.env_spec(...)})`."""
    return {ENV_VAR: json.dumps(ChaosPlan(rules, seed=seed).spec())}


def _count(point: str, kind: str) -> None:
    key = (point, kind)
    c = _counters.get(key)
    if c is None:
        # lazy import: chaos must stay import-light (checkpoint/serving
        # both pull it in) and never cycle with telemetry
        from deeplearning4j_tpu_torch import telemetry

        c = telemetry.get_registry().counter(
            "dl4j_chaos_injected",
            "faults injected by the chaos layer").labels(
                point=point, kind=kind)
        _counters[key] = c
    c.inc()


# -------------------------------------------------------------- the hook
def hit(point: str, **ctx) -> Optional[str]:
    """The injection point. No active plan: returns None (one global
    load + compare). Otherwise the first matching rule acts here —
    "error"/"reset" raise, "hang"/"delay" sleep — and the kind is
    returned for site-handled kinds ("nan", and "reset" sites that
    catch `ChaosReset`)."""
    plan = _active if _env_checked else active()
    if plan is None:
        return None
    rule = plan.decide(point)
    if rule is None:
        return None
    _count(point, rule.kind)
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return "delay"
    if rule.kind == "hang":
        time.sleep(rule.hang_s)
        return "hang"
    if rule.kind == "reset":
        raise ChaosReset(
            rule.message or f"chaos: injected reset at {point}")
    if rule.kind == "error":
        raise ChaosError(
            rule.message or f"chaos: injected error at {point}")
    return rule.kind  # "nan": the site corrupts via maybe_nan


def maybe_nan(point: str, arr, **ctx):
    """Numeric-fault site helper: returns `arr` NaN-poisoned (a copy)
    when a "nan" rule fires at `point`, else `arr` untouched. Only
    float arrays are poisoned — the guardian's non-finite defense is
    the downstream consumer (docs/FAULT_TOLERANCE.md). A torch tensor
    is poisoned as a copy on its own device (the same elements as a
    numpy array of its values), so a batch already on the card stays
    there."""
    if (_active if _env_checked else active()) is None:
        return arr
    if hit(point, **ctx) != "nan":
        return arr
    if hasattr(arr, "is_floating_point") and hasattr(arr, "clone"):
        if not arr.is_floating_point():
            return arr
        arr = arr.contiguous().clone()
        flat = arr.view(-1)
        flat[: max(1, flat.numel() // 8)] = float("nan")
        return arr
    import numpy as np

    arr = np.array(arr, copy=True)
    if not np.issubdtype(arr.dtype, np.floating):
        return arr
    flat = arr.reshape(-1)
    flat[: max(1, flat.size // 8)] = np.nan
    return arr
