"""Serving-plane error types shared by the single-host server and the
fleet router.

`OverloadedError` is the machine-actionable shedding signal: every
admission point that can saturate (the micro-batcher's coalescing
queue, the decode loop's admission queue, the fleet's global
outstanding-request high-water mark) raises it instead of a generic
RuntimeError, and every HTTP front end maps it to the same wire shape —
`503` with a `Retry-After` header and a JSON body
`{"error": "overloaded", "retry_after_ms": N}` — so clients and load
balancers can back off without parsing prose (docs/FLEET.md).

`TIER_INTERACTIVE` / `TIER_BATCH` are the two SLO tiers every serving
request carries (an `X-Priority` header, or a `"priority"` body field
where the body is parsed anyway; absent -> interactive). The tier rides
the whole admission path — router select, fleet dispatch, micro-batcher
queue, decode-loop slot/page accounting — so shedding and preemption
can favor the user who is watching: batch sheds first (at a lower
water mark), and an interactive arrival may preempt a batch decode
slot, turning the batch row into a durable-stream resume record
(docs/SERVING.md "Priority tiers"). A shed reply names the tier that
was shed and derives `Retry-After` from THAT tier's backlog, so a bulk
client backs off long while an interactive client retries soon.

`Deadline` / `DeadlineExceededError` are the end-to-end time-budget
twins: a client sends `deadline_ms` (an `X-Deadline-Ms` header, or a
`deadline_ms` body field where the body is parsed anyway), every hop
re-derives its socket timeout from the REMAINING budget instead of a
fixed constant, the router forwards the shrunk budget downstream, and
every admission point (router select, micro-batcher submit AND
dispatch, decode-loop submit AND admission) sheds already-expired work
with the machine-readable shape `504` +
`{"error": "deadline_exceeded", "deadline_ms": D, "elapsed_ms": E}`
BEFORE any compute starts (docs/SERVING.md "Deadlines").
"""

from __future__ import annotations

import math
import time
from typing import Optional

__all__ = ["OverloadedError", "overload_body",
           "Deadline", "DeadlineExceededError", "deadline_body",
           "DEADLINE_HEADER", "replica_failed_body",
           "TIER_INTERACTIVE", "TIER_BATCH", "TIERS",
           "PRIORITY_HEADER", "parse_tier", "backlog_retry_ms"]

#: the wire header carrying the REMAINING budget in milliseconds; each
#: forwarding hop rewrites it smaller (never larger)
DEADLINE_HEADER = "X-Deadline-Ms"

#: the wire header carrying the request's SLO tier; the router forwards
#: it so replicas never need to re-parse the body
PRIORITY_HEADER = "X-Priority"

#: the latency tier: a user is watching — sheds last, may preempt batch
TIER_INTERACTIVE = "interactive"
#: the throughput tier: bulk generation/eval — sheds first, preemptible
TIER_BATCH = "batch"
TIERS = (TIER_INTERACTIVE, TIER_BATCH)


def parse_tier(headers=None, body=None) -> str:
    """Parse a request's SLO tier: the `X-Priority` header wins, else a
    `"priority"` body field; absent -> interactive (the safe default —
    an untagged client is a user). Unknown values raise ValueError so a
    typo'd `"bacth"` fails loudly instead of silently racing users."""
    raw = headers.get(PRIORITY_HEADER) if headers is not None else None
    if raw is None and isinstance(body, dict):
        raw = body.get("priority")
    if raw is None:
        return TIER_INTERACTIVE
    tier = str(raw).strip().lower()
    if tier not in TIERS:
        raise ValueError(
            f"unknown priority tier {raw!r} (expected one of {TIERS})")
    return tier


def backlog_retry_ms(backlog: int, per_item_ms: float,
                     floor_ms: int = 50, cap_ms: int = 30_000) -> int:
    """Retry-After derived from the shed tier's OWN backlog: roughly
    how long the queue ahead of a retry takes to drain (`backlog` items
    at `per_item_ms` estimated service each), floored so a race with an
    emptying queue still backs off a beat, capped so a deep bulk
    backlog never tells a client "come back in an hour"."""
    est = int(max(0, backlog) * max(0.0, per_item_ms))
    return max(floor_ms, min(cap_ms, est if est > 0 else floor_ms))


class OverloadedError(RuntimeError):
    """An admission queue is full (or a shed high-water mark is hit);
    the caller should retry after `retry_after_ms`. `tier` names which
    SLO tier was shed (None on legacy untiered sites) so the 503 body
    tells a bulk client "YOUR lane is full" even when interactive
    admission is wide open."""

    def __init__(self, message: str, retry_after_ms: int = 1000,
                 tier: Optional[str] = None):
        super().__init__(message)
        self.retry_after_ms = max(1, int(retry_after_ms))
        self.tier = tier

    @property
    def retry_after_s(self) -> int:
        """Whole seconds for the `Retry-After` header (ceil, >= 1)."""
        return max(1, math.ceil(self.retry_after_ms / 1000.0))


def overload_body(exc: OverloadedError) -> dict:
    """The JSON body every 503-overloaded reply carries."""
    out = {"error": "overloaded",
           "retry_after_ms": exc.retry_after_ms,
           "detail": str(exc)}
    if exc.tier is not None:
        out["tier"] = exc.tier
    return out


class DeadlineExceededError(RuntimeError):
    """The request's end-to-end time budget ran out. Raised by every
    admission point BEFORE compute starts (shedding expired work is
    free; finishing it is worthless), and by result waits that hit the
    budget. HTTP front ends map it to 504 + `deadline_body`."""

    def __init__(self, message: str,
                 deadline_ms: Optional[int] = None,
                 elapsed_ms: Optional[int] = None):
        super().__init__(message)
        self.deadline_ms = deadline_ms
        self.elapsed_ms = elapsed_ms


def deadline_body(exc: DeadlineExceededError) -> dict:
    """The JSON body every 504-deadline-exceeded reply carries."""
    out = {"error": "deadline_exceeded", "detail": str(exc)}
    if exc.deadline_ms is not None:
        out["deadline_ms"] = exc.deadline_ms
    if exc.elapsed_ms is not None:
        out["elapsed_ms"] = exc.elapsed_ms
    return out


def replica_failed_body(replica_id, detail: str,
                        resume_attempts: Optional[int] = None) -> dict:
    """The structured shape every router-side replica failure speaks —
    as a 502 body when no byte reached the client, or as the final
    in-band NDJSON line of an already-started stream. Always
    `retryable`: the request itself is sound, only its placement
    failed. `resume_attempts` records how many failover resumes the
    router burned before giving up (docs/FLEET.md "Stream failover"),
    so a client can distinguish "never placed" from "resumed N times
    and the fleet still could not finish it"."""
    out = {"error": "replica_failed",
           "replica": replica_id,
           "detail": detail,
           "retryable": True}
    if resume_attempts is not None:
        out["resume_attempts"] = int(resume_attempts)
    return out


class Deadline:
    """A monotonic end-to-end budget: created once where the request
    enters the process, consulted at every hop.

    `None` deadlines are represented by the absence of a Deadline (the
    constructors return None), so hot paths stay `if deadline is None`
    checks and legacy fixed timeouts apply unchanged."""

    __slots__ = ("budget_ms", "_expires")

    def __init__(self, budget_ms: float):
        self.budget_ms = int(budget_ms)
        self._expires = time.monotonic() + self.budget_ms / 1000.0

    # ------------------------------------------------------ constructors
    @classmethod
    def from_ms(cls, ms) -> Optional["Deadline"]:
        """Budget in milliseconds from NOW; None/absent -> no deadline.
        0 is legal and already expired (the canonical "shed me at every
        admission point" probe)."""
        if ms is None:
            return None
        ms = float(ms)
        if ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {ms}")
        return cls(ms)

    @classmethod
    def from_request(cls, headers=None, body=None) -> Optional["Deadline"]:
        """Parse a request's budget: the `X-Deadline-Ms` header wins
        (the router forwards budgets as headers so replicas never need
        to parse the body), else a `deadline_ms` body field."""
        raw = headers.get(DEADLINE_HEADER) if headers is not None else None
        if raw is None and isinstance(body, dict):
            raw = body.get("deadline_ms")
        return cls.from_ms(raw) if raw is not None else None

    # --------------------------------------------------------- the clock
    def remaining_s(self) -> float:
        return self._expires - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def elapsed_ms(self) -> int:
        return int(self.budget_ms - self.remaining_ms())

    def check(self, where: str) -> None:
        """Raise DeadlineExceededError if the budget is spent — the
        one-liner every admission point calls before doing work."""
        if self.expired:
            raise DeadlineExceededError(
                f"deadline exceeded before {where} "
                f"({self.budget_ms}ms budget spent)",
                deadline_ms=self.budget_ms,
                elapsed_ms=self.elapsed_ms())

    def timeout(self, default: float, floor: float = 0.05) -> float:
        """Per-hop socket/wait timeout derived from the remaining
        budget: min(default, remaining), floored so an almost-spent
        budget still makes a bounded attempt instead of a 0s timeout
        (the admission-point `check()` is what sheds truly expired
        work)."""
        return max(floor, min(float(default), self.remaining_s()))

    def header_value(self) -> str:
        """Remaining budget for the forwarded `X-Deadline-Ms` header
        (ceil, >= 1 — a still-unexpired budget never forwards as 0)."""
        return str(max(1, math.ceil(self.remaining_ms())))

    def __repr__(self) -> str:
        return (f"Deadline(budget_ms={self.budget_ms}, "
                f"remaining_ms={self.remaining_ms():.0f})")
