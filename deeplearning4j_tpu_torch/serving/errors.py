"""Serving error types the decode loop raises — a copy of the part of the
JAX package's `serving/errors.py` this slice needs.

`OverloadedError` is the machine-actionable shedding signal: the decode
loop's admission queue raises it at a tier's `max_waiting` bound, with a
`retry_after_ms` hint derived from that tier's backlog
(`backlog_retry_ms`) and the shed `tier`. `Deadline` / `DeadlineExceededError` are the
end-to-end time budget: a request carries a `Deadline`, and the loop sheds
it at submit or admission, or retires it mid-flight, once the budget is
spent. `TIER_INTERACTIVE` / `TIER_BATCH` are the two SLO tiers every
request carries; `parse_tier` reads one off a request (`PRIORITY_HEADER`
wins over a `"priority"` body field), as `eval/holdout.py`'s fleet client
speaks it on the wire.
"""

from __future__ import annotations

import math
import time
from typing import Optional

__all__ = ["OverloadedError", "Deadline", "DeadlineExceededError",
           "PRIORITY_HEADER", "TIER_INTERACTIVE", "TIER_BATCH", "TIERS",
           "parse_tier", "backlog_retry_ms"]

#: the wire header carrying the request's SLO tier; the router forwards
#: it so replicas never need to re-parse the body
PRIORITY_HEADER = "X-Priority"

#: the latency tier (the default): user-facing turns, admitted first
TIER_INTERACTIVE = "interactive"
#: the throughput tier: bulk generation/eval — sheds first, preemptible
TIER_BATCH = "batch"
TIERS = (TIER_INTERACTIVE, TIER_BATCH)


def parse_tier(headers=None, body=None) -> str:
    """Parse a request's SLO tier: the `X-Priority` header wins, else a
    `"priority"` body field; absent -> interactive (an untagged client
    is a user). Unknown values raise ValueError."""
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
    """Retry-After derived from the shed tier's own backlog: `backlog`
    items at `per_item_ms` estimated service each, floored so a race
    with an emptying queue still backs off a beat, capped so a deep bulk
    backlog never says "come back in an hour"."""
    est = int(max(0, backlog) * max(0.0, per_item_ms))
    return max(floor_ms, min(cap_ms, est if est > 0 else floor_ms))


class OverloadedError(RuntimeError):
    """An admission queue is full; the caller should retry after
    `retry_after_ms`. `tier` names the SLO tier that was shed (None where
    the site has no tier)."""

    def __init__(self, message: str, retry_after_ms: int = 1000,
                 tier: Optional[str] = None):
        super().__init__(message)
        self.retry_after_ms = max(1, int(retry_after_ms))
        self.tier = tier

    @property
    def retry_after_s(self) -> int:
        """Whole seconds for a `Retry-After` header (ceil, >= 1)."""
        return max(1, math.ceil(self.retry_after_ms / 1000.0))


class DeadlineExceededError(RuntimeError):
    """The request's end-to-end time budget ran out."""

    def __init__(self, message: str,
                 deadline_ms: Optional[int] = None,
                 elapsed_ms: Optional[int] = None):
        super().__init__(message)
        self.deadline_ms = deadline_ms
        self.elapsed_ms = elapsed_ms


class Deadline:
    """A monotonic end-to-end budget, created once where the request
    enters the process and consulted at every admission point."""

    __slots__ = ("budget_ms", "_expires")

    def __init__(self, budget_ms: float):
        self.budget_ms = int(budget_ms)
        self._expires = time.monotonic() + self.budget_ms / 1000.0

    @classmethod
    def from_ms(cls, ms) -> Optional["Deadline"]:
        """Budget in milliseconds from now; None -> no deadline. 0 is
        legal and already expired."""
        if ms is None:
            return None
        ms = float(ms)
        if ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {ms}")
        return cls(ms)

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
        """Raise DeadlineExceededError if the budget is spent."""
        if self.expired:
            raise DeadlineExceededError(
                f"deadline exceeded before {where} "
                f"({self.budget_ms}ms budget spent)",
                deadline_ms=self.budget_ms,
                elapsed_ms=self.elapsed_ms())

    def __repr__(self) -> str:
        return (f"Deadline(budget_ms={self.budget_ms}, "
                f"remaining_ms={self.remaining_ms():.0f})")
