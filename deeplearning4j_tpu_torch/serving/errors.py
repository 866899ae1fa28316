"""Serving error types the decode loop raises — a copy of the part of the
JAX package's `serving/errors.py` this slice needs.

`OverloadedError` is the machine-actionable shedding signal: the decode
loop's admission queue raises it at its `max_waiting` bound, with a
`retry_after_ms` hint. `Deadline` / `DeadlineExceededError` are the
end-to-end time budget: a request carries a `Deadline`, and the loop sheds
it at submit or admission, or retires it mid-flight, once the budget is
spent. `PRIORITY_HEADER` and `TIER_BATCH` name the batch SLO tier on the
wire, which `eval/holdout.py`'s fleet client speaks.
"""

from __future__ import annotations

import math
import time
from typing import Optional

__all__ = ["OverloadedError", "Deadline", "DeadlineExceededError",
           "PRIORITY_HEADER", "TIER_BATCH"]

#: the wire header carrying the request's SLO tier; the router forwards
#: it so replicas never need to re-parse the body
PRIORITY_HEADER = "X-Priority"

#: the throughput tier: bulk generation/eval — sheds first, preemptible
TIER_BATCH = "batch"


class OverloadedError(RuntimeError):
    """An admission queue is full; the caller should retry after
    `retry_after_ms`."""

    def __init__(self, message: str, retry_after_ms: int = 1000):
        super().__init__(message)
        self.retry_after_ms = max(1, int(retry_after_ms))

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
