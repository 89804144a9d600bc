"""Per-pool circuit breakers, after ``repro/resilience/circuit.py``:
fail fast on pools that keep failing.

* **closed**: requests flow; consecutive pool-fault failures count up.
* **open**: after ``failure_threshold`` consecutive failures, requests fail
  at once (``CircuitOpen``) for ``cooldown_s``.
* **half-open**: after the cooldown one trial request is let through;
  success closes the breaker, failure re-opens it.

Only pool-level faults should be recorded; the breaker counts what it is
told.  The clock is injectable monotonic seconds, so tests drive the
cooldown deterministically.  Host-only.
"""

from __future__ import annotations

import time
from typing import Callable, Dict


class CircuitOpen(RuntimeError):
    """The pool's breaker is open: failing fast without attempting work."""


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.state = "closed"            # closed | open | half-open
        self.failures = 0                # consecutive pool-fault failures
        self.opened_at = 0.0
        self.trips = 0                   # times the breaker opened

    def allow(self) -> None:
        """Raise ``CircuitOpen`` unless a request may proceed.

        In the open state, reaching the cooldown moves to half-open and
        admits exactly one trial (later ``allow`` calls keep raising until
        that trial reports back).
        """
        if self.state == "closed":
            return
        if self.state == "open":
            if self._clock() - self.opened_at < self.cooldown_s:
                raise CircuitOpen(
                    f"circuit open ({self.failures} consecutive pool "
                    f"faults; retrying after "
                    f"{self.cooldown_s:.1f}s cooldown)")
            self.state = "half-open"
            return
        # half-open: one trial is already in flight
        raise CircuitOpen("circuit half-open: trial request in flight")

    def peek(self) -> None:
        """Raise ``CircuitOpen`` iff the breaker is open and still cooling,
        without consuming the half-open trial slot."""
        if (self.state == "open"
                and self._clock() - self.opened_at < self.cooldown_s):
            raise CircuitOpen(
                f"circuit open ({self.failures} consecutive pool faults; "
                f"retrying after {self.cooldown_s:.1f}s cooldown)")

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half-open" or \
                self.failures >= self.failure_threshold:
            if self.state != "open":
                self.trips += 1
            self.state = "open"
            self.opened_at = self._clock()

    def stats(self) -> dict:
        return {"state": self.state, "failures": self.failures,
                "trips": self.trips}


class BreakerBoard:
    """One breaker per pool id, created on first contact, shared config."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, pool_id: str) -> CircuitBreaker:
        br = self._breakers.get(pool_id)
        if br is None:
            br = CircuitBreaker(self.failure_threshold, self.cooldown_s,
                                self._clock)
            self._breakers[pool_id] = br
        return br

    def stats(self) -> dict:
        return {pid: br.stats() for pid, br in self._breakers.items()}
