"""Bounded retry with exponential backoff, after
``repro/resilience/recovery.py``.

One policy object is shared by every recovery site of a solve (loader
passes, row fetches).  The sleeper is injectable, so tests drive many
retries without waiting.  Only ``TransientFault`` subclasses are retried;
exhausted retries raise ``RetryExhausted``, which is not transient, so an
outer retry layer never multiplies an inner one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from repro_torch.resilience.faults import FaultError, TransientFault


class RetryExhausted(FaultError):
    """A transient fault outlived its retry budget: treated as permanent."""


@dataclass(frozen=True)
class RetryPolicy:
    """``max_retries`` re-attempts after the first try; the delay before
    the i-th retry is ``backoff_s * backoff_mult**i`` capped at
    ``max_backoff_s``."""

    max_retries: int = 4
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 1.0
    sleep: Callable[[float], None] = time.sleep

    def delay(self, attempt: int) -> float:
        return min(self.backoff_s * self.backoff_mult ** attempt,
                   self.max_backoff_s)


def with_retries(fn: Callable, policy: RetryPolicy,
                 transient: Tuple[Type[BaseException], ...] = (
                     TransientFault,),
                 on_retry: Optional[Callable[[int, BaseException], None]]
                 = None):
    """Run ``fn()`` with bounded retry of ``transient`` exceptions.

    ``on_retry(attempt, exc)`` fires before each re-attempt (stats
    accounting).  Other exceptions propagate untouched.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except transient as exc:
            if isinstance(exc, RetryExhausted) or \
                    attempt >= policy.max_retries:
                raise RetryExhausted(
                    f"gave up after {attempt} retr"
                    f"{'y' if attempt == 1 else 'ies'}: {exc}") from exc
            if on_retry is not None:
                on_retry(attempt, exc)
            policy.sleep(policy.delay(attempt))
            attempt += 1
