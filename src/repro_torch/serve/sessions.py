"""Anytime-budget sessions: checkpointed OMP state with TTL + LRU eviction,
after ``repro/serve/sessions.py``.  The state is the port's
``OMPAnytimeState``, its buffers on the pool's device.

A client that asked for ``k`` selected examples and later wants ``k'`` has,
with a stateless server, exactly one option: a from-scratch ``k'`` solve.
The incremental-Gram solver's blocked prefix growth makes the cheap option
possible — the per-session ``OMPAnytimeState`` (core/omp.py) holds the
column cache, Gram, cached rows and residual at round ``k``, so the
extension runs only rounds ``[k, k')`` and is certified index-identical to
the one-shot ``k'`` solve (tests/test_torch_serve.py runs the differential
grid).

This module is the bookkeeping half: a bounded store of live sessions with

* **TTL expiry** — a session idle past ``ttl_s`` is dropped on the next
  sweep (state is O(k·(n_cols + d) + k²) floats; clients that walked away
  must not pin it forever);
* **LRU eviction** — beyond ``max_sessions`` the least-recently-used
  session is evicted even if fresh (capacity beats fairness — an evicted
  client degrades to a one-shot solve, it is never wrong);
* a monotonic injectable ``clock`` so the tests drive expiry
  deterministically.

The compute half (running the extension) lives in ``serve/service.py``,
which owns the registry the pool arrays come from.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.omp import OMPAnytimeState


class SessionGone(KeyError):
    """Session expired, was evicted, or never existed."""


@dataclass
class Session:
    session_id: str
    pool_id: str
    pool_fingerprint: str    # content at open time — a pool replaced
                             # under the same id must not serve this state
    tenant: str
    state: OMPAnytimeState
    created_at: float
    last_used: float
    extensions: int = 0


@dataclass
class StreamSession:
    """A continual-stream session: one tenant POSTing gradient batches
    forever against a bounded ``repro_torch.continual.BufferMaintainer``
    (DESIGN.md §11).  Unlike an anytime :class:`Session` there is no pool
    id — the buffer *is* the pool, fed incrementally — but the TTL/LRU
    bookkeeping is shared: an abandoned stream must not pin its arena.
    The compute half (admission charging, batch pushes, checkpointed
    resume) lives in ``serve/service.py``."""

    session_id: str
    tenant: str
    maintainer: Any          # repro_torch.continual.BufferMaintainer
    created_at: float
    last_used: float
    batches: int = 0


class SessionStore:
    def __init__(self, max_sessions: int = 32, ttl_s: float = 600.0,
                 clock: Callable[[], float] = time.monotonic):
        self.max_sessions = int(max_sessions)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._sessions: OrderedDict[str, Session] = OrderedDict()
        self._ids = itertools.count()
        self.evictions = 0
        self.expirations = 0
        # Churn counters for the ``stats()`` snapshot: brownout decisions
        # and tests read these to see whether capacity is beating
        # fairness (high evictions) or clients are walking away (misses).
        self.puts = 0
        self.hits = 0
        self.misses = 0

    def _insert(self, sess) -> None:
        self._sessions[sess.session_id] = sess
        self.puts += 1
        self.sweep()
        while len(self._sessions) > self.max_sessions:
            self._sessions.popitem(last=False)
            self.evictions += 1

    def put(self, pool_id: str, tenant: str, state: OMPAnytimeState,
            pool_fingerprint: str = "") -> Session:
        now = self._clock()
        sess = Session(session_id=f"sess-{next(self._ids)}",
                       pool_id=pool_id, pool_fingerprint=pool_fingerprint,
                       tenant=tenant, state=state, created_at=now,
                       last_used=now)
        self._insert(sess)
        return sess

    def put_stream(self, tenant: str, maintainer) -> StreamSession:
        """Register a continual :class:`StreamSession`.  Streams share the
        anytime sessions' TTL/LRU machinery (``get``/``sweep``/``close``
        only touch ``session_id``/``last_used``) but should live in their
        *own* store — the degradation ladder's prefix scan expects anytime
        state (``serve/service.py`` keeps ``svc.streams`` separate)."""
        now = self._clock()
        sess = StreamSession(session_id=f"stream-{next(self._ids)}",
                             tenant=tenant, maintainer=maintainer,
                             created_at=now, last_used=now)
        self._insert(sess)
        return sess

    def get(self, session_id: str) -> Session:
        self.sweep()
        sess = self._sessions.get(session_id)
        if sess is None:
            self.misses += 1
            raise SessionGone(
                f"session {session_id!r} not found (expired after "
                f"{self.ttl_s}s idle, LRU-evicted, or never opened)")
        self.hits += 1
        sess.last_used = self._clock()
        self._sessions.move_to_end(session_id)
        return sess

    def update(self, session_id: str, state: OMPAnytimeState) -> None:
        sess = self.get(session_id)
        sess.state = state
        sess.extensions += 1

    def close(self, session_id: str) -> bool:
        return self._sessions.pop(session_id, None) is not None

    def live(self) -> list[Session]:
        """Snapshot of live sessions (sweeps first, does not touch LRU) —
        the degradation ladder scans this for a same-pool anytime prefix."""
        self.sweep()
        return list(self._sessions.values())

    def sweep(self) -> int:
        """Drop sessions idle past the TTL; returns how many were dropped."""
        now = self._clock()
        dead = [sid for sid, s in self._sessions.items()
                if now - s.last_used > self.ttl_s]
        for sid in dead:
            del self._sessions[sid]
        self.expirations += len(dead)
        return len(dead)

    def __len__(self) -> int:
        return len(self._sessions)

    def stats(self) -> dict:
        return {"sessions": len(self._sessions),
                "max_sessions": self.max_sessions,
                "puts": self.puts,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "expirations": self.expirations}
