"""`SelectionService`: the one object a serving deployment instantiates,
after ``repro/serve/service.py``.  Its pools, sessions and streams live on
one device (``device``; ``None``: the card, and a missing card raises).

Ties the subsystem together (DESIGN.md §6): the **pool registry**
(admit/fingerprint/precompute), the **admission controller** (tenant
budgets + queue backpressure), the **request scheduler** (micro-batched
solves) and the **session store** (anytime budgets).  The launcher
(``launch/serve_selection.py``) is a thin shell over this.

Typical flow::

    svc = SelectionService(max_batch=32)              # on the card
    pid = svc.register_pool(proxies)                  # once per pool
    t1 = svc.submit(pid, k=256, tenant="team-a")      # queued
    t2 = svc.submit(pid, k=256, tenant="team-b")      # same batch key
    svc.drain()                                       # one batched solve
    subset = t1.result                                # SelectionResult

    sid, res = svc.open_session(pid, k=256)           # anytime budget
    res2 = svc.extend_session(sid, 512)               # resume, not re-solve

Sessions charge admission for the *delta* rounds only — that is the whole
economic point of checkpointing the solver state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.continual.buffer import BufferMaintainer
from repro_torch.core.gradmatch import SelectionResult, _normalize
from repro_torch.core.omp import (omp_session_extend, omp_session_start,
                                  session_prefix_result, session_result)
from repro_torch.resilience.circuit import BreakerBoard
from repro_torch.resilience.recovery import RetryPolicy
from repro_torch.serve.admission import (AdmissionController,
                                         OverloadController, estimate_cost)
from repro_torch.serve.registry import PoolRegistry, UnknownPool
from repro_torch.serve.scheduler import (RequestScheduler, SelectRequest,
                                         Ticket, _flags, _vec)
from repro_torch.serve.sessions import SessionGone, SessionStore


class SelectionService:
    def __init__(
        self,
        max_batch: int = 32,
        max_queue: int = 64,
        max_pools: int = 8,
        max_sessions: int = 32,
        session_ttl_s: float = 600.0,
        default_budget_units: Optional[float] = None,
        max_inflight_per_tenant: int = 16,
        clock=None,
        retry_policy: Optional[RetryPolicy] = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        checkpoint_root: Optional[str] = None,
        degrade: bool = True,
        overload: bool = True,
        brownout_at: float = 0.5,
        overload_at: float = 0.85,
        recover_at: float = 0.25,
        artifact_store=None,
        device: str | torch.device | None = None,
    ):
        # ``artifact_store`` (repro_torch.artifacts.ArtifactStore or a path
        # to one) turns on the offline fast path: gradmatch submits against
        # array pools are answered from verified precomputed trajectories
        # at submit time, rung "artifact" (DESIGN.md §12).
        if isinstance(artifact_store, (str, bytes)):
            from repro_torch.artifacts import ArtifactStore
            artifact_store = ArtifactStore(artifact_store)
        self.artifacts = artifact_store
        self.registry = PoolRegistry(max_pools=max_pools,
                                     artifacts=artifact_store,
                                     device=device)
        self.device = self.registry.device
        self.admission = AdmissionController(
            max_queue=max_queue,
            default_budget_units=default_budget_units,
            max_inflight_per_tenant=max_inflight_per_tenant)
        clock_kw = {} if clock is None else {"clock": clock}
        self.breakers = BreakerBoard(failure_threshold=breaker_threshold,
                                     cooldown_s=breaker_cooldown_s,
                                     **clock_kw)
        self.overload = (OverloadController(
            max_queue=max_queue, brownout_at=brownout_at,
            overload_at=overload_at, recover_at=recover_at)
            if overload else None)
        self.scheduler = RequestScheduler(
            self.registry, self.admission, max_batch=max_batch,
            retry=retry_policy, breakers=self.breakers,
            checkpoint_root=checkpoint_root, degrade=degrade,
            session_lookup=self._prefix_lookup,
            overload=self.overload, session_save=self._session_save,
            **clock_kw)
        self.retry_policy = retry_policy
        self.sessions = SessionStore(max_sessions=max_sessions,
                                     ttl_s=session_ttl_s, **clock_kw)
        # Continual streams get their own store: the degradation ladder's
        # prefix scan over ``self.sessions`` expects anytime OMP state.
        self.streams = SessionStore(max_sessions=max_sessions,
                                    ttl_s=session_ttl_s, **clock_kw)

    # -- pools ---------------------------------------------------------------
    def register_pool(self, pool, pool_id: Optional[str] = None,
                      valid=None, **kw) -> str:
        return self.registry.register(pool, pool_id=pool_id, valid=valid,
                                      **kw)

    def register_chunked_pool(self, pool, pool_id: Optional[str] = None,
                              valid=None, **kw) -> str:
        return self.registry.register_chunked(pool, pool_id=pool_id,
                                              valid=valid,
                                              retry=self.retry_policy, **kw)

    # -- one-shot requests ---------------------------------------------------
    def submit(self, pool_id: str, k: int, strategy: str = "gradmatch",
               tenant: str = "default", **kw) -> Ticket:
        return self.scheduler.submit(SelectRequest(
            pool_id=pool_id, k=k, strategy=strategy, tenant=tenant, **kw))

    def drain(self) -> list[Ticket]:
        return self.scheduler.drain()

    def drain_step(self) -> list[Ticket]:
        """One fair scheduling quantum (the load harness's drive unit)."""
        return self.scheduler.drain_step()

    def select(self, pool_id: str, k: int, **kw) -> SelectionResult:
        """Blocking convenience: submit + drain + unwrap one request.

        Note this drains the *whole* queue — batching still happens if
        other requests are already waiting.
        """
        ticket = self.submit(pool_id, k, **kw)
        self.drain()
        if ticket.status != "done":
            raise RuntimeError(f"request failed: {ticket.error}")
        return ticket.result

    # -- anytime sessions ----------------------------------------------------
    def open_session(self, pool_id: str, k: int, lam: float = 0.5,
                     eps: float = 1e-10, positive: bool = True,
                     target=None, valid=None, tenant: str = "default"
                     ) -> tuple[str, SelectionResult]:
        """Solve ``k`` rounds and keep the solver state for extension."""
        entry = self.registry.get(pool_id)
        if not entry.batchable:
            raise UnknownPool(
                f"pool {pool_id!r} is chunked: anytime sessions need a "
                "resident pool")
        cost = estimate_cost(entry.n, entry.d, k)
        self.admission.admit(tenant, cost, self.scheduler.pending())
        try:
            tgt = (entry.target_sum if target is None
                   else _vec(target, entry.device))
            v = entry.valid
            if valid is not None:
                vv = _flags(valid, entry.device)
                v = vv if v is None else (v & vv)
            state = omp_session_start(entry.grads, tgt, k, lam=lam, eps=eps,
                                      positive=positive, valid=v)
        except Exception:
            self.admission.complete(tenant, refund=cost)
            raise
        self.admission.complete(tenant)
        sess = self.sessions.put(pool_id, tenant, state,
                                 pool_fingerprint=entry.fingerprint)
        return sess.session_id, self._session_selection(state)

    def extend_session(self, session_id: str, k_new: int
                       ) -> SelectionResult:
        """Extend a session's budget ``k -> k_new``; only the delta runs.

        The continuation is certified index-identical to a one-shot
        ``k_new`` solve (tests/test_serve.py, parity gate) — the client
        gets exactly what re-submitting at ``k_new`` would return, minus
        the recompute.
        """
        sess = self.sessions.get(session_id)          # raises SessionGone
        entry = self.registry.get(sess.pool_id)
        if entry.fingerprint != sess.pool_fingerprint:
            # The pool id was re-registered with different content: the
            # cached c0/Gram/colcache no longer describe these gradients.
            self.sessions.close(session_id)
            raise SessionGone(
                f"session {session_id!r} is stale: pool {sess.pool_id!r} "
                "content changed since the session opened — re-open")
        if k_new < sess.state.k:
            raise ValueError(
                f"cannot shrink an anytime session: have k={sess.state.k},"
                f" asked k'={k_new} (slice the previous result instead)")
        if k_new == sess.state.k:                     # idempotent retry:
            self.sessions.get(session_id)             # touch, charge 0
            return self._session_selection(sess.state)
        delta = k_new - sess.state.k
        cost = estimate_cost(entry.n, entry.d, delta)
        self.admission.admit(sess.tenant, cost, self.scheduler.pending())
        try:
            state = omp_session_extend(entry.grads, sess.state, k_new)
        except Exception:
            self.admission.complete(sess.tenant, refund=cost)
            raise
        self.admission.complete(sess.tenant)
        self.sessions.update(session_id, state)
        return self._session_selection(state)

    def close_session(self, session_id: str) -> bool:
        return self.sessions.close(session_id)

    # -- continual streams (DESIGN.md §11) -----------------------------------
    def open_stream(self, d: int, k: int, target, capacity: int = 1024,
                    tenant: str = "default", lam: float = 0.5,
                    eps: float = 1e-10, positive: bool = True,
                    seed: int = 0, compress: bool = True,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 1) -> str:
        """Open an infinite-stream session: the tenant will POST gradient
        batches forever via :meth:`push_stream` against one bounded
        ``BufferMaintainer``.  The explicit ``target`` is required — a
        stream has no pool to sum.  Admission charges one buffer-solve of
        units up front (the arena allocation + worst-case re-solve);
        every push then pays per-batch.  With ``checkpoint_dir`` set, a
        previously killed stream resumes bit-exactly from its last
        snapshot (and keeps snapshotting every ``checkpoint_every``
        batches).  The buffer lives on the service's device."""
        cost = estimate_cost(int(capacity), int(d), int(k))
        self.admission.admit(tenant, cost, self.scheduler.pending())
        try:
            maintainer = (BufferMaintainer.restore(checkpoint_dir,
                                                   device=self.device)
                          if checkpoint_dir else None)
            if maintainer is None:
                maintainer = BufferMaintainer(
                    capacity=int(capacity), d=int(d), target=target,
                    k=int(k), lam=lam, eps=eps, positive=positive,
                    seed=seed, compress=compress,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every, device=self.device)
        except Exception:
            self.admission.complete(tenant, refund=cost)
            raise
        self.admission.complete(tenant)
        return self.streams.put_stream(tenant, maintainer).session_id

    def push_stream(self, stream_id: str, rows, gids=None
                    ) -> SelectionResult:
        """Admit one batch into a stream; returns the maintained coreset
        (gid space, ``SelectStats`` attached — admit/evict/downdate/
        resolve counters included).  Per-batch admission units scale with
        the batch, not the buffer; a failed admit refunds them.  ``rows``
        is a tensor (on any device) or a host array."""
        sess = self.streams.get(stream_id)            # raises SessionGone
        if not isinstance(rows, torch.Tensor):
            rows = np.asarray(rows, np.float32)
        m = sess.maintainer
        cost = estimate_cost(rows.shape[0], m.d, m.k)
        self.admission.admit(sess.tenant, cost, self.scheduler.pending())
        try:
            m.admit(rows, gids=gids)
        except Exception:
            self.admission.complete(sess.tenant, refund=cost)
            raise
        self.admission.complete(sess.tenant)
        sess.batches += 1
        return m.result()

    def stream_result(self, stream_id: str) -> SelectionResult:
        """Current maintained coreset without admitting anything."""
        return self.streams.get(stream_id).maintainer.result()

    def close_stream(self, stream_id: str) -> bool:
        return self.streams.close(stream_id)

    @staticmethod
    def _session_selection(state) -> SelectionResult:
        idx, w, mask, err = session_result(state)
        return SelectionResult(idx, _normalize(w, mask), mask, err)

    def _session_save(self, pool_id: str, fingerprint: str,
                      state) -> None:
        """Park a brownout shared-solve session so later same-pool groups
        (and the degradation ladder's anytime-prefix rung) reuse it.
        Owned by the service, not a client tenant — TTL/LRU churn is
        visible in ``sessions.stats()``."""
        self.sessions.put(pool_id, "__brownout__", state,
                          pool_fingerprint=fingerprint)

    def _prefix_lookup(self, pool_id: str, fingerprint: str,
                       k: int) -> Optional[SelectionResult]:
        """Anytime-prefix rung of the degradation ladder: the first-``k``
        prefix of a live session over the same pool *content*.  Indices
        are certified by the prefix property; weights are the session's
        (renormalized, approximate for the prefix)."""
        for sess in self.sessions.live():
            if (sess.pool_id == pool_id
                    and sess.pool_fingerprint == fingerprint
                    and sess.state.k >= k):
                idx, w, mask, err = session_prefix_result(sess.state, k)
                return SelectionResult(idx, _normalize(w, mask), mask, err)
        return None

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        return {"registry": self.registry.stats(),
                "scheduler": self.scheduler.stats(),
                "sessions": self.sessions.stats(),
                "streams": self.streams.stats(),
                "tenants": self.admission.stats(),
                "breakers": self.breakers.stats(),
                "artifacts": (None if self.artifacts is None
                              else self.artifacts.stats())}


__all__ = ["SelectionService", "SelectRequest", "Ticket", "SessionGone",
           "UnknownPool"]
