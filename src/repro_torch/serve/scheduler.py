"""Request scheduler: queue `SelectRequest`s, micro-batch same-pool solves,
after ``repro/serve/scheduler.py``.  Every strategy runs on the port's
engines, on the pool's device: the micro-batched group on
``omp_select_batched`` (the batched kernels), the shared brownout session
on the anytime sessions, single requests on the streaming, partitioned,
CRAIG, GLISTER and random paths.  Seeds become a ``torch.Generator`` on the
pool's device (random and ``craig-stochastic`` picks differ from the
reference's by design; their invariants do not).

The serving shape this implements (DESIGN.md §6): clients ``submit()``
and get a ticket back immediately (admission control runs here — see
``serve/admission.py``); ``drain()`` executes the queue.  Execution groups
queued requests by **batch key** ``(pool_id, strategy, k, lam, eps,
positive)`` — requests that are the *same solve over the same pool up to
their target/validity vectors* — and runs each group as one
``omp_select_batched`` call: one column-cache/Gram growth schedule and one
pool scan per round serve the whole group, so B queued requests cost one
batched solve instead of B sequential ones (benchmarks/bench_selection.py
``run_serve`` records the throughput ratio; acceptance ≥ 5x at B = 32).

Batch sizes are padded up to a power-of-two bucket (extra rows re-solve
request 0 and are dropped), as the reference pads them for its jit cache:
the batched solver's regime rule reads the padded B (``hi * B <= d``), so
the padding decides which rounds a group runs, and a group of 3 solves as
the reference's group of 4 does.

Non-batchable work degrades gracefully to per-request execution: CRAIG
tiers reuse the registry's cached FL scan, chunked pools run the
streaming block-OMP, everything else goes through the ordinary
``selection.select`` dispatch.  Results are per-ticket ``SelectionResult``
(weights re-normalized per request, exactly as the library path returns).

Resilience (DESIGN.md §8): requests carry optional deadlines (expired
tickets fail fast as ``timeout`` without burning a solve); chunked solves
run under a bounded-retry policy with optional mid-solve checkpoints; a
per-pool circuit breaker fails a poisoned pool fast instead of wedging
the queue; and when a certified streaming solve cannot be had, the
scheduler walks the graceful-degradation ladder (resume → anytime-prefix
→ stochastic fallback), recording the rung on ``Ticket.degradation``.

Overload (DESIGN.md §10): requests carry a **priority class**
(interactive > batch > best-effort) and drain is no longer FIFO — within
the highest queued class, tenants are served by deficit round robin
weighted by ``TenantAccount.weight``, so one hot tenant cannot starve
the rest.  An ``OverloadController`` watches queue depth: under brownout
it sheds best-effort at submit (a labelled ``"shed"`` ticket, never
charged) and routes same-pool differing-k gradmatch groups through one
**shared anytime session** — each request answered as a bit-exact index
prefix of the deepest k (rung ``"prefix-shared"``); under full overload
non-interactive gradmatch drops to the stochastic rung.  Deadlines are
validated at submit (``deadline_s <= 0`` is rejected immediately) and
checked again per group at drain.  Pools admitted with deferred warming
are skipped by the fair scan until warm — their admission pass advances
only when nothing else is runnable, so it never head-of-line-blocks.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.artifacts.store import host_array
from repro_torch.core import craig as craig_lib
from repro_torch.core import glister as glister_lib
from repro_torch.core import partition as part_lib
from repro_torch.core import random_sel
from repro_torch.core import streaming as stream_lib
from repro_torch.core.gradmatch import SelectionResult, _normalize
from repro_torch.core.omp import (omp_select_batched, omp_session_start,
                                  session_prefix_result, session_result)
from repro_torch.resilience.circuit import BreakerBoard, CircuitOpen
from repro_torch.resilience.degrade import (DeadlineExceeded,
                                            stochastic_fallback,
                                            stochastic_pool_select)
from repro_torch.resilience.faults import FaultError
from repro_torch.resilience.recovery import RetryPolicy
from repro_torch.serve.admission import (AdmissionController,
                                         OverloadController, estimate_cost)
from repro_torch.serve.registry import PoolEntry, PoolRegistry, UnknownPool

SERVABLE = ("gradmatch", "gradmatch-partitioned", "craig", "craig-lazy",
            "craig-stochastic", "glister", "random")

# Strict priority order: a queued request of a higher class always drains
# before any lower class; fairness (DRR over tenants) applies *within*
# the class.  The overload controller sheds from the right.
PRIORITIES = ("interactive", "batch", "best-effort")

_CRAIG_METHODS = {"craig": "dense", "craig-lazy": "lazy",
                  "craig-stochastic": "stochastic"}


@dataclass(frozen=True)
class SelectRequest:
    """One selection ask.  ``target=None`` means the pool's cached default
    (the eq.-2 sum); a per-request ``valid`` intersects the pool's own."""

    pool_id: str
    k: int
    strategy: str = "gradmatch"
    lam: float = 0.5
    eps: float = 1e-10
    positive: bool = True
    target: Optional[object] = None     # (d,) array-like
    valid: Optional[object] = None      # (n,) bool array-like
    tenant: str = "default"
    seed: int = 0                       # random / craig-stochastic
    deadline_s: Optional[float] = None  # fail fast past this queue age
    priority: str = "interactive"       # see PRIORITIES

    def batch_key(self):
        # deadline_s deliberately excluded: it shapes *when* a ticket may
        # still run, not *what* solve it is.
        return (self.pool_id, self.strategy, self.k, float(self.lam),
                float(self.eps), self.positive)


@dataclass
class Ticket:
    ticket_id: str
    request: SelectRequest
    cost: float
    status: str = "queued"              # queued | done | failed | shed
    result: Optional[SelectionResult] = None
    error: Optional[str] = None
    batched_with: int = 0               # group size the solve ran at
    degradation: str = "none"           # rung served (DEGRADE_LEVELS)
    submitted_at: float = 0.0           # scheduler clock at submit()


def _vec(x, dev: torch.device) -> torch.Tensor:
    """A request's (d,) target as f32 on the pool's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(host_array(x))
    return x.to(dev, torch.float32)


def _flags(x, dev: torch.device) -> torch.Tensor:
    """A request's (n,) mask as bool on the pool's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(host_array(x, bool))
    return x.to(dev, torch.bool)


def _request_valid(entry: PoolEntry, req_valid):
    """The pool's mask intersected with a request's."""
    if req_valid is None:
        return entry.valid
    v = _flags(req_valid, entry.device)
    return v if entry.valid is None else (entry.valid & v)


def _bucket_b(b: int) -> int:
    p = 1
    while p < b:
        p *= 2
    return p


class RequestScheduler:
    def __init__(self, registry: PoolRegistry,
                 admission: Optional[AdmissionController] = None,
                 max_batch: int = 32,
                 stream_buffer: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 retry: Optional[RetryPolicy] = None,
                 breakers: Optional[BreakerBoard] = None,
                 checkpoint_root: Optional[str] = None,
                 checkpoint_every: int = 8,
                 degrade: bool = True,
                 session_lookup: Optional[Callable] = None,
                 overload: Optional[OverloadController] = None,
                 session_save: Optional[Callable] = None,
                 warm_chunks: int = 8):
        self.registry = registry
        self.admission = admission or AdmissionController()
        self.max_batch = int(max_batch)
        self.stream_buffer = int(stream_buffer)
        self._clock = clock
        self.retry = retry
        self.breakers = breakers or BreakerBoard(clock=clock)
        self.checkpoint_root = checkpoint_root
        self.checkpoint_every = int(checkpoint_every)
        self.degrade = bool(degrade)
        # (pool_id, fingerprint, k) -> SelectionResult | None; wired by
        # SelectionService to its session store (anytime-prefix rung).
        self.session_lookup = session_lookup
        # Brownout machinery (DESIGN.md §10): the overload controller
        # decides shed/brownout levels; session_save(pool_id, fp, state)
        # parks a shared-solve session so later groups reuse it.
        self.overload = overload
        self.session_save = session_save
        self.warm_chunks = int(warm_chunks)
        self._queue: list[Ticket] = []
        self._ids = itertools.count()
        self.batches_run = 0
        self.singles_run = 0
        self.shared_solves = 0
        self.degraded_served = {}          # rung -> count
        # Shed-accounting invariant (load harness + parity gate):
        #   admitted == completed + shed + failed + pending
        # where "admitted" counts every ticket handed back to a caller
        # (queued or shed) and rejections raised at submit count nowhere.
        self.counters = {"admitted": 0, "shed": 0, "completed": 0,
                         "failed": 0, "timeouts": 0}
        # Deficit round robin state: tenant -> spendable work units, plus
        # the rotation order.  Pruned when a tenant's queue empties so a
        # returning tenant starts fresh instead of cashing stale credit.
        self._deficits: dict[str, float] = {}
        self._rr: list[str] = []

    # -- intake --------------------------------------------------------------
    def submit(self, req: SelectRequest) -> Ticket:
        if req.strategy not in SERVABLE:
            raise ValueError(
                f"unservable strategy {req.strategy!r}; servable: "
                f"{SERVABLE}")
        if req.k <= 0:
            raise ValueError(f"k must be positive, got {req.k}")
        if req.priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {req.priority!r}; one of {PRIORITIES}")
        if req.deadline_s is not None and req.deadline_s <= 0:
            # Fail fast: deadline_s is relative to submit, so a <= 0
            # value is already expired — queueing it would only burn a
            # queue slot to be timed out at drain.
            raise ValueError(
                f"deadline_s must be > 0, got {req.deadline_s}: the "
                "deadline is measured from submit, so this request is "
                "already expired")
        entry = self.registry.get(req.pool_id)   # raises UnknownPool
        # Fail fast before charging the tenant: an open breaker means
        # this request would only queue behind a poisoned pool.
        self.breakers.get(req.pool_id).peek()    # raises CircuitOpen
        cost = estimate_cost(entry.n, entry.d, req.k)
        art_ticket = self._try_artifact(req, entry, cost)
        if art_ticket is not None:
            return art_ticket
        if self.overload is not None:
            self.overload.observe(len(self._queue))
            if self.overload.should_shed(req.priority):
                # Visible, labelled, never charged: the caller gets a
                # terminal "shed" ticket instead of an exception so the
                # response carries its degradation rung like any other.
                self.overload.record_shed(req.priority)
                self.counters["admitted"] += 1
                self.counters["shed"] += 1
                return Ticket(
                    ticket_id=f"req-{next(self._ids)}", request=req,
                    cost=cost, status="shed", degradation="shed",
                    error=(f"shed at submit: overload level "
                           f"{self.overload.level} sheds "
                           f"{req.priority!r} traffic"),
                    submitted_at=self._clock())
        self.admission.admit(req.tenant, cost, len(self._queue))
        self.counters["admitted"] += 1
        ticket = Ticket(ticket_id=f"req-{next(self._ids)}", request=req,
                        cost=cost, submitted_at=self._clock())
        self._queue.append(ticket)
        return ticket

    def _try_artifact(self, req: SelectRequest, entry: PoolEntry,
                      cost: float) -> Optional[Ticket]:
        """Answer a gradmatch ask from a verified offline artifact.

        Served *at submit*, off the drain path entirely: a hit is a dict
        probe plus an O(k) slice of the memoized trajectory — no queue
        slot, no admission charge, no pool scan — returned as a terminal
        ticket labelled ``degradation="artifact"``.  The served answer is
        bit-exact (indices, mask, normalized weights, err) to the live
        anytime session engine at this k, and index-identical to the
        one-shot ``omp_select`` wherever the two live paths agree — at
        very large pools their different padded solve widths can flip
        near-tie argmaxes, in which case the artifact sides with the
        session engine and matches the certified batched path at the
        objective level (DESIGN.md §12, parity_gate check 8).  Any miss,
        verification failure, or uncovered ask returns None and the
        request proceeds through the ordinary (live, certified) path —
        fail closed, never a corrupt result.

        Accounting mirrors shed tickets: ``admitted`` and ``completed``
        both count it, the tenant is never charged (nothing was queued),
        preserving ``admitted == completed + shed + failed + pending``.
        """
        if (req.strategy != "gradmatch" or req.valid is not None
                or not entry.batchable):
            return None
        target = (entry.target_sum if req.target is None else req.target)
        try:
            art = self.registry.artifact_lookup(
                entry, req.k, req.lam, req.eps, req.positive, target)
        except Exception:
            return None                  # lookup must never fail a submit
        if art is None:
            return None
        idx, w, mask, err = art.slice(req.k)
        dev = entry.device
        w = torch.from_numpy(np.array(w)).to(dev)
        mask_t = torch.from_numpy(np.array(mask)).to(dev)
        ticket = Ticket(ticket_id=f"req-{next(self._ids)}", request=req,
                        cost=cost, submitted_at=self._clock())
        ticket.result = SelectionResult(
            torch.from_numpy(np.array(idx)).to(dev), _normalize(w, mask_t),
            mask_t, torch.tensor(err, dtype=torch.float32, device=dev))
        self._served(ticket, "artifact")
        self.counters["admitted"] += 1
        self.counters["completed"] += 1
        return ticket

    def pending(self) -> int:
        return len(self._queue)

    # -- execution -----------------------------------------------------------
    def drain(self) -> list[Ticket]:
        """Run the whole queue; returns the tickets in completion order.

        A failing request fails its ticket(s), never the queue: tenants
        get their in-flight slot back either way, and failed work refunds
        its admission charge (a metered tenant must not pay for
        selections that were never delivered).
        """
        done: list[Ticket] = []
        while self._queue:
            done.extend(self.drain_step())
        return done

    def drain_step(self) -> list[Ticket]:
        """Serve one scheduling quantum; returns the finalized tickets.

        One step = pick the fairness winner (strict priority class, then
        weighted deficit round robin over tenants), execute its group,
        settle admission.  The open-loop load harness interleaves steps
        with arrivals; ``drain()`` just loops this to empty.
        """
        if not self._queue:
            return []
        level = (self.overload.observe(len(self._queue))
                 if self.overload is not None else 0)
        head = self._fair_head()
        if head is None:
            # Every queued ticket waits on a warming pool: advance the
            # deferred admission pass and time out what expired — the
            # warm pass itself is the only runnable work.
            group = self._advance_warming()
        else:
            group = self._execute_head(head, level)
        for t in group:
            self._settle(t)
        return group

    def _execute_head(self, head: Ticket, level: int) -> list[Ticket]:
        req = head.request
        try:
            entry = self.registry.get(req.pool_id)
        except UnknownPool as exc:
            # Pool evicted between submit and drain: fail every ticket
            # queued against it (same fate at their own head position).
            group = self._take_group_by_pool(req.pool_id)
            for t in group:
                t.status = "failed"
                t.error = f"{type(exc).__name__}: {exc}"
            return group
        try:
            # The real admission through the breaker (submit only
            # peeks): an open pool fails its whole queued group
            # immediately — no solve, no retry burn, no wedge.
            self.breakers.get(req.pool_id).allow()
        except CircuitOpen as exc:
            group = self._take_group_by_pool(req.pool_id)
            for t in group:
                t.status = "failed"
                t.degradation = "failed"
                t.error = f"{type(exc).__name__}: {exc}"
            return group
        if entry.warm_state == "failed":
            group = self._take_group_by_pool(req.pool_id)
            for t in group:
                t.status = "failed"
                t.degradation = "failed"
                t.error = (f"pool admission warm failed: "
                           f"{entry.warm_error}")
            return group
        if (level >= 2 and self.degrade and req.strategy == "gradmatch"
                and req.priority != "interactive"):
            # Full overload: non-interactive gradmatch takes the
            # stochastic rung — a cheap subsample solve instead of the
            # real thing, labelled as such.
            self._queue.remove(head)
            group = [head]
            if self._expire_split(group):
                self._run_brownout_single(entry, head)
            self._charge_fair(group)
            return group
        if req.strategy == "gradmatch" and entry.batchable:
            if (level >= 1 and self.degrade and req.target is None
                    and req.valid is None):
                # Brownout: same-pool default-target gradmatch requests
                # of *any* k share one anytime session.
                group = self._take_share_group(head)
                live = self._expire_split(group)
                if live:
                    self._run_shared_anytime(entry, live)
            else:
                group = self._take_group(head)
                live = self._expire_split(group)
                if live:
                    self._run_gradmatch_batch(entry, live)
            self._charge_fair(group)
            return group
        self._queue.remove(head)
        group = [head]
        self._run_single(entry, head)   # checks its own deadline
        self._charge_fair(group)
        return group

    def _settle(self, t: Ticket) -> None:
        """Release the admission slot and keep the shed-accounting
        invariant: failed work (timeouts included) refunds its charge."""
        self.admission.complete(
            t.request.tenant,
            refund=t.cost if t.status == "failed" else 0.0)
        if t.status == "done":
            self.counters["completed"] += 1
        else:
            self.counters["failed"] += 1
            if t.degradation == "timeout":
                self.counters["timeouts"] += 1

    # -- fairness (DESIGN.md §10) --------------------------------------------
    def _runnable(self, t: Ticket) -> bool:
        entry = self.registry.peek(t.request.pool_id)
        return entry is None or entry.warm_state != "warming"

    def _fair_head(self) -> Optional[Ticket]:
        """Pick the next ticket: strict priority class first, weighted
        deficit round robin over tenants within the class, FIFO within a
        tenant.  Returns None when nothing is runnable (all queued pools
        still warming)."""
        runnable = [t for t in self._queue if self._runnable(t)]
        if not runnable:
            return None
        for cls in PRIORITIES:
            cand = [t for t in runnable if t.request.priority == cls]
            if cand:
                break
        heads: dict[str, Ticket] = {}
        for t in cand:
            heads.setdefault(t.request.tenant, t)
        queued_tenants = {t.request.tenant for t in self._queue}
        # Reset-on-empty: a tenant with no queued work loses its deficit
        # (and its rotation slot) — DRR credit must not accumulate while
        # idle, or a burst would replay the whole backlog unfairly.
        for tn in list(self._deficits):
            if tn not in queued_tenants:
                del self._deficits[tn]
        self._rr = [tn for tn in self._rr if tn in queued_tenants]
        for tn in heads:
            if tn not in self._rr:
                self._rr.append(tn)
        order = [tn for tn in self._rr if tn in heads]
        if len(order) == 1:
            return heads[order[0]]
        quantum = max(heads[tn].cost for tn in order)
        while True:
            for tn in order:
                if self._deficits.get(tn, 0.0) >= heads[tn].cost:
                    self._rr.remove(tn)
                    self._rr.append(tn)
                    return heads[tn]
            for tn in order:
                w = self.admission.account(tn).weight
                self._deficits[tn] = (self._deficits.get(tn, 0.0)
                                      + quantum * max(w, 1e-9))

    def _charge_fair(self, group: list[Ticket]) -> None:
        """Debit each served ticket's cost from its tenant's deficit.

        Riders batched under another tenant's turn are charged too (they
        got real work), but the debt is floored at one ticket deep —
        unbounded negative deficit would starve a tenant for many
        rotations after one lucky shared batch."""
        for t in group:
            if t.degradation == "timeout":
                continue                 # no solve ran for this ticket
            tn = t.request.tenant
            d = self._deficits.get(tn, 0.0)
            self._deficits[tn] = max(d - t.cost, -t.cost)

    def _expire_split(self, group: list[Ticket]) -> list[Ticket]:
        """Timeout the expired members of a group; returns the live rest.

        Deadline semantics are identical to ``_run_single``'s check, but
        applied per member before a *batched* solve so one stale ticket
        neither blocks nor rides the batch."""
        live = []
        for t in group:
            req = t.request
            age = self._clock() - t.submitted_at
            if req.deadline_s is not None and age > req.deadline_s:
                t.status = "failed"
                t.degradation = "timeout"
                t.error = (f"DeadlineExceeded: deadline of "
                           f"{req.deadline_s}s expired before the solve "
                           f"started (queued {age:.3f}s)")
            else:
                live.append(t)
        return live

    def _advance_warming(self) -> list[Ticket]:
        """Nothing is runnable: step the first blocked pool's deferred
        admission pass, then time out blocked tickets whose deadline
        expired while warming — served from the partially warmed cache's
        stochastic rung when the request carried its own target, failed
        as ``timeout`` otherwise."""
        blocked = [t for t in self._queue if not self._runnable(t)]
        self.registry.step_warm(blocked[0].request.pool_id,
                                max_chunks=self.warm_chunks)
        out: list[Ticket] = []
        for t in list(self._queue):
            if self._runnable(t):
                continue
            req = t.request
            age = self._clock() - t.submitted_at
            if req.deadline_s is None or age <= req.deadline_s:
                continue
            self._queue.remove(t)
            entry = self.registry.peek(req.pool_id)
            res = None
            if (self.degrade and req.target is not None
                    and req.strategy == "gradmatch"
                    and entry is not None and entry.cache is not None):
                res = stochastic_fallback(
                    entry.cache, _vec(req.target, entry.device),
                    req.k, seed=req.seed, lam=req.lam, eps=req.eps,
                    positive=req.positive)
            if res is not None:
                t.result = SelectionResult(
                    res.indices, _normalize(res.weights, res.mask),
                    res.mask, res.err)
                self._served(t, "stochastic")
            else:
                t.status = "failed"
                t.degradation = "timeout"
                t.error = (f"DeadlineExceeded: deadline of "
                           f"{req.deadline_s}s expired while the pool "
                           f"was still warming (queued {age:.3f}s)")
            out.append(t)
        return out

    def _take_group_by_pool(self, pool_id: str) -> list[Ticket]:
        group = [t for t in self._queue if t.request.pool_id == pool_id]
        taken = set(id(t) for t in group)
        self._queue = [t for t in self._queue if id(t) not in taken]
        return group

    def _take_group(self, head: Ticket) -> list[Ticket]:
        # Anchored on the fairness winner: the head always rides its own
        # batch; other same-key tickets (any priority/tenant) fill the
        # remaining slots in queue order — riding is free capacity.
        key = head.request.batch_key()
        group = [head] + [t for t in self._queue if t is not head
                          and t.request.batch_key() == key]
        group = group[: self.max_batch]
        taken = set(id(t) for t in group)
        self._queue = [t for t in self._queue if id(t) not in taken]
        return group

    def _take_share_group(self, head: Ticket) -> list[Ticket]:
        """Brownout grouping: same pool and solve parameters, default
        target/valid, *any* k — the group shares one anytime session and
        each member's answer is the first-k prefix.  Anchored on the
        fairness winner like ``_take_group``."""
        req = head.request

        def shares(t: Ticket) -> bool:
            r = t.request
            return (r.pool_id == req.pool_id and r.strategy == "gradmatch"
                    and r.target is None and r.valid is None
                    and float(r.lam) == float(req.lam)
                    and float(r.eps) == float(req.eps)
                    and r.positive == req.positive)

        group = [head] + [t for t in self._queue
                          if t is not head and shares(t)]
        group = group[: self.max_batch]
        taken = set(id(t) for t in group)
        self._queue = [t for t in self._queue if id(t) not in taken]
        return group

    def _run_shared_anytime(self, entry: PoolEntry,
                            group: list[Ticket]) -> None:
        """One anytime session answers the whole differing-k group.

        The deepest request runs the real incremental solve (rung
        ``"certified"`` — its indices are exactly the one-shot k_max
        solve's); every shallower request is answered as the session's
        first-k prefix, which the full-block prefix-growth schedule
        certifies index-identical to its own one-shot solve
        (``"prefix-shared"``: weights are renormalized, approximate).  A
        live session already covering k_max short-circuits the solve
        entirely.  The state is parked in the session store afterwards so
        the next brownout group (and the degradation ladder) reuse it.
        """
        breaker = self.breakers.get(entry.pool_id)
        req0 = group[0].request
        k_max = max(t.request.k for t in group)
        b = len(group)
        if self.session_lookup is not None:
            reuse = [self.session_lookup(entry.pool_id, entry.fingerprint,
                                         t.request.k) for t in group]
            if all(r is not None for r in reuse):
                for t, res in zip(group, reuse):
                    t.result = res
                    self._served(t, "prefix-shared", batched=b)
                return
        try:
            state = omp_session_start(
                entry.grads, entry.target_sum, k_max, lam=req0.lam,
                eps=req0.eps, positive=req0.positive, valid=entry.valid)
        except Exception as exc:          # fail the group, not the queue
            for t in group:
                t.status = "failed"
                t.error = f"{type(exc).__name__}: {exc}"
            if self._is_pool_fault(exc):
                breaker.record_failure()
            return
        for t in group:
            k = t.request.k
            if k == state.k:
                idx, w, mask, err = session_result(state)
                t.result = SelectionResult(idx, _normalize(w, mask),
                                           mask, err)
                t.status = "done"
                t.batched_with = b
                t.degradation = "certified"
            else:
                idx, w, mask, err = session_prefix_result(state, k)
                t.result = SelectionResult(idx, _normalize(w, mask),
                                           mask, err)
                self._served(t, "prefix-shared", batched=b)
        breaker.record_success()
        self.shared_solves += 1
        if self.session_save is not None:
            self.session_save(entry.pool_id, entry.fingerprint, state)

    def _run_brownout_single(self, entry: PoolEntry,
                             ticket: Ticket) -> None:
        """Full-overload floor for non-interactive gradmatch: a seeded
        subsample solve (stochastic rung) instead of the full pool scan.
        Falls back to the ordinary certified path when no subsample
        arena exists (empty valid set, cache-less chunked pool)."""
        req = ticket.request
        target = (entry.target_sum if req.target is None
                  else _vec(req.target, entry.device))
        res = None
        try:
            if entry.kind == "array":
                valid = _request_valid(entry, req.valid)
                res = stochastic_pool_select(
                    entry.grads, target, req.k, seed=req.seed,
                    lam=req.lam, eps=req.eps, positive=req.positive,
                    valid=valid)
            elif entry.cache is not None and req.valid is None:
                res = stochastic_fallback(
                    entry.cache, target, req.k, seed=req.seed,
                    lam=req.lam, eps=req.eps, positive=req.positive)
        except Exception:
            res = None
        if res is None:
            self._run_single(entry, ticket)
            return
        ticket.result = SelectionResult(
            res.indices, _normalize(res.weights, res.mask), res.mask,
            res.err)
        self._served(ticket, "stochastic")
        self.singles_run += 1

    def _run_gradmatch_batch(self, entry: PoolEntry,
                             group: list[Ticket]) -> None:
        req0 = group[0].request
        b = len(group)
        try:
            # Operand assembly inside the guard too: a malformed
            # per-request target/valid (submit() does not shape-check
            # them) must fail the group, not escape drain().
            dev = entry.device
            targets = torch.stack([
                entry.target_sum if t.request.target is None
                else _vec(t.request.target, dev)
                for t in group])
            base_valid = (entry.valid if entry.valid is not None
                          else torch.ones((entry.n,), dtype=torch.bool,
                                          device=dev))
            valids = torch.stack([
                base_valid if t.request.valid is None
                else base_valid & _flags(t.request.valid, dev)
                for t in group])
            # Pad to the power-of-two bucket, as the reference does: the
            # batched regime rule reads the padded B.  Pad rows re-solve
            # request 0 and are dropped below.
            bb = min(_bucket_b(b), self.max_batch)
            if bb > b:
                pad = bb - b
                targets = torch.cat([targets,
                                     targets[:1].expand(pad, -1)])
                valids = torch.cat([valids, valids[:1].expand(pad, -1)])
            idx, w, mask, err = omp_select_batched(
                entry.grads, targets, k=req0.k, lam=req0.lam, eps=req0.eps,
                positive=req0.positive, valid=valids)
        except Exception as exc:          # fail the group, not the queue
            for t in group:
                t.status = "failed"
                t.error = f"{type(exc).__name__}: {exc}"
            return
        for i, t in enumerate(group):
            t.result = SelectionResult(idx[i], _normalize(w[i], mask[i]),
                                       mask[i], err[i])
            t.status = "done"
            t.batched_with = b
            t.degradation = "certified"
        self.breakers.get(entry.pool_id).record_success()
        self.batches_run += 1

    @staticmethod
    def _is_pool_fault(exc: BaseException) -> bool:
        """Failures that indict the *pool* (count toward its breaker), as
        opposed to a caller's malformed request: injected/real I-O faults
        that exhausted retries, stream death, pass-budget blowups."""
        return isinstance(exc, (FaultError,
                                stream_lib.StreamingPassBudgetError))

    def _run_single(self, entry: PoolEntry, ticket: Ticket) -> None:
        req = ticket.request
        breaker = self.breakers.get(entry.pool_id)
        try:
            age = self._clock() - ticket.submitted_at
            if req.deadline_s is not None and age > req.deadline_s:
                ticket.degradation = "timeout"
                raise DeadlineExceeded(
                    f"deadline of {req.deadline_s}s expired before the "
                    f"solve started (queued {age:.3f}s)")
            ticket.result = self._execute_single(entry, req)
            ticket.status = "done"
            ticket.batched_with = 1
            ticket.degradation = "certified"
            breaker.record_success()
        except DeadlineExceeded as exc:
            # Not a pool fault: the pool never got to run.
            ticket.status = "failed"
            ticket.error = f"{type(exc).__name__}: {exc}"
        except Exception as exc:          # surface, don't wedge the queue
            if self._is_pool_fault(exc):
                breaker.record_failure()
                if (self.degrade and req.strategy == "gradmatch"
                        and entry.kind == "chunked"
                        and self._degrade_chunked(entry, ticket, breaker)):
                    self.singles_run += 1
                    return
            ticket.status = "failed"
            ticket.degradation = "failed"
            ticket.error = f"{type(exc).__name__}: {exc}"
        self.singles_run += 1

    def _degrade_chunked(self, entry: PoolEntry, ticket: Ticket,
                         breaker) -> bool:
        """Walk the degradation ladder for a chunked gradmatch solve whose
        certified attempt died on a pool fault.  Returns True when a rung
        produced an answer (labelled on the ticket); the winning rung is
        counted in ``degraded_served``."""
        req = ticket.request
        target = (entry.target_sum if req.target is None
                  else _vec(req.target, entry.device))
        # Rung 2: re-run the certified solve, resuming from the failed
        # attempt's mid-solve checkpoint.  Still bit-identical to
        # fault-free when it completes — the label records that recovery
        # (not the first attempt) produced it.
        if self.checkpoint_root is not None:
            try:
                ticket.result = self._execute_single(entry, req)
            except Exception as exc2:
                if self._is_pool_fault(exc2):
                    breaker.record_failure()
            else:
                self._served(ticket, "resumed")
                breaker.record_success()
                return True
        # Rung 3: first-k prefix of a live anytime session over the same
        # pool content (indices certified by the prefix property).
        if self.session_lookup is not None:
            res = self.session_lookup(entry.pool_id, entry.fingerprint,
                                      req.k)
            if res is not None:
                ticket.result = res
                self._served(ticket, "anytime-prefix")
                return True
        # Rung 4: seeded stochastic-greedy over the rows still resident in
        # the pool's compressed cache — approximate, loader-free.
        res = stochastic_fallback(entry.cache, target, req.k,
                                  seed=req.seed, lam=req.lam, eps=req.eps,
                                  positive=req.positive)
        if res is not None:
            ticket.result = SelectionResult(
                res.indices, _normalize(res.weights, res.mask), res.mask,
                res.err)
            self._served(ticket, "stochastic")
            return True
        return False

    def _served(self, ticket: Ticket, rung: str, batched: int = 1) -> None:
        ticket.status = "done"
        ticket.batched_with = batched
        ticket.degradation = rung
        self.degraded_served[rung] = self.degraded_served.get(rung, 0) + 1

    def _execute_single(self, entry: PoolEntry,
                        req: SelectRequest) -> SelectionResult:
        dev = entry.device
        if req.strategy == "random":
            return random_sel.random_select(
                torch.Generator(device=dev).manual_seed(req.seed), entry.n,
                req.k, valid=_request_valid(entry, req.valid))
        if req.strategy == "gradmatch" and entry.kind == "chunked":
            if req.valid is not None:
                # The chunk factory was frozen at registration; silently
                # selecting masked rows would be worse than refusing.
                raise ValueError(
                    "per-request valid masks are not supported on chunked "
                    "pools — register the pool with the mask instead")
            target = (entry.target_sum if req.target is None
                      else _vec(req.target, dev))
            # The admission-warmed compressed cache + row fetcher make
            # this request's certified rounds and repairs hit memory
            # instead of re-paying loader passes (DESIGN.md §7).
            return stream_lib.gradmatch_streaming(
                entry.chunk_iter, req.k, target=target, lam=req.lam,
                eps=req.eps, buffer_size=self.stream_buffer,
                cache=entry.cache, row_fetch=entry.row_fetch,
                retry=self.retry,
                checkpoint_dir=self._checkpoint_dir(entry, req, target),
                checkpoint_every=self.checkpoint_every, device=dev)
        if req.strategy == "gradmatch-partitioned":
            # Partition-and-merge (core/partition.py, DESIGN.md §9): the
            # pool's registered partition count (0 = solver auto) shapes
            # the split; chunked pools stream contiguous row ranges
            # through the certified engine, resident pools solve hashed
            # partitions device-parallel.
            target = (None if req.target is None
                      else _vec(req.target, dev))
            if entry.kind == "chunked":
                if req.valid is not None:
                    raise ValueError(
                        "per-request valid masks are not supported on "
                        "chunked pools — register the pool with the mask "
                        "instead")
                return part_lib.gradmatch_partitioned_stream(
                    pool_iter=entry.chunk_iter, k=req.k, n=entry.n,
                    partitions=entry.partitions, row_fetch=entry.row_fetch,
                    target=target, lam=req.lam, eps=req.eps,
                    buffer_size=self.stream_buffer, retry=self.retry,
                    device=dev)
            valid = _request_valid(entry, req.valid)
            return part_lib.gradmatch_partitioned(
                entry.grads, req.k, partitions=entry.partitions,
                target=target, lam=req.lam, eps=req.eps, valid=valid)
        if entry.kind != "array":
            raise ValueError(
                f"strategy {req.strategy!r} needs a resident pool")
        valid = _request_valid(entry, req.valid)
        if req.strategy in _CRAIG_METHODS:
            sim, lm, otf = entry.fl_scan(_CRAIG_METHODS[req.strategy])
            return craig_lib.craig(
                entry.grads, req.k, sim=sim, valid=valid,
                method=_CRAIG_METHODS[req.strategy], l_max=lm,
                on_the_fly=otf,
                generator=torch.Generator(device=dev).manual_seed(req.seed))
        if req.strategy == "glister":
            target = (entry.target_sum if req.target is None
                      else _vec(req.target, dev))
            return glister_lib.glister(entry.grads, target, req.k,
                                       valid=valid)
        raise ValueError(f"unservable strategy {req.strategy!r}")

    def _checkpoint_dir(self, entry: PoolEntry,
                        req: SelectRequest, target) -> Optional[str]:
        """Per-*solve* checkpoint directory under ``checkpoint_root``.

        The solver refuses to resume a checkpoint from an incompatible
        solve, but the target vector is not part of its compatibility
        check — so the directory key hashes everything that defines the
        solve (pool content, k, lam/eps/positive, target bytes).  Two
        different asks never share a directory.
        """
        if self.checkpoint_root is None:
            return None
        h = hashlib.sha1(repr(
            (entry.fingerprint, req.k, float(req.lam), float(req.eps),
             req.positive)).encode())
        h.update(host_array(target).tobytes())
        return os.path.join(self.checkpoint_root,
                            f"{entry.pool_id}-{h.hexdigest()[:12]}")

    def stats(self) -> dict:
        return {"pending": len(self._queue),
                "batches_run": self.batches_run,
                "singles_run": self.singles_run,
                "shared_solves": self.shared_solves,
                "counters": dict(self.counters),
                "degraded_served": dict(self.degraded_served),
                "overload": (None if self.overload is None
                             else self.overload.stats()),
                "breakers": self.breakers.stats()}
