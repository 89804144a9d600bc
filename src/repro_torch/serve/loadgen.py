"""Open-loop load generation for the selection service (DESIGN.md §10),
after ``repro/serve/loadgen.py``.

Closed-loop benchmarks (submit a batch, drain, repeat) measure solver
throughput but say nothing about overload: production arrivals do not
wait for the queue to drain.  This module generates **open-loop**
traffic — seeded Poisson arrivals over configurable
pool/strategy/k/tenant/priority mixes — and drives a ``SelectionService``
through it, recording per-request latency, outcome and degradation rung
plus the shed-accounting invariants.

Time is virtual.  The service is synchronous (``submit``/``drain_step``),
so the harness owns a ``SimClock`` injected as the service clock: all
arrivals due at the current virtual time are submitted, one
``drain_step`` runs, and the clock advances by that step's *measured*
wall time (or an injected ``step_cost`` for fully deterministic tests).
On the card a step can return with work still queued on the device, so
the default timer synchronises the pools' device before each reading (on
the CPU that is a no-op).
Nothing reads the wall clock for scheduling decisions — the arrival
schedule is a pure function of the spec's seed, so a trace replays
bit-identically while the latency numbers stay real.

Invariants checked after every run (``LoadReport.violations``):

* ``admitted == completed + shed + failed + pending`` — no ticket is
  ever silently dropped (a queue wedge or a lost ticket shows up here);
* every tenant's in-flight count returns to zero — no leaked slots;
* every metered unit charged is accounted for by a delivered ticket —
  failed work was refunded exactly once, shed work was never charged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

import torch

from repro_torch.resilience.circuit import CircuitOpen
from repro_torch.serve.admission import AdmissionError
from repro_torch.serve.registry import UnknownPool
from repro_torch.serve.scheduler import SelectRequest


class SimClock:
    """Injectable virtual clock: ``now()`` reads, ``advance()`` moves.

    Pass ``clock=sim.now`` to ``SelectionService`` so deadlines, breaker
    cooldowns and session TTLs all live in the same virtual timeline the
    load harness advances.
    """

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")
        self._t += dt
        return self._t


@dataclass(frozen=True)
class Arrival:
    t: float                  # virtual arrival time
    request: SelectRequest


@dataclass(frozen=True)
class LoadSpec:
    """Seeded description of an open-loop trace.

    ``rate_rps`` is the Poisson arrival rate (exponential inter-arrival
    gaps); each categorical field draws independently from its weighted
    mix.  ``deadline_s`` maps a priority class to its SLO deadline
    (None = no deadline for that class).
    """

    seed: int = 0
    requests: int = 64
    rate_rps: float = 100.0
    pools: Sequence[str] = ()
    pool_weights: Optional[Sequence[float]] = None
    ks: Sequence[int] = (32,)
    k_weights: Optional[Sequence[float]] = None
    tenants: Sequence[str] = ("default",)
    tenant_weights: Optional[Sequence[float]] = None
    priorities: Sequence[str] = ("interactive",)
    priority_weights: Optional[Sequence[float]] = None
    strategies: Sequence[str] = ("gradmatch",)
    strategy_weights: Optional[Sequence[float]] = None
    lam: float = 0.5
    eps: float = 1e-10
    deadline_s: Optional[dict] = None     # priority -> deadline


def _choice(rng, options, weights):
    if len(options) == 1:
        return options[0]
    p = None
    if weights is not None:
        w = np.asarray(weights, np.float64)
        p = w / w.sum()
    return options[int(rng.choice(len(options), p=p))]


def make_arrivals(spec: LoadSpec) -> list[Arrival]:
    """The trace: a pure function of the spec (same seed, same trace)."""
    if not spec.pools:
        raise ValueError("LoadSpec.pools must name at least one pool")
    rng = np.random.default_rng(int(spec.seed))
    t = 0.0
    out: list[Arrival] = []
    for i in range(int(spec.requests)):
        t += float(rng.exponential(1.0 / float(spec.rate_rps)))
        priority = _choice(rng, tuple(spec.priorities),
                           spec.priority_weights)
        deadline = (spec.deadline_s or {}).get(priority)
        out.append(Arrival(t=t, request=SelectRequest(
            pool_id=_choice(rng, tuple(spec.pools), spec.pool_weights),
            k=int(_choice(rng, tuple(spec.ks), spec.k_weights)),
            strategy=_choice(rng, tuple(spec.strategies),
                             spec.strategy_weights),
            lam=spec.lam, eps=spec.eps,
            tenant=_choice(rng, tuple(spec.tenants), spec.tenant_weights),
            priority=priority, seed=i, deadline_s=deadline)))
    return out


@dataclass
class LoadReport:
    requests: int = 0
    completed: int = 0
    shed: int = 0
    failed: int = 0
    timeouts: int = 0
    rejected: int = 0                 # QueueFull / budget / breaker raises
    duration_s: float = 0.0           # first arrival -> last settle
    sustained_rps: float = 0.0        # completed / duration
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    class_p99_ms: dict = field(default_factory=dict)
    tenant_p99_ms: dict = field(default_factory=dict)
    rungs: dict = field(default_factory=dict)
    tenant_served_units: dict = field(default_factory=dict)
    fairness_ratio: Optional[float] = None   # min/max weighted service
    violations: list = field(default_factory=list)
    records: list = field(default_factory=list, repr=False)

    @property
    def ok(self) -> bool:
        return not self.violations


def _pctl(lat_s: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(lat_s), q) * 1e3) if lat_s \
        else 0.0


def device_timer(device: torch.device) -> Callable[[], float]:
    """``time.perf_counter`` read after the work queued on ``device`` has
    finished (a CUDA device is synchronised first; the CPU needs nothing)."""

    def timer() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    return timer


def run_load(service, arrivals: Sequence[Arrival], clock: SimClock,
             timer: Optional[Callable[[], float]] = None,
             step_cost: Optional[Callable] = None,
             max_steps: int = 1_000_000) -> LoadReport:
    """Drive ``service`` through ``arrivals`` on the virtual ``clock``.

    The service must have been constructed with ``clock=clock.now``.
    ``timer`` reads the wall clock around each drain step; its default is
    ``device_timer`` of the service's device.  ``step_cost(
    finalized_tickets) -> seconds`` replaces the measured drain-step wall
    time for deterministic tests.  ``max_steps`` is an anti-wedge bound:
    exceeding it is itself reported as a violation.
    """
    if timer is None:
        timer = device_timer(service.device)
    sched = service.scheduler
    base_used = {t: s["used_units"]
                 for t, s in service.admission.stats().items()}
    arr = sorted(arrivals, key=lambda a: a.t)
    recs: list[dict] = []
    open_recs: dict[str, dict] = {}
    rejected = 0
    i = 0
    steps = 0
    while i < len(arr) or sched.pending():
        now = clock.now()
        while i < len(arr) and arr[i].t <= now + 1e-12:
            a = arr[i]
            i += 1
            try:
                tk = sched.submit(a.request)
            except (AdmissionError, CircuitOpen, UnknownPool):
                rejected += 1
                continue
            rec = {"ticket": tk, "t_arr": a.t, "t_done": None}
            recs.append(rec)
            if tk.status == "shed":
                rec["t_done"] = now
            else:
                open_recs[tk.ticket_id] = rec
        if sched.pending():
            steps += 1
            if steps > max_steps:
                break
            t0 = timer()
            out = sched.drain_step()
            dt = (step_cost(out) if step_cost is not None
                  else timer() - t0)
            clock.advance(dt)
            done_at = clock.now()
            for tk in out:
                rec = open_recs.pop(tk.ticket_id, None)
                if rec is not None:
                    rec["t_done"] = done_at
        elif i < len(arr):
            clock.advance(max(arr[i].t - clock.now(), 0.0))
    return _report(service, recs, rejected, base_used,
                   wedged=steps > max_steps)


def _report(service, recs, rejected, base_used, wedged=False
            ) -> LoadReport:
    rep = LoadReport(requests=len(recs) + rejected, rejected=rejected,
                     records=recs)
    lat_all: list[float] = []
    lat_by_class: dict[str, list] = {}
    lat_by_tenant: dict[str, list] = {}
    t_first = min((r["t_arr"] for r in recs), default=0.0)
    t_last = t_first
    for r in recs:
        t = r["ticket"]
        rep.rungs[t.degradation] = rep.rungs.get(t.degradation, 0) + 1
        if r["t_done"] is not None:
            t_last = max(t_last, r["t_done"])
        if t.status == "done":
            rep.completed += 1
            rep.tenant_served_units[t.request.tenant] = (
                rep.tenant_served_units.get(t.request.tenant, 0.0)
                + t.cost)
            lat = r["t_done"] - r["t_arr"]
            lat_all.append(lat)
            lat_by_class.setdefault(t.request.priority, []).append(lat)
            lat_by_tenant.setdefault(t.request.tenant, []).append(lat)
        elif t.status == "shed":
            rep.shed += 1
        else:
            rep.failed += 1
            if t.degradation == "timeout":
                rep.timeouts += 1
    rep.duration_s = max(t_last - t_first, 0.0)
    rep.sustained_rps = (rep.completed / rep.duration_s
                         if rep.duration_s > 0 else 0.0)
    rep.p50_ms = _pctl(lat_all, 50)
    rep.p99_ms = _pctl(lat_all, 99)
    rep.class_p99_ms = {c: _pctl(v, 99) for c, v in lat_by_class.items()}
    rep.tenant_p99_ms = {c: _pctl(v, 99)
                         for c, v in lat_by_tenant.items()}
    if len(rep.tenant_served_units) > 1:
        shares = [units / service.admission.account(tn).weight
                  for tn, units in rep.tenant_served_units.items()]
        rep.fairness_ratio = min(shares) / max(shares)
    rep.violations = _violations(service, recs, base_used)
    if wedged:
        rep.violations.append("queue wedge: max_steps exceeded with "
                              f"{service.scheduler.pending()} pending")
    return rep


def _violations(service, recs, base_used) -> list[str]:
    """The run's accounting invariants; empty list = clean."""
    v: list[str] = []
    c = service.scheduler.counters
    pending = service.scheduler.pending()
    if c["admitted"] != (c["completed"] + c["shed"] + c["failed"]
                         + pending):
        v.append(
            f"shed accounting broken: admitted={c['admitted']} != "
            f"completed={c['completed']} + shed={c['shed']} + "
            f"failed={c['failed']} + pending={pending}")
    for tenant, s in service.admission.stats().items():
        if s["inflight"] != 0:
            v.append(f"inflight slot leak: tenant {tenant!r} ends at "
                     f"{s['inflight']}")
    # Exactly-once refunds: a tenant's used_units moved by exactly the
    # cost of its *delivered* tickets — failed work refunded once, shed
    # work never charged.  (Only this run's tickets: prior usage is in
    # base_used.)
    expected: dict[str, float] = {}
    for r in recs:
        t = r["ticket"]
        if t.status == "done":
            expected[t.request.tenant] = (
                expected.get(t.request.tenant, 0.0) + t.cost)
    for tenant, s in service.admission.stats().items():
        want = base_used.get(tenant, 0.0) + expected.get(tenant, 0.0)
        if abs(s["used_units"] - want) > 1e-6 * max(want, 1.0):
            v.append(
                f"budget leak: tenant {tenant!r} used_units="
                f"{s['used_units']:.6g}, expected {want:.6g} "
                "(failed work not refunded exactly once, or shed work "
                "charged)")
    return v


__all__ = ["Arrival", "LoadReport", "LoadSpec", "SimClock", "device_timer",
           "make_arrivals", "run_load"]
