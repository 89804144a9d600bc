"""Admission control: bounded queues and per-tenant budget accounting,
after ``repro/serve/admission.py`` (host-side bookkeeping, unchanged).

A shared selection service dies one of two deaths without backpressure: an
unbounded queue (every caller sees unbounded latency) or one hot tenant
starving the rest.  Admission is therefore checked at ``submit`` time, and
rejections are *errors the client sees immediately* — never silent drops:

* ``QueueFull`` — the global queue is at ``max_queue``; retry after a
  drain.  This is the load-shedding backstop, tenant-blind by design.
* ``BudgetExhausted`` — the tenant has spent its cost budget or has too
  many requests in flight.  Budgets are charged in abstract *work units*
  estimated from the request shape (``estimate_cost``), debited at
  admission (optimistic — the scheduler refunds nothing for batched
  amortization, so the budget is a worst-case sequential bound and
  batching is pure headroom for the operator).  Work that *fails* is
  refunded via ``complete(refund=...)``: a metered tenant never pays for
  selections that were not delivered.

``TenantAccount.budget_units=None`` means unmetered (the default tenant) —
in-flight caps still apply, so even unmetered tenants cannot occupy the
whole queue.

Two load-time extensions (DESIGN.md §10):

* ``TenantAccount.weight`` feeds the scheduler's deficit-round-robin fair
  queue — a tenant with weight 2 drains twice the work units per rotation
  of a weight-1 tenant, instead of FIFO letting whoever submitted first
  monopolize the drain.
* ``OverloadController`` maps queue pressure to a brownout **level** with
  hysteresis, and decides *at submit* which priority classes are shed.
  Shedding is visible (the caller gets a labelled ``"shed"`` ticket) and
  never charged — the accounting invariant ``admitted == completed + shed
  + failed + pending`` is checked by the load harness and the parity gate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


class AdmissionError(RuntimeError):
    """Base class: request rejected at admission (client should back off)."""


class QueueFull(AdmissionError):
    pass


class BudgetExhausted(AdmissionError):
    pass


def estimate_cost(n: int, d: int, k: int) -> float:
    """Work units for one selection: the pool scan + per-round solve term.

    ``n·d`` (one scoring pass over the pool) + ``k·(n + d)`` (per-round
    argmax + cache growth) — the incremental solver's leading terms.  Units
    are arbitrary but consistent, which is all budget *ratios* need.
    """
    return float(n) * d + float(k) * (n + d)


@dataclass
class TenantAccount:
    tenant: str
    budget_units: Optional[float] = None   # None = unmetered
    max_inflight: int = 16
    weight: float = 1.0                    # fair-queue share (DRR)
    used_units: float = 0.0
    inflight: int = 0
    admitted: int = 0
    rejected: int = 0

    @property
    def remaining_units(self) -> Optional[float]:
        if self.budget_units is None:
            return None
        return max(self.budget_units - self.used_units, 0.0)


class AdmissionController:
    def __init__(self, max_queue: int = 64,
                 default_budget_units: Optional[float] = None,
                 max_inflight_per_tenant: int = 16):
        self.max_queue = int(max_queue)
        self.default_budget_units = default_budget_units
        self.max_inflight_per_tenant = int(max_inflight_per_tenant)
        self._accounts: dict[str, TenantAccount] = {}

    def account(self, tenant: str) -> TenantAccount:
        acct = self._accounts.get(tenant)
        if acct is None:
            acct = TenantAccount(
                tenant=tenant, budget_units=self.default_budget_units,
                max_inflight=self.max_inflight_per_tenant)
            self._accounts[tenant] = acct
        return acct

    def set_budget(self, tenant: str, budget_units: Optional[float],
                   max_inflight: Optional[int] = None,
                   weight: Optional[float] = None) -> TenantAccount:
        acct = self.account(tenant)
        acct.budget_units = budget_units
        if max_inflight is not None:
            acct.max_inflight = int(max_inflight)
        if weight is not None:
            acct.weight = float(weight)
        return acct

    def set_weight(self, tenant: str, weight: float) -> TenantAccount:
        """Set a tenant's fair-queue share; must be > 0."""
        if not weight > 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        acct = self.account(tenant)
        acct.weight = float(weight)
        return acct

    def admit(self, tenant: str, cost: float, queue_depth: int) -> float:
        """Charge ``cost`` units to ``tenant`` or raise; returns the cost."""
        acct = self.account(tenant)
        if queue_depth >= self.max_queue:
            acct.rejected += 1
            raise QueueFull(
                f"queue at capacity ({queue_depth}/{self.max_queue}); "
                "drain before submitting more")
        if acct.inflight >= acct.max_inflight:
            acct.rejected += 1
            raise BudgetExhausted(
                f"tenant {tenant!r} has {acct.inflight} requests in flight "
                f"(max {acct.max_inflight})")
        if (acct.budget_units is not None
                and acct.used_units + cost > acct.budget_units):
            acct.rejected += 1
            raise BudgetExhausted(
                f"tenant {tenant!r} budget exhausted: {acct.used_units:.3g}"
                f" + {cost:.3g} > {acct.budget_units:.3g} units")
        acct.used_units += cost
        acct.inflight += 1
        acct.admitted += 1
        return cost

    def complete(self, tenant: str, refund: float = 0.0) -> None:
        """Release an in-flight slot; ``refund`` credits back admission
        units for work that failed (a metered tenant must not pay for
        selections that were never delivered — successful batched work is
        still charged its full sequential estimate, that amortization
        stays operator headroom)."""
        acct = self.account(tenant)
        acct.inflight = max(acct.inflight - 1, 0)
        if refund:
            acct.used_units = max(acct.used_units - refund, 0.0)

    def stats(self) -> dict:
        return {t: {"used_units": a.used_units, "inflight": a.inflight,
                    "admitted": a.admitted, "rejected": a.rejected,
                    "weight": a.weight,
                    "remaining_units": a.remaining_units}
                for t, a in self._accounts.items()}


class OverloadController:
    """Queue pressure -> brownout level, with hysteresis.

    Levels (DESIGN.md §10):

    * ``0`` normal — the scheduler runs its ordinary certified paths.
    * ``1`` brownout — best-effort requests are shed at submit; the
      scheduler routes same-pool differing-k gradmatch groups through one
      shared anytime session (each answered as a bit-exact index prefix).
    * ``2`` overload — batch-class requests are shed too, and queued
      non-interactive gradmatch work takes the stochastic rung instead of
      a full solve.

    Thresholds are fractions of ``max_queue``; ``recover_at`` sits below
    ``brownout_at`` so the level does not flap at the boundary — it takes
    a genuinely drained queue to leave brownout, not one lucky step.
    Interactive traffic is never shed here; its backstop stays the
    tenant-blind ``QueueFull`` limit.
    """

    def __init__(self, max_queue: int = 64, brownout_at: float = 0.5,
                 overload_at: float = 0.85, recover_at: float = 0.25):
        if not 0.0 <= recover_at <= brownout_at <= overload_at <= 1.0:
            raise ValueError(
                "need 0 <= recover_at <= brownout_at <= overload_at <= 1,"
                f" got {recover_at}/{brownout_at}/{overload_at}")
        self.max_queue = int(max_queue)
        self.brownout_at = float(brownout_at)
        self.overload_at = float(overload_at)
        self.recover_at = float(recover_at)
        self.level = 0
        self.transitions = 0
        self.sheds: dict[str, int] = {}     # priority -> shed count

    def observe(self, queue_depth: int) -> int:
        """Update and return the level for the current queue depth."""
        f = queue_depth / max(self.max_queue, 1)
        new = self.level
        if f >= self.overload_at:
            new = 2
        elif f >= self.brownout_at:
            new = max(self.level, 1)
        elif f <= self.recover_at:
            new = 0
        elif self.level == 2:
            new = 1                          # partial recovery: 2 -> 1
        if new != self.level:
            self.transitions += 1
            self.level = new
        return self.level

    def should_shed(self, priority: str) -> bool:
        return ((self.level >= 1 and priority == "best-effort")
                or (self.level >= 2 and priority == "batch"))

    def record_shed(self, priority: str) -> None:
        self.sheds[priority] = self.sheds.get(priority, 0) + 1

    def stats(self) -> dict:
        return {"level": self.level, "transitions": self.transitions,
                "sheds": dict(self.sheds)}
