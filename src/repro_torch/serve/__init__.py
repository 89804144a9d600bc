"""Selection-as-a-service (DESIGN.md §6), after ``repro/serve/``.

Multi-tenant batched selection over registered pools on the card: a pool
registry with per-pool precompute and the offline artifact fast path, a
micro-batching request scheduler over the batched multi-target OMP,
anytime-budget sessions (k -> k' extension as a certified resume),
continual stream sessions, tenant admission and backpressure, and the
open-loop load harness.
"""

from repro_torch.resilience.circuit import (BreakerBoard, CircuitBreaker,
                                            CircuitOpen)
from repro_torch.resilience.degrade import DEGRADE_LEVELS, DeadlineExceeded
from repro_torch.resilience.recovery import RetryExhausted, RetryPolicy
from repro_torch.serve.admission import (AdmissionController, AdmissionError,
                                         BudgetExhausted, OverloadController,
                                         QueueFull, estimate_cost)
from repro_torch.serve.loadgen import (Arrival, LoadReport, LoadSpec,
                                       SimClock, device_timer, make_arrivals,
                                       run_load)
from repro_torch.serve.registry import PoolEntry, PoolRegistry, UnknownPool
from repro_torch.serve.scheduler import (PRIORITIES, RequestScheduler,
                                         SelectRequest, Ticket)
from repro_torch.serve.service import SelectionService
from repro_torch.serve.sessions import (Session, SessionGone, SessionStore,
                                        StreamSession)

__all__ = [
    "AdmissionController", "AdmissionError", "Arrival", "BreakerBoard",
    "BudgetExhausted", "CircuitBreaker", "CircuitOpen", "DEGRADE_LEVELS",
    "DeadlineExceeded", "LoadReport", "LoadSpec", "OverloadController",
    "PRIORITIES", "QueueFull", "SimClock", "device_timer", "estimate_cost",
    "make_arrivals", "run_load", "PoolEntry",
    "PoolRegistry", "RetryExhausted", "RetryPolicy", "UnknownPool",
    "RequestScheduler", "SelectRequest", "Ticket", "SelectionService",
    "Session", "SessionGone", "SessionStore", "StreamSession",
]
