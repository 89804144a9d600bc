"""Fault model, injection, recovery, circuit breaking and degradation,
after ``repro/resilience/``: seeded injectors (``faults``), bounded retry
(``recovery``), per-pool breakers (``circuit``) and the labelled
degradation ladder's stochastic rung (``degrade``).  The reference's disk
faults (``inject_disk_fault``, ``DISK_FAULT_KINDS``) come with the
artifact store."""

from repro_torch.resilience.circuit import (BreakerBoard, CircuitBreaker,
                                            CircuitOpen)
from repro_torch.resilience.degrade import (DEGRADE_LEVELS, DeadlineExceeded,
                                            stochastic_fallback)
from repro_torch.resilience.faults import (ChunkReadError, CorruptChunkError,
                                           FaultError, FaultPlan,
                                           FaultyChunkIterator, RowFetchError,
                                           SimulatedCrash, StreamDied,
                                           TransientFault, crash_after,
                                           faulty_row_fetch)
from repro_torch.resilience.recovery import (RetryExhausted, RetryPolicy,
                                             with_retries)

__all__ = [
    "BreakerBoard", "CircuitBreaker", "CircuitOpen",
    "DEGRADE_LEVELS", "DeadlineExceeded", "stochastic_fallback",
    "ChunkReadError", "CorruptChunkError", "FaultError",
    "FaultPlan", "FaultyChunkIterator", "RowFetchError", "SimulatedCrash",
    "StreamDied", "TransientFault", "crash_after", "faulty_row_fetch",
    "RetryExhausted", "RetryPolicy", "with_retries",
]
