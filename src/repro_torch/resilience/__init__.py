"""Fault model, injection, recovery, circuit breaking and degradation,
after ``repro/resilience/``: seeded injectors (``faults``), bounded retry
(``recovery``), per-pool breakers (``circuit``) and the labelled
degradation ladder's stochastic rung (``degrade``), and the artifact
store's disk faults (``DISK_FAULT_KINDS``, ``inject_disk_fault``)."""

from repro_torch.resilience.circuit import (BreakerBoard, CircuitBreaker,
                                            CircuitOpen)
from repro_torch.resilience.degrade import (DEGRADE_LEVELS, DeadlineExceeded,
                                            stochastic_fallback)
from repro_torch.resilience.faults import (DISK_FAULT_KINDS, ChunkReadError,
                                           CorruptChunkError, FaultError,
                                           FaultPlan, FaultyChunkIterator,
                                           RowFetchError, SimulatedCrash,
                                           StreamDied, TransientFault,
                                           crash_after, faulty_row_fetch,
                                           inject_disk_fault,
                                           store_manifest_size)
from repro_torch.resilience.recovery import (RetryExhausted, RetryPolicy,
                                             with_retries)

__all__ = [
    "BreakerBoard", "CircuitBreaker", "CircuitOpen",
    "DEGRADE_LEVELS", "DeadlineExceeded", "stochastic_fallback",
    "ChunkReadError", "CorruptChunkError", "FaultError",
    "FaultPlan", "FaultyChunkIterator", "RowFetchError", "SimulatedCrash",
    "StreamDied", "TransientFault", "crash_after", "faulty_row_fetch",
    "DISK_FAULT_KINDS", "inject_disk_fault", "store_manifest_size",
    "RetryExhausted", "RetryPolicy", "with_retries",
]
