"""Fault kinds the streaming engine raises and recovers from, after
``repro/resilience/faults.py``.

``TransientFault``     goes away on re-read; the retry policy's domain.
  ``ChunkReadError``   a chunk read raised (I/O error analogue).
  ``RowFetchError``    an exact-row fetch raised.
  ``CorruptChunkError``a re-read chunk's content disagrees with the
                       cache's exact-norm sidecars; raised by the engine.

The reference's seeded fault injectors, its permanent ``StreamDied`` and
its circuit breaker are not ported yet (ROADMAP.md queue 1, "Checkpoint
and resilience").
"""

from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for recovered stream faults."""


class TransientFault(FaultError):
    """A fault expected to clear on re-read; retry policies catch these."""


class ChunkReadError(TransientFault):
    """Transient chunk-read failure (I/O error analogue)."""


class RowFetchError(TransientFault):
    """Transient exact-row fetch failure."""


class CorruptChunkError(TransientFault):
    """A chunk's content disagrees with its exact-norm sidecars.

    Transient because a re-read usually clears it; persistent disagreement
    is quarantined row by row by the engine.
    """
