"""Mid-solve checkpoints for the streaming engine and the continual
buffer, after ``repro/checkpoint/solver_state.py``.

A solver snapshot is a nested dict of arrays saved through
``checkpoint.py`` (atomic tmp + rename, npz + JSON manifest, bf16 as
uint16 views, keep-K GC).  ``load_solver_state`` returns ``None`` when
there is nothing to resume: a fresh solve with a checkpoint directory
must not fail for being the first.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.checkpoint.checkpoint import (intact_steps, load_checkpoint,
                                               save_checkpoint)


def save_solver_state(directory: str, step: int, tree: Any,
                      keep: int = 2) -> str:
    """Atomically persist one solver snapshot; keeps the last ``keep``."""
    return save_checkpoint(directory, step, tree, keep=keep)


def load_solver_state(directory: str) -> Optional[dict]:
    """Newest *loadable* solver snapshot under ``directory``, or None.

    Newest first, falling back past a step whose manifest survived but
    whose arrays did not (bit rot, a torn npz, an emptied dir): keep-2
    retention exists so the previous step can take over.  Only when no
    retained step loads does this report nothing to resume.
    """
    for step in reversed(intact_steps(directory)):
        try:
            return load_checkpoint(directory, step)
        except Exception:
            continue
    return None
