"""Checkpointing in the reference's on-disk format (``checkpoint``) and
the solver snapshots built on it (``solver_state``)."""

from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               load_checkpoint, restore_to,
                                               save_checkpoint)
from repro_torch.checkpoint.solver_state import (load_solver_state,
                                                 save_solver_state)

__all__ = [
    "CheckpointManager",
    "load_checkpoint",
    "load_solver_state",
    "restore_to",
    "save_checkpoint",
    "save_solver_state",
]
