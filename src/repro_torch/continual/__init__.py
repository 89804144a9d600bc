"""Continual-stream selection (DESIGN.md §11), after ``repro/continual/``:
``BufferMaintainer`` admits gradient batches forever under a fixed memory
budget and keeps its committed subset exact against a fresh solve over the
surviving rows (decremental OMP, ``core/decremental.py``);
``continual_select`` is the in-memory driver behind
``selection.select("gradmatch-continual", ...)``."""

from repro_torch.continual.buffer import BufferMaintainer, continual_select

__all__ = ["BufferMaintainer", "continual_select"]
