"""Weighted-subset mini-batch loader (Algorithm 1 line 9 feeding) and the
chunked pool view of the streaming path, after ``repro/data/loader.py``.

``SubsetLoader`` serves shuffled mini-batches drawn from the current
selection ``(indices, weights)`` over a device-resident dataset.  Each epoch
walks one permutation of the subset, drawn from a seeded
``torch.Generator``; a mini-batch re-normalizes its weights to sum to 1, so
every SGD step sees the same objective scale.  Batches are gathered on the
device, with no host round trip per step.

``checkpoint_state`` / ``restore_state`` carry the walk (the selection,
the permutation, the cursor and the generator's state, where the
reference keeps a PRNG key) across a kill and resume.

``ChunkedPool`` is the fixed-size, re-iterable chunk view that feeds
``core/streaming.py``.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch


def _check_memmap(arr, name: str) -> None:
    """Refuse a memmap whose backing file is shorter than its claimed view.

    A truncated backing file (partial copy, wrong dtype or shape at open)
    otherwise fails late, as a SIGBUS or zeros in the tail chunks of a
    streaming pass; here it is one early, descriptive error.
    """
    if not isinstance(arr, np.memmap):
        return
    filename = getattr(arr, "filename", None)
    if filename is None:
        return
    need = int(getattr(arr, "offset", 0)) + arr.nbytes
    have = os.path.getsize(filename)
    if have < need:
        raise ValueError(
            f"memmap-backed {name} is truncated: {filename!r} holds "
            f"{have} bytes but shape {arr.shape} / dtype {arr.dtype} at "
            f"offset {int(getattr(arr, 'offset', 0))} needs {need} — the "
            "backing file is incomplete (partial copy?) or the "
            "shape/dtype used to open it is wrong")


class ChunkedPool:
    """Fixed-size, re-iterable chunk view over a dataset.

    The pool is read one ``chunk_size`` slice at a time in a deterministic
    order, and every ``chunks()`` call restarts from offset 0: streaming
    OMP rescans the pool when its certificate fails.  ``x``/``y`` may be
    tensors (on any device), numpy arrays or ``np.memmap``; a slice is
    whatever slicing gives, so an out-of-core pool is never materialized.
    """

    def __init__(self, x, y=None, chunk_size: int = 4096):
        _check_memmap(x, "x")
        if y is not None:
            _check_memmap(y, "y")
        self.x = x
        self.y = y
        self.chunk_size = int(chunk_size)

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def num_chunks(self) -> int:
        return -(-self.n // self.chunk_size)

    def chunks(self) -> Iterator[tuple]:
        """Yields ``(x_chunk, y_chunk, offset)``; ``y_chunk`` None if no y."""
        for lo in range(0, self.n, self.chunk_size):
            hi = min(lo + self.chunk_size, self.n)
            yield (self.x[lo:hi],
                   None if self.y is None else self.y[lo:hi], lo)

    def __iter__(self) -> Iterator[tuple]:
        return self.chunks()


class SubsetLoader:
    """Mini-batches over the selected subset with weights."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, batch_size: int,
                 seed: int = 0):
        self.x = x
        self.y = y
        self.batch_size = batch_size
        self._gen = torch.Generator().manual_seed(seed)
        n = x.shape[0]
        self.set_selection(torch.arange(n, device=x.device),
                           torch.full((n,), 1.0 / n, device=x.device),
                           torch.ones((n,), dtype=torch.bool,
                                      device=x.device))

    # -- selection plumbing --------------------------------------------------
    def set_selection(self, indices: torch.Tensor, weights: torch.Tensor,
                      mask: torch.Tensor) -> None:
        """Keep the valid slots (mask and index >= 0), normalized to sum 1,
        and restart the walk over them."""
        dev = self.x.device
        idx = indices.to(dev).long()
        w = weights.to(device=dev, dtype=torch.float32)
        m = mask.to(dev).bool() & (idx >= 0)
        self._sel_idx = idx[m]
        w = w[m]
        s = w.sum()
        self._sel_w = torch.where(
            s > 0, w / s, torch.full_like(w, 1.0 / max(w.shape[0], 1)))
        self._perm = self._draw_perm()
        self._cursor = 0

    @property
    def subset_size(self) -> int:
        return self._sel_idx.shape[0]

    def steps_per_epoch(self) -> int:
        return max(self.subset_size // self.batch_size, 1)

    # -- iteration -----------------------------------------------------------
    def _draw_perm(self) -> torch.Tensor:
        return torch.randperm(self.subset_size, generator=self._gen).to(
            self.x.device)

    def next_batch(self) -> dict:
        """One weighted mini-batch; advances (and wraps) the walk."""
        n = self.subset_size
        bs = min(self.batch_size, n)
        if self._cursor + bs > n:   # wrap: new epoch, fresh permutation
            self._perm = self._draw_perm()
            self._cursor = 0
        take = self._perm[self._cursor: self._cursor + bs]
        self._cursor += bs
        rows = self._sel_idx[take]
        w = self._sel_w[take]
        s = w.sum()
        w = torch.where(s > 0, w / s, torch.full_like(w, 1.0 / bs))
        return {"x": self.x[rows], "y": self.y[rows], "weights": w}

    def epoch_batches(self) -> Iterator[dict]:
        for _ in range(self.steps_per_epoch()):
            yield self.next_batch()

    # -- checkpointing ---------------------------------------------------------
    def checkpoint_state(self) -> dict:
        return {
            "cursor": np.int64(self._cursor),
            "perm": self._perm,
            "gen_state": self._gen.get_state(),
            "sel_idx": self._sel_idx,
            "sel_w": self._sel_w,
        }

    def restore_state(self, st: dict) -> None:
        dev = self.x.device

        def on_dev(a, dtype):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.asarray(a))
            return t.to(device=dev, dtype=dtype)

        self._cursor = int(st["cursor"])
        self._perm = on_dev(st["perm"], torch.int64)
        self._gen.set_state(on_dev(st["gen_state"], torch.uint8).cpu())
        self._sel_idx = on_dev(st["sel_idx"], torch.int64)
        self._sel_w = on_dev(st["sel_w"], torch.float32)
