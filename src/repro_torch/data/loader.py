"""Weighted-subset mini-batch loader (Algorithm 1 line 9 feeding), after
``repro/data/loader.py:SubsetLoader``.

Serves shuffled mini-batches drawn from the current selection
``(indices, weights)`` over a device-resident dataset.  Each epoch walks one
permutation of the subset, drawn from a seeded ``torch.Generator``; a
mini-batch re-normalizes its weights to sum to 1, so every SGD step sees the
same objective scale.  Batches are gathered on the device, with no host
round trip per step.
"""

from __future__ import annotations

from typing import Iterator

import torch


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
