"""RANDOM baseline: uniform subset, uniform weights (paper's
skyline-for-time), drawn from a ``torch.Generator``.  Its indices differ
from the JAX package's by design; its invariants do not."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.gradmatch import SelectionResult


def random_select(generator: torch.Generator, n: int, k: int,
                  valid: Optional[torch.Tensor] = None) -> SelectionResult:
    """``k`` distinct rows of ``range(n)`` (of the valid rows, by Gumbel
    top-k, when ``valid`` is given), on the generator's device."""
    dev = generator.device
    if valid is None:
        perm = torch.randperm(n, generator=generator, device=dev)[:k]
    else:
        u = torch.rand((n,), generator=generator, device=dev)
        g = -torch.log(-torch.log(u.clamp(1e-20, 1.0)))
        g = torch.where(valid.to(dev), g, float("-inf"))
        perm = torch.topk(g, k).indices
    mask = torch.ones((k,), dtype=torch.bool, device=dev)
    w = torch.full((k,), 1.0 / k, dtype=torch.float32, device=dev)
    return SelectionResult(perm.to(torch.int32), w, mask,
                           torch.zeros((), device=dev))
