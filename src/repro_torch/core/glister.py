"""GLISTER baseline (Killamsetty et al. 2021), Taylor-approximated greedy,
after ``repro/core/glister.py``.

Greedily maximizes ``g_j . v`` with the validation (or training) gradient
estimate advanced one Taylor step after each pick,
``v <- v - eta * g_e / ||g_e|| * ||v|| / k`` (GLISTER's identity-Hessian
approximation).  Unweighted: uniform 1/k over the picks.  The loop runs on
``greedy.modular_greedy``, whose per-round masked argmax is the
``corr_argmax`` kernel; the row norms are computed once.
"""

from __future__ import annotations

import torch

from repro_torch.core import greedy as greedy_lib
from repro_torch.core.gradmatch import SelectionResult


def glister(
    grads: torch.Tensor,       # (n, d) candidate training-gradient proxies
    val_grad: torch.Tensor,    # (d,)  validation (or full-train) gradient
    k: int,
    eta: float = 1.0,
    valid: torch.Tensor | None = None,
) -> SelectionResult:
    grads = grads.float()
    norms = torch.sqrt((grads * grads).sum(1))
    scale = 1.0 / k

    def advance(v, e, t):
        e = e.reshape(1)
        g_e = grads.index_select(0, e)[0]
        n_e = norms.index_select(0, e)[0]
        return v - eta * g_e / torch.clamp_min(n_e, 1e-8) * scale * torch.sqrt(
            (v * v).sum())

    indices, mask, _ = greedy_lib.modular_greedy(grads, k, advance, val_grad,
                                                 valid=valid)
    # GLISTER is unweighted: uniform 1/k over the picks.
    w = mask.float() / torch.clamp_min(mask.sum(), 1)
    return SelectionResult(indices, w, mask,
                           torch.zeros((), device=grads.device))
