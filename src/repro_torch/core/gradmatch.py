"""GRAD-MATCH: gradient-matching data subset selection (paper Alg. 1 + 2),
after ``repro/core/gradmatch.py``.

  - ``gradmatch``          : OMP over per-example proxies
  - ``gradmatch_per_class``: one OMP per class, budget split exactly
  - ``gradmatch_pb``       : OMP over per-mini-batch proxies (the PB variant)
  - ``SelectionResult``    : padded result consumed by the trainer

The target gradient is the *sum* of candidate gradients (matching the
training loss) or a given validation-gradient sum.  Returned weights are
normalized to sum to 1 over the valid slots.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import omp as omp_lib
from repro_torch.core import proxies as proxy_lib


class SelectionResult(NamedTuple):
    indices: torch.Tensor  # (k,) int32 candidate ids, -1 on unused slots
    weights: torch.Tensor  # (k,) f32, >= 0, sums to 1 over valid slots
    mask: torch.Tensor     # (k,) bool
    err: torch.Tensor      # () f32  final E_lambda value (diagnostic)
    # Solver accounting: the streaming entry points attach their
    # SelectStats, the partitioned ones their PartitionStats; None
    # elsewhere.
    stats: Optional[Any] = None

    @property
    def size(self) -> torch.Tensor:
        return self.mask.sum()


def _normalize(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = torch.where(mask, w, 0.0)
    s = w.sum()
    # Degenerate all-zero solutions fall back to uniform over the mask.
    uniform = mask.to(w.dtype) / torch.clamp_min(mask.sum(), 1)
    return torch.where(s > 1e-12, w / torch.clamp_min(s, 1e-12), uniform)


def gradmatch(
    grads: torch.Tensor,            # (n, d) candidate gradient proxies
    k: int,
    target: Optional[torch.Tensor] = None,   # (d,) defaults to sum of grads
    lam: float = 0.5,
    eps: float = 1e-10,
    valid: Optional[torch.Tensor] = None,
    corr_fn=None,
    method: str = "incremental",
) -> SelectionResult:
    """Plain GRAD-MATCH on an explicit candidate gradient matrix."""
    if target is None:
        if valid is None:
            target = grads.sum(dim=0)
        else:
            target = (grads * valid[:, None].to(grads.dtype)).sum(dim=0)
    idx, w, mask, err = omp_lib.omp_select(
        grads, target, k=k, lam=lam, eps=eps, valid=valid, corr_fn=corr_fn,
        method=method)
    return SelectionResult(idx, _normalize(w, mask), mask, err)


def gradmatch_per_class(
    grads: torch.Tensor,       # (n, d) per-class per-gradient proxies
    labels: torch.Tensor,      # (n,)
    num_classes: int,
    k: int,
    lam: float = 0.5,
    eps: float = 1e-10,
    method: str = "incremental",
) -> SelectionResult:
    """Paper default: one OMP per class, budget split exactly by
    ``omp.split_budget`` — the selection holds ``min(k, n_valid)`` rows
    (labels outside ``[0, num_classes)`` are not candidates).  ``err`` is
    the global objective of the unnormalized per-class solution against
    the summed target."""
    labels_np = labels.cpu().numpy()
    in_range = (labels_np >= 0) & (labels_np < num_classes)
    sizes = np.bincount(labels_np[in_range], minlength=num_classes)
    quotas = omp_lib.split_budget(k, sizes)
    cls = torch.arange(num_classes, device=grads.device)
    onehot = (labels.long()[:, None] == cls).to(grads.dtype)       # (n, C)
    targets = onehot.T @ grads                                       # (C, d)
    idx, w, mask = omp_lib.omp_select_per_class(
        grads, labels, targets, num_classes, 0, lam=lam, eps=eps,
        method=method, quotas=quotas)
    err = omp_lib.matching_error(grads, targets.sum(dim=0), idx, w, mask,
                                 lam=lam)
    # Per-class weights each sum to ~their class share; renormalize globally.
    return SelectionResult(idx, _normalize(w, mask), mask, err)


def gradmatch_pb(
    example_proxies: torch.Tensor,  # (n, d)
    batch_size: int,
    k_batches: int,
    lam: float = 0.5,
    eps: float = 1e-10,
    target: Optional[torch.Tensor] = None,
    corr_fn=None,
    method: str = "incremental",
) -> SelectionResult:
    """GRAD-MATCHPB: ground set = mini-batches (paper S3, 'PB' variant)."""
    pb = proxy_lib.per_batch(example_proxies, batch_size)
    if target is None:
        target = pb.sum(dim=0)
    return gradmatch(pb, k=k_batches, target=target, lam=lam, eps=eps,
                     corr_fn=corr_fn, method=method)


def expand_batch_selection(sel: SelectionResult, batch_size: int,
                           n_examples: int) -> SelectionResult:
    """Expand a per-batch selection to per-example indices/weights: batch j
    covers examples [j*B, (j+1)*B), each inheriting w_j / B."""
    base = torch.where(sel.mask, sel.indices, 0) * batch_size         # (k,)
    offs = torch.arange(batch_size, dtype=torch.int32,
                        device=sel.indices.device)
    ex_idx = (base[:, None] + offs[None, :]).reshape(-1)             # (k*B,)
    ex_idx = torch.where(sel.mask.repeat_interleave(batch_size), ex_idx, -1)
    ex_idx = torch.where(ex_idx < n_examples, ex_idx, -1)
    ex_mask = ex_idx >= 0
    ex_w = (sel.weights / batch_size).repeat_interleave(batch_size)
    ex_w = torch.where(ex_mask, ex_w, 0.0)
    s = torch.clamp_min(ex_w.sum(), 1e-12)
    return SelectionResult(ex_idx.to(torch.int32), ex_w / s, ex_mask,
                           sel.err, sel.stats)
