"""Plain PyTorch versions of the port's kernels.

Written to the contracts of ``repro/kernels/ref.py``: f32 accumulation, the
lowest index wins a tie, and an all-masked input gives ``(0, -inf)``.  They
are what a kernel wrapper runs for a tensor on the CPU, what the CPU tests
hold against the JAX package, and what the kernels are held against on the
card.
"""

from __future__ import annotations

import torch


def corr_ref(grads: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """OMP residual-correlation scores: (n, d) @ (d,) -> (n,) in f32."""
    return grads.float() @ residual.float()


def corr_argmax_ref(colcache: torch.Tensor, w: torch.Tensor,
                    base: torch.Tensor, mask: torch.Tensor,
                    absolute: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked argmax of ``scores = base - colcache @ w``.

    colcache (n, p), w (p,), base (n,), mask (n,) bool -> (index i32 (),
    score f32 ()).  ``torch.argmax`` returns the first maximal index, so
    ties go to the lowest index; an all-False mask gives (0, -inf).
    """
    scores = base.float() - colcache.float() @ w.float()
    if absolute:
        scores = scores.abs()
    scores = torch.where(mask, scores, float("-inf"))
    idx = torch.argmax(scores)
    return idx.to(torch.int32), scores.index_select(0, idx.view(1))[0]


def lastlayer_grad_ref(hidden: torch.Tensor, logits: torch.Tensor,
                       labels: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Last-layer CE gradient pieces for a classification head.

    hidden (n, d_h), logits (n, C), labels (n,) int -> resid (n, C) =
    softmax(logits) - onehot(labels), and hgrad (n, d_h) = resid[i, y_i] *
    hidden_i (the paper's per-gradient approximation).
    """
    z = logits.float()
    z = z - z.max(dim=-1, keepdim=True).values
    e = torch.exp(z)
    p = e / e.sum(dim=-1, keepdim=True)
    y = labels.long()
    onehot = (y[:, None] == torch.arange(z.shape[-1], device=z.device)
              ).to(torch.float32)
    resid = p - onehot
    own = (resid * onehot).sum(dim=-1, keepdim=True)
    return resid, own * hidden.float()
