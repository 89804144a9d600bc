"""Last-layer gradient proxies (paper S4, 'last-layer' + 'per-gradient'),
after ``repro/core/proxies.py``.

For a cross-entropy head ``z = H W + b`` the per-sample gradients are closed
form (no backprop through the trunk needed):

    dL_i/db   = p_i - y_i                      (num_classes,)
    dL_i/dW   = h_i (p_i - y_i)^T              (d_h, num_classes)

The paper's GRAD-MATCH keeps, per sample, only the slice for its own class
(the *per-gradient* approximation).  Both proxies come from one
``ops.lastlayer_grad`` call: the kernel's ``resid`` is the bias proxy, and
``[hgrad, resid[i, y_i]]`` the per-class proxy.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def softmax_residual(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """(p - onehot(y)) per sample.  logits (..., C), labels (...,).
    Labels outside [0, C) get a zero one-hot row, as in ``jax.nn.one_hot``."""
    p = torch.softmax(logits.float(), dim=-1)
    cls = torch.arange(logits.shape[-1], device=logits.device)
    return p - (labels.long()[..., None] == cls).to(p.dtype)


def lastlayer_proxies(hidden: torch.Tensor, logits: torch.Tensor,
                      labels: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-class proxy (n, d_h + 1), bias proxy (n, C)) from one kernel
    call.  Labels must lie in [0, C)."""
    resid, hgrad = ops.lastlayer_grad(hidden, logits, labels)
    own = resid.gather(1, labels.long()[:, None])
    return torch.cat([hgrad, own], dim=-1), resid


def bias_grad_proxy(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Per-sample last-layer *bias* gradient: (n, C).  (The trainer takes
    it from ``lastlayer_proxies``, which shares one kernel call with the
    per-class proxy.)"""
    return softmax_residual(logits, labels)


def per_class_grad_proxy(hidden: torch.Tensor, logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Paper's per-class *per-gradient* approximation: (n, d_h + 1).

    For sample i of class c keep only row c of dW plus the class bias term:
    g_i = [ (p_ic - 1) * h_i ,  p_ic - 1 ].  Used with per-class OMP where all
    candidates share the class, so rows are comparable.
    """
    return lastlayer_proxies(hidden, logits, labels)[0]


def per_batch(proxies: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Group per-example proxies into per-mini-batch (PB) proxies.

    (n, d) -> (n // B, d); each row is the *mean* gradient of one mini-batch.
    A ragged tail of fewer than B examples is dropped.
    """
    n, d = proxies.shape
    nb = n // batch_size
    return proxies[: nb * batch_size].reshape(nb, batch_size, d).mean(dim=1)
