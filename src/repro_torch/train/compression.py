"""Top-k gradient compression with error feedback (EF-TopK), after
``repro/train/compression.py``: opt-in, off by default.

Each step compresses ``grad + residual`` to its top ``frac`` entries by
magnitude and keeps what was dropped as the next step's residual, so
nothing is lost, only delayed (Stich et al. 2018; Lin et al. 2018, "Deep
Gradient Compression").  ``compress_with_feedback`` returns the dense
tensor the other side of a sparse transport would rebuild, so the
optimizer runs dense with the sparse transport's semantics.

The kept set is the reference's exactly: ``k = max(int(n * frac), 1)``
entries, and at a tie on the k-th magnitude the lowest indices, as
``lax.top_k`` breaks ties (``torch.topk`` promises no order, and ties are
common where bf16 gradients are widened to f32).  ``residual = acc -
dense`` exactly, so ``dense + residual == acc`` bit for bit.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch


class CompressionState(NamedTuple):
    residual: dict   # key -> f32 error-feedback accumulator, like grads


def init_state(grads: Mapping) -> CompressionState:
    """Zero residuals shaped like ``grads`` (a mapping: parameter names,
    or anything with a ``shape`` and a ``device``)."""
    return CompressionState({k: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device)
                             for k, g in grads.items()})


def topk_sparsify(x: torch.Tensor, frac: float
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the top ``frac`` fraction of entries by |value| (k >= 1).

    Returns (dense_masked f32 of x's shape, values (k,), flat indices
    (k,)), the indices by descending magnitude and, among equal
    magnitudes, ascending index: ``lax.top_k``'s order.
    """
    flat = x.reshape(-1).float()
    n = flat.numel()
    k = max(int(n * frac), 1)
    mag = flat.abs()
    kth = torch.topk(mag, k, sorted=False).values.min()   # k-th largest
    above = torch.nonzero(mag > kth).squeeze(1)
    ties = torch.nonzero(mag == kth).squeeze(1)[:k - above.numel()]
    idx = torch.cat([above, ties])
    # each part is in ascending index order and no magnitude is in both,
    # so a stable sort gives descending magnitude, then ascending index
    idx = idx[torch.sort(mag[idx], descending=True, stable=True).indices]
    vals = flat[idx]
    dense = torch.zeros_like(flat)
    dense[idx] = vals
    return dense.reshape(x.shape), vals, idx


def compress_with_feedback(grads: Mapping, state: CompressionState,
                           frac: float = 0.01
                           ) -> tuple[dict, CompressionState]:
    """EF-TopK: compress ``grad + residual``; the residual keeps what was
    dropped.  Returns (the dense compressed f32 gradients by key, the new
    state)."""
    comp, resid = {}, {}
    for key, g in grads.items():
        acc = g.float() + state.residual[key]
        comp[key], _, _ = topk_sparsify(acc, frac)
        resid[key] = acc - comp[key]
    return comp, CompressionState(resid)


def compression_ratio(frac: float) -> float:
    """Payload ratio of (values + int32 indices) against dense f32."""
    return 2.0 * frac
