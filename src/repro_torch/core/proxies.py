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

``hidden_grad_proxy`` is the LM head's proxy, the exact head-input
gradient from the fused ``ops.hidden_grad`` kernel; ``models/lm.py:
selection_proxy`` pools it per sequence.

``proxy_chunk_stream`` and ``proxy_row_fetch`` feed the streaming engine
(``core/streaming.py``) proxies one chunk at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

_PICK = {"per_class": 0, "bias": 1}


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


def hidden_grad_proxy(hidden: torch.Tensor, logits: torch.Tensor,
                      labels: torch.Tensor, unembed: torch.Tensor
                      ) -> torch.Tensor:
    """dL/dh = (p - y) @ W^T: the LM-friendly proxy, dimension d_model.

    Exact head-input gradient from one ``ops.hidden_grad`` call (the fused
    kernel on the card).  logits (..., V), labels (...,), unembed (d_h, V)
    -> (..., d_h) f32.  For LM candidates = micro-batches, call with
    (B, T, ...) and mean over T.  ``hidden`` is unused, kept for the
    reference's signature.
    """
    del hidden
    lead = labels.shape
    v = logits.shape[-1]
    g = ops.hidden_grad(logits.reshape(-1, v), labels.reshape(-1), unembed)
    return g.reshape(*lead, -1)


def proxy_chunk_stream(pool_iter, proxy_fn, pick: str = "bias"):
    """Adapt a raw-data chunk factory into a proxy chunk factory.

    ``pool_iter`` yields ``(x, y, offset)`` (``data.loader.ChunkedPool``);
    ``proxy_fn(x, y)`` returns ``(per_class_proxy, bias_proxy)``
    (``train.steps.make_proxy_fn``).  The factory yields ``(proxy_chunk,
    None)``, the protocol ``streaming.omp_select_streaming`` consumes, so
    the full ``(n, d)`` proxy matrix never exists.
    """
    which = _PICK[pick]

    def chunks():
        for x, y, _ in pool_iter():
            yield proxy_fn(x, y)[which], None

    return chunks


def proxy_row_fetch(x, y, proxy_fn, chunk_size: int, pick: str = "bias"):
    """Exact proxy rows by global id, for the streaming engine's repair
    and refill tiers; ``chunk_size`` is the scan's.

    The engine treats fetched rows as the very rows the chunked scan saw.
    The reference gathers the ids and extracts their proxies, exact
    because its extractor works row by row.  On the card the forward pass
    is a cuBLAS GEMM whose algorithm (and so its order of summation) may
    change with the row count, so a gather of a few rows can differ in the
    last bit from the same rows extracted in a chunk.  Here each chunk that
    holds a fetched id is re-extracted as the scan sliced it and the rows
    are gathered from it: the same call shapes, the same bits.
    """
    which = _PICK[pick]
    n = x.shape[0]

    def fetch(ids):
        ids = np.asarray(ids, np.int64)
        out = None
        for c in np.unique(ids // chunk_size):
            lo = int(c) * chunk_size
            hi = min(lo + chunk_size, n)
            rows = proxy_fn(x[lo:hi], y[lo:hi])[which]
            if out is None:
                out = rows.new_empty((len(ids), rows.shape[1]))
            at = np.flatnonzero(ids // chunk_size == c)
            out[torch.as_tensor(at, device=rows.device)] = rows[
                torch.as_tensor(ids[at] - lo, device=rows.device)]
        return out

    return fetch


def per_batch(proxies: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Group per-example proxies into per-mini-batch (PB) proxies.

    (n, d) -> (n // B, d); each row is the *mean* gradient of one mini-batch.
    A ragged tail of fewer than B examples is dropped.
    """
    n, d = proxies.shape
    nb = n // batch_size
    return proxies[: nb * batch_size].reshape(nb, batch_size, d).mean(dim=1)
