"""Orthogonal Matching Pursuit (Algorithm 2 of the paper), after
``repro/core/omp.py``.

The paper minimizes, over subsets ``X`` (|X| <= k) and non-negative weights
``w``::

    Err_lambda(w, X) = || sum_{i in X} w_i g_i  -  g_tgt ||^2 + lambda ||w||^2

where ``g_i`` are candidate gradients (rows of ``G``, shape (n, d)) and
``g_tgt`` is the target gradient.  OMP greedily adds the candidate with the
largest residual correlation and re-solves the (regularized, non-negative)
least squares on the active set.

``omp_select`` runs the incremental solver by default (``c0 = G @ g_tgt``
once, a growing column cache or the cached active rows, an incrementally
grown active-set Gram; see the reference module for the derivation) and the
dense re-solve-from-scratch solver with ``method="dense"``, the parity
oracle.

As in the reference, nothing branches on data: a solve runs exactly ``k``
rounds and every update is gated on ``grow = err > eps``, so a stopped
solver leaves its buffers unchanged.  No round reads a value back to the
host, so the rounds queue on the device without a sync, and each 128-round
block has static buffer shapes (``_grow_prefix``).  The class loop of
``omp_select_per_class`` takes the place of the reference's ``vmap``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def _nnls_active(
    gram: torch.Tensor,      # (k, k) = G_S G_S^T  (masked rows/cols zeroed)
    corr: torch.Tensor,      # (k,)   = G_S g_tgt
    mask: torch.Tensor,      # (k,) bool
    lam: float,
    n_iters: int,
) -> torch.Tensor:
    """Non-negative ridge LS on the (masked) active set via projected gradient.

    Solves  min_{w>=0} 0.5 w^T (A + lam I) w - c^T w  restricted to mask,
    with step 1/L for the Gershgorin bound L of the masked system.
    """
    k = gram.shape[0]
    a = gram + lam * torch.eye(k, dtype=gram.dtype, device=gram.device)
    m = mask.to(gram.dtype)
    a = a * m[:, None] * m[None, :]
    c = corr * m
    lip = torch.clamp_min(a.abs().sum(dim=1).max(), 1e-6)
    step = 1.0 / lip
    w = torch.zeros((k,), dtype=gram.dtype, device=gram.device)
    for _ in range(n_iters):
        w = torch.clamp_min(w - step * (a @ w - c), 0.0) * m
    return w


def _nnls_active_cached(
    gram: torch.Tensor,         # (k, k) cached Gram, inactive rows/cols zero
    gram_absrow: torch.Tensor,  # (k,) cached sum_j |A_ij| over active j
    rows: torch.Tensor,         # (k, d) cached active rows, inactive zero
    corr: torch.Tensor,         # (k,) cached c_S, inactive entries zero
    mask: torch.Tensor,         # (k,) bool
    lam: float,
    n_iters: int,
) -> torch.Tensor:
    """Same math as ``_nnls_active``, consuming the incremental caches: the
    step comes from the cached Gershgorin row sums, and ``A @ w`` uses
    ``R (R^T w)`` when d < k, else the cached Gram."""
    m = mask.to(rows.dtype)
    c = corr * m
    lip = torch.clamp_min((m * (gram_absrow + lam)).max(), 1e-6)
    step = 1.0 / lip
    k, d = rows.shape
    use_factor = d < k
    w = torch.zeros((k,), dtype=rows.dtype, device=rows.device)
    for _ in range(n_iters):
        if use_factor:
            aw = rows @ (w @ rows) + lam * w
        else:
            aw = gram @ w + lam * w
        w = torch.clamp_min(w - step * (aw - c), 0.0) * m
    return w


def _take(avail: torch.Tensor, e: torch.Tensor, grow: torch.Tensor) -> None:
    """Mark candidate ``e`` (a (1,) index) unavailable if the round grew —
    the reference's taken-set scatter, kept up to date in place."""
    avail.index_put_((e,), avail.index_select(0, e) & ~grow)


def _omp_select_dense(grads, target, k, lam, eps, nnls_iters, positive,
                      valid, corr_fn):
    """Reference solver: re-gather + re-solve the active set every round."""
    dev = grads.device
    indices = torch.full((k,), -1, dtype=torch.int32, device=dev)
    mask = torch.zeros((k,), dtype=torch.bool, device=dev)
    w = torch.zeros((k,), dtype=torch.float32, device=dev)
    avail = valid.clone()
    residual = target
    err = (target ** 2).sum()
    for t in range(k):
        scores = (corr_fn(grads, residual) if corr_fn is not None
                  else grads @ residual)
        if not positive:
            scores = scores.abs()
        scores = torch.where(avail, scores, float("-inf"))
        e = torch.argmax(scores).view(1)
        # stop criterion E_lambda <= eps -> do not grow the active set.
        grow = err > eps
        indices[t] = torch.where(grow, e[0], -1)
        mask[t] = grow
        _take(avail, e, grow)
        sel = torch.where(mask, indices, 0).long()
        g_s = grads[sel] * mask[:, None].to(grads.dtype)      # (k, d)
        w = _nnls_active(g_s @ g_s.T, g_s @ target, mask, lam, nnls_iters)
        residual = target - w @ g_s
        err = (residual ** 2).sum() + lam * (w ** 2).sum()
    return indices, w, mask, err


@dataclass
class _IncState:
    """Prefix buffers of the incremental solver, grown once per block."""

    weights: torch.Tensor    # (P,) f32
    colcache: torch.Tensor   # (n, P) f32, C[:, t] = G @ g_{e_t} (wide)
    gram: torch.Tensor       # (P, P) f32, active-set Gram
    gram_absrow: torch.Tensor  # (P,) f32, cached Gershgorin row sums
    tcorr: torch.Tensor      # (P,) f32, c_S[t] = g_{e_t} . g_tgt
    rows: torch.Tensor       # (P, d) f32, cached active rows


def _grow_prefix(st: _IncState, width: int, keep_cols: bool) -> None:
    """Zero-pad the prefix buffers out to ``width`` slots.  ``keep_cols=
    False`` (narrow regime) stops growing the column cache: it is dead
    state from that block on."""
    pad = width - st.weights.shape[0]
    st.weights = F.pad(st.weights, (0, pad))
    if keep_cols:
        st.colcache = F.pad(st.colcache, (0, pad))
    st.gram = F.pad(st.gram, (0, pad, 0, pad))
    st.gram_absrow = F.pad(st.gram_absrow, (0, pad))
    st.tcorr = F.pad(st.tcorr, (0, pad))
    st.rows = F.pad(st.rows, (0, 0, 0, pad))


def _omp_select_incremental(grads, target, k, lam, eps, nnls_iters, positive,
                            valid, block):
    """Incremental-Gram OMP with cached correlations.

    Per block of rounds, one of two regimes scores the candidates through
    the fused ``corr_argmax`` kernel:

    * wide (P <= d): scores = c0 - C @ w over the ``(n, P)`` column cache;
      the new Gram row is the free read ``C[e, :]``.
    * narrow (d < P): scores = G @ r with r = g_tgt - w^T R from the cached
      active rows; the new Gram row is ``R @ g_e``.
    """
    n, d = grads.shape
    dev = grads.device
    f32 = dict(dtype=torch.float32, device=dev)
    c0 = ops.corr(grads, target)             # (n,), computed exactly once
    zeros_n = torch.zeros((n,), **f32)
    indices = torch.full((k,), -1, dtype=torch.int32, device=dev)
    mask = torch.zeros((k,), dtype=torch.bool, device=dev)
    avail = valid.clone()
    st = _IncState(torch.zeros((0,), **f32), torch.zeros((n, 0), **f32),
                   torch.zeros((0, 0), **f32), torch.zeros((0,), **f32),
                   torch.zeros((0,), **f32), torch.zeros((0, d), **f32))
    residual = target
    err = (target ** 2).sum()
    absolute = not positive
    for lo in range(0, k, block):
        hi = min(lo + block, k)
        use_cols = hi <= d
        _grow_prefix(st, hi, keep_cols=use_cols)
        for t in range(lo, hi):
            if use_cols:
                e, _ = ops.corr_argmax(st.colcache, st.weights, c0, avail,
                                       absolute=absolute)
            else:
                e, _ = ops.corr_argmax(grads, -residual, zeros_n, avail,
                                       absolute=absolute)
            e = e.long().view(1)
            grow = err > eps
            growf = grow.to(torch.float32)
            indices[t] = torch.where(grow, e[0], -1)
            mask[t] = grow
            _take(avail, e, grow)
            mask_p = mask[:hi]

            # Extend the caches by one slot (gated on `grow`).
            g_e = grads.index_select(0, e)[0] * growf
            st.rows[t] = g_e
            if use_cols:
                st.colcache[:, t] = ops.corr(grads, g_e)
                row_vals = torch.where(
                    mask_p, st.colcache.index_select(0, e)[0], 0.0) * growf
            else:
                row_vals = torch.where(mask_p, st.rows @ g_e, 0.0)
            st.gram[t, :] = row_vals
            st.gram[:, t] = row_vals
            st.gram_absrow = torch.where(
                mask_p, st.gram_absrow + row_vals.abs(), 0.0)
            st.gram_absrow[t] = row_vals.abs().sum()
            st.tcorr[t] = c0.index_select(0, e)[0] * growf

            # NNLS on the cached active-set buffers; the residual norm in
            # the factored form over the cached rows.
            st.weights = _nnls_active_cached(st.gram, st.gram_absrow,
                                             st.rows, st.tcorr, mask_p, lam,
                                             nnls_iters)
            residual = target - st.weights @ st.rows
            err = (residual ** 2).sum() + lam * (st.weights ** 2).sum()
    return indices, st.weights, mask, err


def omp_select(
    grads: torch.Tensor,       # (n, d) candidate gradients (rows)
    target: torch.Tensor,      # (d,)   target gradient (full train or val)
    k: int,
    lam: float = 0.5,
    eps: float = 1e-10,
    nnls_iters: int = 50,
    positive: bool = True,
    valid: Optional[torch.Tensor] = None,   # (n,) bool availability
    corr_fn=None,              # optional (G, r) -> (n,) scores (dense only)
    method: str = "incremental",      # "incremental" | "dense"
    block: int = 128,          # rounds per statically-sized prefix block
):
    """Run OMP for exactly ``k`` rounds (slots beyond the eps-stop get masked).

    Returns (indices (k,) i32, weights (k,) f32, mask (k,) bool, err ()) on
    the device of ``grads``.  Unused slots have index -1 and weight 0.  A
    custom ``corr_fn`` scores an explicit residual, which only the dense
    formulation materializes, so it implies ``method="dense"``.
    """
    if method not in ("incremental", "dense"):
        raise ValueError(f"unknown OMP method {method!r}")
    n, _ = grads.shape
    grads = grads.float().contiguous()
    target = target.to(device=grads.device, dtype=torch.float32).contiguous()
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=grads.device)
    valid = valid.to(device=grads.device, dtype=torch.bool).contiguous()
    if method == "dense" or corr_fn is not None:
        return _omp_select_dense(grads, target, k, lam, eps, nnls_iters,
                                 positive, valid, corr_fn)
    return _omp_select_incremental(grads, target, k, lam, eps, nnls_iters,
                                   positive, valid, block)


def omp_select_dense(grads, target, k, lam=0.5, eps=1e-10, nnls_iters=50,
                     positive=True, valid=None, corr_fn=None):
    """Reference dense solver — parity oracle for ``omp_select``."""
    return omp_select(grads, target, k, lam=lam, eps=eps,
                      nnls_iters=nnls_iters, positive=positive, valid=valid,
                      corr_fn=corr_fn, method="dense")


def split_budget(k: int, sizes: Sequence[int]) -> np.ndarray:
    """Split a global budget ``k`` across partitions of the given sizes.

    An even split with the ``k % P`` remainder going to the largest
    partitions first, every quota capped at its partition size, and
    capped-off surplus rebalanced over the partitions that still have
    capacity.  Guarantees ``sum(quota) == min(k, sum(sizes))`` and
    ``quota[p] <= sizes[p]``.  Host-side (numpy): quotas are solver shapes.
    """
    sizes = np.asarray(sizes, np.int64)
    if sizes.ndim != 1 or sizes.shape[0] == 0:
        raise ValueError(f"sizes must be a non-empty 1-D sequence, got "
                         f"shape {sizes.shape}")
    if (sizes < 0).any():
        raise ValueError(f"negative partition size in {sizes}")
    quota = np.zeros(sizes.shape[0], np.int64)
    remaining = min(int(k), int(sizes.sum()))
    # Largest-first order, ties broken by partition id for determinism.
    order = np.argsort(-sizes, kind="stable")
    while remaining > 0:
        cap = sizes - quota
        act = order[cap[order] > 0]
        base, rem = divmod(remaining, len(act))
        add = np.full(len(act), base, np.int64)
        add[:rem] += 1                      # remainder to largest first
        add = np.minimum(add, cap[act])
        quota[act] += add
        remaining -= int(add.sum())
    return quota


def omp_select_per_class(
    grads: torch.Tensor,     # (n, d)
    labels: torch.Tensor,    # (n,) int class ids
    targets: torch.Tensor,   # (num_classes, d) per-class target gradients
    num_classes: int,
    k_per_class: int,
    lam: float = 0.5,
    eps: float = 1e-10,
    method: str = "incremental",
    quotas: Optional[Sequence[int]] = None,   # (C,) per-class budgets
    nnls_iters: int = 50,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paper's per-class decomposition, one OMP per class.

    Each class-c problem only sees candidates with label c.  Returns
    flattened (num_classes*k, ...) padded arrays.  With ``quotas`` every
    class runs ``max(quotas)`` rounds and keeps its first ``quotas[c]``
    (index-exact by the greedy prefix property); those weights are re-solved
    by one NNLS on the truncated active set.
    """
    grads = grads.float()
    if quotas is None:
        outs = [omp_select(grads, targets[c], k=k_per_class, lam=lam,
                           eps=eps, valid=labels == c, method=method)
                for c in range(num_classes)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]),
                torch.cat([o[2] for o in outs]))

    quotas = np.asarray(quotas, np.int64)
    if quotas.shape != (num_classes,):
        raise ValueError(
            f"quotas must be ({num_classes},), got {quotas.shape}")
    dev = grads.device
    k_cap = int(quotas.max()) if quotas.size else 0
    if k_cap == 0:                      # empty budget: all-off result
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    slot = torch.arange(k_cap, device=dev)
    out_idx, out_w, out_mask = [], [], []
    for c in range(num_classes):
        target = targets[c]
        idx, _, mask, _ = omp_select(grads, target, k=k_cap, lam=lam,
                                     eps=eps, valid=labels == c,
                                     method=method)
        mask = mask & (slot < int(quotas[c]))
        idx = torch.where(mask, idx, -1)
        # Exact reweight of the truncated prefix.
        sel = torch.where(mask, idx, 0).long()
        g_s = grads[sel] * mask[:, None].to(grads.dtype)
        w = _nnls_active(g_s @ g_s.T, g_s @ target.float(), mask, lam,
                         nnls_iters)
        out_idx.append(idx)
        out_w.append(torch.where(mask, w, 0.0))
        out_mask.append(mask)
    return torch.cat(out_idx), torch.cat(out_w), torch.cat(out_mask)


def matching_error(
    grads: torch.Tensor, target: torch.Tensor, indices: torch.Tensor,
    weights: torch.Tensor, mask: torch.Tensor, lam: float = 0.0,
) -> torch.Tensor:
    """Err_lambda = ||G_S^T w - g_tgt||^2 + lam ||w||^2 for a given (X, w)."""
    sel = torch.where(mask, indices, 0).long()
    g_s = grads[sel] * mask[:, None].to(grads.dtype)
    resid = target - weights @ g_s
    return (resid ** 2).sum() + lam * (weights ** 2).sum()
