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
block has static buffer shapes (``_grow_prefix``).

The one-shot solver and the anytime sessions (``omp_session_start`` /
``omp_session_extend``, ``omp_session_trajectory``) run one round body,
``_inc_round``, so a resumed session is bit-identical to the rounds it
skips.  ``omp_select_batched`` solves B targets over one pool with the
batched kernels ``corr_batched`` / ``corr_argmax_batched`` and one batched
NNLS a round; ``omp_select_per_class`` runs on it, one problem a class, in
place of the reference's ``vmap`` of ``omp_select``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Sequence

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
class OMPIncState:
    """Buffers of the incremental solver, the fields of the reference's
    ``OMPIncState``.

    ``indices``/``mask`` hold every slot (the budget, or a session's
    block-multiple capacity); the rest are prefix buffers of the current
    block width P, grown between blocks.  The rounds update them in place.
    The taken set is not a field: ``_run_session_block`` rebuilds the
    running availability mask from ``indices``/``mask`` and the caller's
    ``valid`` when it starts, and updates it in place round by round.
    """

    indices: torch.Tensor      # (cap,) i32, -1 on unused slots
    mask: torch.Tensor         # (cap,) bool
    weights: torch.Tensor      # (P,) f32
    colcache: torch.Tensor     # (n, P) f32, C[:, t] = G @ g_{e_t} (wide)
    gram: torch.Tensor         # (P, P) f32, active-set Gram
    gram_absrow: torch.Tensor  # (P,) f32, cached Gershgorin row sums
    tcorr: torch.Tensor        # (P,) f32, c_S[t] = g_{e_t} . g_tgt
    rows: torch.Tensor         # (P, d) f32, cached active rows
    residual: torch.Tensor     # (d,) f32, g_tgt - w^T rows
    err: torch.Tensor          # () f32

    def clone(self) -> "OMPIncState":
        return OMPIncState(*(getattr(self, f.name).clone()
                             for f in fields(self)))


def _empty_inc_state(k: int, n: int, d: int,
                     target: torch.Tensor) -> OMPIncState:
    f32 = dict(dtype=torch.float32, device=target.device)
    return OMPIncState(
        indices=torch.full((k,), -1, dtype=torch.int32, device=target.device),
        mask=torch.zeros((k,), dtype=torch.bool, device=target.device),
        weights=torch.zeros((0,), **f32),
        colcache=torch.zeros((n, 0), **f32),
        gram=torch.zeros((0, 0), **f32),
        gram_absrow=torch.zeros((0,), **f32),
        tcorr=torch.zeros((0,), **f32),
        rows=torch.zeros((0, d), **f32),
        residual=target,
        err=(target ** 2).sum(),
    )


def _grow_prefix(st, width: int, keep_cols: bool):
    """Zero-pad the prefix buffers of an ``OMPIncState`` (or, padding the
    same trailing dimensions, an ``OMPBatchState``) out to ``width`` slots,
    in place; the state is returned for the reference's call form.
    ``keep_cols=False`` (narrow regime) stops growing the column cache: it
    is dead state from that block on."""
    pad = width - st.weights.shape[-1]
    st.weights = F.pad(st.weights, (0, pad))
    if keep_cols:
        st.colcache = F.pad(st.colcache, (0, pad))
    st.gram = F.pad(st.gram, (0, pad, 0, pad))
    st.gram_absrow = F.pad(st.gram_absrow, (0, pad))
    st.tcorr = F.pad(st.tcorr, (0, pad))
    st.rows = F.pad(st.rows, (0, 0, 0, pad))
    return st


def _block_cap(k: int, block: int) -> int:
    return max(block * (-(-k // block)), block)


def _pad_slots(st: OMPIncState, cap: int) -> OMPIncState:
    """Grow the full-capacity index/mask buffers to ``cap`` slots, in
    place."""
    pad = cap - st.indices.shape[0]
    if pad > 0:
        st.indices = F.pad(st.indices, (0, pad), value=-1)
        st.mask = F.pad(st.mask, (0, pad))
    return st


def _available(valid: torch.Tensor, indices: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``valid & ~taken``; unused slots scatter into a sentinel slot n (the
    reference's out-of-bounds drop), so nothing is read back."""
    n = valid.shape[0]
    taken = torch.zeros((n + 1,), dtype=torch.bool, device=valid.device)
    taken.index_fill_(0, torch.where(mask, indices, n).long(), True)
    return valid & ~taken[:n]


def _inc_round(grads, target, c0, zeros_n, avail, st: OMPIncState, t: int,
               use_cols: bool, lam: float, eps: float, nnls_iters: int,
               absolute: bool) -> None:
    """One round of the incremental solver, in place: the one copy of the
    round that the one-shot solver and the session engine both run, so a
    session resume is bit-identical to the rounds it skips.

    Wide (P <= d): scores = c0 - C @ w over the ``(n, P)`` column cache;
    the new Gram row is the free read ``C[e, :]``.  Narrow (d < P): scores
    = G @ r with r = g_tgt - w^T R from the cached active rows; the new
    Gram row is ``R @ g_e``.  Every update is gated on ``grow = err > eps``,
    so a stopped solver leaves its buffers unchanged.
    """
    p = st.weights.shape[0]
    if use_cols:
        e, _ = ops.corr_argmax(st.colcache, st.weights, c0, avail,
                               absolute=absolute)
    else:
        e, _ = ops.corr_argmax(grads, -st.residual, zeros_n, avail,
                               absolute=absolute)
    e = e.long().view(1)
    grow = st.err > eps
    growf = grow.to(torch.float32)
    st.indices[t] = torch.where(grow, e[0], -1)
    st.mask[t] = grow
    _take(avail, e, grow)
    mask_p = st.mask[:p]

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
    st.gram_absrow = torch.where(mask_p, st.gram_absrow + row_vals.abs(),
                                 0.0)
    st.gram_absrow[t] = row_vals.abs().sum()
    st.tcorr[t] = c0.index_select(0, e)[0] * growf

    # NNLS on the cached active-set buffers; the residual norm in the
    # factored form over the cached rows.
    st.weights = _nnls_active_cached(st.gram, st.gram_absrow, st.rows,
                                     st.tcorr, mask_p, lam, nnls_iters)
    st.residual = target - st.weights @ st.rows
    st.err = (st.residual ** 2).sum() + lam * (st.weights ** 2).sum()


def _run_session_block(grads, target, c0, valid, st: OMPIncState, t0: int,
                       t1: int, use_cols: bool, lam: float, eps: float,
                       nnls_iters: int, absolute: bool) -> OMPIncState:
    """Rounds ``[t0, t1)`` inside one prefix width, in place."""
    avail = _available(valid, st.indices, st.mask)
    zeros_n = torch.zeros_like(c0)
    for t in range(t0, t1):
        _inc_round(grads, target, c0, zeros_n, avail, st, t, use_cols, lam,
                   eps, nnls_iters, absolute)
    return st


def _omp_select_incremental(grads, target, k, lam, eps, nnls_iters, positive,
                            valid, block):
    """Incremental-Gram OMP with cached correlations: ``c0 = G @ g_tgt``
    once, then blocks of ``_inc_round`` at static prefix widths ``hi =
    min(lo + block, k)``, each block in the wide regime when ``hi <= d``
    and in the narrow one otherwise."""
    n, d = grads.shape
    c0 = ops.corr(grads, target)             # (n,), computed exactly once
    st = _empty_inc_state(k, n, d, target)
    for lo in range(0, k, block):
        hi = min(lo + block, k)
        use_cols = hi <= d
        _grow_prefix(st, hi, keep_cols=use_cols)
        _run_session_block(grads, target, c0, valid, st, lo, hi, use_cols,
                           lam, eps, nnls_iters, absolute=not positive)
    return st.indices, st.weights, st.mask, st.err


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


# ---------------------------------------------------------------------------
# anytime sessions: checkpointed solves with budget extension k -> k'
# ---------------------------------------------------------------------------

class OMPAnytimeState(NamedTuple):
    """Checkpoint of an in-flight incremental OMP solve, after the
    reference's ``OMPAnytimeState``: a budget extension ``k -> k'`` is a
    resume that runs only the new rounds.

    Unlike ``omp_select``, whose prefix widths depend on the final ``k``
    through ``hi = min(lo + block, k)``, the session engine grows its
    prefixes to full block multiples (``width = lo + block``), so the width
    schedule and the wide/narrow regime at every round do not depend on
    the budget first asked for.  ``extend(k); extend(k')`` and
    ``extend(k')`` therefore run the same rounds on the same shapes and
    give the same bits; both pick what a one-shot ``omp_select(k')`` picks
    away from the f32 noise floor (weights to tolerance: the NNLS sees
    block-padded buffers whose extra rows are exact zeros).

    ``k`` is the rounds solved; ``st`` holds the index/mask buffers at a
    block-multiple capacity and the prefix-grown caches; ``c0``,
    ``target`` and ``valid`` are per-session constants, so an extension
    never rescans the pool for them.  The pool itself is not held: the
    caller passes the same array back to ``omp_session_extend``.
    """

    k: int                  # rounds solved so far
    block: int              # prefix growth quantum
    st: OMPIncState         # buffers at block-multiple capacity
    c0: torch.Tensor        # (n,) G @ g_tgt, computed once at the start
    target: torch.Tensor    # (d,)
    valid: torch.Tensor     # (n,) bool
    lam: float
    eps: float
    nnls_iters: int
    positive: bool

    @property
    def indices(self) -> torch.Tensor:
        return self.st.indices[: self.k]

    @property
    def weights(self) -> torch.Tensor:
        return self.st.weights[: self.k]

    @property
    def mask(self) -> torch.Tensor:
        return self.st.mask[: self.k]

    @property
    def err(self) -> torch.Tensor:
        return self.st.err


def omp_session_start(
    grads: torch.Tensor,       # (n, d) candidate pool (not stored)
    target: torch.Tensor,      # (d,)
    k: int,
    lam: float = 0.5,
    eps: float = 1e-10,
    nnls_iters: int = 50,
    positive: bool = True,
    valid: Optional[torch.Tensor] = None,
    block: int = 128,
) -> OMPAnytimeState:
    """Open an anytime OMP session and solve its first ``k`` rounds, on the
    device of ``grads``."""
    n, d = grads.shape
    grads = grads.float().contiguous()
    target = target.to(device=grads.device, dtype=torch.float32).contiguous()
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=grads.device)
    valid = valid.to(device=grads.device, dtype=torch.bool).contiguous()
    c0 = ops.corr(grads, target)
    st = _empty_inc_state(_block_cap(k, block), n, d, target)
    sess = OMPAnytimeState(k=0, block=int(block), st=st, c0=c0,
                           target=target, valid=valid, lam=float(lam),
                           eps=float(eps), nnls_iters=int(nnls_iters),
                           positive=bool(positive))
    return _extend(grads, sess, int(k), copy=False)


def omp_session_extend(grads: torch.Tensor, sess: OMPAnytimeState,
                       k_new: int) -> OMPAnytimeState:
    """Extend a session's budget to ``k_new`` rounds: only rounds
    ``[sess.k, k_new)`` run.

    ``grads`` must be the pool the session was started on.  The session
    passed in stays as it was (the new one works on a copy of its
    buffers).  ``k_new`` may not shrink the budget: by the prefix property
    ``sess.indices[:k_small]`` already is the ``k_small`` solution, so a
    smaller ask is a caller's error.
    """
    if k_new < sess.k:
        raise ValueError(
            f"cannot shrink an anytime session: have k={sess.k}, asked "
            f"k'={k_new} (slice indices[:k'] instead: prefix property)")
    if k_new == sess.k:
        return sess
    return _extend(grads, sess, int(k_new), copy=True)


def _extend(grads, sess: OMPAnytimeState, k_new: int,
            copy: bool) -> OMPAnytimeState:
    """Rounds ``[sess.k, k_new)`` on full-block widths; ``copy=False``
    updates the session's buffers in place."""
    grads = grads.float().contiguous()
    d = grads.shape[1]
    block = sess.block
    st = sess.st.clone() if copy else sess.st
    _pad_slots(st, _block_cap(k_new, block))
    for lo in range((sess.k // block) * block, k_new, block):
        width = lo + block           # full-block width: independent of k
        use_cols = width <= d
        if st.weights.shape[0] < width:
            _grow_prefix(st, width, keep_cols=use_cols)
        _run_session_block(grads, sess.target, sess.c0, sess.valid, st,
                           max(lo, sess.k), min(lo + block, k_new),
                           use_cols, sess.lam, sess.eps, sess.nnls_iters,
                           absolute=not sess.positive)
    return sess._replace(k=k_new, st=st)


def session_result(sess: OMPAnytimeState
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """(indices (k,), weights (k,), mask (k,), err ()): ``omp_select``'s
    contract at the session's budget."""
    return sess.indices, sess.weights, sess.mask, sess.err


def session_prefix_result(sess: OMPAnytimeState, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """The first ``k`` slots of a session: a degraded answer.

    Indices and mask are exact (the prefix property: they are what a
    one-shot ``k`` solve picks); the weights are the budget-``sess.k``
    weights restricted to the prefix, not a fresh ``k``-round solve's, so
    the caller renormalizes and labels the answer degraded.  ``k`` may not
    exceed the solved budget.
    """
    k = int(k)
    if k > sess.k:
        raise ValueError(
            f"session has only {sess.k} solved rounds, asked prefix {k} "
            "(extend the session instead)")
    return (sess.indices[:k], sess.weights[:k], sess.mask[:k], sess.err)


class OMPTrajectory(NamedTuple):
    """Host-side record of an anytime solve to ``k_max``.

    ``weights_traj`` is lower-triangular: row ``t-1`` holds the NNLS
    weights after round t, so ``(indices[:k], weights_traj[k-1, :k],
    mask[:k], err_trace[k-1])`` is the session engine's answer at budget
    ``k``, bit for bit.
    """

    indices: np.ndarray       # (k_max,) int32
    mask: np.ndarray          # (k_max,) bool
    weights_traj: np.ndarray  # (k_max, k_max) f32, row t-1 = after round t
    err_trace: np.ndarray     # (k_max,) f32, Err_lambda after round t


def omp_session_trajectory(
    grads: torch.Tensor,
    target: torch.Tensor,
    k_max: int,
    lam: float = 0.5,
    eps: float = 1e-10,
    nnls_iters: int = 50,
    positive: bool = True,
    valid: Optional[torch.Tensor] = None,
    block: int = 128,
) -> tuple[OMPAnytimeState, OMPTrajectory]:
    """Solve to ``k_max`` one round at a time, recording every prefix.

    The session engine's width schedule does not depend on the budget, so
    round-by-round extension equals a direct one: row ``t-1`` is what a
    fresh ``omp_session_start(grads, target, t)`` reports, bit for bit.
    The rows are recorded on the pool's device and taken to the host in
    one copy at the end.
    """
    k_max = int(k_max)
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    sess = omp_session_start(grads, target, 0, lam=lam, eps=eps,
                             nnls_iters=nnls_iters, positive=positive,
                             valid=valid, block=block)
    # (k_max, k_max + 1): row t-1 holds the weights after round t, then
    # its err in the last column
    rec = torch.zeros((k_max, k_max + 1), dtype=torch.float32,
                      device=sess.c0.device)
    for t in range(1, k_max + 1):
        sess = _extend(grads, sess, t, copy=False)
        rec[t - 1, :t] = sess.weights
        rec[t - 1, k_max] = sess.err
    rec = rec.cpu().numpy()
    traj = OMPTrajectory(
        indices=sess.indices.cpu().numpy().astype(np.int32),
        mask=sess.mask.cpu().numpy().astype(bool),
        weights_traj=np.ascontiguousarray(rec[:, :k_max]),
        err_trace=np.ascontiguousarray(rec[:, k_max]),
    )
    return sess, traj


# ---------------------------------------------------------------------------
# batched multi-target OMP: one pool scan serves B targets
# ---------------------------------------------------------------------------

@dataclass
class OMPBatchState:
    """``OMPIncState`` with a leading batch axis of B problems."""

    indices: torch.Tensor      # (B, k) i32
    mask: torch.Tensor         # (B, k) bool
    weights: torch.Tensor      # (B, P) f32
    colcache: torch.Tensor     # (B, n, P) f32 (wide regime)
    gram: torch.Tensor         # (B, P, P) f32
    gram_absrow: torch.Tensor  # (B, P) f32
    tcorr: torch.Tensor        # (B, P) f32
    rows: torch.Tensor         # (B, P, d) f32
    residual: torch.Tensor     # (B, d) f32
    err: torch.Tensor          # (B,) f32


# The paddings act on the trailing dimensions, so the single solver's
# growth serves the batched state as it is.
_grow_prefix_batched = _grow_prefix


def _nnls_active_cached_batched(
    gram: torch.Tensor,         # (B, k, k)
    gram_absrow: torch.Tensor,  # (B, k)
    rows: torch.Tensor,         # (B, k, d)
    corr: torch.Tensor,         # (B, k)
    mask: torch.Tensor,         # (B, k) bool
    lam: float,
    n_iters: int,
) -> torch.Tensor:
    """``_nnls_active_cached`` for B problems at once (the reference's
    ``vmap``): each iteration is a few batched products for the whole
    batch, not B sets of launches."""
    m = mask.to(rows.dtype)
    c = corr * m
    lip = torch.clamp_min((m * (gram_absrow + lam)).amax(dim=1), 1e-6)
    step = (1.0 / lip)[:, None]
    _, k, d = rows.shape
    use_factor = d < k
    w = torch.zeros_like(c)
    for _ in range(n_iters):
        if use_factor:
            u = torch.bmm(w[:, None, :], rows)                  # (B, 1, d)
            aw = torch.bmm(rows, u.transpose(1, 2))[:, :, 0] + lam * w
        else:
            aw = torch.bmm(gram, w[:, :, None])[:, :, 0] + lam * w
        w = torch.clamp_min(w - step * (aw - c), 0.0) * m
    return w


def _nnls_active_batched(gram: torch.Tensor, corr: torch.Tensor,
                         mask: torch.Tensor, lam: float,
                         n_iters: int) -> torch.Tensor:
    """``_nnls_active`` for B problems at once: (B, k, k), (B, k), (B, k)
    -> (B, k)."""
    k = gram.shape[1]
    m = mask.to(gram.dtype)
    a = gram + lam * torch.eye(k, dtype=gram.dtype, device=gram.device)
    a = a * m[:, :, None] * m[:, None, :]
    c = corr * m
    lip = torch.clamp_min(a.abs().sum(dim=2).amax(dim=1), 1e-6)
    step = (1.0 / lip)[:, None]
    w = torch.zeros_like(c)
    for _ in range(n_iters):
        aw = torch.bmm(a, w[:, :, None])[:, :, 0]
        w = torch.clamp_min(w - step * (aw - c), 0.0) * m
    return w


def _batch_round(grads, targets, c0_t, zeros_nb, avail_t, bcol,
                 st: OMPBatchState, t: int, use_cols: bool, lam: float,
                 eps: float, nnls_iters: int, absolute: bool) -> None:
    """``_inc_round`` for B problems, in place: one pool scan, one new
    column build and one batched NNLS a round for the whole batch."""
    p = st.weights.shape[1]
    if use_cols:
        e, _ = ops.corr_argmax_batched(st.colcache, st.weights, c0_t,
                                       avail_t, absolute=absolute)
    else:
        e, _ = ops.corr_argmax_batched(grads, -st.residual, zeros_nb,
                                       avail_t, absolute=absolute)
    e = e.long()
    grow = st.err > eps                                    # (B,)
    growf = grow.to(torch.float32)
    st.indices[:, t] = torch.where(grow, e, -1)
    st.mask[:, t] = grow
    avail_t.index_put_((e, bcol), avail_t[e, bcol] & ~grow)
    mask_p = st.mask[:, :p]

    g_e = grads.index_select(0, e) * growf[:, None]        # (B, d)
    st.rows[:, t] = g_e
    if use_cols:
        st.colcache[:, :, t] = ops.corr_batched(grads, g_e).T
        row_vals = torch.where(mask_p, st.colcache[bcol, e],
                               0.0) * growf[:, None]
    else:
        row_vals = torch.where(
            mask_p, torch.bmm(st.rows, g_e[:, :, None])[:, :, 0], 0.0)
    st.gram[:, t, :] = row_vals
    st.gram[:, :, t] = row_vals
    st.gram_absrow = torch.where(mask_p, st.gram_absrow + row_vals.abs(),
                                 0.0)
    st.gram_absrow[:, t] = row_vals.abs().sum(dim=1)
    st.tcorr[:, t] = c0_t[e, bcol] * growf

    st.weights = _nnls_active_cached_batched(
        st.gram, st.gram_absrow, st.rows, st.tcorr, mask_p, lam, nnls_iters)
    st.residual = targets - torch.bmm(st.weights[:, None, :], st.rows)[:, 0]
    st.err = (st.residual ** 2).sum(dim=1) + lam * (st.weights ** 2).sum(
        dim=1)


def _empty_batch_state(k: int, n: int, d: int,
                       targets: torch.Tensor) -> OMPBatchState:
    bsz = targets.shape[0]
    dev = targets.device
    f32 = dict(dtype=torch.float32, device=dev)
    return OMPBatchState(
        indices=torch.full((bsz, k), -1, dtype=torch.int32, device=dev),
        mask=torch.zeros((bsz, k), dtype=torch.bool, device=dev),
        weights=torch.zeros((bsz, 0), **f32),
        colcache=torch.zeros((bsz, n, 0), **f32),
        gram=torch.zeros((bsz, 0, 0), **f32),
        gram_absrow=torch.zeros((bsz, 0), **f32),
        tcorr=torch.zeros((bsz, 0), **f32),
        rows=torch.zeros((bsz, 0, d), **f32),
        residual=targets,
        err=(targets ** 2).sum(dim=1),
    )


def _run_batch_block(grads, targets, c0_t, avail_t, st: OMPBatchState,
                     t0: int, t1: int, use_cols: bool, lam: float,
                     eps: float, nnls_iters: int,
                     absolute: bool) -> OMPBatchState:
    """Rounds ``[t0, t1)`` inside one prefix width, in place; ``avail_t``
    (n, B) is the running availability, updated in place."""
    zeros_nb = torch.zeros_like(c0_t)
    bcol = torch.arange(targets.shape[0], device=grads.device)
    for t in range(t0, t1):
        _batch_round(grads, targets, c0_t, zeros_nb, avail_t, bcol, st, t,
                     use_cols, lam, eps, nnls_iters, absolute)
    return st


def _omp_select_batched_incremental(grads, targets, k, lam, eps, nnls_iters,
                                    positive, valids, block,
                                    single_regime: bool = False):
    """Incremental-Gram OMP over B targets sharing one pool.

    The rounds are ``_inc_round``'s, batched: the narrow scan reads the
    pool once a round for every problem (``corr_argmax_batched`` on the
    shared ``(n, d)`` pool), the wide regime builds all B new columns in
    one ``corr_batched``, and one batched NNLS serves the batch.  The
    prefix schedule is ``omp_select``'s.  The regime rule is the
    reference's ``hi * B <= d`` (the column cache is per problem, the
    narrow scan shared); ``single_regime`` takes ``omp_select``'s ``hi <=
    d`` instead, so that every problem runs the regimes its single solve
    runs (per-class selection, the reference's ``vmap(omp_select)``).
    Pool-sized arrays are pool-major ``(n, B)``, as in the reference.
    """
    n, d = grads.shape
    bsz = targets.shape[0]
    c0_t = ops.corr_batched(grads, targets)          # (n, B), exactly once
    # (n, B), running; a copy: the caller's mask is never written.
    avail_t = valids.T.clone(memory_format=torch.contiguous_format)
    st = _empty_batch_state(k, n, d, targets)
    for lo in range(0, k, block):
        hi = min(lo + block, k)
        use_cols = hi <= d if single_regime else hi * bsz <= d
        _grow_prefix_batched(st, hi, keep_cols=use_cols)
        _run_batch_block(grads, targets, c0_t, avail_t, st, lo, hi,
                         use_cols, lam, eps, nnls_iters,
                         absolute=not positive)
    return st.indices, st.weights, st.mask, st.err


def omp_select_batched(
    grads: torch.Tensor,       # (n, d) shared candidate pool
    targets: torch.Tensor,     # (B, d) one target per problem
    k: int,
    lam: float = 0.5,
    eps: float = 1e-10,
    nnls_iters: int = 50,
    positive: bool = True,
    valid: Optional[torch.Tensor] = None,   # (B, n) or (n,) availability
    method: str = "incremental",
    block: int = 128,
    single_regime: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve B OMP problems over one shared pool.

    Returns ``(indices (B, k) i32, weights (B, k) f32, mask (B, k) bool,
    err (B,) f32)`` on the device of ``grads``: row b is what
    ``omp_select(grads, targets[b], ...)`` picks, index for index away
    from the f32 noise floor (the same math, batched reductions).
    ``method="dense"`` runs B dense solves, the oracle.  ``single_regime``
    takes ``omp_select``'s regime rule (``hi <= d``) in place of the
    reference's ``hi * B <= d``, so each problem runs its single solve's
    rounds (the partition and per-class solves).
    """
    if method not in ("incremental", "dense"):
        raise ValueError(f"unknown OMP method {method!r}")
    n, _ = grads.shape
    grads = grads.float().contiguous()
    targets = targets.to(device=grads.device,
                         dtype=torch.float32).contiguous()
    bsz = targets.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=grads.device)
    valid = valid.to(device=grads.device, dtype=torch.bool)
    valid = valid.expand(bsz, n).contiguous()
    if method == "dense":
        outs = [_omp_select_dense(grads, targets[b], k, lam, eps, nnls_iters,
                                  positive, valid[b], None)
                for b in range(bsz)]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(4))
    return _omp_select_batched_incremental(grads, targets, k, lam, eps,
                                           nnls_iters, positive, valid,
                                           block, single_regime)


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
    """Paper's per-class decomposition: one OMP problem per class, solved
    together by the batched engine (the reference ``vmap``s
    ``omp_select``).

    Class c's problem sees only the candidates labelled c.  Returns
    flattened (num_classes*k, ...) padded arrays.  With ``quotas`` every
    class runs ``max(quotas)`` rounds and keeps its first ``quotas[c]``
    (index-exact by the greedy prefix property); those weights are
    re-solved by one batched NNLS on the truncated active sets.  Each
    block takes ``omp_select``'s regime (``hi <= d``), so each class runs
    the rounds its single solve runs.
    """
    if method not in ("incremental", "dense"):
        raise ValueError(f"unknown OMP method {method!r}")
    grads = grads.float().contiguous()
    dev = grads.device
    targets = targets.to(device=dev, dtype=torch.float32).contiguous()
    cls = torch.arange(num_classes, device=dev)
    valids = labels.to(dev)[None, :] == cls[:, None]            # (C, n)

    def solve(k):
        if method == "dense":
            outs = [_omp_select_dense(grads, targets[c], k, lam, eps, 50,
                                      True, valids[c], None)
                    for c in range(num_classes)]
            return tuple(torch.stack([o[i] for o in outs])
                         for i in range(4))
        return _omp_select_batched_incremental(
            grads, targets, k, lam, eps, 50, True, valids, 128,
            single_regime=True)

    if quotas is None:
        idx, w, mask, _ = solve(k_per_class)
        return idx.reshape(-1), w.reshape(-1), mask.reshape(-1)

    quotas = np.asarray(quotas, np.int64)
    if quotas.shape != (num_classes,):
        raise ValueError(
            f"quotas must be ({num_classes},), got {quotas.shape}")
    k_cap = int(quotas.max()) if quotas.size else 0
    if k_cap == 0:                      # empty budget: all-off result
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    idx, _, mask, _ = solve(k_cap)
    slot = torch.arange(k_cap, device=dev)
    quota_t = torch.as_tensor(quotas, device=dev)
    mask = mask & (slot[None, :] < quota_t[:, None])
    idx = torch.where(mask, idx, -1)
    # Exact reweight of the truncated prefixes: one batched NNLS over the
    # quota-sized active sets against the class targets.
    sel = torch.where(mask, idx, 0).long()
    g_s = grads[sel] * mask[:, :, None].to(grads.dtype)       # (C, k, d)
    w = _nnls_active_batched(torch.bmm(g_s, g_s.transpose(1, 2)),
                             torch.bmm(g_s, targets[:, :, None])[:, :, 0],
                             mask, lam, nnls_iters)
    return (idx.reshape(-1), torch.where(mask, w, 0.0).reshape(-1),
            mask.reshape(-1))


def matching_error(
    grads: torch.Tensor, target: torch.Tensor, indices: torch.Tensor,
    weights: torch.Tensor, mask: torch.Tensor, lam: float = 0.0,
) -> torch.Tensor:
    """Err_lambda = ||G_S^T w - g_tgt||^2 + lam ||w||^2 for a given (X, w)."""
    sel = torch.where(mask, indices, 0).long()
    g_s = grads[sel] * mask[:, None].to(grads.dtype)
    resid = target - weights @ g_s
    return (resid ** 2).sum() + lam * (weights ** 2).sum()
