"""Decremental OMP: remove committed rows from an anytime solution, after
``repro/core/decremental.py``.

The math rests on the greedy prefix property: round ``t`` of the session
engine is a function of the pool, the target and the state rounds ``< t``
left.  A candidate that never won an argmax influenced no round, so
removing it changes nothing; removing the pick of round ``i`` leaves
rounds ``< i`` as they were, and only the tail ``[i, k)`` is recomputed.

``omp_downdate`` truncates the session's prefix buffers at the removed
pick's round, re-runs the factor-form NNLS on the surviving active set,
recomputes the residual and replays the tail with real argmaxes (the
session engine's ``corr_argmax`` rounds).  Removing the last round's pick
is one truncation, one NNLS and one residual: O(k·d + k²) against a
re-solve's O(k·n·d).

``session_extend_traced`` is the replay engine of the continual buffer:
the session engine's rounds, one at a time (``_run_session_block`` over
``[t, t + 1)``, the same state transitions as a block extension, bit for
bit), recording each round's entering residual and winning gain, the
admission certificate ``certify_admission`` checks newcomers against.

Exactness bar, the anytime sessions': indices exact away from the f32
noise floor, weights to tolerance.  The one deliberate deviation from
bit-replay is the reference's: truncation recomputes the Gershgorin row
sums (``gram_absrow``) from the surviving Gram instead of replaying their
accumulation, which can move the NNLS step by an ulp.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.omp import (OMPAnytimeState, OMPIncState, _block_cap,
                                  _empty_inc_state, _grow_prefix,
                                  _nnls_active_cached, _pad_slots,
                                  _run_session_block, omp_session_extend)

__all__ = [
    "DowndateInfo",
    "ReplayTrace",
    "certify_admission",
    "omp_downdate",
    "session_extend_traced",
    "session_truncate",
]


def _truncate_buffers(st: OMPIncState, target: torch.Tensor, t: int,
                      lam: float, nnls_iters: int) -> OMPIncState:
    """Zero the prefix buffers past round ``t`` and re-tighten: weights,
    residual and err re-derived by the factor-form NNLS round ``t - 1``
    ran over the same buffers (w0 = 0, fixed iterations).  The buffers'
    width is the fresh session's block-quantized width after ``t``
    rounds."""
    wt = st.weights.shape[0]            # == block * ceil(t / block)
    keep = torch.arange(wt, device=target.device) < t
    indices = torch.where(keep, st.indices[:wt], -1).to(torch.int32)
    mask = st.mask[:wt] & keep
    rows = torch.where(keep[:, None], st.rows, 0.0)
    tcorr = torch.where(keep, st.tcorr, 0.0)
    gram = torch.where(keep[:, None] & keep[None, :], st.gram, 0.0)
    wc = st.colcache.shape[1]
    colcache = torch.where(
        torch.arange(wc, device=target.device)[None, :] < t, st.colcache,
        0.0)
    absrow = torch.where(keep, gram.abs().sum(dim=1), 0.0)
    w = _nnls_active_cached(gram, absrow, rows, tcorr, mask, lam, nnls_iters)
    resid = target - w @ rows
    err = (resid ** 2).sum() + lam * (w ** 2).sum()
    return OMPIncState(indices, mask, w, colcache, gram, absrow, tcorr, rows,
                       resid, err)


def session_truncate(sess: OMPAnytimeState, t: int,
                     valid: Optional[torch.Tensor] = None
                     ) -> OMPAnytimeState:
    """Truncate an anytime session to its first ``t`` rounds, exactly.

    By the greedy prefix property the result is the state a fresh
    ``t``-round session over the same pool holds (weights at the noise
    floor, ``gram_absrow`` above), so a later ``omp_session_extend`` goes
    on as if rounds ``>= t`` never ran.  ``valid`` optionally replaces the
    candidate mask the replayed rounds see.  The session passed in is left
    as it was.
    """
    t = int(t)
    if not 0 <= t <= sess.k:
        raise ValueError(
            f"cannot truncate to t={t}: session holds k={sess.k} rounds")
    v = sess.valid if valid is None else valid.to(
        device=sess.valid.device, dtype=torch.bool)
    if t == sess.k and valid is None:
        return sess
    block = sess.block
    d = sess.st.rows.shape[1]
    n = v.shape[0]
    if t == 0:
        st0 = _empty_inc_state(_block_cap(1, block), n, d, sess.target)
        return sess._replace(k=0, st=st0, valid=v)
    cap_t = _block_cap(t, block)        # == fresh width after t rounds
    src = sess.st
    st = OMPIncState(
        indices=src.indices[:cap_t], mask=src.mask[:cap_t],
        weights=src.weights[:cap_t],
        colcache=src.colcache[:, :min(cap_t, src.colcache.shape[1])],
        gram=src.gram[:cap_t, :cap_t], gram_absrow=src.gram_absrow[:cap_t],
        tcorr=src.tcorr[:cap_t], rows=src.rows[:cap_t],
        residual=src.residual, err=src.err)
    st = _truncate_buffers(st, sess.target, t, sess.lam, sess.nnls_iters)
    return sess._replace(k=t, st=st, valid=v)


class DowndateInfo(NamedTuple):
    """Accounting for one ``omp_downdate`` call."""

    round: int      # earliest round the removed candidate was committed at
    replayed: int   # tail rounds re-run with real argmaxes
    resolved: bool  # True when the removal degenerated to a full re-solve


def omp_downdate(grads: torch.Tensor, sess: OMPAnytimeState, idx: int,
                 k_new: Optional[int] = None):
    """Remove committed candidate ``idx`` from an anytime OMP solution.

    Truncates the prefix buffers at its round ``i``, re-runs the NNLS on
    the surviving active set, recomputes the residual, and replays rounds
    ``[i, k_new)`` over the surviving pool (``valid[idx]`` is cleared: the
    row leaves the solution and the candidate set).  ``k_new`` defaults to
    ``sess.k - 1``.  ``i == 0`` is a full re-solve (``resolved=True``).

    Returns ``(new_session, DowndateInfo)``; the session passed in is left
    as it was.
    """
    idx = int(idx)
    ind = sess.indices.cpu().numpy()
    msk = sess.mask.cpu().numpy()
    hits = np.nonzero((ind == idx) & msk)[0]
    if hits.size == 0:
        committed = np.unique(ind[msk])
        raise ValueError(
            f"candidate {idx} is not committed in this session "
            f"(committed: {committed[:16].tolist()}"
            f"{'...' if committed.size > 16 else ''})")
    i = int(hits[0])
    if k_new is None:
        k_new = sess.k - 1
    if k_new < i:
        raise ValueError(
            f"k_new={k_new} would truncate below the removed round {i}")
    new_valid = sess.valid.clone()
    new_valid[idx] = False
    out = session_truncate(sess, i, valid=new_valid)
    if k_new > i:
        out = omp_session_extend(grads, out, k_new)
    return out, DowndateInfo(round=i, replayed=int(k_new) - i,
                             resolved=(i == 0))


class ReplayTrace(NamedTuple):
    """Per-round certificate data for the continual buffer.

    ``resid[t]`` is the residual *entering* round ``t``; ``win[t]`` is the
    winner's residual-correlation gain at that round, what a newcomer must
    beat to change the round.  Sentinels: ``+inf`` for eps-stopped rounds
    (no newcomer can un-stop them), ``-inf`` for degenerate rounds (the
    pool ran out and the engine re-committed a taken slot: any newcomer
    wins such a round and forces a replay).
    """

    resid: np.ndarray   # (k, d) f32
    win: np.ndarray     # (k,) f32, +/-inf sentinels as above


def _empty_trace(d: int) -> ReplayTrace:
    return ReplayTrace(resid=np.zeros((0, d), np.float32),
                       win=np.zeros((0,), np.float32))


def session_extend_traced(grads: torch.Tensor, sess: OMPAnytimeState,
                          k_new: int, trace: Optional[ReplayTrace] = None):
    """``omp_session_extend`` that also records a ``ReplayTrace``.

    Runs the session engine one round at a time (the same state, bit for
    bit, as a block extension), keeping each round's entering residual on
    the device; the winning gains are computed afterwards on the host in
    the reference's arithmetic.  ``trace`` must cover the ``sess.k``
    rounds already solved (``None`` only for a fresh session); the
    returned trace covers ``[0, k_new)``.  The session passed in is left
    as it was.

    Returns ``(new_session, new_trace)``.
    """
    d = grads.shape[1]
    if trace is None:
        if sess.k != 0:
            raise ValueError(
                f"session holds {sess.k} rounds but no trace was given")
        trace = _empty_trace(d)
    if trace.win.shape[0] != sess.k:
        raise ValueError(
            f"trace covers {trace.win.shape[0]} rounds, session holds "
            f"{sess.k}")
    if k_new < sess.k:
        raise ValueError(
            f"cannot shrink an anytime session: have k={sess.k}, asked "
            f"k'={k_new} (use session_truncate)")
    if k_new == sess.k:
        return sess, trace
    grads = grads.float().contiguous()
    block = sess.block
    absolute = not sess.positive
    st = _pad_slots(sess.st.clone(), _block_cap(k_new, block))
    resids = []
    for t in range(sess.k, k_new):
        width = block * (t // block + 1)     # full-block session schedule
        use_cols = width <= d
        if st.weights.shape[0] < width:
            _grow_prefix(st, width, keep_cols=use_cols)
        resids.append(st.residual)           # replaced, not updated in place
        _run_session_block(grads, sess.target, sess.c0, sess.valid, st, t,
                           t + 1, use_cols, sess.lam, sess.eps,
                           sess.nnls_iters, absolute=absolute)
    new_sess = sess._replace(k=int(k_new), st=st)

    ind = st.indices[:k_new].cpu().numpy()
    msk = st.mask[:k_new].cpu().numpy()
    valid_np = sess.valid.cpu().numpy()
    r_new = torch.stack(resids).cpu().numpy().astype(np.float32)  # (T, d)
    picks = ind[sess.k:k_new]
    take = torch.as_tensor(np.where(picks >= 0, picks, 0).astype(np.int64),
                           device=grads.device)
    rows_t = grads[take].cpu().numpy()
    gains = np.einsum("td,td->t", rows_t, r_new)
    if absolute:
        gains = np.abs(gains)
    win_new = np.empty((k_new - sess.k,), np.float32)
    seen = set(ind[:sess.k][msk[:sess.k]].tolist())
    for j, t in enumerate(range(sess.k, k_new)):
        if not msk[t]:
            win_new[j] = np.inf          # eps-stopped: unbeatable
        elif int(picks[j]) in seen or not valid_np[picks[j]]:
            win_new[j] = -np.inf         # degenerate re-pick: always replay
        else:
            win_new[j] = gains[j]
            seen.add(int(picks[j]))
    return new_sess, ReplayTrace(
        resid=np.concatenate([trace.resid, r_new], axis=0),
        win=np.concatenate([trace.win, win_new]))


def certify_admission(new_rows: np.ndarray, trace: ReplayTrace, k: int,
                      positive: bool = True, band_rel: float = 1e-4,
                      band_abs: float = 1e-6) -> int:
    """Earliest committed round a newcomer could win, fail-closed.

    Scores every newcomer row against the recorded residual trajectory
    (host numpy, the reference's arithmetic); a round whose winning gain
    does not clear the best newcomer score by the f32 band cannot be
    certified and must be replayed.  Returns ``k`` when every round is
    certified, ``0`` when nothing is (a full re-solve).
    """
    if k == 0:
        return 0
    if new_rows.shape[0] == 0:
        return k
    s = np.asarray(new_rows, np.float32) @ trace.resid[:k].T     # (B, k)
    if not positive:
        s = np.abs(s)
    best = s.max(axis=0)
    win = trace.win[:k]
    band = band_rel * np.abs(win) + band_abs
    with np.errstate(invalid="ignore"):
        ok = np.where(np.isposinf(win), True,
                      np.where(np.isneginf(win), False, best < win - band))
    bad = ~ok.astype(bool)
    return int(np.argmax(bad)) if bad.any() else k
