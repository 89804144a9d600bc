"""Streaming block-OMP selection over out-of-core candidate pools, after
``repro/core/streaming.py``.

``omp_select`` holds the whole ``(n, d)`` proxy pool in memory.  This module
selects from pools consumed through a re-iterable *chunk factory* (a
callable returning a fresh iterator of ``(chunk, valid)`` pairs in a fixed
order), with peak pool-dependent memory ``O(chunk + M·d + cache_bytes)``.
It selects the identical subset the in-memory solver would: each loader
pass refreshes a top-``M`` exact-row buffer and a compressed chunk cache
(bf16 rows with f32 norm and compression-error sidecars), then commits
certified OMP rounds against the buffer.  A round is certified when the
buffer's best score provably beats every out-of-buffer candidate, by a
ladder of bounds, each failing closed into the next:

  1. the residual-projection sketch, per uncached chunk;
  2. the compressed-cache interval bound, per cached row (the ``bound_max``
     kernel): ``u_i = s_i + (e_i + acc·||g_i||)·||r||``;
  3. exact-row repair: a few offending rows fetched by id into an annex;
  4. a rescan: a refill from the cache, else a full loader pass.

Port notes (what differs from the reference, and why):

* Chunks and fetched rows from numpy or memmap pools are copied to the
  solve's device one chunk at a time, by a plain ``.to(device)``.
* The commit loop is a Python loop with one host sync a round, taken on
  the certificate (the reference runs ``lax.while_loop`` on the device).
* ``lax.top_k`` and ``jnp.lexsort`` order ties by position; ``torch.topk``
  promises no order, so every top-k whose order matters is a stable sort.
* ``.at[p].set(v, mode="drop")`` writes: dropped positions land in a
  scratch slot one past the end of the array, which is cut off (an
  in-range sentinel would make duplicate writes race), so no write needs
  a host sync to filter its positions.
* The solve's state lives in tensors updated in place, so a mid-solve
  snapshot (``checkpoint_dir``) is taken only between commit blocks, as
  host copies, under the reference's keys and in its on-disk format; the
  arena masks' scratch slot is not saved.  The ``score_chunk_fn`` hook
  takes the device-parallel scorer ``distributed.pmap_chunk_topm``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import restore_to
from repro_torch.checkpoint.solver_state import (load_solver_state,
                                                 save_solver_state)
from repro_torch.core.gradmatch import SelectionResult, _normalize
from repro_torch.core.omp import _nnls_active_cached
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.resilience.faults import CorruptChunkError
from repro_torch.resilience.recovery import RetryPolicy, with_retries

_NEG_INF = float("-inf")
_BIG_ID = 2**31 - 1

# Soundness margin for scoring a bf16-compressed row in f32 accumulation
# against the exact f32 row: the measured compression error e_i bounds the
# rounding by Cauchy-Schwarz, and two f32 summation orders differ by at
# most d·2^-23 relative to ||g||·||r|| (1.25 absorbs second-order terms).
DEFAULT_CACHE_BYTES = 256 << 20


def _acc_margin(d: int) -> float:
    return float(d * 2.0 ** -23 * 1.25)


def _rows(x, device: torch.device) -> torch.Tensor:
    """Rows as a contiguous f32 tensor on ``device``; numpy (and memmap)
    rows are copied there by a plain ``.to(device)``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()


def _flags(v, device: torch.device) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v, dtype=bool))
    return v.to(device=device, dtype=torch.bool)


def _pad_rows(x: torch.Tensor, length: int, value=0) -> torch.Tensor:
    """Pad the leading dimension of ``x`` to ``length`` with ``value``."""
    pad = length - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_full((pad, *x.shape[1:]), value)])


def _top(vals: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the ``m`` largest, equal values in position
    order, as ``lax.top_k`` gives them (``torch.topk`` promises no order
    among ties)."""
    order = torch.sort(vals, descending=True, stable=True).indices[:m]
    return vals[order], order


def _set_drop(buf: torch.Tensor, pos: torch.Tensor, value) -> None:
    """``buf[pos] = value`` in place, for a ``buf`` that carries one
    scratch slot past its last real entry: non-negative positions at or
    past it land in that slot (the reference's ``mode="drop"``)."""
    last = buf.shape[0] - 1
    buf.index_put_((pos.long().clamp(max=last),),
                   torch.as_tensor(value, dtype=buf.dtype, device=buf.device))


# ---------------------------------------------------------------------------
# chunk protocol
# ---------------------------------------------------------------------------

def array_chunks(pool, chunk_size: int, valid=None) -> Callable[[], Iterator]:
    """Chunk factory over an ``(n, d)`` array: a tensor (on any device), a
    numpy array or an ``np.memmap``.

    Each call returns a fresh iterator of ``(chunk, valid_chunk)`` in the
    same order.  Rows are only touched one chunk at a time, so a
    memory-mapped pool is never materialized.
    """
    n = pool.shape[0]
    cs = int(chunk_size)

    def chunks():
        for lo in range(0, n, cs):
            hi = min(lo + cs, n)
            yield pool[lo:hi], (None if valid is None else valid[lo:hi])

    return chunks


def array_row_fetch(pool) -> Callable:
    """Exact-row fetch for an array-backed pool: a plain gather of the
    same f32 rows the chunk factory yields."""

    def fetch(ids):
        if isinstance(pool, torch.Tensor):
            idx = torch.as_tensor(np.asarray(ids, np.int64),
                                  device=pool.device)
            return pool[idx].float()
        return np.asarray(pool[np.asarray(ids)], np.float32)

    return fetch


def chunked_pool_iter(pool, valid=None) -> Callable[[], Iterator]:
    """Adapt a ``data.loader.ChunkedPool`` of proxy rows to the
    ``(chunk, valid)`` protocol: the labels are dropped, and ``valid`` is
    an optional full-length (n,) mask sliced by the offsets the pool
    reports.  (Raw-data pools go through ``proxies.proxy_chunk_stream``.)
    """

    def chunks():
        for x, _, lo in pool.chunks():
            c = x.shape[0]
            yield x, (None if valid is None else valid[lo:lo + c])

    return chunks


def subrange_chunks(pool_iter: Callable[[], Iterator], lo: int,
                    hi: int) -> Callable[[], Iterator]:
    """Clip a chunk factory to the global row range ``[lo, hi)``: chunks
    that straddle the range are sliced, and every call walks the same
    sub-chunks in the same order.  Row ids inside the view are local; add
    ``lo`` to map a pick back to a global id."""
    lo, hi = int(lo), int(hi)

    def chunks():
        off = 0
        for chunk, v in pool_iter():
            c = chunk.shape[0]
            if off + c > lo:
                s = max(lo - off, 0)
                e = min(hi - off, c)
                if s < e:
                    yield chunk[s:e], (None if v is None else v[s:e])
            off += c
            if off >= hi:
                break

    return chunks


def offset_row_fetch(row_fetch: Callable, lo: int) -> Callable:
    """Shift an exact-row fetcher into a ``subrange_chunks`` view: local
    id ``i`` fetches global row ``lo + i``."""
    lo = int(lo)

    def fetch(ids):
        return row_fetch(np.asarray(ids, np.int64) + lo)

    return fetch


def streaming_target(pool_iter: Callable[[], Iterator],
                     cache: "ChunkCache | None" = None,
                     retry: "RetryPolicy | None" = None,
                     device: str | torch.device | None = None):
    """One pass: ``(sum of valid rows (d,) f32, total row count)``, the
    eq. (2) target, summed chunk by chunk on ``device`` (``None``: the
    card).

    With a ``cache`` the same pass warms the compressed chunk cache, so a
    later solve can bootstrap from it without a loader pass.  With a
    ``retry`` policy, transient iterator faults restart the pass (the
    accumulators are pass-local and ``cache.offer`` is idempotent for
    resident chunks, so a restart is exact).
    """
    dev = resolve_device(device)
    if cache is not None and cache.device != dev:
        raise ValueError(f"the cache lives on {cache.device}, the pass runs "
                         f"on {dev}")

    def scan():
        total = None
        n = 0
        idx = 0
        for chunk, v in pool_iter():
            c = _rows(chunk, dev)
            if v is not None:
                c = c * _flags(v, dev)[:, None].to(torch.float32)
            s = c.sum(dim=0)
            total = s if total is None else total + s
            offer_chunk(cache, idx, n, chunk, v)
            n += chunk.shape[0]
            idx += 1
        return total, n, idx

    if retry is None:
        total, n, idx = scan()
    else:
        total, n, idx = with_retries(scan, retry)
    if total is None:
        raise ValueError("empty pool iterator")
    if cache is not None and cache.covers(idx):
        cache.complete = idx
    return total, n


def _bucket(c: int) -> int:
    """Pad a chunk length to the next power of two (at least 8)."""
    p = 8
    while p < c:
        p *= 2
    return p


def _padded_chunk(chunk, v, offset: int, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows padded to the chunk's bucket, ok-mask, global ids with -1 on
    the padding) for rows ``[offset, offset + len(chunk))``."""
    c = chunk.shape[0]
    cpad = _bucket(c)
    ch = _pad_rows(_rows(chunk, device), cpad)
    pos_in = torch.arange(cpad, dtype=torch.int32, device=device)
    ok = pos_in < c
    if v is not None:
        ok = ok & _pad_rows(_flags(v, device), cpad, False)
    gids = torch.where(pos_in < c, offset + pos_in, -1)
    return ch, ok, gids


def offer_chunk(cache: "ChunkCache | None", idx: int, offset: int,
                chunk, v) -> None:
    """Offer one ``(chunk, valid)`` pair to the compressed cache, padded to
    its power-of-two bucket with its ok-mask and global row ids: the
    warming pass's body."""
    if cache is None:
        return
    ch, ok, gids = _padded_chunk(chunk, v, offset, cache.device)
    cache.offer(idx, offset, chunk.shape[0], ch, ok, gids)


# ---------------------------------------------------------------------------
# compressed chunk cache (bf16 rows + f32 row-norm sidecars, LRU-bounded)
# ---------------------------------------------------------------------------

def _compress_chunk(ch: torch.Tensor, ok: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bf16 rows (round to nearest even, as XLA) + f32 sidecars: the exact
    row norm and the measured compression-error norm ``||g - bf16(g)||``,
    both from the rows before rounding (they make the interval bound
    sound and tight)."""
    norms = torch.sqrt((ch * ch).sum(dim=1))
    rows_bf = ch.to(torch.bfloat16)
    diff = ch - rows_bf.float()
    errn = torch.sqrt((diff * diff).sum(dim=1))
    return (rows_bf, torch.where(ok, norms, 0.0),
            torch.where(ok, errn, 0.0))


class ChunkCache:
    """Compressed chunk cache: one flat bf16 row arena with f32 norm /
    global-id / validity sidecars, slotted per chunk, LRU-evicted to stay
    under ``cache_bytes``, on ``device`` (``None``: the card).

    Keyed by chunk position in the (stable) iteration order and safe to
    share across solves over the same pool; per-solve state (taken and
    in-buffer masks) lives in the solver.  The layout is the reference's:
    power-of-two chunk buckets, ``slot_rows`` fixed by the first chunk,
    capacity doubling in ``offer`` and LRU eviction, so arena positions
    (and the position-ordered ties that depend on them) match.
    """

    def __init__(self, cache_bytes: int, d: int,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cache_bytes = int(cache_bytes)
        self.d = int(d)
        # bf16 row + f32 norm + f32 error norm + i32 gid + bool ok (+ the
        # solver's two per-solve masks, counted so the budget is honest).
        self.bytes_per_row = 2 * d + 4 + 4 + 4 + 3
        self.cap_rows_budget = max(self.cache_bytes // self.bytes_per_row, 0)
        self.slot_rows = 0            # fixed once the first chunk arrives
        self.cap_slots = 0
        self.rows = None              # (cap_rows, d) bf16
        self.norms = None             # (cap_rows,) f32 exact row norms
        self.errn = None              # (cap_rows,) f32 ||g - bf16(g)||
        self.gids = None              # (cap_rows,) i32
        self.ok = None                # (cap_rows,) bool
        # chunk_idx -> (slot, offset, length); insertion-recency ordered.
        self.entries: dict[int, tuple[int, int, int]] = {}
        self._lru: list[int] = []
        self.insertions = 0
        self.evictions = 0
        # Set by a full warming pass (streaming_target): the pool's chunk
        # count.  A solver handed a cache that still covers all `complete`
        # chunks bootstraps from it with zero loader passes.
        self.complete = 0

    @property
    def cap_rows(self) -> int:
        return 0 if self.rows is None else self.rows.shape[0]

    def slot_of(self, chunk_idx: int) -> int | None:
        e = self.entries.get(chunk_idx)
        return None if e is None else e[0]

    def _touch(self, chunk_idx: int) -> None:
        self._lru.remove(chunk_idx)
        self._lru.append(chunk_idx)

    def _grow_to(self, slots: int) -> None:
        rows_new = slots * self.slot_rows
        if rows_new <= self.cap_rows:
            return
        if self.rows is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            self.rows = torch.zeros((rows_new, self.d), dtype=torch.bfloat16,
                                    device=self.device)
            self.norms = torch.zeros((rows_new,), **f32)
            self.errn = torch.zeros((rows_new,), **f32)
            self.gids = torch.full((rows_new,), -1, dtype=torch.int32,
                                   device=self.device)
            self.ok = torch.zeros((rows_new,), dtype=torch.bool,
                                  device=self.device)
        else:
            self.rows = _pad_rows(self.rows, rows_new)
            self.norms = _pad_rows(self.norms, rows_new)
            self.errn = _pad_rows(self.errn, rows_new)
            self.gids = _pad_rows(self.gids, rows_new, -1)
            self.ok = _pad_rows(self.ok, rows_new, False)

    def offer(self, chunk_idx: int, offset: int, length: int,
              ch: torch.Tensor, ok: torch.Tensor, gids: torch.Tensor) -> bool:
        """Present one (padded f32) chunk; returns True when its rows are
        resident after the call.  A resident chunk is only LRU-touched (its
        content is static across passes); a new chunk is compressed and
        written, evicting least-recently-offered chunks if needed."""
        ent = self.entries.get(chunk_idx)
        if ent is not None:
            if ent[1] != offset or ent[2] != length:
                raise RuntimeError(
                    "pool iterator unstable: chunk %d moved from offset %d"
                    " (len %d) to offset %d (len %d)"
                    % (chunk_idx, ent[1], ent[2], offset, length))
            self._touch(chunk_idx)
            return True
        cpad = ch.shape[0]
        if self.slot_rows == 0:
            self.slot_rows = cpad
            self.cap_slots = self.cap_rows_budget // max(self.slot_rows, 1)
        if cpad > self.slot_rows or self.cap_slots == 0:
            return False              # uncacheable under this budget
        if len(self.entries) < self.cap_slots:
            slot = len(self.entries)
            want = min(self.cap_slots,
                       max(2 * max(len(self.entries), 1), slot + 1))
            self._grow_to(want)
        else:
            victim = self._lru.pop(0)
            slot, _, _ = self.entries.pop(victim)
            self.evictions += 1
        rows_c, norms_c, errn_c = _compress_chunk(ch, ok)
        lo, hi = slot * self.slot_rows, slot * self.slot_rows + cpad
        end = (slot + 1) * self.slot_rows
        self.rows[lo:hi] = rows_c
        self.rows[hi:end] = 0
        self.norms[lo:hi] = norms_c
        self.norms[hi:end] = 0
        self.errn[lo:hi] = errn_c
        self.errn[hi:end] = 0
        self.gids[lo:hi] = gids
        self.gids[hi:end] = -1
        self.ok[lo:hi] = ok
        self.ok[hi:end] = False
        self.entries[chunk_idx] = (slot, offset, length)
        self._lru.append(chunk_idx)
        self.insertions += 1
        return True

    def covers(self, num_chunks: int) -> bool:
        return len(self.entries) == num_chunks and num_chunks > 0

    def quarantine(self, pos) -> None:
        """Mask arena rows out of every certification scan (the engine's
        fail-closed response to corruption); positions at or past
        ``cap_rows`` are dropped.  The mask persists for the cache's
        lifetime."""
        if self.ok is None:
            return
        pos = np.asarray(pos, np.int64)
        pos = pos[(pos >= 0) & (pos < self.cap_rows)]
        self.ok[torch.as_tensor(pos, device=self.device)] = False

    def state_dict(self) -> dict:
        """Checkpointable snapshot, the reference's keys.  The entry table
        is stored in LRU order, so a restore reproduces the eviction
        behaviour, and so the solve, exactly."""
        st = {"cache_bytes": np.int64(self.cache_bytes),
              "d": np.int64(self.d),
              "slot_rows": np.int64(self.slot_rows),
              "cap_slots": np.int64(self.cap_slots),
              "complete": np.int64(self.complete),
              "insertions": np.int64(self.insertions),
              "evictions": np.int64(self.evictions),
              "ent_cidx": np.asarray(self._lru, np.int64),
              "ent_slot": np.asarray(
                  [self.entries[c][0] for c in self._lru], np.int64),
              "ent_off": np.asarray(
                  [self.entries[c][1] for c in self._lru], np.int64),
              "ent_len": np.asarray(
                  [self.entries[c][2] for c in self._lru], np.int64)}
        if self.rows is not None:
            st.update(rows=self.rows, norms=self.norms, errn=self.errn,
                      gids=self.gids, ok=self.ok)
        return st

    def load_state(self, st: dict) -> None:
        if int(st["d"]) != self.d:
            raise ValueError(
                f"cache checkpoint is for d={int(st['d'])}, "
                f"this cache has d={self.d}")
        self.cache_bytes = int(st["cache_bytes"])
        self.cap_rows_budget = max(self.cache_bytes // self.bytes_per_row,
                                   0)
        self.slot_rows = int(st["slot_rows"])
        self.cap_slots = int(st["cap_slots"])
        self.complete = int(st["complete"])
        self.insertions = int(st["insertions"])
        self.evictions = int(st["evictions"])
        self.entries = {}
        self._lru = []
        for c, s, o, ln in zip(np.asarray(st["ent_cidx"]).tolist(),
                               np.asarray(st["ent_slot"]).tolist(),
                               np.asarray(st["ent_off"]).tolist(),
                               np.asarray(st["ent_len"]).tolist()):
            self.entries[int(c)] = (int(s), int(o), int(ln))
            self._lru.append(int(c))
        if "rows" in st:
            arena = restore_to({k: st[k] for k in ("rows", "norms", "errn",
                                                   "gids", "ok")},
                               self.device)
            self.rows, self.norms, self.errn = (arena["rows"],
                                                arena["norms"],
                                                arena["errn"])
            self.gids, self.ok = arena["gids"], arena["ok"]
        else:
            self.rows = self.norms = self.errn = None
            self.gids = self.ok = None

    def stats(self) -> dict:
        return {"resident_chunks": len(self.entries),
                "cap_slots": self.cap_slots,
                "slot_rows": self.slot_rows,
                "insertions": self.insertions,
                "evictions": self.evictions,
                "resident_bytes": self.cap_rows * self.bytes_per_row}


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def _score_chunk(chunk, pool_ok, gids, offset, residual, sel_idx, sel_mask,
                 m: int, absolute: bool, need_norms: bool = True):
    """Top-``m`` of one chunk against the carried residual.

    Returns (vals (m,), ids (m,), rows (m, d), ok (m,), cmax (), cthresh ())
    where ``cthresh`` upper-bounds the pass score of every row this chunk
    dropped (-inf when nothing real could have been dropped) and ``cmax``
    is the max valid row norm (0 when ``need_norms`` is False: the pool is
    static, so the per-chunk norm bound is frozen after the first pass).
    """
    c = chunk.shape[0]
    scores = ops.corr(chunk, residual)                       # (c,)
    s = scores.abs() if absolute else scores
    # The chunk covers ids [offset, offset + c): the taken mask is an O(k)
    # scatter.  Picks of other chunks (and unused slots) land in a scratch
    # slot past the end, which is cut off.
    local = sel_idx.long() - int(offset)
    inb = sel_mask & (local >= 0) & (local < c)
    taken = torch.zeros((c + 1,), dtype=torch.bool, device=chunk.device)
    _set_drop(taken, torch.where(inb, local, c), True)
    avail = pool_ok & ~taken[:c]
    vals, pos = _top(torch.where(avail, s, _NEG_INF), m)     # ties: low pos
    if need_norms:
        norms = torch.sqrt((chunk * chunk).sum(dim=1))
        cmax = torch.where(pool_ok, norms, 0.0).max()
    else:
        cmax = torch.zeros((), dtype=torch.float32, device=chunk.device)
    cthresh = (vals[m - 1] if c > m
               else torch.full((), _NEG_INF, device=chunk.device))
    return vals, gids[pos], chunk[pos], pool_ok[pos], cmax, cthresh


def _merge_topm(bv, bi, br, bok, cv, ci, cr, cok, size: int):
    """Merge two candidate buffers, keep the top ``size`` by (score desc,
    id asc, padding ids last): the reference's ``jnp.lexsort`` as two
    stable sorts, so the buffer argmax keeps the lowest-index tie rule."""
    vals = torch.cat([bv, cv])
    ids = torch.cat([bi, ci])
    rows = torch.cat([br, cr])
    ok = torch.cat([bok, cok])
    id_order = torch.where(ids >= 0, ids, _BIG_ID)
    by_id = torch.sort(id_order, stable=True).indices
    by_val = torch.sort(vals[by_id], descending=True, stable=True).indices
    order = by_id[by_val][:size]
    return vals[order], ids[order], rows[order], ok[order]


def _buffer_scores_argmax(buf_rows, buf_ids, buf_dead, residual,
                          absolute: bool):
    """Score and argmax over the buffer against the current residual.

    ``buf_dead`` marks slots that can never win (invalid rows, pads,
    picked rows).  Ties go to the lowest global id, as ``argmax`` over the
    full pool would give (the all-dead case too).  Returns device scalars
    (position, id, max score).
    """
    s = ops.corr(buf_rows, residual)
    s = s.abs() if absolute else s
    s_m = torch.where(buf_dead, _NEG_INF, s)
    maxv = s_m.max()
    cand = torch.where(s_m == maxv,
                       torch.where(buf_ids >= 0, buf_ids, _BIG_ID), _BIG_ID)
    pos = torch.argmin(cand)
    return pos, buf_ids[pos], maxv


def _sketch_bound(residual, r0, chunk_thresh, chunk_norm, chunk_cached,
                  absolute: bool):
    """Max possible drifted-residual score of any out-of-buffer row of an
    uncached chunk: with ``r = a·r0 + r_perp``, ``g·r <= a·T_c +
    ||g||·||r_perp||``; NaN-safe at ``T_c = -inf`` and inflated past f32
    reassociation noise (fail closed)."""
    r0n2 = (r0 * r0).sum()
    r0n = torch.sqrt(r0n2)
    alpha = torch.dot(residual, r0) / torch.clamp_min(r0n2, 1e-30)
    rperp = residual - alpha * r0
    rpn = torch.sqrt((rperp * rperp).sum())
    fin = torch.isfinite(chunk_thresh)
    t_safe = torch.where(fin, chunk_thresh, 0.0)
    if absolute:
        proj = alpha.abs() * t_safe
    else:
        proj = torch.where(alpha >= 0, alpha * t_safe,
                           -alpha * chunk_norm * r0n)
    bound = torch.where(fin, proj + chunk_norm * rpn, _NEG_INF)
    bound = torch.where(fin, bound + 1e-6 * bound.abs() + 1e-30, bound)
    return torch.where(chunk_cached, _NEG_INF, bound).max()


def _arena_refresh_scan(ar_rows, ar_norms, ar_errn, ar_gids, ar_ok,
                        ar_taken, ar_inbuf, buf_rows, buf_ids, buf_dead,
                        residual, acc, *, absolute: bool, cand_cap: int,
                        m: int):
    """Cache-served refill, phase 1: every new arena row that could belong
    to the exact top-``m`` of the pool under the current residual.

    ``cutoff`` is the ``m``-th largest lower bound over (out-of-buffer
    arena rows, exact current-buffer scores); an out-of-buffer row whose
    upper bound clears it is a candidate.  Returns (ids, arena positions
    (``cap`` when dead), #candidates, #available) on the device.
    """
    cap = ar_rows.shape[0]
    rnorm = torch.sqrt((residual * residual).sum())
    s = ops.corr(ar_rows, residual)
    s = s.abs() if absolute else s
    pad = (ar_errn + acc * ar_norms) * rnorm
    u = s + pad
    lo = s - pad
    avail = ar_ok & ~ar_taken & ~ar_inbuf
    sb = ops.corr(buf_rows, residual)
    sb = sb.abs() if absolute else sb
    avail_b = ~buf_dead & (buf_ids >= 0)
    l_all = torch.cat([torch.where(avail, lo, _NEG_INF),
                       torch.where(avail_b, sb, _NEG_INF)])
    cutoff = torch.topk(l_all, m).values[m - 1]
    cand = avail & (u >= cutoff)
    vals, pos = _top(torch.where(cand, u, _NEG_INF), cand_cap)
    live = vals > _NEG_INF
    return (torch.where(live, ar_gids[pos], -1), torch.where(live, pos, cap),
            cand.sum(), avail.sum() + avail_b.sum())


def _arena_pos(ids, chunk_off, slot_lo, cap: int):
    """Arena rows of global ids through the device-side chunk map; ``cap``
    (the masks' scratch slot) for dead ids and uncached chunks."""
    ids = ids.long()
    nc = chunk_off.shape[0]
    j = (torch.searchsorted(chunk_off, ids, right=True) - 1).clamp(0, nc - 1)
    pos = slot_lo[j] + ids - chunk_off[j]
    return torch.where((ids >= 0) & (slot_lo[j] >= 0), pos, cap)


def _refresh_merge(f_rows, f_ids, f_ok, buf_rows, buf_ids, buf_dead,
                   residual, cap: int, chunk_off, slot_lo, *,
                   absolute: bool, m: int):
    """Cache-served refill, phase 2: exact-score the fetched candidates and
    the surviving buffer rows and keep the top ``m`` by (score desc, id
    asc), the order a loader pass's merge gives.  Also rebuilds the arena
    in-buffer mask (with its scratch slot) from the merged ids."""
    sf = ops.corr(f_rows, residual)
    sf = sf.abs() if absolute else sf
    vf = torch.where(f_ok & (f_ids >= 0), sf, _NEG_INF)
    sb = ops.corr(buf_rows, residual)
    sb = sb.abs() if absolute else sb
    avail_b = ~buf_dead & (buf_ids >= 0)
    vb = torch.where(avail_b, sb, _NEG_INF)
    mv, mi, mr, _ = _merge_topm(vb, buf_ids, buf_rows, avail_b, vf, f_ids,
                                f_rows, f_ok, size=m)
    inbuf = torch.zeros((cap + 1,), dtype=torch.bool, device=mv.device)
    _set_drop(inbuf, _arena_pos(mi, chunk_off, slot_lo, cap), True)
    return mv, mi, mr, mv == _NEG_INF, inbuf


def _verify_norms(ch, ok, ref):
    """Rows of a re-read chunk that disagree with the cache's f32
    exact-norm sidecar, past f32 reassociation noise (real corruption
    moves the norm by orders of magnitude more; a norm-preserving change
    such as pure sign flips is not detectable this way)."""
    nn = torch.where(ok, torch.sqrt((ch * ch).sum(dim=1)), 0.0)
    return ok & ((nn - ref).abs() > 1e-4 * (ref + 1e-6))


@dataclass
class _Prefix:
    """The committed prefix of a streaming solve, updated in place by
    ``_commit_rounds`` (the reference threads it through its while_loop)."""
    indices: torch.Tensor    # (k,) i32
    mask: torch.Tensor       # (k,) bool
    weights: torch.Tensor    # (k,) f32
    rows: torch.Tensor       # (k, d) f32 active rows
    gram: torch.Tensor       # (k, k) f32
    absrow: torch.Tensor     # (k,) f32 Gershgorin row sums
    tcorr: torch.Tensor      # (k,) f32
    residual: torch.Tensor   # (d,) f32
    err: torch.Tensor        # () f32


@dataclass
class _Arena:
    """What the commit loop reads of the cache and the per-solve masks;
    ``taken``/``inbuf`` carry the scratch slot at position ``cap``."""
    rows: torch.Tensor
    norms: torch.Tensor
    errn: torch.Tensor
    gids: torch.Tensor
    ok: torch.Tensor
    taken: torch.Tensor
    inbuf: torch.Tensor
    chunk_off: torch.Tensor
    slot_lo: torch.Tensor

    @property
    def cap(self) -> int:
        return self.rows.shape[0]

    def avail(self) -> torch.Tensor:
        return self.ok & ~self.taken[:self.cap] & ~self.inbuf[:self.cap]


def _commit_rounds(buf_rows, buf_ids, bdead, st: _Prefix, target, lam, r0,
                   chunk_thresh, chunk_norm, chunk_cached,
                   arena: Optional[_Arena], t0: int, t_hi: int,
                   t_first: int, eps: float, acc: float, stats, *, p: int,
                   nnls_iters: int, absolute: bool, fmax: int):
    """Commit as many certified OMP rounds against the buffer as the
    bounds allow, updating ``st``, ``bdead`` and ``arena.taken`` in place.

    The reference runs this as a ``lax.while_loop`` with ``lax.cond`` on
    the certificate.  Here it is a Python loop with one host sync a round,
    taken on the certificate: the sketch rung, the ``bound_max`` scan (run
    whether or not the sketch passed, then folded with the sketch's verdict
    on the device, so the two rungs cost one sync, not two), the eps test
    and the round's diagnostics come back in one read.  The bound's
    threshold (the buffer max) stays a device scalar the kernel reads in
    place.  Round ``t_first`` (the one right after a buffer refresh) is
    exact by construction and bypasses certification.  The loop stops at
    ``t_hi`` (the next prefix-block boundary), at the eps stop, or at the
    first round the bounds cannot certify, whose (maxv, sketch, u_max,
    #offenders) and top-``fmax`` offender (gid, arena row) pairs are
    returned for the repair tier.

    Returns (t, go, diag, offenders or None); ``go`` is False only when a
    round failed its certificate.
    """
    dev = target.device
    neg_inf = torch.full((), _NEG_INF, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    diag = (_NEG_INF, _NEG_INF, _NEG_INF, 0)
    t = t0
    while t < t_hi:
        pos, e, maxv = _buffer_scores_argmax(buf_rows, buf_ids, bdead,
                                             st.residual, absolute)
        sk = _sketch_bound(st.residual, r0, chunk_thresh, chunk_norm,
                           chunk_cached, absolute)
        sketch_ok = maxv > sk
        if arena is not None:
            avail_a = arena.avail()
            u_max, _, n_off = ops.bound_max(
                arena.rows, arena.norms, arena.errn, st.residual, acc, maxv,
                avail_a, absolute=absolute)
            u_max = torch.where(sketch_ok, u_max, neg_inf)
            n_off = torch.where(sketch_ok, n_off, zero_i)
        else:
            u_max, n_off = neg_inf, zero_i
        cert = (sketch_ok & (maxv > u_max) & torch.isfinite(maxv)) | (
            t == t_first)
        flags = torch.stack([cert.double(), (st.err > eps).double(),
                             maxv.double(), sk.double(), u_max.double(),
                             n_off.double()])
        c_ok, live, d_maxv, d_sk, d_umax, d_noff = flags.tolist()
        stats.host_syncs += 1
        if not live:
            break                       # eps stop: the loop condition
        diag = (d_maxv, d_sk, d_umax, int(d_noff))
        if not c_ok:
            offenders = None
            if arena is not None and fmax > 0:
                # Once per loop exit, in plain torch (plain jnp in the
                # reference): the repair tier's worklist, the offending
                # rows' ids and arena rows by upper bound.
                r = st.residual
                s = arena.rows.float() @ r
                s = s.abs() if absolute else s
                u = s + (arena.errn + acc * arena.norms) * torch.sqrt(
                    (r * r).sum())
                vals, opos = _top(torch.where(avail_a, u, _NEG_INF), fmax)
                live_o = vals > _NEG_INF
                offenders = (torch.where(live_o, arena.gids[opos], -1),
                             torch.where(live_o, opos, arena.cap))
            return t, False, diag, offenders
        g_e = buf_rows[pos]
        st.indices[t] = e
        st.mask[t] = True
        st.rows[t] = g_e
        mask_p = st.mask[:p]
        row_vals = torch.where(mask_p, st.rows[:p] @ g_e, 0.0)
        st.gram[t, :p] = row_vals
        st.gram[:p, t] = row_vals
        ar = torch.where(mask_p, st.absrow[:p] + row_vals.abs(), 0.0)
        ar[t] = row_vals.abs().sum()
        st.absrow[:p] = ar
        # g_e . target through the scoring kernel, as the in-memory
        # solver's c0 = corr(G, target): the reference's jnp.dot rounds
        # differently, and over thousands of rounds that last bit moves
        # near-tied picks away from the in-memory solver's.
        st.tcorr[t] = ops.corr(g_e.view(1, -1), target)[0]
        w_p = _nnls_active_cached(st.gram[:p, :p], st.absrow[:p],
                                  st.rows[:p], st.tcorr[:p], mask_p, lam,
                                  nnls_iters)
        st.weights.zero_()
        st.weights[:p] = w_p
        st.residual = target - w_p @ st.rows[:p]
        st.err = (st.residual ** 2).sum() + lam * (w_p ** 2).sum()
        if arena is not None:
            _set_drop(arena.taken,
                      _arena_pos(e.view(1), arena.chunk_off, arena.slot_lo,
                                 arena.cap), True)
        bdead[pos] = True
        t += 1
    return t, True, diag, None


# ---------------------------------------------------------------------------
# the streaming solver
# ---------------------------------------------------------------------------

@dataclass
class SelectStats:
    """Pass/round/cache accounting for benchmarks, the tests and the
    ``max_passes`` diagnostics.  The fields are the reference's, plus
    ``host_syncs`` (the port's commit loop reads the device once a round;
    the reference's loop runs on the device)."""
    passes: int = 0             # full loader scans
    rounds: int = 0
    certified_rounds: int = 0   # rounds committed without loader traffic
    chunks: int = 0
    pool_size: int = 0
    refills: int = 0            # buffer refreshes served from the cache
    repairs: int = 0            # bounded exact-row repair events
    fetched_rows: int = 0       # exact rows fetched by id (repair+refill)
    cache_hits: int = 0         # certification chunk lookups in the arena
    cache_misses: int = 0       # ... that had to use the sketch bound
    retries: int = 0            # transient faults retried (chunks + rows)
    quarantined: int = 0        # rows masked out after persistent
                                # corruption (never silently selected)
    checkpoints: int = 0        # mid-solve snapshots written
    resumes: int = 0            # solves resumed from a checkpoint
    admits: int = 0             # continual: rows admitted to the buffer
    evicts: int = 0             # continual: buffer rows evicted (any tier)
    downdates: int = 0          # continual: committed rows removed via the
                                # decremental downdate path
    resolves: int = 0           # continual: fail-closed full re-solves
    host_syncs: int = 0         # port only: commit-loop device reads

    @property
    def cache_hit_rate(self) -> float:
        tot = self.cache_hits + self.cache_misses
        return self.cache_hits / tot if tot else 0.0

    def summary(self) -> str:
        s = (f"passes={self.passes} rounds={self.rounds} "
             f"certified_rounds={self.certified_rounds} "
             f"refills={self.refills} repairs={self.repairs} "
             f"fetched_rows={self.fetched_rows} "
             f"cache_hit_rate={self.cache_hit_rate:.2f}")
        if self.retries or self.quarantined:
            s += (f" retries={self.retries} "
                  f"quarantined={self.quarantined}")
        if self.resumes:
            s += f" resumes={self.resumes}"
        if self.admits or self.evicts or self.downdates or self.resolves:
            s += (f" admits={self.admits} evicts={self.evicts} "
                  f"downdates={self.downdates} resolves={self.resolves}")
        return s


# The reference's earlier name.
StreamStats = SelectStats


class StreamingPassBudgetError(RuntimeError):
    """Raised when streaming OMP exceeds its ``max_passes`` budget; carries
    the accumulated ``SelectStats`` so the failure is diagnosable."""

    def __init__(self, cap: int, stats: SelectStats):
        self.cap = cap
        self.stats = stats
        super().__init__(
            f"streaming OMP exceeded its pass budget (cap={cap}). "
            f"Solver state at failure: {stats.summary()}. "
            "Is the pool iterator stable across passes?  An adversarial "
            "pool that never certifies needs max_passes >= k + 2.")


class StreamingOMPResult(NamedTuple):
    indices: torch.Tensor   # (k,) int32, -1 on unused slots
    weights: torch.Tensor   # (k,) f32
    mask: torch.Tensor      # (k,) bool
    err: torch.Tensor       # () f32
    stats: SelectStats


def omp_select_streaming(
    pool_iter: Callable[[], Iterator],   # factory of (chunk, valid) iters
    target,                              # (d,) target gradient
    k: int,
    lam: float = 0.5,
    eps: float = 1e-10,
    nnls_iters: int = 50,
    positive: bool = True,
    buffer_size: int = 256,              # M: carried top-M candidate buffer
    chunk_topm: Optional[int] = None,    # m per chunk (default: M)
    block: int = 128,                    # NNLS prefix growth (as omp)
    max_passes: Optional[int] = None,
    score_chunk_fn=None,                 # hook with _score_chunk's contract
    cache: Optional[ChunkCache] = None,  # shared compressed cache
    cache_bytes: int = DEFAULT_CACHE_BYTES,  # budget when cache is None
    row_fetch: Optional[Callable] = None,    # ids -> exact f32 rows
    repair_slots: int = 512,             # annex width for exact-row repairs
    retry: Optional[RetryPolicy] = None,     # transient-fault recovery
    checkpoint_dir: Optional[str] = None,    # mid-solve snapshots
    checkpoint_every: int = 8,           # committed rounds between saves
    resume: bool = True,                 # pick up a prior checkpoint
    device: str | torch.device | None = None,
) -> StreamingOMPResult:
    """OMP over a chunked pool, with ``omp_select``'s selection, on
    ``device`` (``None``: the card).

    ``pool_iter()`` must yield the same chunks in the same order on every
    call.  ``cache``/``cache_bytes`` control the compressed chunk cache
    (``cache_bytes=0`` disables it).  ``row_fetch(ids)`` is the optional
    exact-row gather; without it the repair and refill tiers are skipped
    and every certificate failure costs a loader pass, which is still
    exact.  Transient loader and fetch faults are retried under ``retry``
    (default ``RetryPolicy()``) at whole-pass / fetch granularity; re-read
    chunks and fetched rows are verified against the cache's exact-norm
    sidecars, and rows that keep disagreeing are quarantined, never
    selected.  With ``checkpoint_dir`` the commit-loop state is saved every
    ``checkpoint_every`` committed rounds (between commit blocks, as host
    copies, in the reference's format and keys), and a later call with the
    same arguments resumes from it bit for bit; ``resume=False`` ignores
    an existing snapshot, and one written by an incompatible solve raises.
    """
    dev = resolve_device(device)
    target = torch.as_tensor(target, dtype=torch.float32).to(dev)
    d = target.shape[0]
    k = int(k)
    m_cfg = int(chunk_topm) if chunk_topm is not None else int(buffer_size)
    big_m = int(buffer_size)
    annex = int(repair_slots) if row_fetch is not None else 0
    fmax = min(128, annex) if annex else 0
    absolute = not positive
    scorer = score_chunk_fn if score_chunk_fn is not None else _score_chunk
    if cache is None:
        cache = ChunkCache(int(cache_bytes), d, dev)
    elif cache.device != dev:
        raise ValueError(f"the cache lives on {cache.device}, the solve on "
                         f"{dev}")
    if retry is None:
        retry = RetryPolicy()
    acc = _acc_margin(d)
    f32 = dict(dtype=torch.float32, device=dev)

    st = _Prefix(indices=torch.full((k,), -1, dtype=torch.int32, device=dev),
                 mask=torch.zeros((k,), dtype=torch.bool, device=dev),
                 weights=torch.zeros((k,), **f32),
                 rows=torch.zeros((k, d), **f32),
                 gram=torch.zeros((k, k), **f32),
                 absrow=torch.zeros((k,), **f32),
                 tcorr=torch.zeros((k,), **f32),
                 residual=target, err=(target ** 2).sum())
    err = float(st.err)

    stats = SelectStats()
    cap = int(max_passes) if max_passes is not None else k + 2
    t = 0

    # Buffer (M exact rows + annex repair slots), sketch state, per-solve
    # arena masks (with a scratch slot at position cap_rows).  All built by
    # the first loader pass, or by the warm-cache bootstrap.
    bi = br = bdead = None
    annex_cursor = big_m
    r0 = None
    chunk_thresh = chunk_norm = chunk_cached = None
    chunk_norm_host: list[float] = []
    chunk_meta: list[tuple[int, int]] = []   # (offset, length) per chunk
    ar_taken = ar_inbuf = None
    chunk_off_d = slot_lo_d = None           # device-side chunk map
    num_chunks = 0
    quarantined: set[int] = set()   # global ids failed closed (corruption)
    corrupt_seen: dict[int, int] = {}   # chunk idx -> mismatched reads
    last_ckpt = 0

    def _note_retry(attempt, exc) -> None:
        stats.retries += 1

    def arena_ready() -> bool:
        return cache.cap_rows > 0 and len(cache.entries) > 0

    def _idx(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    def _quarantine(gids_np) -> None:
        """Fail-closed response to persistent corruption: drop the rows
        from every candidate source (arena validity, buffer liveness and,
        through ``quarantined``, later loader passes).  Rows already
        committed were read clean when picked and stay."""
        nonlocal bdead
        fresh = [int(g) for g in np.atleast_1d(np.asarray(gids_np))
                 if g >= 0 and int(g) not in quarantined]
        if not fresh:
            return
        quarantined.update(fresh)
        stats.quarantined = len(quarantined)
        if arena_ready() and chunk_meta:
            cache.quarantine(gids_to_pos(np.asarray(fresh, np.int64)))
        if bi is not None:
            bdead = bdead | torch.isin(bi, _idx(fresh).to(torch.int32))

    def sync_arena_masks() -> None:
        """(Re)size the per-solve arena masks to the arena capacity plus
        the scratch slot, keeping the real entries."""
        nonlocal ar_taken, ar_inbuf
        cap_r = cache.cap_rows
        if ar_taken is None or ar_taken.shape[0] != cap_r + 1:
            old_t, old_i = ar_taken, ar_inbuf
            ar_taken = torch.zeros((cap_r + 1,), dtype=torch.bool,
                                   device=dev)
            ar_inbuf = torch.zeros_like(ar_taken)
            if old_t is not None and old_t.shape[0] <= cap_r + 1:
                keep = old_t.shape[0] - 1          # drop the old scratch
                ar_taken[:keep] = old_t[:keep]
                ar_inbuf[:keep] = old_i[:keep]

    def rebuild_inbuf(ids) -> None:
        """Mark the buffer ids' arena rows in-buffer."""
        nonlocal ar_inbuf
        if ar_inbuf is None:
            return
        ar_inbuf = torch.zeros_like(ar_inbuf)
        _set_drop(ar_inbuf, _idx(gids_to_pos(ids.cpu().numpy())), True)

    def loader_pass() -> bool:
        """Full loader scan: refresh buffer + cache + sketch state; False
        on an empty pool.  Transient iterator faults restart the whole
        scan under the retry policy (the scan's accumulators are local,
        ``cache.offer`` is idempotent for resident chunks, so a restart
        recomputes the identical refresh)."""
        if stats.passes >= cap:
            raise StreamingPassBudgetError(cap, stats)
        return with_retries(_scan_pass, retry, on_retry=_note_retry)

    def _scan_pass() -> bool:
        nonlocal bi, br, bdead, annex_cursor, r0, chunk_thresh
        nonlocal chunk_norm, chunk_cached, num_chunks
        mv = torch.full((big_m,), _NEG_INF, **f32)
        mi = torch.full((big_m,), -1, dtype=torch.int32, device=dev)
        mr = torch.zeros((big_m, d), **f32)
        mok = torch.zeros((big_m,), dtype=torch.bool, device=dev)
        threshs = []
        norms_new = []
        offset = 0
        cidx = 0
        first_visit = len(chunk_norm_host) == 0
        for chunk, cvalid in pool_iter():
            c = int(chunk.shape[0])
            ch, ok, gids = _padded_chunk(chunk, cvalid, offset, dev)
            cpad = ch.shape[0]
            if quarantined:
                ql = [g - offset for g in quarantined
                      if offset <= g < offset + c]
                if ql:
                    ok = ok.clone()
                    ok[_idx(ql)] = False
            if cidx >= len(chunk_meta):
                chunk_meta.append((offset, c))
            slot = cache.slot_of(cidx)
            if slot is not None:
                # Re-read of a resident chunk: verify it against the
                # exact-norm sidecar recorded at first contact.  A mismatch
                # is first a transient misread (the scan restarts); rows
                # that keep disagreeing past the retry budget are
                # quarantined and the scan goes on without them.
                lo = slot * cache.slot_rows
                bad = _verify_norms(ch, ok, cache.norms[lo:lo + cpad])
                bad = bad.cpu().numpy()
                if bad.any():
                    seen = corrupt_seen.get(cidx, 0) + 1
                    corrupt_seen[cidx] = seen
                    if seen <= retry.max_retries:
                        raise CorruptChunkError(
                            f"chunk {cidx} disagrees with its exact-norm "
                            f"sidecar on {int(bad.sum())} row(s) "
                            f"(mismatched read {seen})")
                    _quarantine(offset + np.flatnonzero(bad))
                    ok = ok & ~torch.from_numpy(bad).to(dev)
            m_eff = min(m_cfg, cpad, big_m)
            need_n = cidx >= len(chunk_norm_host)
            vals, ids, rws, rok, cmax, cthresh = scorer(
                ch, ok, gids, offset, st.residual, st.indices, st.mask,
                m=m_eff, absolute=absolute, need_norms=need_n)
            mv, mi, mr, mok = _merge_topm(mv, mi, mr, mok, vals, ids, rws,
                                          rok, size=big_m)
            if need_n:
                norms_new.append(cmax)
            cache.offer(cidx, offset, c, ch, ok, gids)
            threshs.append(cthresh)
            offset += c
            cidx += 1
            stats.chunks += 1
        if offset == 0:
            return False
        stats.pool_size = offset
        if first_visit:
            num_chunks = cidx
        if norms_new:
            chunk_norm_host.extend(torch.stack(norms_new).tolist())
        # A chunk inserted this pass may have evicted an earlier one: the
        # resident set is only final once the pass completes.
        cached_flags = [cache.slot_of(i) is not None for i in range(cidx)]
        # Rows dropped at the merge are bounded by the buffer's min value
        # (-inf while the buffer is not full).
        chunk_thresh = torch.maximum(torch.stack(threshs), mv[big_m - 1])
        chunk_norm = torch.tensor(chunk_norm_host, **f32)
        chunk_cached = torch.tensor(cached_flags, dtype=torch.bool,
                                    device=dev)
        r0 = st.residual
        bi = torch.cat([mi, torch.full((annex,), -1, dtype=torch.int32,
                                       device=dev)])
        br = torch.cat([mr, torch.zeros((annex, d), **f32)])
        # Slots that can never win the argmax: taken/invalid rows and pads
        # scored -inf; annex slots start dead until a repair admits rows.
        bdead = torch.cat([mv == _NEG_INF,
                           torch.ones((annex,), dtype=torch.bool,
                                      device=dev)])
        annex_cursor = big_m
        sync_arena_masks()
        rebuild_inbuf(mi)
        stats.passes += 1
        return True

    def cache_refill() -> bool:
        """Refresh the buffer from the arena (no loader traffic).  Only
        sound when the cache covers every chunk; False when the candidate
        set is empty or oversized and a loader pass is needed."""
        nonlocal bi, br, bdead, annex_cursor, r0, ar_inbuf
        if not (row_fetch is not None and cache.covers(num_chunks)
                and arena_ready()):
            return False
        # Merge deeper than M (keeps the endgame rounds free of offender
        # churn) while two repair batches' worth of annex stays free.
        deep = big_m + max(annex - 2 * fmax, 0)
        cand_cap = min(_bucket(min(4 * big_m, cache.cap_rows)),
                       cache.cap_rows)
        cap_r = cache.cap_rows
        gids, pos, n_cand, n_avail = _arena_refresh_scan(
            cache.rows, cache.norms, cache.errn, cache.gids, cache.ok,
            ar_taken[:cap_r], ar_inbuf[:cap_r], br, bi, bdead, st.residual,
            acc, absolute=absolute, cand_cap=cand_cap, m=deep)
        n_cand, n_avail = torch.stack([n_cand, n_avail]).tolist()
        if n_cand == 0 or n_cand > cand_cap or n_avail == 0:
            return False
        # fb >= n_cand (n_cand <= cand_cap), but the bucket can round past
        # cand_cap when cap_rows is not a power of two.
        fb = min(_bucket(max(n_cand, 1)), cand_cap)
        ids_np = gids[:fb].cpu().numpy()
        fetched, live = checked_fetch(ids_np, pos[:fb].cpu().numpy())
        f_ids = _idx(np.where(live, ids_np, -1)).to(torch.int32)
        mv, mi, mr, mdead, inbuf_new = _refresh_merge(
            fetched, f_ids, f_ids >= 0, br, bi, bdead, st.residual, cap_r,
            chunk_off_d, slot_lo_d, absolute=absolute, m=deep)
        # Outside rows now provably score below the new buffer minimum;
        # the sketch rung is moot while coverage is complete, so only r0
        # needs refreshing.
        r0 = st.residual
        pad = big_m + annex - deep
        bi = torch.cat([mi, torch.full((pad,), -1, dtype=torch.int32,
                                       device=dev)])
        br = torch.cat([mr, torch.zeros((pad, d), **f32)])
        bdead = torch.cat([mdead, torch.ones((pad,), dtype=torch.bool,
                                             device=dev)])
        annex_cursor = deep
        ar_inbuf = inbuf_new
        stats.refills += 1
        stats.fetched_rows += int(live.sum())
        return True

    def checked_fetch(ids_np, pos_np):
        """Exact-row fetch with transient retry and corruption detection.

        Fetched rows whose arena row holds an exact-norm sidecar must
        reproduce it (the fetch contract is the same f32 rows).  Rows that
        disagree are re-fetched under the retry budget; persistent
        disagreement quarantines them, and the returned ``live`` drops
        them.  Entries with id -1 are padding and fetch nothing.  Returns
        (rows (len, d) on the device, live (len,) numpy bool).
        """
        ids_np = np.asarray(ids_np, np.int64)
        pos_np = np.asarray(pos_np, np.int64)
        live = ids_np >= 0
        out = torch.zeros((len(ids_np), d), **f32)
        if not live.any():
            return out, live
        todo = live.copy()
        misreads = 0
        while True:
            sel = np.flatnonzero(todo)
            rows_f = with_retries(
                lambda: _rows(row_fetch(ids_np[sel]), dev), retry,
                on_retry=_note_retry)
            out[_idx(sel)] = rows_f
            if not arena_ready():
                break
            have = pos_np[sel] < cache.cap_rows
            if not have.any():
                break
            ref = cache.norms[_idx(np.clip(pos_np[sel], 0,
                                           cache.cap_rows - 1))].double()
            r64 = rows_f.double()
            nf = torch.sqrt((r64 * r64).sum(dim=1))
            off = ((nf - ref).abs() > 1e-4 * (ref + 1e-6)).cpu().numpy()
            bad = have & off
            if not bad.any():
                break
            misreads += 1
            if misreads > retry.max_retries:
                _quarantine(ids_np[sel[bad]])
                live[sel[bad]] = False
                out[_idx(sel[bad])] = 0.0
                break
            _note_retry(misreads, None)
            retry.sleep(retry.delay(misreads - 1))
            todo = np.zeros_like(todo)
            todo[sel[bad]] = True
        return out, live

    def gids_to_pos(ids_np: np.ndarray) -> np.ndarray:
        """Host map: global ids -> arena rows (``cap_rows``, the masks'
        scratch slot, for dead ids and uncached chunks)."""
        offs = np.asarray([mm[0] for mm in chunk_meta], np.int64)
        slo = np.full((len(chunk_meta),), -1, np.int64)
        for c_i, (slot, _, _) in cache.entries.items():
            if c_i < len(slo):
                slo[c_i] = slot * cache.slot_rows
        j = np.clip(np.searchsorted(offs, ids_np, side="right") - 1, 0,
                    len(offs) - 1)
        pos = slo[j] + ids_np - offs[j]
        return np.where((ids_np >= 0) & (slo[j] >= 0), pos,
                        cache.cap_rows).astype(np.int64)

    def rebuild_taken() -> None:
        """Rebuild the arena taken mask from the committed selection,
        after a loader pass (slot assignments may change); between passes
        the commit loop maintains it."""
        nonlocal ar_taken
        sync_arena_masks()
        sel_np = st.indices.cpu().numpy().astype(np.int64)
        msk_np = st.mask.cpu().numpy()
        pos = np.where(msk_np, gids_to_pos(sel_np), cache.cap_rows)
        ar_taken = torch.zeros_like(ar_taken)
        _set_drop(ar_taken, _idx(pos), True)

    def rebuild_chunk_map() -> None:
        """Device copy of the chunk -> arena-slot map the commit loop uses
        to fold its own picks into the taken mask."""
        nonlocal chunk_off_d, slot_lo_d
        off = np.asarray([mm[0] for mm in chunk_meta] or [0], np.int64)
        slo = np.full((max(num_chunks, 1),), -1, np.int64)
        for c_i, (slot, _, _) in cache.entries.items():
            if c_i < len(slo):
                slo[c_i] = slot * cache.slot_rows
        chunk_off_d = _idx(off)
        slot_lo_d = _idx(slo)

    def capture_tree() -> dict:
        """Everything the commit loop needs to resume bit for bit, under
        the reference's keys: the committed prefix, the buffer and annex,
        the sketch state, the cache's manifest and arena, the per-solve
        arena masks (without their scratch slot), host bookkeeping and
        stats.  Device tensors are copied to the host by the save."""
        tree = {
            "cfg": {"k": np.int64(k), "d": np.int64(d),
                    "big_m": np.int64(big_m), "annex": np.int64(annex),
                    "block": np.int64(block),
                    "absolute": np.int64(absolute),
                    "nnls_iters": np.int64(nnls_iters),
                    "lam": np.float64(lam), "eps": np.float64(eps)},
            "solver": {"t": np.int64(t), "err": np.float64(err),
                       "t_first": np.int64(t_first),
                       "need_refresh": np.int64(need_refresh),
                       "annex_cursor": np.int64(annex_cursor),
                       "num_chunks": np.int64(num_chunks),
                       "indices": st.indices, "mask": st.mask,
                       "weights": st.weights, "rows": st.rows,
                       "gram": st.gram, "absrow": st.absrow,
                       "tcorr": st.tcorr, "residual": st.residual,
                       "r0": r0, "bi": bi, "br": br, "bdead": bdead,
                       "chunk_thresh": chunk_thresh,
                       "chunk_norm": chunk_norm,
                       "chunk_cached": chunk_cached},
            "host": {"chunk_off": np.asarray(
                         [mm[0] for mm in chunk_meta], np.int64),
                     "chunk_len": np.asarray(
                         [mm[1] for mm in chunk_meta], np.int64),
                     "chunk_norm_host": np.asarray(chunk_norm_host,
                                                   np.float64),
                     "quarantined": np.asarray(sorted(quarantined),
                                               np.int64)},
            "stats": {kk: np.int64(vv) for kk, vv in vars(stats).items()},
            "arena": cache.state_dict(),
        }
        if ar_taken is not None:
            cap_r = ar_taken.shape[0] - 1
            tree["masks"] = {"ar_taken": ar_taken[:cap_r],
                             "ar_inbuf": ar_inbuf[:cap_r]}
        return tree

    need_refresh = True
    t_first = -1
    resumed = False
    tree = (load_solver_state(checkpoint_dir)
            if checkpoint_dir is not None and resume else None)
    if tree is not None:
        cfg = tree["cfg"]
        want = {"k": k, "d": d, "big_m": big_m, "annex": annex,
                "block": int(block), "absolute": int(absolute),
                "nnls_iters": int(nnls_iters)}
        got = {kk: int(cfg[kk]) for kk in want}
        if (got != want or float(cfg["lam"]) != float(lam)
                or float(cfg["eps"]) != float(eps)):
            raise ValueError(
                f"checkpoint under {checkpoint_dir!r} was written by an "
                f"incompatible solve (saved {got}, this solve {want}): "
                "pass resume=False or a fresh checkpoint_dir")
        sol = restore_to(tree["solver"], dev)
        t = int(sol["t"])
        err = float(sol["err"])
        t_first = int(sol["t_first"])
        need_refresh = bool(int(sol["need_refresh"]))
        annex_cursor = int(sol["annex_cursor"])
        num_chunks = int(sol["num_chunks"])
        st = _Prefix(indices=sol["indices"], mask=sol["mask"],
                     weights=sol["weights"], rows=sol["rows"],
                     gram=sol["gram"], absrow=sol["absrow"],
                     tcorr=sol["tcorr"], residual=sol["residual"],
                     err=torch.tensor(err, **f32))
        r0, bi, br, bdead = sol["r0"], sol["bi"], sol["br"], sol["bdead"]
        chunk_thresh = sol["chunk_thresh"]
        chunk_norm = sol["chunk_norm"]
        chunk_cached = sol["chunk_cached"]
        host = tree["host"]
        chunk_meta.extend(
            zip(np.asarray(host["chunk_off"]).tolist(),
                np.asarray(host["chunk_len"]).tolist()))
        chunk_norm_host.extend(
            float(x) for x in np.asarray(host["chunk_norm_host"]))
        quarantined.update(int(x) for x in np.asarray(host["quarantined"]))
        for kk, vv in tree["stats"].items():
            setattr(stats, kk, int(vv))
        cache.load_state(tree["arena"])
        if "masks" in tree:
            masks = restore_to(tree["masks"], dev)
            no = torch.zeros((1,), dtype=torch.bool, device=dev)
            ar_taken = torch.cat([masks["ar_taken"], no])
            ar_inbuf = torch.cat([masks["ar_inbuf"], no])
        rebuild_chunk_map()
        stats.resumes += 1
        last_ckpt = t
        resumed = True

    if (not resumed and cache.complete > 0
            and cache.covers(cache.complete) and row_fetch is not None):
        # Bootstrap from a pre-warmed cache (a warming pass already paid
        # the summing pass and filled it): the first buffer refresh is a
        # cache refill, so this solve touches the loader zero times.
        num_chunks = cache.complete
        metas = sorted((c_i, off, ln) for c_i, (slot, off, ln)
                       in cache.entries.items())
        chunk_meta.extend((off, ln) for _, off, ln in metas)
        stats.pool_size = sum(ln for _, _, ln in metas)
        chunk_thresh = torch.zeros((num_chunks,), **f32)   # all cached:
        chunk_norm = torch.zeros((num_chunks,), **f32)     # sketch moot
        chunk_cached = torch.ones((num_chunks,), dtype=torch.bool,
                                  device=dev)
        r0 = target
        bi = torch.full((big_m + annex,), -1, dtype=torch.int32, device=dev)
        br = torch.zeros((big_m + annex, d), **f32)
        bdead = torch.ones((big_m + annex,), dtype=torch.bool, device=dev)
        annex_cursor = big_m + annex
        sync_arena_masks()
        rebuild_chunk_map()

    while t < k and err > eps:
        if need_refresh:
            if not cache_refill():
                if not loader_pass():
                    break
                rebuild_taken()
                rebuild_chunk_map()
            need_refresh = False
            t_first = t
        p = min(k, block * (t // block + 1))
        has_arena = arena_ready()
        fm = min(fmax, cache.cap_rows) if has_arena else 0
        arena = (_Arena(cache.rows, cache.norms, cache.errn, cache.gids,
                        cache.ok, ar_taken, ar_inbuf, chunk_off_d,
                        slot_lo_d) if has_arena else None)
        t_new, go, diag, offs = _commit_rounds(
            br, bi, bdead, st, target, lam, r0, chunk_thresh, chunk_norm,
            chunk_cached, arena, t, p, t_first, eps, acc, stats, p=p,
            nnls_iters=nnls_iters, absolute=absolute, fmax=fm)
        err = float(st.err)
        stats.host_syncs += 1
        committed = t_new - t
        stats.rounds += committed
        certified = committed - (1 if t_first == t and committed > 0
                                 else 0)
        stats.certified_rounds += certified
        stats.cache_hits += certified * len(cache.entries)
        stats.cache_misses += certified * (num_chunks - len(cache.entries))
        t = t_new
        t_first = -1
        if (checkpoint_dir is not None and bi is not None and t > last_ckpt
                and t - last_ckpt >= checkpoint_every):
            save_solver_state(checkpoint_dir, t, capture_tree())
            last_ckpt = t
            stats.checkpoints += 1
        if t >= k or err <= eps:
            break
        if go:
            continue          # block boundary: re-enter at the next p
        # Certification failed at round t; the loop's own scan localized
        # the blockers.  Repair the few offending cached rows when
        # possible, else refresh the buffer.
        maxv, sk_now, _, n_off = diag
        free = big_m + annex - annex_cursor
        if (has_arena and row_fetch is not None
                and 0 < n_off <= min(fm, free)
                and sk_now < maxv and np.isfinite(maxv)):
            gids, a_pos = offs     # from the loop's exit round
            ids_np = gids.cpu().numpy().astype(np.int64)
            pos_np = a_pos.cpu().numpy().astype(np.int64)
            # The worklist is the top-fm rows by upper bound: the true
            # offenders (u >= maxv, first by construction) plus a prefetch
            # band.  Clamp it to the free annex room: admitting past it
            # would mark rows in-buffer arena-side whose buffer writes were
            # dropped, invisible to both scans.  The guard above
            # (n_off <= free) keeps every true offender inside the clamp.
            ids_np[free:] = -1
            pos_np[free:] = cache.cap_rows
            fetched, live = checked_fetch(ids_np, pos_np)
            # Admit the live rows into the annex at the cursor, in order
            # (the reference's scatter with dropped dead entries).
            slots = annex_cursor + np.arange(int(live.sum()))
            keep = np.flatnonzero(live)
            br[_idx(slots)] = fetched[_idx(keep)]
            bi[_idx(slots)] = _idx(ids_np[keep]).to(torch.int32)
            bdead[_idx(slots)] = False
            _set_drop(ar_inbuf, _idx(pos_np[keep]), True)
            annex_cursor += len(keep)
            stats.fetched_rows += len(keep)
            stats.repairs += 1
            continue
        need_refresh = True

    return StreamingOMPResult(st.indices, st.weights, st.mask,
                              st.err.clone(), stats)


# ---------------------------------------------------------------------------
# GRAD-MATCH wrappers
# ---------------------------------------------------------------------------

def gradmatch_streaming(
    pool_iter: Callable[[], Iterator],
    k: int,
    target=None,
    lam: float = 0.5,
    eps: float = 1e-10,
    buffer_size: int = 256,
    chunk_topm: Optional[int] = None,
    score_chunk_fn=None,
    cache: Optional[ChunkCache] = None,
    cache_bytes: int = DEFAULT_CACHE_BYTES,
    row_fetch: Optional[Callable] = None,
    retry: Optional[RetryPolicy] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 8,
    resume: bool = True,
    device: str | torch.device | None = None,
) -> SelectionResult:
    """GRAD-MATCH over a chunked pool on ``device`` (``None``: the card);
    the target defaults to one summing pass, which also warms the
    compressed cache.  The result carries the solver's ``SelectStats``."""
    dev = resolve_device(device)
    if target is None:
        if cache is None:
            first = next(iter(pool_iter()), None)
            if first is None:
                raise ValueError("empty pool iterator")
            cache = ChunkCache(cache_bytes, int(first[0].shape[1]), dev)
        target, _ = streaming_target(pool_iter, cache=cache, retry=retry,
                                     device=dev)
    out = omp_select_streaming(
        pool_iter, target, k, lam=lam, eps=eps, buffer_size=buffer_size,
        chunk_topm=chunk_topm, score_chunk_fn=score_chunk_fn, cache=cache,
        cache_bytes=cache_bytes, row_fetch=row_fetch, retry=retry,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        resume=resume, device=dev)
    return SelectionResult(out.indices, _normalize(out.weights, out.mask),
                           out.mask, out.err, out.stats)


def gradmatch_streaming_array(
    proxies,                 # (n, d) tensor, numpy array or memmap
    k: int,
    target=None,
    valid=None,
    lam: float = 0.5,
    eps: float = 1e-10,
    chunk_size: int = 2048,
    buffer_size: int = 256,
    score_chunk_fn=None,
    cache_bytes: int = DEFAULT_CACHE_BYTES,
    device: str | torch.device | None = None,
) -> SelectionResult:
    """Streaming GRAD-MATCH over an explicit array, chunked on the fly, on
    the device of ``proxies`` when it is a tensor (else ``device``, whose
    ``None`` is the card).

    The target matches ``gradmatch``'s (full-matrix sum), so the two paths
    agree on pools the in-memory solver can hold; the array doubles as the
    exact-row fetch for the repair and refill tiers.
    """
    dev = (proxies.device if isinstance(proxies, torch.Tensor)
           else resolve_device(device))
    if target is None:
        g = _rows(proxies, dev)
        if valid is None:
            target = g.sum(dim=0)
        else:
            target = (g * _flags(valid, dev)[:, None].to(g.dtype)).sum(dim=0)
    out = omp_select_streaming(
        array_chunks(proxies, chunk_size, valid=valid), target, k, lam=lam,
        eps=eps, buffer_size=buffer_size, score_chunk_fn=score_chunk_fn,
        cache_bytes=cache_bytes, row_fetch=array_row_fetch(proxies),
        device=dev)
    return SelectionResult(out.indices, _normalize(out.weights, out.mask),
                           out.mask, out.err, out.stats)
