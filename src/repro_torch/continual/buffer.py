"""Bounded-buffer continual selection, after ``repro/continual/buffer.py``
(DESIGN.md §11).

A continual-learning tenant streams gradient batches forever; the buffer
holds at most ``capacity`` rows yet keeps its committed ``k``-subset
exact: index-identical (weights to tolerance) to a fresh OMP solve over
the rows that survive in the buffer.  The pieces, the reference's:

* **Storage** is the ``ChunkCache`` arena layout (``_compress_chunk``,
  ``_bucket``): bf16 rows with f32 exact-norm and compression-error
  sidecars, gid / ok sidecars on the host.  The solver sees the f32 pool
  view of the stored rows (what is stored is what is solved).
* **Admission** scores each batch against the recorded residual
  trajectory (``decremental.certify_admission``); the earliest round that
  cannot be certified is where the replay starts (round 0: a re-solve).
* **Eviction** takes free slots first, then non-committed rows (free:
  they won no argmax), picked by a seeded Gumbel top-m over their current
  residual scores, and only then committed rows, lowest recorded gain
  first, through the downdate path (truncate + replay).
* **Narrow regime**: the session block is rounded up past the proxy width
  (``128·⌈(d+1)/128⌉``), so the session engine never builds the column
  cache: every round scores the live pool view (``corr_argmax`` over
  ``(capacity, d)``), and a slot overwrite needs no cache patching.

The arena, the pool view and the session live on ``device`` (``None``:
the card); the gid / ok sidecars, the trace and the eviction draws are
host numpy, as in the reference, so the port evicts the rows the
reference evicts.  ``checkpoint_dir`` snapshots the arena, the session
buffers, the trace and the counters every ``checkpoint_every`` batches,
in the reference's keys; a killed stream resumes bit for bit through
``restore`` (the admission RNG is keyed on ``(seed, batch_counter)``).
"""

from __future__ import annotations

from dataclasses import fields
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import restore_to
from repro_torch.checkpoint.solver_state import (load_solver_state,
                                                 save_solver_state)
from repro_torch.core import decremental as dec
from repro_torch.core.distributed import _device_of
from repro_torch.core.gradmatch import SelectionResult, _normalize
from repro_torch.core.omp import (OMPAnytimeState, OMPIncState, _block_cap,
                                  _empty_inc_state)
from repro_torch.core.streaming import (SelectStats, _bucket,
                                        _compress_chunk, _pad_rows, _rows)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = ["BufferMaintainer", "continual_select"]

_ST_FIELDS = tuple(f.name for f in fields(OMPIncState))


def _soft_lowest(scores: np.ndarray, m: int, rng: np.random.Generator,
                 temp: float) -> np.ndarray:
    """Sample ``m`` entries biased toward the lowest scores: Gumbel top-m
    over ``-scores / temp`` (sampling without replacement from
    softmax(-scores / temp)), a seeded tie-breaker."""
    if m >= scores.shape[0]:
        return np.arange(scores.shape[0])
    keys = -scores / max(temp, 1e-12) + rng.gumbel(size=scores.shape[0])
    return np.sort(np.argpartition(keys, -m)[-m:])


def _vec(x, device: torch.device) -> torch.Tensor:
    """A (d,) f32 vector on ``device``, never sharing the caller's
    memory."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(np.asarray(t).nbytes)


class BufferMaintainer:
    """Fixed-capacity row buffer maintaining an exact OMP coreset."""

    def __init__(self, capacity: int, d: int, target, k: int, *,
                 lam: float = 0.5, eps: float = 1e-10, nnls_iters: int = 50,
                 positive: bool = True, compress: bool = True, seed: int = 0,
                 evict_temp: float = 1.0, band_rel: float = 1e-4,
                 band_abs: float = 1e-6, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 device: str | torch.device | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.d = int(d)
        self.k = int(k)
        self.lam = float(lam)
        self.eps = float(eps)
        self.nnls_iters = int(nnls_iters)
        self.positive = bool(positive)
        self.compress = bool(compress)
        self.seed = int(seed)
        self.evict_temp = float(evict_temp)
        self.band_rel = float(band_rel)
        self.band_abs = float(band_abs)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        # Force the narrow regime: a block wider than d means the session
        # engine never allocates the (n, P) column cache.
        self.block = 128 * (-(-(self.d + 1) // 128))
        self.target = _vec(target, self.device)
        if self.target.shape != (self.d,):
            raise ValueError(
                f"target shape {tuple(self.target.shape)} != ({self.d},)")
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        self._rows_bf = torch.zeros((self.capacity, self.d),
                                    dtype=torch.bfloat16, device=dev)
        self._norms = torch.zeros((self.capacity,), **f32)
        self._errn = torch.zeros((self.capacity,), **f32)
        self._gids = np.full((self.capacity,), -1, np.int64)
        self._ok = np.zeros((self.capacity,), bool)
        self._pool = torch.zeros((self.capacity, self.d), **f32)
        self._sess = OMPAnytimeState(
            k=0, block=self.block,
            st=_empty_inc_state(_block_cap(self.k, self.block),
                                self.capacity, self.d, self.target),
            c0=torch.zeros((self.capacity,), **f32),
            target=self.target,
            valid=torch.zeros((self.capacity,), dtype=torch.bool,
                              device=dev),
            lam=self.lam, eps=self.eps, nnls_iters=self.nnls_iters,
            positive=self.positive)
        self._trace = dec._empty_trace(self.d)
        self.stats = SelectStats(pool_size=self.capacity)
        self.batches = 0
        self._next_gid = 0

    def _ok_tensor(self) -> torch.Tensor:
        return torch.from_numpy(self._ok.copy()).to(self.device)

    # -- admission ----------------------------------------------------------

    def admit(self, rows, gids=None) -> dict:
        """Admit one incoming batch (a tensor or a host array); returns an
        accounting dict.

        Batches larger than the buffer are folded in ``capacity``-row
        waves.  ``gids`` default to a running global counter.
        """
        rows = _rows(rows, self.device)
        if rows.ndim != 2 or rows.shape[1] != self.d:
            raise ValueError(
                f"batch shape {tuple(rows.shape)} incompatible with "
                f"d={self.d}")
        b = rows.shape[0]
        if gids is None:
            gids = np.arange(self._next_gid, self._next_gid + b,
                             dtype=np.int64)
        else:
            gids = np.asarray(gids, np.int64)
            if gids.shape != (b,):
                raise ValueError(f"gids shape {gids.shape} != ({b},)")
        self._next_gid = max(self._next_gid, int(gids.max()) + 1 if b else 0)
        report = {"admitted": 0, "evicted": 0, "downdates": 0,
                  "replayed_from": self._sess.k}
        for lo in range(0, b, self.capacity):
            sub = self._admit_wave(rows[lo:lo + self.capacity],
                                   gids[lo:lo + self.capacity])
            report["admitted"] += sub["admitted"]
            report["evicted"] += sub["evicted"]
            report["downdates"] += sub["downdates"]
            report["replayed_from"] = min(report["replayed_from"],
                                          sub["replayed_from"])
        if b == 0:
            return report
        self.batches += 1
        if self.checkpoint_dir and self.batches % self.checkpoint_every == 0:
            self.save_checkpoint()
        return report

    def _committed_rounds(self) -> dict:
        """slot -> earliest committed round (degenerate re-picks map to
        the slot's first, real round)."""
        ind = self._sess.indices.cpu().numpy()
        msk = self._sess.mask.cpu().numpy()
        rounds: dict = {}
        for t in np.nonzero(msk)[0]:
            rounds.setdefault(int(ind[t]), int(t))
        return rounds

    def _admit_wave(self, rows: torch.Tensor, gids: np.ndarray) -> dict:
        b = rows.shape[0]
        if b == 0:
            return {"admitted": 0, "evicted": 0, "downdates": 0,
                    "replayed_from": self._sess.k}
        dev = self.device
        rng = np.random.default_rng((self.seed, self.batches))
        rounds = self._committed_rounds()

        # 1) victims: free slots first, then non-committed residents
        #    (free evictions), then committed rows via the downdate path.
        free = np.nonzero(~self._ok)[0]
        n_free = min(b, free.size)
        need = b - n_free
        victims = np.empty((0,), np.int64)
        n_down = 0
        t_evict = self._sess.k
        if need > 0:
            occupied = np.nonzero(self._ok)[0]
            committed = np.fromiter(rounds.keys(), np.int64,
                                    count=len(rounds))
            is_comm = np.isin(occupied, committed)
            noncomm = occupied[~is_comm]
            take_nc = min(need, noncomm.size)
            picks = []
            if take_nc:
                # host numpy scores, the reference's arithmetic
                resid = self._sess.st.residual.cpu().numpy().astype(
                    np.float32)
                sc = self._pool.cpu().numpy()[noncomm] @ resid
                if not self.positive:
                    sc = np.abs(sc)
                picks.append(noncomm[_soft_lowest(sc, take_nc, rng,
                                                  self.evict_temp)])
            n_down = need - take_nc
            if n_down > 0:
                comm = occupied[is_comm]
                gains = np.array([self._trace.win[rounds[int(s)]]
                                  for s in comm], np.float32)
                sel = comm[_soft_lowest(gains, n_down, rng, self.evict_temp)]
                picks.append(sel)
                t_evict = min(rounds[int(s)] for s in sel)
            victims = np.concatenate(picks) if picks else victims

        # 2) write newcomers into victim + free slots (bf16 + sidecars),
        #    patch the pool view and the session's c0.
        slots = np.sort(np.concatenate([free[:n_free], victims]))
        cpad = _bucket(b)
        padded = _pad_rows(rows, cpad)
        rows_bf, norms, errn = _compress_chunk(
            padded, torch.arange(cpad, device=dev) < b)
        rows_bf, norms, errn = rows_bf[:b], norms[:b], errn[:b]
        stored = rows_bf.float() if self.compress else rows
        sl = torch.as_tensor(slots, device=dev)
        self._rows_bf[sl] = rows_bf
        self._norms[sl] = norms
        self._errn[sl] = errn
        self._pool[sl] = stored
        self._gids[slots] = gids
        self._ok[slots] = True
        new_c0 = self._sess.c0.clone()
        new_c0[sl] = ops.corr(stored.contiguous(), self.target)

        # 3) earliest round the admission can disturb: committed-victim
        #    rounds and the earliest certificate violation (0: re-solve).
        t_cert = dec.certify_admission(
            stored.cpu().numpy(), self._trace, self._sess.k,
            positive=self.positive, band_rel=self.band_rel,
            band_abs=self.band_abs)
        t_star = min(t_evict, t_cert)

        k_before = self._sess.k
        sess = self._sess._replace(c0=new_c0, valid=self._ok_tensor())
        trace = self._trace
        if t_star < sess.k:
            if t_star == 0 and k_before > 0:
                self.stats.resolves += 1
            sess = dec.session_truncate(sess, t_star)
            trace = dec.ReplayTrace(resid=trace.resid[:t_star],
                                    win=trace.win[:t_star])
        sess, trace = dec.session_extend_traced(self._pool, sess, self.k,
                                                trace)
        self._sess, self._trace = sess, trace

        self.stats.admits += b
        self.stats.evicts += int(victims.size)
        self.stats.downdates += n_down
        self.stats.rounds += self.k - t_star
        return {"admitted": b, "evicted": int(victims.size),
                "downdates": n_down, "replayed_from": t_star}

    # -- retraction ---------------------------------------------------------

    def invalidate(self, gids) -> int:
        """Drop buffer rows by gid (upstream retractions).  Non-committed
        rows leave for free; committed rows go through the decremental
        path.  Returns the number of rows dropped."""
        drop = np.isin(self._gids, np.asarray(gids)) & self._ok
        slots = np.nonzero(drop)[0]
        if slots.size == 0:
            return 0
        rounds = self._committed_rounds()
        hit = [rounds[int(s)] for s in slots if int(s) in rounds]
        self._ok[slots] = False
        sess = self._sess._replace(valid=self._ok_tensor())
        if hit:
            t_star = min(hit)
            if t_star == 0 and self._sess.k > 0:
                self.stats.resolves += 1
            self.stats.downdates += len(hit)
            self.stats.rounds += self.k - t_star
            sess = dec.session_truncate(sess, t_star)
            trace = dec.ReplayTrace(resid=self._trace.resid[:t_star],
                                    win=self._trace.win[:t_star])
            sess, trace = dec.session_extend_traced(self._pool, sess,
                                                    self.k, trace)
            self._trace = trace
        self._sess = sess
        self.stats.evicts += int(slots.size)
        return int(slots.size)

    # -- results ------------------------------------------------------------

    def slot_result(self):
        """Raw slot-space solution ``(indices, weights, mask, err)``: the
        view to compare against a fresh solve over ``pool_view()``."""
        return (self._sess.indices, self._sess.weights, self._sess.mask,
                self._sess.err)

    def result(self) -> SelectionResult:
        """Committed coreset in gid space, weights normalized."""
        idx = self._sess.indices
        mask = self._sess.mask
        gids = torch.from_numpy(self._gids.astype(np.int32)).to(self.device)
        gid_idx = torch.where(mask, gids[torch.where(mask, idx, 0).long()],
                              -1).to(torch.int32)
        return SelectionResult(gid_idx,
                               _normalize(self._sess.weights, mask), mask,
                               self._sess.err, stats=self.stats)

    def pool_view(self):
        """(f32 pool, ok mask): what a fresh solve sees."""
        return self._pool, self._ok_tensor()

    def memory_bytes(self) -> int:
        """Resident bytes: arena + sidecars + f32 pool view + session
        prefix buffers + trace; flat in the number of admitted batches."""
        arena = sum(_nbytes(x) for x in (self._rows_bf, self._norms,
                                         self._errn, self._gids, self._ok,
                                         self._pool))
        st = self._sess.st
        sess = sum(_nbytes(getattr(st, f)) for f in _ST_FIELDS
                   if f != "err") + _nbytes(self._sess.c0) + _nbytes(
            self._sess.valid)
        trace = self._trace.resid.nbytes + self._trace.win.nbytes
        return int(arena + sess + trace)

    # -- checkpoint / resume ------------------------------------------------

    def state_dict(self) -> dict:
        """The snapshot tree, the reference's keys (device tensors are
        copied to the host by the save)."""
        st = self._sess.st
        return {
            "config": {
                "capacity": np.int64(self.capacity), "d": np.int64(self.d),
                "k": np.int64(self.k), "block": np.int64(self.block),
                "lam": np.float64(self.lam), "eps": np.float64(self.eps),
                "nnls_iters": np.int64(self.nnls_iters),
                "positive": np.bool_(self.positive),
                "compress": np.bool_(self.compress),
                "seed": np.int64(self.seed),
                "evict_temp": np.float64(self.evict_temp),
                "band_rel": np.float64(self.band_rel),
                "band_abs": np.float64(self.band_abs),
                "checkpoint_every": np.int64(self.checkpoint_every),
            },
            "arena": {
                "rows_bf": self._rows_bf, "norms": self._norms,
                "errn": self._errn, "gids": self._gids.copy(),
                "ok": self._ok.copy(), "pool": self._pool,
            },
            "session": {
                "k": np.int64(self._sess.k),
                "c0": self._sess.c0,
                "valid": self._sess.valid,
                "target": self.target,
                "st": {f: getattr(st, f) for f in _ST_FIELDS},
            },
            "trace": {"resid": self._trace.resid, "win": self._trace.win},
            "counters": {
                "batches": np.int64(self.batches),
                "next_gid": np.int64(self._next_gid),
                "admits": np.int64(self.stats.admits),
                "evicts": np.int64(self.stats.evicts),
                "downdates": np.int64(self.stats.downdates),
                "resolves": np.int64(self.stats.resolves),
                "rounds": np.int64(self.stats.rounds),
                "checkpoints": np.int64(self.stats.checkpoints),
                "resumes": np.int64(self.stats.resumes),
            },
        }

    def save_checkpoint(self) -> str:
        if not self.checkpoint_dir:
            raise ValueError("no checkpoint_dir configured")
        path = save_solver_state(self.checkpoint_dir, self.batches,
                                 self.state_dict())
        self.stats.checkpoints += 1
        return path

    def _load_tree(self, tree: dict) -> None:
        dev = self.device
        ar = tree["arena"]
        arena = restore_to({k: ar[k] for k in ("rows_bf", "norms", "errn",
                                               "pool")}, dev)
        self._rows_bf, self._norms = arena["rows_bf"], arena["norms"]
        self._errn, self._pool = arena["errn"], arena["pool"]
        self._gids = np.asarray(ar["gids"], np.int64)
        self._ok = np.asarray(ar["ok"], bool)
        se = tree["session"]
        st = OMPIncState(**restore_to(se["st"], dev))
        self._sess = self._sess._replace(
            k=int(se["k"]), st=st, c0=restore_to(se["c0"], dev),
            valid=restore_to(se["valid"], dev))
        self._trace = dec.ReplayTrace(
            resid=np.asarray(tree["trace"]["resid"], np.float32).reshape(
                -1, self.d),
            win=np.asarray(tree["trace"]["win"], np.float32).reshape(-1))
        ct = tree["counters"]
        self.batches = int(ct["batches"])
        self._next_gid = int(ct["next_gid"])
        for f in ("admits", "evicts", "downdates", "resolves", "rounds",
                  "checkpoints", "resumes"):
            setattr(self.stats, f, int(ct[f]))
        self.stats.resumes += 1

    @classmethod
    def restore(cls, checkpoint_dir: str,
                device: str | torch.device | None = None
                ) -> "Optional[BufferMaintainer]":
        """Resume a killed stream bit for bit on ``device`` (``None``: the
        card); ``None`` if nothing was saved."""
        tree = load_solver_state(checkpoint_dir)
        if tree is None:
            return None
        cfg = tree["config"]
        m = cls(capacity=int(cfg["capacity"]), d=int(cfg["d"]),
                target=np.asarray(tree["session"]["target"]),
                k=int(cfg["k"]), lam=float(cfg["lam"]), eps=float(cfg["eps"]),
                nnls_iters=int(cfg["nnls_iters"]),
                positive=bool(cfg["positive"]),
                compress=bool(cfg["compress"]), seed=int(cfg["seed"]),
                evict_temp=float(cfg["evict_temp"]),
                band_rel=float(cfg["band_rel"]),
                band_abs=float(cfg["band_abs"]),
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=int(cfg["checkpoint_every"]),
                device=device)
        if m.block != int(cfg["block"]):
            raise ValueError(
                f"checkpoint block {int(cfg['block'])} != derived {m.block}")
        m._load_tree(tree)
        return m


def continual_select(proxies, k: int, *, target=None,
                     capacity: Optional[int] = None,
                     batch: Optional[int] = None, lam: float = 0.5,
                     eps: float = 1e-10, seed: int = 0,
                     device: str | torch.device | None = None
                     ) -> SelectionResult:
    """In-memory driver for strategy ``"gradmatch-continual"``, on the
    pool's device (a tensor's, else ``device``, whose ``None`` is the
    card).

    Streams the proxy matrix through a ``BufferMaintainer`` in admission
    batches.  With ``capacity=None`` the buffer covers the whole pool
    (nothing is evicted) and the selection is pooled ``gradmatch``'s; a
    smaller ``capacity`` selects over the surviving rows.  ``compress`` is
    off here, so the buffer solves the caller's exact f32 rows.
    """
    dev = _device_of(proxies, device)
    g = _rows(proxies, dev)
    n, d = g.shape
    cap = n if capacity is None else int(capacity)
    bs = min(n, 256) if batch is None else int(batch)
    tgt = g.sum(dim=0) if target is None else _vec(target, dev)
    m = BufferMaintainer(capacity=cap, d=d, target=tgt, k=k, lam=lam,
                         eps=eps, compress=False, seed=seed, device=dev)
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        m.admit(g[lo:hi], gids=np.arange(lo, hi, dtype=np.int64))
    return m.result()
