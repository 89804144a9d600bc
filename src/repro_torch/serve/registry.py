"""Pool registry: admit a candidate pool once, serve many requests off it,
after ``repro/serve/registry.py``.

The selection service (DESIGN.md §6) is multi-tenant over *shared* pools:
B concurrent requests against the same pool share one solve.  The
registry is where "the same pool" is established and where everything
derivable from the pool alone is computed once and cached:

* a content **fingerprint** (shape/dtype + sampled row bytes, folded with
  the validity mask), so a client re-registering identical data gets the
  existing ``pool_id`` back instead of a duplicate device copy;
* the full-content **digest**, the artifact key (SHA-256 over every byte);
* the default GRAD-MATCH **target** ``sum_i g_i`` (eq. 2 of the paper),
  summed on the device;
* lazily, the CRAIG **FL scan** (``greedy.resolve_fl_scan``): a resident
  ``(n, n)`` similarity under the greedy engine's cutover, else the
  ``l_max`` offset for the on-the-fly scan.

Both hashes read host bytes: an array pool is copied to the host as f32
numpy once at admission (one device-to-host copy of a tensor pool), and
the device keeps its own copy, on the registry's device (``None``: the
card).

Pools come in two kinds: ``"array"`` (an in-memory ``(n, d)`` proxy
matrix, device-resident, batchable) and ``"chunked"`` (a
``data.loader.ChunkedPool`` or a chunk factory, served through the
streaming block-OMP one request at a time; its default target costs one
summing pass that also warms the compressed chunk cache).

Eviction is LRU over registered pools (``max_pools``).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.artifacts.store import content_digest_array, host_array
from repro_torch.core import greedy as greedy_lib
from repro_torch.core import streaming as stream_lib
from repro_torch.device import resolve_device
from repro_torch.resilience.faults import TransientFault


class UnknownPool(KeyError):
    """Raised for a ``pool_id`` that was never registered or was evicted."""


def _fingerprint_array(x, sample_rows: int = 64) -> str:
    """Content hash over shape/dtype + up to ``sample_rows`` strided rows
    of a host array (a tensor is copied to the host first).

    Sampling keeps admission O(sample·d) for huge pools; strided rows catch
    the "same head, different tail" case.  **Never** an artifact key: two
    pools differing outside the sampled rows must not share a durable
    artifact, so those are keyed by ``PoolEntry.content_digest``.
    """
    x = host_array(x)
    h = hashlib.sha1()
    h.update(repr((x.shape, str(x.dtype))).encode())
    n = x.shape[0]
    step = max(n // sample_rows, 1)
    sample = np.ascontiguousarray(x[::step][:sample_rows])
    h.update(sample.tobytes())
    return h.hexdigest()[:16]


def _fold_valid(fp: str, valid) -> str:
    """Fold the validity mask into a content fingerprint: the same rows
    under a different mask are a different pool."""
    if valid is None:
        return fp
    v = host_array(valid, bool)
    return hashlib.sha1(
        (fp + "+valid").encode() + v.tobytes()).hexdigest()[:16]


@dataclass
class PoolEntry:
    pool_id: str
    kind: str                      # "array" | "chunked"
    n: int
    d: int
    fingerprint: str
    device: torch.device = torch.device("cpu")
    # Full-content SHA-256 over every pool byte + the validity mask: the
    # artifact key.  None for chunked pools (no artifact fast path).
    content_digest: Optional[str] = None
    grads: Optional[torch.Tensor] = None         # array pools, (n, d) f32
    chunk_iter: Optional[Callable] = None        # chunked pools: factory
    valid: Optional[torch.Tensor] = None         # (n,) bool or None
    target_sum: Optional[torch.Tensor] = None    # (d,) default target
    # Chunked pools: the compressed chunk cache warmed by the admission
    # pass and shared by every streaming request, plus the exact-row
    # fetch for the engine's repair/refill tiers (None for factories).
    cache: Optional[stream_lib.ChunkCache] = field(default=None,
                                                   repr=False)
    row_fetch: Optional[Callable] = field(default=None, repr=False)
    # Partition count for "gradmatch-partitioned" requests (0 = auto).
    partitions: int = 0
    # Async admission (DESIGN.md §10): "warm", "warming" (the summing pass
    # is stepped off the drain path), or "failed".
    warm_state: str = "warm"
    warm_error: Optional[str] = None
    warmed_chunks: int = 0
    _warm: Optional[Iterator] = field(default=None, repr=False)
    # CRAIG scan cache, resolved lazily on the first craig request:
    _fl: Optional[tuple] = field(default=None, repr=False)

    @property
    def batchable(self) -> bool:
        return self.kind == "array"

    def fl_scan(self, method: str = "lazy"):
        """(sim | None, l_max, on_the_fly) for the greedy engine: resolved
        once per pool and reused by every CRAIG request against it."""
        if self.kind != "array":
            raise UnknownPool(
                f"pool {self.pool_id!r} is chunked: CRAIG requests need a "
                "resident pool")
        if self._fl is None:
            self._fl = greedy_lib.resolve_fl_scan(self.grads, None, method)
        return self._fl


def _warm_steps(entry: PoolEntry, chunk_iter: Callable,
                cache: Optional[stream_lib.ChunkCache], retry,
                n_expect: int) -> Iterator[None]:
    """Incremental twin of ``streaming_target``: one summed and cached
    chunk per ``next()``, so the admission pass can be advanced off the
    drain path.  A transient fault restarts the pass up to ``retry``'s
    budget; permanent faults propagate to ``step_warm``.  On completion
    the entry flips to ``warm_state="warm"`` with its target installed.
    """
    dev = entry.device
    attempt = 0
    while True:
        total = None
        count = 0
        idx = 0
        try:
            for chunk, v in chunk_iter():
                c = stream_lib._rows(chunk, dev)
                if v is not None:
                    c = c * stream_lib._flags(v, dev)[:, None].to(
                        torch.float32)
                s = c.sum(dim=0)
                total = s if total is None else total + s
                stream_lib.offer_chunk(cache, idx, count, chunk, v)
                count += chunk.shape[0]
                idx += 1
                entry.warmed_chunks = idx
                yield
            break
        except TransientFault:
            if retry is None or attempt >= retry.max_retries:
                raise
            retry.sleep(retry.delay(attempt))
            attempt += 1
    if total is None:
        raise ValueError("empty pool iterator")
    if count != n_expect:
        raise ValueError(
            f"deferred-warm row count mismatch: admission said "
            f"{n_expect} rows, the pass saw {count}: the fingerprint "
            "and cost estimates are wrong; re-register with the true n")
    if cache is not None and cache.covers(idx):
        cache.complete = idx
    entry.target_sum = total
    entry.warm_state = "warm"


class PoolRegistry:
    """Admit pools once; hand out cached entries by ``pool_id``.

    Pools live on ``device`` (``None``: the card; a missing card raises).
    With ``artifacts`` (a ``repro_torch.artifacts.ArtifactStore``), array
    pools get the offline fast path (DESIGN.md §12): ``artifact_lookup``
    answers a (pool, params, target) ask from a *verified* precomputed
    trajectory, memoized in memory so repeat hits are a dict probe and a
    slice.  Verification failures quarantine on the spot and report a
    miss (the scheduler falls through to the live solver).
    """

    def __init__(self, max_pools: int = 8, artifacts=None,
                 device: str | torch.device | None = None):
        self.max_pools = int(max_pools)
        self.artifacts = artifacts
        self.device = resolve_device(device)
        self._pools: OrderedDict[str, PoolEntry] = OrderedDict()
        self._by_fp: dict[str, str] = {}
        self.evictions = 0
        # ident -> verified SelectionArtifact; idents never verify twice.
        self._art_memo: dict[str, object] = {}
        self.art_hits = 0
        self.art_misses = 0
        self.art_quarantined = 0

    # -- admission -----------------------------------------------------------
    def register(self, pool, pool_id: Optional[str] = None,
                 valid=None, partitions: int = 0) -> str:
        """Admit an in-memory ``(n, d)`` proxy pool (a tensor or a host
        array); returns its id.

        Both hashes are taken from one host copy of the pool; the device
        copy is made from the pool itself, and is a copy even where the
        pool already lies there (the registry owns what it hashed).
        Re-registering content with a known fingerprint returns the
        existing id unless an explicit distinct ``pool_id`` is given.
        ``partitions`` configures how "gradmatch-partitioned" requests
        split this pool (0 = auto).
        """
        x = host_array(pool)
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError(f"pool must be (n, d), got {x.shape}")
        fp = _fold_valid(_fingerprint_array(x), valid)
        known = self._by_fp.get(fp)
        if known is not None and known in self._pools and pool_id is None:
            self._pools.move_to_end(known)
            return known
        pid = pool_id or f"pool-{fp}"
        dev = self.device
        src = (pool.detach() if isinstance(pool, torch.Tensor)
               else torch.from_numpy(x))
        g = src.to(dev, torch.float32, copy=True).contiguous()
        v = None if valid is None else torch.as_tensor(
            host_array(valid, bool), device=dev)
        gv = g if v is None else g * v[:, None].to(g.dtype)
        entry = PoolEntry(
            pool_id=pid, kind="array", n=x.shape[0], d=x.shape[1],
            fingerprint=fp, device=dev,
            content_digest=content_digest_array(x, valid),
            grads=g, valid=v, target_sum=gv.sum(dim=0),
            partitions=int(partitions),
        )
        self._admit(pid, fp, entry)
        return pid

    def register_chunked(self, pool, pool_id: Optional[str] = None,
                         valid=None,
                         cache_bytes: int = stream_lib.DEFAULT_CACHE_BYTES,
                         retry=None, partitions: int = 0,
                         warm: str = "sync",
                         n: Optional[int] = None) -> str:
        """Admit a ``ChunkedPool`` (or any ``(chunk, valid)`` factory).

        The default target is one summing pass on the registry's device,
        and the same pass warms the pool's compressed chunk cache, so the
        admission scan is never re-paid.  ``retry`` (a
        ``RetryPolicy``) rides the pass through transient loader faults.

        ``warm="sync"`` runs that pass here; ``warm="deferred"`` (DESIGN.md
        §10) admits in the ``"warming"`` state and leaves the pass to
        ``step_warm``, chunk by chunk, off the drain path.  Deferred
        admission needs the row count up front (``ChunkedPool.n``, or
        ``n=`` for factory pools): the fingerprint folds it in.
        """
        if warm not in ("sync", "deferred"):
            raise ValueError(f"warm must be 'sync' or 'deferred', "
                             f"got {warm!r}")
        if callable(pool):
            if valid is not None:
                raise ValueError(
                    "valid= is only supported for ChunkedPool admission; "
                    "bake the mask into a custom chunk factory's (chunk, "
                    "valid) pairs instead")
            chunk_iter = pool
            row_fetch = None
            n_known = None if n is None else int(n)
        else:
            chunk_iter = stream_lib.chunked_pool_iter(pool, valid=valid)
            row_fetch = stream_lib.array_row_fetch(pool.x)
            n_known = int(pool.n)
        first = next(iter(chunk_iter()), None)
        if first is None:
            raise ValueError("empty pool iterator")
        first_chunk = first[0]
        dev = self.device
        d = int(first_chunk.shape[1])
        cache = stream_lib.ChunkCache(int(cache_bytes), d, dev)
        if warm == "sync":
            target, n_rows = stream_lib.streaming_target(
                chunk_iter, cache=cache, retry=retry, device=dev)
        else:
            if n_known is None:
                raise ValueError(
                    "warm='deferred' needs n= for factory pools: the row "
                    "count is part of the fingerprint and is otherwise "
                    "only known after the summing pass")
            target, n_rows = None, n_known
        fp_src = host_array(first_chunk)
        fp = hashlib.sha1(
            repr((n_rows, fp_src.shape)).encode()
            + _fingerprint_array(fp_src).encode()).hexdigest()[:16]
        fp = _fold_valid(fp, valid)
        known = self._by_fp.get(fp)
        if known is not None and known in self._pools and pool_id is None:
            self._pools.move_to_end(known)
            return known
        pid = pool_id or f"chunked-{fp}"
        entry = PoolEntry(pool_id=pid, kind="chunked", n=int(n_rows), d=d,
                          fingerprint=fp, device=dev,
                          chunk_iter=chunk_iter, target_sum=target,
                          cache=cache, row_fetch=row_fetch,
                          partitions=int(partitions))
        if warm == "deferred":
            entry.warm_state = "warming"
            entry._warm = _warm_steps(entry, chunk_iter, cache, retry,
                                      int(n_rows))
        self._admit(pid, fp, entry)
        return pid

    # -- async warming (DESIGN.md §10) ---------------------------------------
    def step_warm(self, pool_id: str, max_chunks: int = 8) -> bool:
        """Advance a deferred admission pass by up to ``max_chunks``
        chunks; returns True once the pool is no longer warming.  A
        permanent warm failure is recorded on the entry
        (``warm_state="failed"``, ``warm_error``), not raised."""
        entry = self._pools.get(pool_id)
        if entry is None or entry.warm_state != "warming" \
                or entry._warm is None:
            return True
        try:
            for _ in range(int(max_chunks)):
                next(entry._warm)
        except StopIteration:
            entry._warm = None
        except Exception as exc:
            entry.warm_state = "failed"
            entry.warm_error = f"{type(exc).__name__}: {exc}"
            entry._warm = None
        return entry.warm_state != "warming"

    def warming(self) -> list[str]:
        return [pid for pid, e in self._pools.items()
                if e.warm_state == "warming"]

    def _admit(self, pid: str, fp: str, entry: PoolEntry) -> None:
        # Re-registering an explicit pool_id with different content also
        # retires the replaced content's fingerprint.
        old = self._pools.get(pid)
        if old is not None and old.fingerprint != fp:
            if self._by_fp.get(old.fingerprint) == pid:
                del self._by_fp[old.fingerprint]
        self._pools[pid] = entry
        self._pools.move_to_end(pid)
        self._by_fp[fp] = pid
        while len(self._pools) > self.max_pools:
            old_id, old = self._pools.popitem(last=False)
            self._by_fp.pop(old.fingerprint, None)
            self.evictions += 1

    # -- artifact fast path (DESIGN.md §12) ----------------------------------
    def artifact_lookup(self, entry: PoolEntry, k: int, lam: float,
                        eps: float, positive: bool, target):
        """Verified artifact covering this ask, or None (fall through).

        Misses are not negative-cached (an offline build may commit at any
        time).  Hits are memoized by manifest ident.  A quarantine bumps
        the counter; the next probe is a clean miss.  The target is hashed
        from its host bytes.
        """
        if self.artifacts is None or entry.content_digest is None:
            return None
        from repro_torch.artifacts import artifact_key_for

        key = artifact_key_for(None, host_array(target), lam, eps, positive,
                               fingerprint=entry.content_digest)
        ident = key.ident()
        art = self._art_memo.get(ident)
        if art is None:
            before = self.artifacts.quarantined
            art = self.artifacts.get(key)
            self.art_quarantined += self.artifacts.quarantined - before
            if art is None:
                self.art_misses += 1
                return None
            if art.n != entry.n or art.d != entry.d:
                # Only a full-content digest collision gets here; treat it
                # as corruption all the same.
                self.artifacts.quarantine(ident, "dims-disagree-with-pool")
                self.art_quarantined += 1
                self.art_misses += 1
                return None
            self._art_memo[ident] = art
        if int(k) > art.k_max:
            self.art_misses += 1
            return None
        self.art_hits += 1
        return art

    # -- lookup --------------------------------------------------------------
    def peek(self, pool_id: str) -> Optional[PoolEntry]:
        """Entry or None, without touching LRU order."""
        return self._pools.get(pool_id)

    def get(self, pool_id: str) -> PoolEntry:
        entry = self._pools.get(pool_id)
        if entry is None:
            raise UnknownPool(
                f"unknown pool {pool_id!r} (evicted or never registered); "
                f"known: {list(self._pools)}")
        self._pools.move_to_end(pool_id)
        return entry

    def __contains__(self, pool_id: str) -> bool:
        return pool_id in self._pools

    def __len__(self) -> int:
        return len(self._pools)

    def stats(self) -> dict:
        return {
            "pools": len(self._pools),
            "warming": len(self.warming()),
            "evictions": self.evictions,
            "artifact_hits": self.art_hits,
            "artifact_misses": self.art_misses,
            "artifact_quarantined": self.art_quarantined,
            "resident_bytes": sum(
                e.n * e.d * 4 for e in self._pools.values()
                if e.kind == "array"),
            "cache_bytes": sum(
                e.cache.stats()["resident_bytes"]
                for e in self._pools.values() if e.cache is not None),
        }
