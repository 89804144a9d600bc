"""Partition-and-merge selection (DESIGN.md §9), after
``repro/core/partition.py``.

The pool splits into ``P`` partitions, each small problem is solved by the
existing engines against its own target, and one **certified merge round**
re-solves the union of the partition picks against the global target:

* ``make_plan`` / ``split_budget``: per-class partitions when labels exist,
  hashed ones otherwise, contiguous row ranges for out-of-core streams;
  the budget split exactly (``omp.split_budget``).
* the partition solves: on one card, **one batched solve over the shared
  ``(n, d)`` pool**, problem ``p`` masked to its partition's rows (the call
  ``omp_select_per_class`` makes), in place of the reference's ``vmap`` of
  ``omp_select`` over padded ``(P, n_max, d)`` copies.  It takes the
  single solver's regime rule (``single_regime=True``), so each problem
  runs the rounds its own ``omp_select`` runs, and its picks are global
  ids (the partitions list their rows in ascending order in the reference,
  so the lowest-id tie rule is the same).  ``use_pmap=True`` takes the
  device-grouped path of ``distributed.pmap_partition_omp``; out-of-core
  partitions run the streaming engine on ``subrange_chunks`` views of one
  loader.
* the merge: ``omp_select(method="incremental")`` over the union rows
  against the global target, at ``min(k, |union|)`` rounds.  It reweights
  every pick, and its ``err`` is the global objective of the result.

Per-partition weights never reach the result, only indices, which makes the
quota truncation exact: OMP round ``t`` depends only on rounds ``< t``, so
the first ``quota_p`` picks of a ``k_cap``-round solve are a
``quota_p``-round solve's.

The pool stays on its device (a tensor's, else ``device``, whose ``None``
is the card); the plan, the quotas and the union ids live on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import distributed as dist_lib
from repro_torch.core import omp as omp_lib
from repro_torch.core import streaming as stream_lib
from repro_torch.core.gradmatch import SelectionResult, _normalize
from repro_torch.core.omp import split_budget

__all__ = [
    "PartitionPlan", "PartitionStats", "make_plan", "split_budget",
    "gradmatch_partitioned", "gradmatch_partitioned_stream",
]

# Knuth's multiplicative hash over the row id: deterministic, stateless,
# spreads contiguous id ranges uniformly over partitions.  The uint64
# products wrap, so it stays in numpy.
_HASH_MULT = np.uint64(2654435761)
_HASH_MOD = np.uint64(1 << 32)


class PartitionPlan(NamedTuple):
    """How the pool splits: ``kind`` in {"class", "hash", "contiguous"}.

    ``assign`` maps each row to its partition (class/hash kinds);
    ``bounds`` is the ``(P+1,)`` row-offset fence (contiguous kind).
    ``sizes`` counts *candidate* rows per partition (invalid rows
    excluded).
    """
    kind: str
    num_parts: int
    sizes: np.ndarray                       # (P,) candidate rows per part
    assign: Optional[np.ndarray] = None     # (n,) partition id per row
    bounds: Optional[np.ndarray] = None     # (P+1,) contiguous offsets


@dataclasses.dataclass
class PartitionStats:
    """Partition/merge accounting attached to ``SelectionResult.stats``."""
    num_parts: int
    kind: str
    quotas: tuple
    union_size: int          # partition picks entering the merge
    merged: int              # picks surviving the merge re-solve
    stream: Optional[stream_lib.SelectStats] = None  # out-of-core solves


def make_plan(n: int, partitions: int = 0, labels=None, num_classes: int = 0,
              kind: str = "auto", valid=None,
              devices: int = 1) -> PartitionPlan:
    """Build a partition plan over ``n`` rows.

    ``kind="auto"`` picks per-class when labels exist, hashed otherwise.
    ``partitions`` applies to the non-class kinds only; ``0`` means
    ``max(devices, 2)``, with ``devices`` the count of local devices the
    solves spread over (1 for a pool on the CPU).
    """
    n = int(n)
    if kind == "auto":
        kind = "class" if (labels is not None and num_classes > 1) else "hash"
    valid_np = (np.ones(n, bool) if valid is None
                else np.asarray(_host(valid), bool))
    if kind == "class":
        if labels is None or num_classes <= 0:
            raise ValueError("kind='class' needs labels and num_classes")
        assign = np.asarray(_host(labels), np.int64)
        p = int(num_classes)
        ok = valid_np & (assign >= 0) & (assign < p)
        sizes = np.bincount(assign[ok], minlength=p)
        return PartitionPlan("class", p, sizes, assign=assign)
    p = int(partitions) if partitions > 0 else max(int(devices), 2)
    p = max(1, min(p, n)) if n else 1
    if kind == "hash":
        ids = np.arange(n, dtype=np.uint64)
        assign = (((ids * _HASH_MULT) % _HASH_MOD) % np.uint64(p)).astype(
            np.int64)
        sizes = np.bincount(assign[valid_np], minlength=p)
        return PartitionPlan("hash", p, sizes, assign=assign)
    if kind == "contiguous":
        bounds = (np.arange(p + 1, dtype=np.int64) * n) // p
        sizes = np.array([int(valid_np[bounds[i]:bounds[i + 1]].sum())
                          for i in range(p)], np.int64)
        return PartitionPlan("contiguous", p, sizes, bounds=bounds)
    raise ValueError(f"unknown partition kind {kind!r}; "
                     "known: class, hash, contiguous, auto")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _empty_result(k: int, err: float, dev: torch.device) -> SelectionResult:
    return SelectionResult(
        torch.full((k,), -1, dtype=torch.int32, device=dev),
        torch.zeros((k,), dtype=torch.float32, device=dev),
        torch.zeros((k,), dtype=torch.bool, device=dev),
        torch.tensor(err, dtype=torch.float32, device=dev))


def _certified_merge(union_rows: torch.Tensor, union_gids: np.ndarray,
                     target: torch.Tensor, k: int, lam: float, eps: float,
                     nnls_iters: int):
    """The merge round: incremental-Gram OMP over the union of partition
    picks against the global target.  Returns padded ``(k,)`` tensors with
    *global* ids, the global ``err`` of the merged solution and the count
    of merged picks.

    The merge budget is ``min(k, |union|)``: never more rounds than
    candidates, so every committed slot is a distinct union row.
    """
    dev = union_rows.device
    u = int(union_rows.shape[0])
    k_merge = min(int(k), u)
    m_idx, m_w, m_mask, m_err = omp_lib.omp_select(
        union_rows, target, k=k_merge, lam=lam, eps=eps,
        nnls_iters=nnls_iters, method="incremental")
    gids = torch.as_tensor(union_gids, dtype=torch.int32, device=dev)
    pad = k - k_merge
    out_idx = torch.where(m_mask, gids[torch.where(m_mask, m_idx, 0).long()],
                          -1)
    out_w = torch.where(m_mask, m_w, 0.0)
    out_idx = torch.cat([out_idx, out_idx.new_full((pad,), -1)])
    out_w = torch.cat([out_w, out_w.new_zeros((pad,))])
    out_mask = torch.cat([m_mask, m_mask.new_zeros((pad,))])
    return out_idx, out_w, out_mask, m_err, int(m_mask.sum())


def gradmatch_partitioned(
    proxies,                     # (n, d) tensor or numpy array
    k: int,
    partitions: int = 0,
    labels=None,
    num_classes: int = 0,
    target=None,                 # (d,) global target; None = eq.-2 sum
    lam: float = 0.5,
    eps: float = 1e-10,
    valid=None,
    kind: str = "auto",
    method: str = "incremental",
    use_pmap: Optional[bool] = None,   # None = auto (>1 local device)
    nnls_iters: int = 50,
    device: str | torch.device | None = None,
) -> SelectionResult:
    """Partition-and-merge GRAD-MATCH over a resident pool, on the pool's
    device (a tensor's, else ``device``, whose ``None`` is the card).

    Splits per ``make_plan``, solves every partition against its own
    target (the class kind: ``onehot.T @ g``, ``gradmatch_per_class``'s
    targets; else the partition's row sum, or a size-proportional share of
    an explicit ``target``), truncates each partition to its
    ``split_budget`` quota, and re-solves the union in one certified merge
    round.  The partition solves are one batched solve over the shared
    pool; ``use_pmap=True`` takes ``distributed.pmap_partition_omp``
    instead (the default when more than one local device is present).
    """
    dev = dist_lib._device_of(proxies, device)
    pool = stream_lib._rows(proxies, dev)
    n, d = pool.shape
    valid_np = (np.ones(n, bool) if valid is None
                else np.asarray(_host(valid), bool))
    devices = dist_lib.local_devices(dev)
    plan = make_plan(n, partitions, labels=labels, num_classes=num_classes,
                     kind=kind, valid=valid_np, devices=len(devices))
    quotas = split_budget(k, plan.sizes)
    k_cap = int(quotas.max()) if quotas.size else 0
    stats = PartitionStats(plan.num_parts, plan.kind, tuple(quotas.tolist()),
                           0, 0)
    if k_cap == 0:
        err = 0.0 if target is None else float(
            (torch.as_tensor(target, dtype=torch.float32) ** 2).sum())
        return SelectionResult(*_empty_result(k, err, dev)[:4], stats)

    p_count = plan.num_parts
    if plan.assign is not None:
        gid_lists = [np.flatnonzero(valid_np & (plan.assign == p))
                     for p in range(p_count)]
    else:
        gid_lists = [
            plan.bounds[p] + np.flatnonzero(
                valid_np[plan.bounds[p]:plan.bounds[p + 1]])
            for p in range(p_count)]
    valid_t = torch.as_tensor(valid_np, device=dev)

    n_valid = int(valid_np.sum())
    if target is not None:
        g_target = torch.as_tensor(target, dtype=torch.float32).to(dev)
        fracs = torch.as_tensor(plan.sizes / max(n_valid, 1),
                                dtype=torch.float32, device=dev)
        targets_p = fracs[:, None] * g_target
    elif plan.kind == "class":
        # gradmatch_per_class's targets, formed the same way, so the class
        # kind's partition solve is its per-class solve.
        g_v = pool * valid_t[:, None].to(pool.dtype)
        cls = torch.arange(p_count, device=dev)
        assign = torch.as_tensor(plan.assign, device=dev)
        onehot = (assign[:, None] == cls).to(pool.dtype)
        targets_p = onehot.T @ g_v
        g_target = targets_p.sum(dim=0)
    else:
        targets_p = torch.stack([
            pool[torch.as_tensor(gi, device=dev)].sum(dim=0)
            for gi in gid_lists])
        g_target = targets_p.sum(dim=0)

    if use_pmap is None:
        use_pmap = len(devices) > 1
    if use_pmap:
        n_max = max(1, max(len(g) for g in gid_lists))
        parts = pool.new_zeros((p_count, n_max, d))
        pvalid = torch.zeros((p_count, n_max), dtype=torch.bool, device=dev)
        for p, gi in enumerate(gid_lists):
            parts[p, :len(gi)] = pool[torch.as_tensor(gi, device=dev)]
            pvalid[p, :len(gi)] = True
        idx, _, mask, _ = dist_lib.pmap_partition_omp(
            parts, targets_p, pvalid, k_cap, lam=lam, eps=eps,
            nnls_iters=nnls_iters, method=method)
        local = _host(idx)
        pick_lists = [gi[np.maximum(local[p], 0)] if len(gi) else local[p]
                      for p, gi in enumerate(gid_lists)]
    else:
        assign = (torch.as_tensor(plan.assign, device=dev)
                  if plan.assign is not None else None)
        masks = torch.zeros((p_count, n), dtype=torch.bool, device=dev)
        for p in range(p_count):
            if assign is not None:
                masks[p] = valid_t & (assign == p)
            else:
                lo, hi = int(plan.bounds[p]), int(plan.bounds[p + 1])
                masks[p, lo:hi] = valid_t[lo:hi]
        idx, _, mask, _ = omp_lib.omp_select_batched(
            pool, targets_p, k_cap, lam=lam, eps=eps, nnls_iters=nnls_iters,
            valid=masks, method=method, single_regime=True)
        pick_lists = list(_host(idx))

    # Quota truncation (index-exact by the prefix property), global ids in
    # partition order, each partition's picks in round order.
    mask_np = _host(mask) & (np.arange(k_cap)[None, :] < quotas[:, None])
    union_gids = np.concatenate(
        [np.asarray(pick_lists[p], np.int64)[mask_np[p]]
         for p in range(p_count)] or [np.zeros((0,), np.int64)])
    stats.union_size = int(union_gids.shape[0])
    if stats.union_size == 0:
        return SelectionResult(
            *_empty_result(k, float((g_target ** 2).sum()), dev)[:4], stats)

    out_idx, out_w, out_mask, err, merged = _certified_merge(
        pool[torch.as_tensor(union_gids, device=dev)], union_gids, g_target,
        k, lam, eps, nnls_iters)
    stats.merged = merged
    return SelectionResult(out_idx, _normalize(out_w, out_mask), out_mask,
                           err, stats)


def _accumulate_stats(agg: stream_lib.SelectStats,
                      s: stream_lib.SelectStats) -> None:
    for f in dataclasses.fields(stream_lib.SelectStats):
        if f.name == "pool_size":
            continue
        setattr(agg, f.name, getattr(agg, f.name) + getattr(s, f.name))


def _gather_rows_by_scan(pool_iter: Callable, gids: np.ndarray, d: int,
                         dev: torch.device) -> torch.Tensor:
    """One loader pass gathering exact rows by global id (factory-only
    pools without a ``row_fetch`` capability)."""
    rows = torch.zeros((len(gids), d), dtype=torch.float32, device=dev)
    gids = np.asarray(gids, np.int64)
    order = np.argsort(gids, kind="stable")
    srt = gids[order]
    j, off = 0, 0
    for chunk, _ in pool_iter():
        c = chunk.shape[0]
        j2 = int(np.searchsorted(srt, off + c))
        if j2 > j:
            local = srt[j:j2] - off
            rows[torch.as_tensor(order[j:j2], device=dev)] = \
                stream_lib._rows(chunk[local], dev)
            j = j2
        off += c
        if j >= len(srt):
            break
    return rows


def gradmatch_partitioned_stream(
    pool=None,                   # (n, d) array/memmap/tensor; or pool_iter
    k: int = 0,
    partitions: int = 0,
    pool_iter: Optional[Callable] = None,  # (chunk, valid) factory
    n: Optional[int] = None,     # pool rows (counted in one pass if None)
    row_fetch: Optional[Callable] = None,
    target=None,
    lam: float = 0.5,
    eps: float = 1e-10,
    chunk_size: int = 4096,
    buffer_size: int = 256,
    cache_bytes: int = stream_lib.DEFAULT_CACHE_BYTES,  # per partition
    retry=None,
    nnls_iters: int = 50,
    device: str | torch.device | None = None,
) -> SelectionResult:
    """Out-of-core partition-and-merge: contiguous row ranges, each solved
    by the certified streaming engine over a ``subrange_chunks`` view of
    one shared loader, then the certified merge, on ``device`` (a tensor
    pool's own device when ``None``; else the card).

    ``cache_bytes`` is a per-partition budget; partitions run one after
    the other, each cache dropped before the next.  ``partitions=0`` sizes
    partitions to ~128k rows (capped at 16).  The quotas come from raw
    range sizes (valid-dense pools); the engine never selects an invalid
    row.
    """
    dev = dist_lib._device_of(pool, device)
    if pool is not None:
        n, d = int(pool.shape[0]), int(pool.shape[1])
        pool_iter = stream_lib.array_chunks(pool, chunk_size)
        if row_fetch is None:
            row_fetch = stream_lib.array_row_fetch(pool)
    else:
        if pool_iter is None:
            raise ValueError("need pool= or pool_iter=")
        first = next(iter(pool_iter()), None)
        if first is None:
            raise ValueError("empty pool iterator")
        d = int(first[0].shape[1])
        if n is None:
            n = sum(int(c.shape[0]) for c, _ in pool_iter())
    p_count = int(partitions) if partitions > 0 else min(
        16, max(2, -(-n // 131072)))
    p_count = max(1, min(p_count, n))
    bounds = (np.arange(p_count + 1, dtype=np.int64) * n) // p_count
    sizes = np.diff(bounds)
    quotas = split_budget(k, sizes)
    agg = stream_lib.SelectStats(pool_size=n)
    picks = []
    part_targets = []
    g_target = (None if target is None
                else torch.as_tensor(target, dtype=torch.float32).to(dev))
    for p in range(p_count):
        if quotas[p] == 0:
            continue
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        sub = stream_lib.subrange_chunks(pool_iter, lo, hi)
        cache = stream_lib.ChunkCache(int(cache_bytes), d, dev)
        sub_fetch = (None if row_fetch is None
                     else stream_lib.offset_row_fetch(row_fetch, lo))
        # One summing pass per partition: the partition target and the
        # cache warm-up (so the solve's certified rounds hit memory).
        t_p, _ = stream_lib.streaming_target(sub, cache=cache, retry=retry,
                                             device=dev)
        if g_target is not None:
            t_p = torch.tensor((hi - lo) / n, dtype=torch.float32,
                               device=dev) * g_target
        part_targets.append(t_p)
        out = stream_lib.omp_select_streaming(
            sub, t_p, int(quotas[p]), lam=lam, eps=eps,
            nnls_iters=nnls_iters, buffer_size=buffer_size, cache=cache,
            row_fetch=sub_fetch, retry=retry, device=dev)
        _accumulate_stats(agg, out.stats)
        local = _host(out.indices)[_host(out.mask)]
        picks.append(lo + local.astype(np.int64))
    stats = PartitionStats(p_count, "contiguous", tuple(quotas.tolist()),
                           0, 0, stream=agg)
    if g_target is None:
        g_target = (torch.stack(part_targets).sum(dim=0) if part_targets
                    else torch.zeros((d,), dtype=torch.float32, device=dev))
    union_gids = np.concatenate(picks or [np.zeros((0,), np.int64)])
    stats.union_size = int(union_gids.shape[0])
    if stats.union_size == 0:
        return SelectionResult(
            *_empty_result(k, float((g_target ** 2).sum()), dev)[:4], stats)
    if row_fetch is not None:
        union_rows = stream_lib._rows(row_fetch(union_gids), dev)
    else:
        union_rows = _gather_rows_by_scan(pool_iter, union_gids, d, dev)
        agg.passes += 1
    out_idx, out_w, out_mask, err, merged = _certified_merge(
        union_rows, union_gids, g_target, k, lam, eps, nnls_iters)
    stats.merged = merged
    return SelectionResult(out_idx, _normalize(out_w, out_mask), out_mask,
                           err, stats)
