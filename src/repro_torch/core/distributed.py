"""Device-parallel and rank-parallel selection, after
``repro/core/distributed.py`` (DESIGN.md §3).

Two kinds of parallelism, as in the reference:

* **Ranks** (``sharded_omp_select``, ``sharded_gradmatch_pb``): the
  candidate rows are split over the ranks of a ``torch.distributed``
  process group (the reference's ``shard_map`` over a mesh axis), and each
  OMP round costs ``O(d)`` of traffic: the rank-local scores (kernel
  ``corr``), one ``all_gather`` of each rank's (best score, global id)
  electing the global argmax at the lowest id (the reference's
  ``pmax`` / ``pmin``), and one ``all_reduce`` SUM of the winner's masked
  row (``psum``).  The small NNLS runs replicated on every rank.
  ``group=None`` is a world of one, as a one-device mesh is.
* **Local devices** (``pmap_chunk_topm``, ``pmap_fl_gains`` /
  ``fl_greedy_pmap``, ``pmap_partition_omp``): the reference's ``pmap``
  over ``jax.local_devices()``.  Here the local devices are the visible
  cards for work on the card (one on an H100 host) and the CPU for work on
  the CPU; ``local_devices`` is the one place that says so.  Each device's
  share runs there and the host merges the shares.

The FL gain scan stays plain torch (``greedy.fl_gains_cols``), as the
reference's runs ``fl_gains_cols`` in jnp rather than its Pallas kernel.
The mesh helpers ``replicate`` / ``shard_rows`` wait with the mesh
analogues (ROADMAP.md queue 1, "The rest of the LM side", (g)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import greedy as greedy_lib
from repro_torch.core import omp as omp_lib
from repro_torch.core import streaming as stream_lib
from repro_torch.core.gradmatch import SelectionResult, _normalize
from repro_torch.core.omp import _nnls_active_cached
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def local_devices(device) -> list[torch.device]:
    """The devices a local-parallel call spreads over: every visible card
    for work on the card, else ``device`` alone."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _device_of(x, device) -> torch.device:
    """A tensor's own device unless ``device`` says otherwise; for host
    arrays ``device`` (``None``: the card)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


# ---------------------------------------------------------------------------
# rank-parallel OMP over a torch.distributed group
# ---------------------------------------------------------------------------

def _world(group) -> tuple[int, int]:
    if group is None:
        return 1, 0
    dist = torch.distributed
    return dist.get_world_size(group), dist.get_rank(group)


def _elect(best_val: torch.Tensor, cand: torch.Tensor, n: int,
           group) -> torch.Tensor:
    """The global argmax from each rank's (best score, global id): the max
    score, the lowest id at it."""
    if group is None:
        return cand
    mine = torch.stack([best_val.double(), cand.double()])
    got = [torch.empty_like(mine) for _ in range(_world(group)[0])]
    torch.distributed.all_gather(got, mine, group=group)
    got = torch.stack(got)
    gmax = got[:, 0].max()
    return torch.where(got[:, 0] == gmax, got[:, 1],
                       float(n)).min().long()


def _sharded_solve(g_local: torch.Tensor, tgt: torch.Tensor, k: int, n: int,
                   base: int, group, lam: float, eps: float,
                   nnls_iters: int) -> SelectionResult:
    """``k`` OMP rounds over the rank's rows ``[base, base + n_local)`` of
    an ``n``-row pool, every rank holding the same replicated state."""
    dev = g_local.device
    n_local, d = g_local.shape
    f32 = dict(dtype=torch.float32, device=dev)
    indices = torch.full((k,), -1, dtype=torch.int32, device=dev)
    mask = torch.zeros((k,), dtype=torch.bool, device=dev)
    weights = torch.zeros((k,), **f32)
    rows = torch.zeros((k, d), **f32)
    gram = torch.zeros((k, k), **f32)
    absrow = torch.zeros((k,), **f32)
    tcorr = torch.zeros((k,), **f32)
    residual = tgt
    err = (tgt ** 2).sum()
    # rows of this rank already taken, with a scratch slot n_local for the
    # rounds whose pick lies on another rank (or did not grow)
    taken = torch.zeros((n_local + 1,), dtype=torch.bool, device=dev)
    for t in range(k):
        # 1) local scores against the shared residual, taken rows -inf
        scores = torch.where(taken[:n_local], float("-inf"),
                             ops.corr(g_local, residual))
        # 2) global argmax: max score, lowest global id at the max
        best_local = torch.argmax(scores)
        e = _elect(scores[best_local], base + best_local, n, group)
        # 3) the winning row by a sum of the masked rows
        mine = (e >= base) & (e < base + n_local)
        pos = torch.where(mine, e - base, 0)
        g_e = torch.where(mine, g_local[pos], 0.0)
        if group is not None:
            torch.distributed.all_reduce(g_e, group=group)

        grow = err > eps
        growf = grow.to(torch.float32)
        indices[t] = torch.where(grow, e, -1)
        mask[t] = grow
        taken[torch.where(mine & grow, pos, n_local)] = True
        g_e = g_e * growf
        rows[t] = g_e
        # 4) the replicated Gram / target-correlation caches grow by one
        #    row and column, then the small NNLS on them
        row_vals = torch.where(mask, rows @ g_e, 0.0)
        gram[t, :] = row_vals
        gram[:, t] = row_vals
        absrow = torch.where(mask, absrow + row_vals.abs(), 0.0)
        absrow[t] = row_vals.abs().sum()
        tcorr[t] = torch.dot(g_e, tgt)
        weights = _nnls_active_cached(gram, absrow, rows, tcorr, mask, lam,
                                      nnls_iters)
        residual = tgt - weights @ rows
        err = (residual ** 2).sum() + lam * (weights ** 2).sum()
    return SelectionResult(indices, _normalize(weights, mask), mask, err)


def sharded_omp_select(
    grads,                       # (n, d) the pool; this rank scores its rows
    target,                      # (d,) replicated
    k: int,
    group=None,                  # torch.distributed group; None: one rank
    lam: float = 0.5,
    eps: float = 1e-10,
    nnls_iters: int = 50,
    device: str | torch.device | None = None,
) -> SelectionResult:
    """Rank-parallel OMP: ``omp.omp_select``'s math, rows split over the
    ranks of ``group``.

    ``n`` must be divisible by the group's size (the caller pads the pool
    with zero rows, which never beat the eps-stop); rank ``r`` scores rows
    ``[r n/W, (r+1) n/W)``.  Every rank returns the same (indices,
    weights, mask, err) with *global* candidate ids, on the pool's device
    (a tensor's, else ``device``, whose ``None`` is the card).
    """
    dev = _device_of(grads, device)
    g = stream_lib._rows(grads, dev)
    n, _ = g.shape
    world, rank = _world(group)
    assert n % world == 0, (n, world)
    n_local = n // world
    tgt = torch.as_tensor(target, dtype=torch.float32).to(dev)
    return _sharded_solve(g[rank * n_local:(rank + 1) * n_local], tgt,
                          int(k), n, rank * n_local, group, lam, eps,
                          nnls_iters)


def sharded_gradmatch_pb(
    example_proxies,             # (n, d) the pool of example proxies
    batch_size: int,
    k_batches: int,
    group=None,
    lam: float = 0.5,
    eps: float = 1e-10,
    target=None,
    device: str | torch.device | None = None,
) -> SelectionResult:
    """GRAD-MATCHPB over the ranks of ``group``: each rank averages its
    own whole mini-batches, the full-pool target is one ``all_reduce``
    SUM of the ranks' batch sums, and the batches are selected by the
    rank-parallel OMP."""
    dev = _device_of(example_proxies, device)
    g = stream_lib._rows(example_proxies, dev)
    n, d = g.shape
    world, rank = _world(group)
    assert n % (world * batch_size) == 0, (n, world, batch_size)
    n_local = n // world
    nb = n_local // batch_size
    local = g[rank * n_local:(rank + 1) * n_local]
    pb = local.reshape(nb, batch_size, d).mean(dim=1)
    tgt = pb.sum(dim=0)
    if group is not None:
        torch.distributed.all_reduce(tgt, group=group)
    if target is not None:
        tgt = torch.as_tensor(target, dtype=torch.float32).to(dev)
    return _sharded_solve(pb, tgt, int(k_batches), nb * world, rank * nb,
                          group, lam, eps, 50)


# ---------------------------------------------------------------------------
# device-parallel chunk scoring for streaming selection (core/streaming.py)
# ---------------------------------------------------------------------------

def pmap_chunk_topm(chunk, pool_ok, gids, offset, residual, sel_idx,
                    sel_mask, *, m: int, absolute: bool,
                    need_norms: bool = True):
    """Device-parallel drop-in for ``streaming._score_chunk`` (the
    ``score_chunk_fn`` hook).

    The chunk's rows are split over the local devices; each scores its
    share (top ``min(m, rows a share)``) and the host merges the shares to
    the chunk's top-m.  The threshold is the max of the local ones, and
    the merged boundary when the merge itself dropped candidates, so the
    certification bound stays safe.
    """
    home = chunk.device
    devices = local_devices(home)
    ndev = len(devices)
    c, d = chunk.shape
    per = -(-c // ndev)
    pad = per * ndev - c
    if pad:
        chunk = F.pad(chunk, (0, 0, 0, pad))
        pool_ok = F.pad(pool_ok, (0, pad))
        gids = F.pad(gids, (0, pad), value=-1)
    m_loc = min(m, per)
    mv = torch.full((m,), float("-inf"), dtype=torch.float32, device=home)
    mi = torch.full((m,), -1, dtype=torch.int32, device=home)
    mr = torch.zeros((m, d), dtype=torch.float32, device=home)
    mok = torch.zeros((m,), dtype=torch.bool, device=home)
    cmaxs, threshs = [], []
    for s, dv in enumerate(devices):
        lo, hi = s * per, (s + 1) * per
        vals, ids, rows, ok, cmax, cthresh = stream_lib._score_chunk(
            chunk[lo:hi].to(dv), pool_ok[lo:hi].to(dv), gids[lo:hi].to(dv),
            int(offset) + lo, residual.to(dv), sel_idx.to(dv),
            sel_mask.to(dv), m=m_loc, absolute=absolute,
            need_norms=need_norms)
        mv, mi, mr, mok = stream_lib._merge_topm(
            mv, mi, mr, mok, vals.to(home), ids.to(home), rows.to(home),
            ok.to(home), size=m)
        cmaxs.append(cmax.to(home))
        threshs.append(cthresh.to(home))
    thresh = torch.stack(threshs).max()
    if ndev * m_loc > m:           # the merge itself dropped candidates
        thresh = torch.maximum(thresh, mv[m - 1])
    return mv, mi, mr, mok, torch.stack(cmaxs).max(), thresh


# ---------------------------------------------------------------------------
# device-parallel facility-location gain scan (core/greedy.py, DESIGN.md §5)
# ---------------------------------------------------------------------------

class FLPoolShards(NamedTuple):
    """Round-invariant operands of the sharded gain scan, prepared once:
    each device's candidate columns and their norms, its copy of the pool,
    and its shard's id offset.  Only (cover, avail) change between greedy
    rounds."""
    cand: list            # per device: (per, d) candidate column shard
    cand_sqn: list        # per device: (per,)
    offsets: list         # per device: global id base of its shard
    grads: list           # per device: (n, d) coverage-row pool, f32
    sqnorms: list         # per device: (n,)
    devices: list
    per: int
    n: int


def shard_fl_pool(grads, device: str | torch.device | None = None
                  ) -> FLPoolShards:
    dev = _device_of(grads, device)
    devices = local_devices(dev)
    ndev = len(devices)
    g = stream_lib._rows(grads, dev)
    n, d = g.shape
    sqnorms = (g * g).sum(dim=1)
    per = -(-n // ndev)
    pad = per * ndev - n
    cand = F.pad(g, (0, 0, 0, pad)).reshape(ndev, per, d)
    cand_sqn = F.pad(sqnorms, (0, pad)).reshape(ndev, per)
    return FLPoolShards([cand[s].to(dv) for s, dv in enumerate(devices)],
                        [cand_sqn[s].to(dv) for s, dv in enumerate(devices)],
                        [s * per for s in range(ndev)],
                        [g.to(dv) for dv in devices],
                        [sqnorms.to(dv) for dv in devices],
                        devices, per, n)


def pmap_fl_gains(shards: FLPoolShards, cover, avail, row_okf, l_max, *,
                  row_block: int = 256):
    """One facility-location gain scan, candidate columns sharded over the
    local devices.  Returns (argmax id, max gain) with the lowest global id
    at ties: the per-round election of the sharded CRAIG greedy.  The
    similarity is rebuilt from the pool in (row_block, per-shard) strips,
    so no device holds an (n, n) block."""
    home = cover.device
    per = shards.per
    avail_p = F.pad(avail, (0, len(shards.devices) * per - shards.n))
    vals, ids = [], []
    for s, dv in enumerate(shards.devices):
        gains = greedy_lib.fl_gains_cols(
            shards.cand[s], shards.cand_sqn[s], shards.grads[s],
            shards.sqnorms[s], cover.to(dv), row_okf.to(dv), l_max.to(dv),
            block=row_block)
        gm = torch.where(avail_p[s * per:(s + 1) * per].to(dv), gains,
                         float("-inf"))
        v = gm.max()
        pos = torch.where(gm == v, torch.arange(per, device=dv), per).min()
        vals.append(v.to(home))
        ids.append((shards.offsets[s] + pos).to(home))
    vals, ids = torch.stack(vals), torch.stack(ids)
    gmax = vals.max()
    e = torch.where(vals == gmax, ids, shards.n).min()
    return e, gmax


def fl_greedy_pmap(grads, k: int, valid=None, l_max=None,
                   row_block: int = 256,
                   device: str | torch.device | None = None):
    """CRAIG's greedy with every round's gain scan sharded over the local
    devices (each shard scores its candidate columns, the host elects one
    (value, id) pair a device), on the pool's device (a tensor's, else
    ``device``, whose ``None`` is the card).

    Every round is a full exact scan, as the dense oracle's, so the picks
    are ``greedy.fl_greedy(method="dense")``'s up to the similarity's
    rounding; the similarity is rebuilt on the fly, never materialized.
    """
    dev = _device_of(grads, device)
    g = stream_lib._rows(grads, dev)
    n = g.shape[0]
    valid = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool).to(dev))
    row_okf = valid.to(torch.float32)
    lm = greedy_lib.default_l_max(g) if l_max is None else l_max
    lm = torch.as_tensor(lm, dtype=torch.float32).to(dev)
    shards = shard_fl_pool(g)      # round-invariant: prepared once
    sqnorms = (g * g).sum(dim=1)

    indices = torch.full((int(k),), -1, dtype=torch.int32, device=dev)
    mask = torch.zeros((int(k),), dtype=torch.bool, device=dev)
    picked = torch.zeros((int(k),), dtype=torch.float32, device=dev)
    cover = torch.zeros((n,), dtype=torch.float32, device=dev)
    avail = valid.clone()
    ids = torch.arange(n, device=dev)
    for t in range(int(k)):
        if not bool(avail.any()):
            break
        e, gain = pmap_fl_gains(shards, cover, avail, row_okf, lm,
                                row_block=row_block)
        indices[t] = e
        mask[t] = True
        picked[t] = gain
        col = greedy_lib.fl_rows(g, sqnorms, row_okf, lm, e.view(1))[0]
        cover = torch.maximum(cover, col)
        avail = avail & (ids != e)
    rounds = int(mask.sum())
    stats = greedy_lib.GreedyStats(rounds=rounds, rescans=rounds)
    return greedy_lib.GreedyResult(indices, mask, picked, cover, stats)


# ---------------------------------------------------------------------------
# device-grouped partition solves (core/partition.py, DESIGN.md §9)
# ---------------------------------------------------------------------------

def pmap_partition_omp(parts, targets, valids, k: int, lam: float = 0.5,
                       eps: float = 1e-10, nnls_iters: int = 50,
                       method: str = "incremental", block: int = 128,
                       device: str | torch.device | None = None):
    """Solve ``P`` independent partition OMPs in groups of the local
    devices' count.

    ``parts`` is ``(P, n_max, d)`` padded partition pools, ``targets``
    ``(P, d)``, ``valids`` ``(P, n_max)`` (padding rows False).  Group
    ``j`` is one batched solve on device ``j mod devices``, over the
    group's flattened ``(g n_max, d)`` pool, problem ``b`` masked to block
    ``b``, each problem on its single solve's regime rule; a ragged tail
    group is a smaller batch.  Returns ``(idx, w, mask, err)`` stacked over
    partitions, on the parts' device (a tensor's, else ``device``), with
    *partition-local* row ids (-1 on unused slots): the caller owns the
    local-to-global map.
    """
    home = _device_of(parts, device)
    parts = stream_lib._rows(parts, home)
    targets = torch.as_tensor(targets, dtype=torch.float32).to(home)
    valids = torch.as_tensor(valids, dtype=torch.bool).to(home)
    devices = local_devices(home)
    ndev = len(devices)
    p_total, n_max, d = parts.shape
    outs = []
    for j, s in enumerate(range(0, p_total, ndev)):
        got = min(ndev, p_total - s)
        dv = devices[j % ndev]
        pool = parts[s:s + got].reshape(got * n_max, d).to(dv)
        masks = torch.zeros((got, got * n_max), dtype=torch.bool, device=dv)
        for b in range(got):
            masks[b, b * n_max:(b + 1) * n_max] = valids[s + b].to(dv)
        idx, w, mask, err = omp_lib.omp_select_batched(
            pool, targets[s:s + got].to(dv), int(k), lam=lam, eps=eps,
            nnls_iters=nnls_iters, valid=masks, method=method, block=block,
            single_regime=True)
        off = torch.arange(got, device=dv)[:, None] * n_max
        idx = torch.where(idx >= 0, idx - off, -1).to(torch.int32)
        outs.append(tuple(x.to(home) for x in (idx, w, mask, err)))
    return tuple(torch.cat([o[i] for o in outs], dim=0) for i in range(4))
