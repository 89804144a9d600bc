"""Wrappers of the OMP scoring kernels ``corr``, ``corr_argmax``, their
batched forms ``corr_batched`` and ``corr_argmax_batched``, and the
streaming certificate's ``bound_max``.

The CUDA sources are ``csrc/corr.cu``, ``csrc/corr_batched.cu`` and
``csrc/bound_max.cu``; they replace the Pallas kernels
``repro/kernels/corr.py:corr``, ``:corr_argmax`` and ``:bound_max``, and
the batched dispatch ``repro/kernels/ops.py:corr_batched`` and
``:corr_argmax_batched`` (a ``lax.map`` of the single kernels on a TPU,
one launch for the whole batch here).  A wrapper given CUDA
tensors checks them, launches its kernel on the current stream and raises
if the launch failed; given CPU tensors it runs the plain version in
``ref.py``.  It never falls back from the card to the plain version.
``launches`` counts kernel launches, and nothing else; ``shapes`` counts the
same launches of ``corr`` and ``bound_max`` by (kernel, rows, d, dtype),
and of the batched kernels by (kernel, rows, d, dtype, B, per-problem).

The batched kernels launch by a plan (``batched_plan``), a pure function of
the shapes: the row-tile route (one thread a row) for a shared pool of
width 1-96, the warp route (one warp a row) for the rest.  ``corr_argmax``
launches by ``corr_argmax_plan``: the batched argmax's row tiles at B = 1
for a pool of width 1-96 and at least ``ARGMAX_MIN_ROWS`` rows, its own
warp kernel (``csrc/corr.cu``) for the rest; the two give the same bits.
``bound_max`` launches by ``bound_max_plan``, a pure function of the
shapes and the two addresses it aligns: the tile route (live tiles by bulk
copy) or the row loop.  It, ``corr_argmax`` and ``corr_argmax_batched``
are one device operation a call: a per-stream workspace, zero between
calls, takes the place of a memset and a decode launch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.args import (BLOCK_SMEM, SM_SMEM, bank_ways,
                                      check_array, check_matrix,
                                      check_vector, sm_count, stream)

launches = {"corr": 0, "corr_argmax": 0, "corr_batched": 0,
            "corr_argmax_batched": 0, "bound_max": 0}
# bound_max's and corr_argmax's launches by route, bumped with ``launches``.
bound_routes = {"tiles": 0, "rows": 0}
argmax_routes = {"rows": 0, "warps": 0}
# corr and bound_max launches by (kernel, rows, d, dtype), the batched
# kernels' by (kernel, rows, d, dtype, B, per-problem matrix), bumped with
# ``launches``: one path calls corr at many shapes (a buffer, a chunk, one
# row), each with its own time, bound_max at its arena's, and a batched
# kernel's time follows its batch.
shapes: dict[tuple, int] = {}


def _count(name: str, m: torch.Tensor, *batch) -> None:
    launches[name] += 1
    key = (name, *m.shape[-2:], str(m.dtype).removeprefix("torch."), *batch)
    shapes[key] = shapes.get(key, 0) + 1

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _vec_ok(m: torch.Tensor) -> int:
    """1 when every row starts on a 16-byte boundary (16-byte loads)."""
    per_vec = 16 // m.element_size()
    return int(m.data_ptr() % 16 == 0 and m.shape[1] % per_vec == 0)


def corr(grads: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """scores = grads @ residual in f32.  grads (n, d) f32/bf16, residual
    (d,) f32 -> (n,) f32."""
    if not grads.is_cuda:
        return ref.corr_ref(grads, residual)
    check_matrix("grads", grads, _DTYPES)
    n, d = grads.shape
    check_vector("residual", residual, d, grads.device, torch.float32)
    out = torch.empty((n,), dtype=torch.float32, device=grads.device)
    code = build.lib().rt_corr(
        grads.device.index, grads.data_ptr(), _DTYPES[grads.dtype],
        residual.data_ptr(), out.data_ptr(), n, d, _vec_ok(grads),
        stream(grads.device))
    build.check(code, "corr")
    _count("corr", grads)
    return out


def corr_argmax(colcache: torch.Tensor, w: torch.Tensor, base: torch.Tensor,
                mask: torch.Tensor, absolute: bool = False, *,
                route: str | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused masked argmax of ``base - colcache @ w`` (optionally abs).

    colcache (n, p) f32, w (p,) f32, base (n,) f32, mask (n,) bool ->
    (index i32 (), score f32 ()) on the device.  The lowest index wins a
    tie; an all-masked input gives (0, -inf).  The score vector is never
    written to device memory.

    A CUDA call launches by ``corr_argmax_plan`` (``route`` forces one, for
    measurement): one device operation, whose last block writes (index,
    score) and returns the stream's workspace to zero.  Both routes give
    the same bits.
    """
    if not colcache.is_cuda:
        return ref.corr_argmax_ref(colcache, w, base, mask, absolute=absolute)
    check_matrix("colcache", colcache, (torch.float32,))
    n, p = colcache.shape
    dev = colcache.device
    check_vector("w", w, p, dev, torch.float32)
    check_vector("base", base, n, dev, torch.float32)
    check_vector("mask", mask, n, dev, torch.bool)
    plan = corr_argmax_plan(n, p, colcache.data_ptr(), sm_count(dev), route)
    vec = _vec_ok(colcache)
    idx = torch.empty((), dtype=torch.int32, device=dev)
    val = torch.empty((), dtype=torch.float32, device=dev)
    s = stream(dev)
    ws = _workspace(dev, s, KEY_STRIDE + 1)
    if plan.route == "rows":
        # The batched argmax at B = 1: base and mask (n,) are (n, 1), w
        # (p,) is (1, p), and (index, score) its (1,) outputs.
        code = build.lib().rt_corr_argmax_batched(
            dev.index, colcache.data_ptr(), w.data_ptr(), base.data_ptr(),
            mask.data_ptr(), n, p, 1, 0, int(absolute), vec, 1, plan.rows,
            plan.groups, plan.stages, plan.grid, ws.data_ptr(),
            idx.data_ptr(), val.data_ptr(), s)
    else:
        code = build.lib().rt_corr_argmax(
            dev.index, colcache.data_ptr(), w.data_ptr(), base.data_ptr(),
            mask.data_ptr(), n, p, int(absolute), vec, ws.data_ptr(),
            idx.data_ptr(), val.data_ptr(), s)
    if code != 0:
        _workspaces.pop((dev.index, s), None)
    build.check(code, "corr_argmax")
    launches["corr_argmax"] += 1
    argmax_routes[plan.route] += 1
    return idx, val


# -- the batched kernels' launch plan (csrc/corr_batched.cu) ----------------
# The source owns the row tiles' layout and its constants (RowLayout,
# kRowThreads, kRowMaxD, kMaxSmem, kKeyStride) and refuses a launch whose
# layout does not fit; these mirror them for the plan's fit decision and
# the workspace's size.

ROW_THREADS = 128       # a row-tile block's threads (kRowThreads)
ROW_MAX_D = 96          # the widest row a thread keeps in registers
ROW_MIN_ROWS = 1 << 11  # smaller pools take the warps, and so do
ROW_MIN_PAIRS = 1 << 14  # smaller batches (PERF.md §6)
ARGMAX_MIN_ROWS = 10_240  # corr_argmax's row tiles from here (PERF.md §6)
# Blocks an SM by rows a thread, the kernel's bounds: 128 threads at up to
# 128 registers each (one row a thread), or 170 (two rows).
ROW_BLOCKS_PER_SM = {1: 4, 2: 3}
WARP_ROWS = 8           # the warp route's warps a block, one row each
WARP_BLOCKS_PER_SM = 4


@dataclass(frozen=True)
class BatchedPlan:
    """How a batched kernel launches at a shape.  ``route`` "rows": one
    thread a row (or two), tiles of ``rows`` consecutive rows loaded by
    bulk copy into a ring of ``stages`` shared-memory slots, ``groups``
    threads sharing each row's problems, ``smem`` bytes of dynamic shared
    memory; "warps": one warp a row, ``rows`` warps a block, static shared
    memory only (``groups`` 1).  ``grid`` blocks."""
    route: str
    rows: int
    stages: int
    grid: int
    smem: int
    groups: int = 1


def _align128(x: int) -> int:
    return -(-x // 128) * 128


def rows_smem(d: int, b: int, rows: int, stages: int, argmax: bool) -> int:
    """Dynamic shared memory of a row-tile block, the total of the kernel's
    ``RowLayout``: barriers, B vectors of 32 ceil(d / 32) + 12 floats, B x 128 keys
    (argmax) or a (rows, B | 1) output tile, then ``stages`` tile slots."""
    vs = 32 * -(-d // 32) + 12
    keys = _align128(128 + b * vs * 4)
    per = b * ROW_THREADS * 8 if argmax else rows * (b | 1) * 4
    return _align128(keys + per) + stages * _align128(rows * d * 4 + 16)


def row_split(b: int, argmax: bool, vec: bool) -> tuple[int, int]:
    """(problem groups, rows a thread) on the row-tile route, as measured
    on an H100 (``PERF.md``).  One thread scores a row against every
    problem of a small batch.  For more problems a thread holds two rows,
    so each vector element it reads from shared memory (the reads that set
    the pace) serves two dot products, and the problems are shared by two
    (``corr_batched`` from 8) or four (``corr_argmax_batched`` from 16)
    groups of threads.  The 16-byte order keeps one row a thread."""
    if vec or b < (16 if argmax else 8):
        return 1, 1
    return (4 if argmax else 2), 2


def _row_plan(n: int, d: int, b: int, argmax: bool, vec: bool,
              sms: int) -> BatchedPlan | None:
    """The row-tile launch of an (n, d) shared pool and B problems, or None
    where its layout does not fit a block's shared memory."""
    groups, per_thread = row_split(b, argmax, vec)
    if -(-n // (ROW_THREADS * per_thread // groups)) < sms:
        # fewer tiles than SMs: one row a thread, the problems shared
        # by up to four threads
        groups, per_thread = min(4, 1 << (b.bit_length() - 1)), 1
    rows = ROW_THREADS * per_thread // groups
    tiles = max(1, -(-n // rows))

    def fit(stages):
        smem = rows_smem(d, b, rows, stages, argmax)
        return smem, min(SM_SMEM // (smem + 1024),
                         ROW_BLOCKS_PER_SM[per_thread])

    smem, per_sm = fit(1)
    if smem > BLOCK_SMEM:
        return None
    smem2, per2 = fit(2)
    if tiles <= sms * per_sm or smem2 > BLOCK_SMEM:
        return BatchedPlan("rows", rows, 1, tiles, smem, groups)
    return BatchedPlan("rows", rows, 2, min(tiles, sms * per2), smem2,
                       groups)


def _warp_plan(n: int, sms: int) -> BatchedPlan:
    grid = max(1, min(-(-n // WARP_ROWS), sms * WARP_BLOCKS_PER_SM))
    return BatchedPlan("warps", WARP_ROWS, 0, grid, 0)


def batched_plan(n: int, d: int, b: int, *, argmax: bool,
                 per_problem: bool = False, vec: bool = False,
                 sms: int = 132) -> BatchedPlan:
    """The launch of ``corr_batched`` (``argmax`` False) or
    ``corr_argmax_batched`` on an (n, d) pool and B problems (``vec``: the
    pool takes 16-byte loads, ``_vec_ok``), on a card of ``sms`` SMs.

    Row tiles take a shared pool with 1 <= d <= 96 whose vectors, keys and
    a tile slot fit in a block's shared memory: one slot a block where
    every tile gets its own block in one wave, else a ring of two in a
    persistent wave; a pool of fewer tiles than SMs shares each row's
    problems among more threads.  Every other shape takes the warps, and
    so does a pool of fewer than ``ROW_MIN_ROWS`` rows or a batch of fewer
    than ``ROW_MIN_PAIRS`` (row, problem) pairs.  On an H100 the row
    tiles' set-up (barriers, the vectors' staging, a bulk copy's round
    trip) costs 1-2 us more than the warps' and is repaid from about 2^14
    pairs; under 2^11 rows their few tiles leave most SMs idle while each
    thread walks its problems in turn."""
    if (not per_problem and 1 <= d <= ROW_MAX_D and b >= 1
            and n >= ROW_MIN_ROWS and n * b >= ROW_MIN_PAIRS):
        plan = _row_plan(n, d, b, argmax, vec, sms)
        if plan is not None:
            return plan
    return _warp_plan(n, sms)


def corr_argmax_plan(n: int, p: int, addr: int, sms: int = 132,
                     route: str | None = None) -> BatchedPlan:
    """The launch of ``corr_argmax`` on an (n, p) f32 matrix at ``addr``,
    on a card of ``sms`` SMs; ``route`` forces one route (ValueError where
    the row tiles cannot take the call).

    The row tiles of the batched argmax at B = 1 (``_row_plan``) take a
    matrix of width 1 <= p <= ``ROW_MAX_D`` from ``ARGMAX_MIN_ROWS`` rows,
    whether or not its first element lies on a 16-byte boundary (their
    copy's head and tail take the rest); the warp kernel of
    ``csrc/corr.cu`` takes everything else.  On an H100 (PERF.md §6,
    ``tools/kernel_turns.py --routes``) the warps win up to 8 192 rows
    (their single pass against the tiles' copy and fold) and the tiles from
    12 288, at widths 10 and 65, aligned or not: GLISTER's (45 000, 10)
    takes the tiles, GRAD-MATCH-PB's (703, 10), the wide regime's p 512 and
    the LM's (16, 4) the warps.  ``addr`` decides the replayed lane order
    (16-byte or scalar), as it does ``rt_corr_argmax``'s."""
    if route not in (None, "rows", "warps"):
        raise ValueError(f"corr_argmax: no route {route!r}")
    return _argmax_plan(n, p, addr % 16 == 0 and p % 4 == 0, sms, route,
                        ROW_MAX_D, ARGMAX_MIN_ROWS)


@functools.lru_cache(maxsize=256)
def _argmax_plan(n: int, p: int, vec: bool, sms: int, route: str | None,
                 max_d: int, min_rows: int) -> BatchedPlan:
    """``corr_argmax_plan`` by the 16-byte lane order rather than the
    address, cached: GLISTER and the OMP rounds call ``corr_argmax`` at one
    shape thousands of times a selection, and the plan's arithmetic is host
    time on each call.  The thresholds are arguments, so that the cache
    follows a caller who changes them."""
    rows = (_row_plan(n, p, 1, True, vec, sms)
            if 1 <= p <= max_d and n >= 1 and n < 2 ** 31 else None)
    if route == "rows" and rows is None:
        raise ValueError(f"corr_argmax: the row tiles cannot take "
                         f"({n}, {p})")
    if route == "rows" or (route is None and rows is not None
                           and n >= min_rows):
        return rows
    # the warp kernel's own grid (csrc/common.cuh: blocks_for_rows)
    return BatchedPlan("warps", WARP_ROWS, 0,
                       max(1, min(-(-n // WARP_ROWS), ROWS_MAX_BLOCKS)), 0)


def tile_spans(n: int, d: int, offset: int,
               rows: int = ROW_THREADS) -> list[tuple[int, ...]]:
    """(first row, rows, head, bulk, tail) of each tile of ``rows`` rows as
    the kernel loads it (``start_tile``) from an (n, d) f32 pool whose
    first element lies ``offset`` bytes past a 16-byte boundary: ``bulk``
    bytes by one bulk copy from a 16-byte boundary, the ``head`` before it
    and the ``tail`` after it by plain loads."""
    spans = []
    for r0 in range(0, n, rows):
        k = min(rows, n - r0)
        a = offset + r0 * d * 4
        e = a + k * d * 4
        a16 = min(-(-a // 16) * 16, e)
        e16 = max(e // 16 * 16, a16)
        spans.append((r0, k, a16 - a, e16 - a16, e - e16))
    return spans


def _plan(dev: torch.device, n: int, d: int, b: int, argmax: bool,
          per_problem: bool = False, vec: bool = False) -> BatchedPlan:
    return batched_plan(n, d, b, argmax=argmax, per_problem=per_problem,
                        vec=vec, sms=sm_count(dev))


# corr_argmax_batched's workspace: B key words (one 128-byte line each)
# and a completion counter, per (device, stream), zero when made; B = 1
# for corr_argmax on either route (csrc/corr.cu: kArgmaxDone).  The
# kernel's last block returns them to zero, so a call needs no memset;
# after a failed call the workspace is dropped and the next call makes a
# new one.  (Make it with a first call before capturing calls into a CUDA
# graph.)
KEY_STRIDE = 16
_workspaces: dict[tuple[int, int], torch.Tensor] = {}
# bound_max's workspace, per (device, stream), the same way: the key word,
# the count word and the completion counter, one 128-byte line each
# (csrc/bound_max.cu: kWsCount, kWsDone).
BOUND_WS_WORDS = 48
_bound_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(dev: torch.device, s: int, words: int,
               pool: dict | None = None) -> torch.Tensor:
    pool = _workspaces if pool is None else pool
    ws = pool.get((dev.index, s))
    if ws is None or ws.numel() < words:
        ws = torch.zeros((max(words, 64),), dtype=torch.int64, device=dev)
        pool[(dev.index, s)] = ws
    return ws


def corr_batched(grads: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Batched scores ``grads @ vecs.T`` in f32, pool-major: grads (n, d)
    f32, vecs (B, d) f32 -> (n, B) f32, column b equal to
    ``corr(grads, vecs[b])``."""
    if not grads.is_cuda:
        return ref.corr_batched_ref(grads, vecs)
    check_matrix("grads", grads, (torch.float32,))
    n, d = grads.shape
    dev = grads.device
    bsz = vecs.shape[0] if vecs.dim() == 2 else -1
    check_array("vecs", vecs, (bsz, d), dev, torch.float32)
    out = torch.empty((n, bsz), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out
    vec = _vec_ok(grads)
    plan = _plan(dev, n, d, bsz, argmax=False, vec=bool(vec))
    code = build.lib().rt_corr_batched(
        dev.index, grads.data_ptr(), vecs.data_ptr(), out.data_ptr(), n, d,
        bsz, vec, int(plan.route == "rows"), plan.rows, plan.groups,
        plan.stages, plan.grid, stream(dev))
    build.check(code, "corr_batched")
    _count("corr_batched", grads, bsz, False)
    return out


def corr_argmax_batched(mat: torch.Tensor, w: torch.Tensor,
                        base_t: torch.Tensor, mask_t: torch.Tensor,
                        absolute: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """B fused masked argmaxes of ``base - mat @ w`` (optionally abs).

    mat (n, p) f32 shared by every problem, or (B, n, p) f32 one per
    problem; w (B, p) f32; base_t (n, B) f32 and mask_t (n, B) bool,
    pool-major -> (indices i32 (B,), scores f32 (B,)) on the device.  Per
    problem: the lowest index wins a tie, an all-masked column gives
    (0, -inf).  The (n, B) scores are never written to device memory.
    """
    if not mat.is_cuda:
        return ref.corr_argmax_batched_ref(mat, w, base_t, mask_t,
                                           absolute=absolute)
    dev = mat.device
    if mat.dim() not in (2, 3):
        raise ValueError("mat must be (n, p) or (B, n, p), got shape "
                         f"{tuple(mat.shape)}")
    per_problem = mat.dim() == 3
    n, p = mat.shape[-2:]
    bsz = mat.shape[0] if per_problem else (w.shape[0] if w.dim() == 2
                                            else -1)
    check_array("mat", mat, tuple(mat.shape), dev, torch.float32)
    if n >= 2 ** 31:
        raise ValueError(f"mat has {n} rows; at most 2^31 - 1")
    check_array("w", w, (bsz, p), dev, torch.float32)
    check_array("base_t", base_t, (n, bsz), dev, torch.float32)
    check_array("mask_t", mask_t, (n, bsz), dev, torch.bool)
    idx = torch.empty((bsz,), dtype=torch.int32, device=dev)
    val = torch.empty((bsz,), dtype=torch.float32, device=dev)
    if bsz == 0:
        return idx, val
    vec = int(mat.data_ptr() % 16 == 0 and p % 4 == 0)
    plan = _plan(dev, n, p, bsz, argmax=True, per_problem=per_problem,
                 vec=bool(vec))
    s = stream(dev)
    ws = _workspace(dev, s, KEY_STRIDE * bsz + 1)
    code = build.lib().rt_corr_argmax_batched(
        dev.index, mat.data_ptr(), w.data_ptr(), base_t.data_ptr(),
        mask_t.data_ptr(), n, p, bsz, int(per_problem), int(absolute), vec,
        int(plan.route == "rows"), plan.rows, plan.groups, plan.stages,
        plan.grid, ws.data_ptr(), idx.data_ptr(), val.data_ptr(), s)
    if code != 0:
        _workspaces.pop((dev.index, s), None)
    build.check(code, "corr_argmax_batched")
    _count("corr_argmax_batched", mat, bsz, per_problem)
    return idx, val


# -- bound_max's launch plan (csrc/bound_max.cu) ----------------------------
# The source owns the tile layout (BoundLayout) and its constants
# (kBoundRows, kBoundMaxTiles, kBoundMaxStages) and refuses a launch that
# does not fit; these mirror them for the plan.

BOUND_ROWS = 256        # rows a tile, one a thread (kBoundRows)
BOUND_MAX_TILES = 64    # tiles a block walks, at most (kBoundMaxTiles)
BOUND_MIN_ROWS = 1024   # smaller n takes the row loop, and so do
BOUND_MIN_D = 32        # narrower rows (PERF.md §6)
BOUND_BLOCKS_PER_SM = 8  # 256-thread blocks an SM holds
BOUND_SMEM = BLOCK_SMEM - 1024  # its dynamic shared memory (kMaxSmem)
ROWS_MAX_BLOCKS = 132 * 8 * 4  # the row loop's grid cap (kMaxBlocks)


@dataclass(frozen=True)
class BoundPlan:
    """How ``bound_max`` launches.  ``route`` "tiles": tiles of ``rows``
    rows, the live ones copied into a ring of ``stages`` shared-memory
    slots (``smem`` bytes of dynamic shared memory), ``skew`` where a
    warp's rows would share a few banks; "rows": the row loop, one
    thread a row in device memory.  ``grid`` blocks."""
    route: str
    rows: int
    stages: int
    grid: int
    smem: int
    skew: bool = False


def bound_smem(d: int, itemsize: int, stages: int) -> int:
    """Dynamic shared memory of a tile block, the total of the kernel's
    ``BoundLayout``: barriers, the residual (d floats), ``stages`` slots of
    a tile's rows."""
    return (_align128(128 + 4 * d)
            + stages * _align128(BOUND_ROWS * d * itemsize))


def bound_max_plan(n: int, d: int, itemsize: int, rows_addr: int,
                   mask_addr: int, sms: int = 132,
                   route: str | None = None) -> BoundPlan:
    """The launch of ``bound_max`` over (n, d) rows of ``itemsize`` bytes
    at ``rows_addr`` with the mask at ``mask_addr``, on a card of ``sms``
    SMs; ``route`` forces one route (ValueError where the tiles cannot
    take the call).

    The tile route takes n >= ``BOUND_MIN_ROWS``, d >= ``BOUND_MIN_D`` and
    both addresses on a 16-byte boundary (the tile's bulk copy and the
    mask's 16-byte loads): one slot a block where every tile gets its own
    block in one wave, as at the streaming arenas, else a persistent wave
    with a ring of two and at most ``BOUND_MAX_TILES`` tiles a block; a
    skewed column walk where a warp's rows share banks (``bank_ways`` >= 4).
    Everything else takes the row loop.  On an H100 (PERF.md §6) the row
    loop, one device operation as well, is the faster under 32
    columns (8.2 against 9.0 us at the (88 064, 10) arena), where a warp's
    32 rows span at most 2 KB; the tiles from 32 (10.8 against 14.2 us at
    (88 064, 65), from n = 1 024)."""
    tiles_ok = (d >= 1 and n >= 1 and rows_addr % 16 == 0
                and mask_addr % 16 == 0
                and bound_smem(d, itemsize, 1) <= BOUND_SMEM)
    if route == "tiles" and not tiles_ok:
        raise ValueError(f"bound_max: the tile route cannot take n {n}, d "
                         f"{d} at addresses {rows_addr:#x} / {mask_addr:#x}")
    if route not in (None, "tiles", "rows"):
        raise ValueError(f"bound_max: no route {route!r}")
    if route == "tiles" or (route is None and tiles_ok
                            and n >= BOUND_MIN_ROWS and d >= BOUND_MIN_D):
        tiles = -(-n // BOUND_ROWS)

        def per_sm(smem):
            return min(SM_SMEM // (smem + 1024), BOUND_BLOCKS_PER_SM)

        skew = bank_ways(d * itemsize) >= 4
        smem = bound_smem(d, itemsize, 1)
        if tiles <= sms * per_sm(smem):
            return BoundPlan("tiles", BOUND_ROWS, 1, tiles, smem, skew)
        smem2 = bound_smem(d, itemsize, 2)
        stages, smem = (2, smem2) if smem2 <= BOUND_SMEM else (1, smem)
        grid = min(tiles, max(sms * per_sm(smem),
                              -(-tiles // BOUND_MAX_TILES)))
        return BoundPlan("tiles", BOUND_ROWS, stages, grid, smem, skew)
    grid = max(1, min(-(-n // BOUND_ROWS), ROWS_MAX_BLOCKS))
    return BoundPlan("rows", BOUND_ROWS, 0, grid, 0)


def bound_max(rows: torch.Tensor, norms: torch.Tensor, errn: torch.Tensor,
              residual: torch.Tensor, acc, thresh, mask: torch.Tensor,
              absolute: bool = False, *, route: str | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused interval-bound scan of a compressed row cache; the contract is
    ``ref.bound_max_ref``'s: (max u f32 (), its index i32 (), count i32 ()).

    rows (n, d) bf16/f32, norms/errn (n,) f32, residual (d,) f32, mask (n,)
    bool.  ``acc`` is a Python float (a tensor is read on the host);
    ``thresh`` a float or a 0-d f32 tensor on the rows' device, which the
    kernel reads in place, so a device threshold costs no host sync.

    A CUDA call launches by ``bound_max_plan`` (``route`` forces one, for
    measurement): one device operation, whose last block writes the three
    outputs and returns the stream's workspace to zero.
    """
    if not rows.is_cuda:
        return ref.bound_max_ref(rows, norms, errn, residual, acc, thresh,
                                 mask, absolute=absolute)
    check_matrix("rows", rows, _DTYPES)
    n, d = rows.shape
    dev = rows.device
    check_vector("norms", norms, n, dev, torch.float32)
    check_vector("errn", errn, n, dev, torch.float32)
    check_vector("residual", residual, d, dev, torch.float32)
    check_vector("mask", mask, n, dev, torch.bool)
    if not isinstance(thresh, torch.Tensor):
        thresh = torch.full((), float(thresh), dtype=torch.float32,
                            device=dev)
    if (thresh.device != dev or thresh.dtype != torch.float32
            or thresh.numel() != 1):
        raise ValueError("thresh must be one float32 on the rows' device, "
                         f"got {thresh.dtype} {tuple(thresh.shape)} on "
                         f"{thresh.device}")
    plan = bound_max_plan(n, d, rows.element_size(), rows.data_ptr(),
                          mask.data_ptr(), sm_count(dev), route)
    idx = torch.empty((), dtype=torch.int32, device=dev)
    val = torch.empty((), dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    s = stream(dev)
    ws = _workspace(dev, s, BOUND_WS_WORDS, _bound_workspaces)
    code = build.lib().rt_bound_max(
        dev.index, rows.data_ptr(), _DTYPES[rows.dtype], norms.data_ptr(),
        errn.data_ptr(), residual.data_ptr(), float(acc), thresh.data_ptr(),
        mask.data_ptr(), n, d, int(absolute), int(plan.route == "tiles"),
        plan.rows, plan.stages, int(plan.skew), plan.grid, ws.data_ptr(),
        idx.data_ptr(), val.data_ptr(), count.data_ptr(), s)
    if code != 0:
        _bound_workspaces.pop((dev.index, s), None)
    build.check(code, "bound_max")
    _count("bound_max", rows)
    bound_routes[plan.route] += 1
    return val, idx, count
