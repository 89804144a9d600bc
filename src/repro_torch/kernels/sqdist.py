"""Wrapper of the pairwise squared-distance kernel ``sqdist``.

The CUDA sources are ``csrc/sqdist_tc.cu`` (the tensor cores) and
``csrc/sqdist.cu`` (FFMA); they replace the Pallas kernel
``repro/kernels/sqdist.py:sqdist``.  CUDA tensors go to a kernel (or raise),
CPU tensors to the plain version in ``ref.py``.  ``launches`` counts kernel
launches, and nothing else: one a call, whatever the route;
``sqdist_routes`` counts them by route.

A call launches by ``sqdist_plan``, a pure function of the shapes, the dtype
and whether ``a`` is ``b``: "tc-sym" (``a`` is ``b``, the resident build's
only call: the tensor cores compute each unordered pair once and write it
to both places, so the result is bitwise symmetric), "tc" (the tensor cores
over every tile) or "ffma" (``sqdist.cu``, for what the tensor cores cannot
take or lose on).  The tensor cores' arithmetic is ``fl_gain.dot_3xtf32``;
``emulate_sqdist_tc`` runs the whole function with it on any device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.args import (BLOCK_SMEM, check_matrix, sm_count,
                                      stream)
from repro_torch.kernels.fl_gain import dot_3xtf32

launches = {"sqdist": 0}
sqdist_routes = {"tc-sym": 0, "tc": 0, "ffma": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# -- the launch plan (csrc/sqdist_tc.cu) --------------------------------------
# The source owns the tensor-core kernel's layout and its constants (kSqTile,
# kSqMaxK8F32, kSqMaxK8Bf16, kSqStageBytes, kSqAlignSlack, kSqStaticSmem) and
# refuses a launch it has no form for; these mirror them for the plan.

SQ_TILE = 128            # output tile rows and columns
SQ_MAX_K8 = {4: 10, 2: 20}   # by itemsize: f32 hi + lo, d <= 80; bf16 hi
SQ_PLANE = SQ_TILE * 32  # a 128-row plane of 32-byte rows
SQ_STAGE_BYTES = 65_536  # the staged output boxes
SQ_ALIGN_SLACK = 1024
SQ_STATIC_SMEM = 1088   # the barriers and two tiles' column norms
FFMA_TILE = (128, 64)    # the FFMA kernel's (rows, columns) a block
FFMA_MAX_ROWS = 65_535 * 128  # its grid's rows
# Below this many products (n m d) the FFMA kernel wins: its one launch
# against the tensor cores' three or four (the norms, the prologue, the
# tiles and, when a is b, the diagonal), ~18-25 µs in all.  On an H100
# (PERF.md §6, tools/kernel_turns.py --routes) the FFMA kernel is faster
# up to 1 024^2 outputs at d 65 and 2 048^2 at d 10, the tensor cores
# from 2 048^2 and 4 096^2; 2^27 splits every measured shape so.
TC_MIN_WORK = 1 << 27


def sq_smem(planes: int) -> int:
    """Dynamic shared memory of a tensor-core block: the alignment slack,
    the staged boxes, and A's and B's ``planes`` planes."""
    return SQ_ALIGN_SLACK + SQ_STAGE_BYTES + 2 * planes * SQ_PLANE


@dataclass(frozen=True)
class SqdistPlan:
    """How ``sqdist`` launches.  "tc-sym" / "tc": the prologue (the
    operands into ``planes`` 32-byte planes each: hi and lo for f32, hi for
    bf16, ``k8`` k steps a pass), then ``grid`` persistent blocks over
    ``tiles`` output tiles of 128 x 128 (on "tc-sym" the tiles I <= J),
    ``smem`` bytes of dynamic shared memory, written by TMA stores when
    ``tma_store`` (m % 4 == 0: 16-byte row strides), else by the blocks'
    threads.  "ffma": ``grid`` blocks of (128, 64)."""
    route: str
    k8: int
    planes: int
    tiles: int
    grid: int
    smem: int
    tma_store: bool


def sqdist_plan(n: int, m: int, d: int, itemsize: int, same: bool,
                sms: int = 132, route: str | None = None) -> SqdistPlan:
    """The launch of ``sqdist`` over a (n, d) and b (m, d) of ``itemsize``
    bytes (4: f32, 2: bf16), ``same`` when a is b, on a card of ``sms``
    SMs; ``route`` forces one ("tc" on ``same`` inputs computes every
    tile), ValueError where it cannot take the call.

    The tensor cores take f32 rows of up to 80 columns (k8 = ceil(d / 8) <=
    10, hi and lo) and bf16 rows of up to 160 (k8 rounded up to an even
    count <= 20, hi only), every n and m below 2^31, from ``TC_MIN_WORK``
    products n m d: the craig-resident path's (45 000, 45 000, 65) f32
    takes "tc-sym".  Smaller calls and wider rows take the FFMA kernel."""
    return _plan(n, m, d, itemsize, same, sms, route, TC_MIN_WORK)


@functools.lru_cache(maxsize=256)
def _plan(n: int, m: int, d: int, itemsize: int, same: bool, sms: int,
          route: str | None, min_work: int) -> SqdistPlan:
    """``sqdist_plan``, cached; the threshold is an argument, so that the
    cache follows a caller who changes it."""
    if route not in (None, "tc-sym", "tc", "ffma"):
        raise ValueError(f"sqdist: no route {route!r}")
    if route == "tc-sym" and not same:
        raise ValueError("sqdist: route 'tc-sym' needs a is b")
    k8 = -(-d // 8)
    if itemsize == 2:
        k8 += k8 % 2
    tc_ok = (itemsize in SQ_MAX_K8 and 1 <= k8 <= SQ_MAX_K8[itemsize]
             and 1 <= n < 2 ** 31 and 1 <= m < 2 ** 31)
    if route in ("tc-sym", "tc") and not tc_ok:
        raise ValueError(f"sqdist: the tensor cores cannot take ({n}, {m}, "
                         f"{d}) of {itemsize}-byte elements")
    if route is None:
        route = ("ffma" if not tc_ok or n * m * d < min_work
                 else "tc-sym" if same else "tc")
    if route == "ffma":
        if n > FFMA_MAX_ROWS:
            raise ValueError(f"sqdist: a has {n} rows; the FFMA grid takes "
                             f"at most {FFMA_MAX_ROWS}")
        tiles = -(-n // FFMA_TILE[0]) * -(-m // FFMA_TILE[1])
        return SqdistPlan("ffma", 0, 0, tiles, tiles, 0, False)
    planes = 2 * k8 if itemsize == 4 else k8
    ti, tj = -(-n // SQ_TILE), -(-m // SQ_TILE)
    tiles = ti * (ti + 1) // 2 if route == "tc-sym" else ti * tj
    smem = sq_smem(planes)
    assert smem + SQ_STATIC_SMEM <= BLOCK_SMEM
    return SqdistPlan(route, k8, planes, tiles, min(tiles, sms), smem,
                      m % 4 == 0)


def block_tiles(block: int, grid: int, n: int, m: int,
                sym: bool) -> list[tuple[int, int]]:
    """The output tiles (I, J) of 128 x 128 that block ``block`` of
    ``grid`` computes, in order: positions [block T / grid, (block + 1) T /
    grid) of the tile list, which is row-major over every (I, J), or over
    I <= J when ``sym`` (``csrc/sqdist_tc.cu``: the kernel's ``TileWalk``
    and its ranges)."""
    ti, tj = -(-n // SQ_TILE), -(-m // SQ_TILE)
    tiles = ti * (ti + 1) // 2 if sym else ti * tj
    order = ([(i, j) for i in range(ti) for j in range(i, ti)] if sym
             else [(i, j) for i in range(ti) for j in range(tj)])
    assert len(order) == tiles
    return order[block * tiles // grid:(block + 1) * tiles // grid]


def box_kind(sym: bool, diag: bool, bi: int, bj: int) -> int:
    """How the staged 32 x 32 box (rows 32 bi .., columns 32 bj .. of a
    tile) leaves: 0 not at all, 1 as itself, 2 as itself and transposed, 3
    as itself with its lower half taken from its upper half (a box on a
    diagonal tile's diagonal) (``csrc/sqdist_tc.cu``: ``box_kind``)."""
    if not sym:
        return 1
    if not diag:
        return 2
    return 2 if bi < bj else (3 if bi == bj else 0)


def emulate_sqdist_tc(a: torch.Tensor, b: torch.Tensor,
                      mirror: bool | None = None) -> torch.Tensor:
    """``sqdist`` as the tensor-core routes form it, on any device: the
    squared norms as the wrapper reduces them, the dot products as
    ``dot_3xtf32`` (exact TF32 products summed in f64 and rounded once,
    where the card sums them in f32), the epilogue's expression; with
    ``mirror`` (default: a is b) the upper triangle written to both places
    and the diagonal's dots as the FFMA kernel forms them (fmaf over k in
    order; here each step in f64, rounded to f32), as "tc-sym" writes
    them."""
    if mirror is None:
        mirror = a is b
    af, bf = a.float(), b.float()
    an = af.square().sum(1)
    bn = an if mirror else bf.square().sum(1)
    out = (an[:, None] + bn[None, :] - 2.0 * dot_3xtf32(af, bf)).clamp_min_(
        0.0)
    if mirror:
        out = out.triu() + out.triu(1).T
        dots = torch.zeros_like(an)
        for k in range(af.shape[1]):
            dots = (dots.double() + af[:, k].double() ** 2).float()
        out.diagonal().copy_((an + an - 2.0 * dots).clamp_min_(0.0))
    return out


def _norms(x: torch.Tensor) -> torch.Tensor:
    """The squared row norms of x in f32, in a buffer padded to whole
    tiles of 128 rows (the tensor cores load a tile's 128 at once; the
    padding is never read into a stored element)."""
    rows = x.shape[0]
    out = torch.empty((-(-rows // SQ_TILE) * SQ_TILE,), dtype=torch.float32,
                      device=x.device)
    torch.sum(x.float().square(), 1, out=out[:rows])
    return out


def sqdist(a: torch.Tensor, b: torch.Tensor, *,
           route: str | None = None) -> torch.Tensor:
    """``max(|a_i|^2 + |b_j|^2 - 2 a_i . b_j, 0)``: a (n, d), b (m, d),
    both f32 or both bf16 -> (n, m) f32, accumulated in f32.

    A CUDA call launches by ``sqdist_plan`` (``route`` forces one, for
    measurement).  ``sqdist(a, a)`` on the tensor cores is bitwise
    symmetric; on either route a call gives the same bits as the last."""
    if not a.is_cuda:
        return ref.sqdist_ref(a, b)
    check_matrix("a", a, _DTYPES)
    check_matrix("b", b, _DTYPES)
    dev = a.device
    if b.device != dev or b.dtype != a.dtype or b.shape[1] != a.shape[1]:
        raise ValueError(f"b ({tuple(b.shape)}, {b.dtype}, {b.device}) must "
                         f"match a ({tuple(a.shape)}, {a.dtype}, {dev}) in "
                         "width, dtype and device")
    (n, d), m = a.shape, b.shape[0]
    same = a.data_ptr() == b.data_ptr() and n == m
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return out
    plan = sqdist_plan(n, m, d, a.element_size(), same, sm_count(dev), route)
    an = _norms(a)
    bn = an if same else _norms(b)
    if plan.route == "ffma":
        code = build.lib().rt_sqdist(
            dev.index, a.data_ptr(), b.data_ptr(), _DTYPES[a.dtype],
            an.data_ptr(), bn.data_ptr(), n, m, d, out.data_ptr(),
            stream(dev))
    else:
        sym = plan.route == "tc-sym"
        rows = n if sym else n + m
        split = torch.empty((plan.planes * 8 * rows,), dtype=torch.float32,
                            device=dev)
        code = build.lib().rt_sqdist_tc(
            dev.index, a.data_ptr(), b.data_ptr(), _DTYPES[a.dtype],
            an.data_ptr(), bn.data_ptr(), n, m, d, plan.k8, int(sym),
            plan.grid, split.data_ptr(), out.data_ptr(), stream(dev))
    build.check(code, "sqdist")
    launches["sqdist"] += 1
    sqdist_routes[plan.route] += 1
    return out
