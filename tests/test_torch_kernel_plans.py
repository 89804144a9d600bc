"""The launch plans of ``lastlayer_grad`` and ``bound_max`` as pure
functions, on the CPU.

``lastlayer_grad.lastlayer_plan`` and ``corr.bound_max_plan`` choose each
call's route (the tile route, rows in flight by bulk copy, or the kernel it
replaced) from the shapes and the addresses alone.  These tests hold which
route each shape and address takes, that every tile's bulk copies are
multiples of 16 bytes, that the layouts fit a block's 227 KB of shared
memory and that the grids stay within their limits; and, in numpy, the two
pieces of arithmetic the tile kernels rest on: the serial tree that
replays ``warp_sum``'s butterfly, and the multiply-high division of
``csrc/lastlayer_grad.cu``.  The kernels themselves are held against the
routes they replace, bit for bit, on the card (``test_torch_kernels_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import corr as corr_kernel  # noqa: E402
from repro_torch.kernels import lastlayer_grad as llg_kernel  # noqa: E402

CSRC = Path(llg_kernel.__file__).resolve().parent / "csrc"
ALIGNED = [0x7F00_0000_0000] * 5
SMS = 132


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int(?:64_t)? {name} = (\w+);",
                         text).group(1).replace("kThreads", "256"))


def test_plans_mirror_the_kernels_constants():
    """The plans' constants are the sources' (which refuse any launch that
    does not fit them)."""
    assert _constant("lastlayer_grad.cu", "kTileThreads") == (
        llg_kernel.TILE_THREADS)
    assert _constant("lastlayer_grad.cu", "kTileMaxRows") == (
        llg_kernel.TILE_MAX_ROWS)
    assert _constant("lastlayer_grad.cu", "kTileMaxC") == llg_kernel.TILE_MAX_C
    assert _constant("lastlayer_grad.cu", "kMaxSmem") == llg_kernel.BLOCK_SMEM
    assert _constant("bound_max.cu", "kBoundRows") == corr_kernel.BOUND_ROWS
    assert _constant("bound_max.cu", "kBoundMaxTiles") == (
        corr_kernel.BOUND_MAX_TILES)
    assert corr_kernel.BOUND_SMEM == corr_kernel.BLOCK_SMEM - 1024
    assert "constexpr int64_t kMaxSmem = 232448 - 1024;" in (
        CSRC / "bound_max.cu").read_text()
    # the workspace's three words, a 128-byte line each, inside its size
    done = _constant("bound_max.cu", "kWsDone")
    assert done + 1 <= corr_kernel.BOUND_WS_WORDS


# -- lastlayer_grad ----------------------------------------------------------

def test_lastlayer_plan_by_shape():
    """The routes, tiles and rings of the shapes the paths give the
    kernel: the main path's 45 000 rows in one wave of one-slot blocks,
    the stream path's 1 024-row chunks on the warps."""
    plan = llg_kernel.lastlayer_plan
    main = plan(45000, 64, 10, ALIGNED)
    assert main == llg_kernel.LastlayerPlan(
        "tiles", 128, 1, 352, 128 + 32768 + 5120 + 1024 + 512)
    assert plan(45000, 64, 10, ALIGNED, label_bytes=4).smem == (
        128 + 32768 + 5120 + 512 + 512)
    assert plan(1024, 64, 10, ALIGNED).route == "warps"
    assert plan(1024, 64, 10, ALIGNED, route="tiles").route == "tiles"
    assert plan(45000, 64, 10, ALIGNED, route="warps") == (
        llg_kernel.LastlayerPlan("warps", 8, 0, 4224, 0))
    # C above one term a lane, an empty hidden: the warps
    assert plan(45000, 64, 31, ALIGNED).route == "tiles"
    assert plan(45000, 64, 20, ALIGNED).route == "tiles"
    assert plan(45000, 64, 8, ALIGNED).route == "tiles"
    assert plan(45000, 64, 33, ALIGNED).route == "warps"
    # C 16 and 32: a warp's logits rows on one bank in 16 or 32
    assert plan(45000, 64, 16, ALIGNED).route == "warps"
    assert plan(45000, 64, 32, ALIGNED).route == "warps"
    assert plan(45000, 64, 32, ALIGNED, route="tiles").route == "tiles"
    assert plan(1001, 84, 37, ALIGNED).route == "warps"
    assert plan(45000, 0, 10, ALIGNED).route == "warps"
    assert plan(0, 64, 10, ALIGNED) == llg_kernel.LastlayerPlan(
        "warps", 8, 0, 1, 0)
    # more tiles than a wave: a persistent ring of two
    big = plan(10 ** 6, 64, 10, ALIGNED)
    assert (big.route, big.rows, big.stages) == ("tiles", 128, 2)
    assert big.grid == SMS * (llg_kernel.SM_SMEM // (big.smem + 1024))
    # wide hidden rows: shorter tiles
    wide = plan(45000, 2048, 10, ALIGNED)
    assert wide.route == "tiles" and wide.rows * 2048 < 1 << 16
    # rows too wide for a tile of 4: the warps, and the tiles refuse
    assert plan(45000, 16383, 10, ALIGNED).route == "warps"
    with pytest.raises(ValueError, match="tile route"):
        plan(45000, 16383, 10, ALIGNED, route="tiles")
    with pytest.raises(ValueError, match="tile route"):
        plan(45000, 64, 37, ALIGNED, route="tiles")
    with pytest.raises(ValueError, match="no route"):
        plan(45000, 64, 10, ALIGNED, route="rows")


@pytest.mark.parametrize("which", range(5))
def test_lastlayer_plan_sends_an_unaligned_operand_to_the_warps(which):
    """Any of hidden, logits, labels, resid, hgrad off a 16-byte boundary
    (a view such as ``logits[1:]``) takes the warp route; forcing the
    tiles raises."""
    for off in (4, 8, 12):
        addrs = list(ALIGNED)
        addrs[which] += off
        assert llg_kernel.lastlayer_plan(45000, 64, 10, addrs).route == (
            "warps")
        with pytest.raises(ValueError):
            llg_kernel.lastlayer_plan(45000, 64, 10, addrs, route="tiles")


@pytest.mark.parametrize("label_bytes", [4, 8])
@pytest.mark.parametrize("stages", [1, 2])
def test_lastlayer_tiles_are_16_byte_multiples_and_fit(label_bytes, stages):
    """For every d_h and C from 1 to 1 024 (each against a spread of the
    other): a tile of a multiple of 4 rows, so its hidden, logits and
    labels are multiples of 16 bytes; its layout within 227 KB; its hidden
    part below 2^16 elements (the kernel's division); and where even 4
    rows do not fit, no tile at all."""
    spread = (1, 2, 3, 5, 10, 31, 32, 33, 37, 64, 65, 100, 257, 1000, 1024)
    pairs = ([(dh, c) for dh in range(1, 1025) for c in spread]
             + [(dh, c) for c in range(1, 1025) for dh in spread])
    for dh, c in pairs:
        rows = llg_kernel.tile_rows(dh, c, label_bytes, stages)
        smem = llg_kernel.tile_smem(dh, c, label_bytes, 4, stages)
        if rows == 0:
            assert smem > llg_kernel.BLOCK_SMEM or 4 * dh >= 1 << 16
            continue
        assert rows % 4 == 0 and 4 <= rows <= llg_kernel.TILE_MAX_ROWS
        for part in (rows * dh * 4, rows * c * 4, rows * label_bytes):
            assert part % 16 == 0
        assert llg_kernel.tile_smem(dh, c, label_bytes, rows,
                                    stages) <= llg_kernel.BLOCK_SMEM
        assert rows * dh < 1 << 16
        if rows < llg_kernel.TILE_MAX_ROWS:      # the most that fits
            assert (llg_kernel.tile_smem(dh, c, label_bytes, rows + 4,
                                         stages) > llg_kernel.BLOCK_SMEM
                    or (rows + 4) * dh >= 1 << 16)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 45000, 450000, 10 ** 7])
@pytest.mark.parametrize("dh,nc", [(64, 10), (1, 1), (84, 32), (65, 3),
                                   (2048, 10), (12000, 2)])
def test_lastlayer_plan_grid_within_limits(n, dh, nc):
    """A tile plan walks every row once (blocks take tiles blockIdx + k
    grid), one slot only where every tile has its own block, its grid at
    most the tiles and one wave; the warps' grid is the warp kernel's cap."""
    for route in (None, "tiles", "warps"):
        plan = llg_kernel.lastlayer_plan(n, dh, nc, ALIGNED, SMS,
                                         route=route)
        if plan.route == "warps":
            assert plan.smem == 0
            assert plan.grid == max(1, min(-(-n // 8),
                                           llg_kernel.WARP_MAX_BLOCKS))
            continue
        assert route == "tiles" or n >= llg_kernel.TILE_MIN_ROWS
        tiles = -(-n // plan.rows)
        assert plan.smem == llg_kernel.tile_smem(dh, nc, 8, plan.rows,
                                                 plan.stages)
        assert plan.smem <= llg_kernel.BLOCK_SMEM
        per_sm = min(llg_kernel.SM_SMEM // (plan.smem + 1024),
                     llg_kernel.TILE_BLOCKS_PER_SM)
        assert 1 <= plan.grid <= min(tiles, 2 ** 31 - 1)
        if plan.stages == 1 and plan.grid == tiles:
            assert tiles <= SMS * per_sm
        else:
            assert plan.grid == min(tiles, SMS * per_sm)
        walked = sorted(t for blk in range(min(plan.grid, 64))
                        for t in range(blk, tiles, plan.grid))
        assert walked == [t for t in range(tiles) if t % plan.grid < 64]


# -- bound_max ---------------------------------------------------------------

def test_bound_max_plan_by_shape():
    """The streaming arenas: the (86 016, 65) one takes the tiles, one slot
    a block, every tile its own block in one wave; the (88 064, 10) one,
    narrower than ``BOUND_MIN_D``, the row loop; so do a small n and
    unaligned rows or mask; a width whose rows share banks walks its
    columns skewed."""
    plan = corr_kernel.bound_max_plan
    a = 0x7F00_0000_0000
    assert plan(86016, 65, 2, a, a) == corr_kernel.BoundPlan(
        "tiles", 256, 1, 336, 512 + 33280)
    assert plan(88064, 10, 2, a, a) == corr_kernel.BoundPlan(
        "rows", 256, 0, 344, 0)
    assert plan(88064, 10, 2, a, a, route="tiles") == corr_kernel.BoundPlan(
        "tiles", 256, 1, 344, 256 + 5120)
    assert plan(88064, 31, 2, a, a).route == "rows"
    assert plan(88064, 32, 2, a, a).route == "tiles"
    assert plan(1024, 65, 4, a, a).route == "tiles"
    assert plan(1023, 65, 4, a, a).route == "rows"
    assert plan(1023, 65, 4, a, a, route="tiles").route == "tiles"
    # rows[1:] of a bf16 (n, 65): 130 bytes past the base
    assert plan(86015, 65, 2, a + 130, a).route == "rows"
    assert plan(86016, 65, 2, a, a + 1).route == "rows"
    for addr in ((a + 130, a), (a, a + 8)):
        with pytest.raises(ValueError, match="tile route"):
            plan(86016, 65, 2, *addr, route="tiles")
    with pytest.raises(ValueError, match="no route"):
        plan(88064, 10, 2, a, a, route="warps")
    assert plan(0, 10, 2, a, a).grid == 1
    # f32 rows too wide for a slot take the row loop
    assert plan(88064, 300, 4, a, a).route == "rows"
    assert plan(88064, 300, 2, a, a).route == "tiles"
    # the skewed walk: 16-byte-multiple strides put 4+ rows on a bank
    for d, skew in ((32, True), (48, True), (64, True), (65, False),
                    (96, True), (100, False), (129, False), (256, True)):
        assert plan(88064, d, 2, a, a).skew == skew, d
    assert plan(88064, 32, 4, a, a).skew and not plan(88064, 33, 4, a,
                                                      a).skew


def test_bank_ways():
    """A warp's 32 rows a stride apart: 20 bytes (5 words, odd) spread
    them over every bank; 128 bytes put all 32 on one."""
    from repro_torch.kernels.args import bank_ways
    assert [bank_ways(b) for b in (20, 40, 64, 128, 130, 256, 200)] == [
        1, 2, 16, 32, 1, 32, 2]


@pytest.mark.parametrize("itemsize", [2, 4])
def test_bound_max_tiles_are_16_byte_multiples_and_fit(itemsize):
    """For every d from 1 to 1 024: a tile's rows are a multiple of 16
    bytes (256 rows), and where the plan takes the tiles its layout fits
    227 KB; its mask part (256 bytes) is sixteen 16-byte loads."""
    assert corr_kernel.BOUND_ROWS % 16 == 0
    a = 0x7F00_0000_0000
    for d in range(1, 1025):
        assert corr_kernel.BOUND_ROWS * d * itemsize % 16 == 0
        plan = corr_kernel.bound_max_plan(86016, d, itemsize, a, a)
        fits = corr_kernel.bound_smem(d, itemsize, 1) <= (
            corr_kernel.BOUND_SMEM)
        assert (plan.route == "tiles") == (fits
                                           and d >= corr_kernel.BOUND_MIN_D)
        if plan.route == "tiles":
            assert plan.smem == corr_kernel.bound_smem(d, itemsize,
                                                       plan.stages)
            assert plan.smem <= corr_kernel.BOUND_SMEM


@pytest.mark.parametrize("n", [4096, 86016, 88064, 10 ** 6, 10 ** 8,
                               2 ** 31 - 1])
@pytest.mark.parametrize("d,itemsize", [(10, 2), (65, 2), (65, 4), (1, 4),
                                        (200, 4)])
def test_bound_max_plan_grid_within_limits(n, d, itemsize):
    """A tile plan gives each block at most ``BOUND_MAX_TILES`` tiles and
    no block none, its grid within int32; the row loop's grid its cap."""
    a = 0x7F00_0000_0000
    for route in (None, "tiles", "rows"):
        plan = corr_kernel.bound_max_plan(n, d, itemsize, a, a, SMS, route)
        if plan.route == "rows":
            assert plan.grid == max(1, min(-(-n // 256), 132 * 8 * 4))
            continue
        tiles = -(-n // plan.rows)
        assert 1 <= plan.grid <= tiles and plan.grid < 2 ** 31
        assert plan.grid * corr_kernel.BOUND_MAX_TILES >= tiles
        assert plan.stages in (1, 2)
        if plan.stages == 1 and plan.grid == tiles:
            per_sm = min(corr_kernel.SM_SMEM // (plan.smem + 1024),
                         corr_kernel.BOUND_BLOCKS_PER_SM)
            assert tiles <= SMS * per_sm


# -- the tile kernels' arithmetic, mirrored in numpy -------------------------

def _butterfly(x: np.ndarray) -> np.ndarray:
    """``warp_sum``: 32 lanes, x += shfl_xor(x, off) for off 16 .. 1."""
    x = x.copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = (x + x[lanes ^ off]).astype(np.float32)
    return x


def _lane_tree(e: np.ndarray, nc: int, lane: int = 0, off: int = 1):
    """``lane_tree<lane, off>`` of csrc/lastlayer_grad.cu."""
    if off == 32:
        return e[lane] if lane < nc else np.float32(0)
    return np.float32(_lane_tree(e, nc, lane, 2 * off)
                      + _lane_tree(e, nc, lane + off, 2 * off))


def test_lane_tree_replays_the_warp_butterfly_bit_for_bit():
    """Every lane of the butterfly ends with the serial tree's sum, bit
    for bit, for every C from 1 to 32 (lanes past C hold 0), on exp terms
    spread over many binades."""
    rng = np.random.default_rng(0)
    for nc in range(1, 33):
        for _ in range(20):
            e = np.zeros(32, np.float32)
            e[:nc] = np.exp(rng.standard_normal(nc) * 6).astype(np.float32)
            warp = _butterfly(e)
            tree = _lane_tree(e, nc)
            assert np.all(warp.view(np.uint32) == np.float32(tree).view(
                np.uint32)), (nc, warp[0], tree)


def test_hgrad_row_division_is_exact():
    """``(e * (2^32 / d_h + 1)) >> 32 == e / d_h`` for every element e of a
    tile the plan can give (e d_h < 2^32), every d_h from 1 to 2 048 and
    spot checks up to 16 383."""
    for dh in list(range(1, 2049)) + [4095, 4096, 8191, 10000, 16383]:
        rows = max(llg_kernel.tile_rows(dh, 1, 4, 1), 4)
        e = np.arange(rows * dh, dtype=np.uint64)
        inv = np.uint64((1 << 32) // dh + 1)
        assert np.array_equal((e * inv) >> np.uint64(32), e // np.uint64(dh))
