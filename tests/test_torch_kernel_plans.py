"""The launch plans of ``lastlayer_grad``, ``bound_max``,
``fl_gain_argmax_otf``, ``corr_argmax`` and ``sqdist`` as pure functions, on
the CPU.

``lastlayer_grad.lastlayer_plan`` and ``corr.bound_max_plan`` choose each
call's route (the tile route, rows in flight by bulk copy, or the kernel it
replaced) from the shapes and the addresses alone; ``fl_gain.
fl_gain_otf_plan`` chooses the tensor cores or the FFMA tiles, and
``corr.corr_argmax_plan`` the batched argmax's row tiles at B = 1 or the
warp kernel, ``sqdist.sqdist_plan`` the mirrored tensor cores, their full
grid or the FFMA tiles.  These tests hold which
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
from repro_torch.kernels import fl_gain as fl_kernel  # noqa: E402
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
    # the tensor-core on-the-fly scan (fl_gain_tc.cu) and the FFMA one
    for name, value in (("kOtfCols", fl_kernel.OTF_COLS),
                        ("kOtfRows", fl_kernel.OTF_ROWS),
                        ("kOtfMaxStages", fl_kernel.OTF_MAX_STAGES),
                        ("kOtfMaxK8", fl_kernel.OTF_MAX_K8),
                        ("kOtfStaticSmem", fl_kernel.OTF_STATIC_SMEM),
                        ("kAlignSlack", fl_kernel.OTF_ALIGN_SLACK),
                        ("kMaxSmem", fl_kernel.BLOCK_SMEM)):
        assert _constant("fl_gain_tc.cu", name) == value, name
    assert _constant("fl_gain_tc.cu", "kWsDone") + 1 == (
        fl_kernel.OTF_WS_WORDS)
    assert _constant("dot_tile.cuh", "kTileJ") == fl_kernel.FFMA_COLS
    # corr_argmax's workspace: the batched layout at B = 1, both routes
    assert _constant("corr.cu", "kArgmaxDone") == corr_kernel.KEY_STRIDE
    assert _constant("corr_batched.cu", "kKeyStride") == (
        corr_kernel.KEY_STRIDE)


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


# -- fl_gain_argmax_otf ------------------------------------------------------

def test_fl_gain_otf_plan_by_shape():
    """d -> d_pad, the next multiple of wgmma's TF32 depth 8: the paths'
    (45 000, 65) and (45 000, 10) take the tensor cores with four ring
    slots; 104 columns with two; 105 the FFMA kernel (a forced tensor-core
    route raises)."""
    plan = fl_kernel.fl_gain_otf_plan
    assert plan(45000, 65) == fl_kernel.FlOtfPlan(
        "tc", 72, 4, 352, 1024 + 9 * 8192 + 4 * 9 * 4096)
    assert plan(45000, 10) == fl_kernel.FlOtfPlan(
        "tc", 16, 4, 352, 1024 + 2 * 8192 + 4 * 2 * 4096)
    for d, d_pad, stages in ((1, 8, 4), (7, 8, 4), (8, 8, 4), (9, 16, 4),
                             (72, 72, 4), (73, 80, 3), (88, 88, 3),
                             (89, 96, 2), (104, 104, 2)):
        got = plan(1000, d)
        assert (got.route, got.d_pad, got.stages) == ("tc", d_pad, stages)
        assert got.grid == 8
    assert plan(45000, 105) == fl_kernel.FlOtfPlan("ffma", 105, 0, 704, 0)
    assert plan(1, 600).grid == 1
    with pytest.raises(ValueError, match="tensor cores"):
        plan(300, 105, route="tc")
    with pytest.raises(ValueError, match="no route"):
        plan(300, 10, route="warps")
    assert plan(300, 10, route="ffma").route == "ffma"
    # 32-bit offsets: n d_pad < 2^31
    assert plan(2 ** 31 // 72 + 1, 65).route == "ffma"
    assert plan(2 ** 31 // 72, 65).route == "tc"


def test_fl_gain_otf_plan_layouts_fit():
    """For every d: where the plan takes the tensor cores, its dynamic
    shared memory plus the kernel's static part fits a block's 227 KB and
    its ring has the most slots (up to four) that do; where it does not,
    not even two slots fit."""
    budget = fl_kernel.BLOCK_SMEM - fl_kernel.OTF_STATIC_SMEM
    for d in range(1, 300):
        got = fl_kernel.fl_gain_otf_plan(45000, d)
        k8 = -(-d // 8)
        if got.route == "tc":
            assert got.smem == fl_kernel.otf_smem(k8, got.stages) <= budget
            assert got.stages == fl_kernel.OTF_MAX_STAGES or (
                fl_kernel.otf_smem(k8, got.stages + 1) > budget)
        else:
            assert fl_kernel.otf_smem(k8, 2) > budget
            assert d > 104


# -- corr_argmax -------------------------------------------------------------

def test_corr_argmax_plan_at_b1():
    """GLISTER's (45 000, 10) takes the row tiles at B = 1 (the batched
    argmax's plan there, every tile its own block); GRAD-MATCH-PB's
    (703, 10), the wide regime's p 512 and the LM's (16, 4) the warps; a
    pool off a 16-byte boundary takes the same rule (measured, PERF.md
    §6), small pools the warps either way."""
    plan = corr_kernel.corr_argmax_plan
    a = 0x7F00_0000_0000
    glister = plan(45000, 10, a)
    assert glister == corr_kernel.BatchedPlan(
        "rows", 128, 1, 352, corr_kernel.rows_smem(10, 1, 128, 1, True), 1)
    assert plan(45000, 65, a).route == "rows"
    assert plan(45000, 10, a + 4) == glister
    assert plan(703, 10, a) == corr_kernel.BatchedPlan("warps", 8, 0, 88, 0)
    # the warp kernel's own grid: a warp a row, eight a block, capped
    assert plan(8192, 512, a) == corr_kernel.BatchedPlan(
        "warps", 8, 0, 1024, 0)
    assert plan(10 ** 6, 512, a).grid == 132 * 8 * 4
    assert plan(16, 4, a).route == "warps"
    assert plan(4096, 10, a + 4).route == "warps"
    n0 = corr_kernel.ARGMAX_MIN_ROWS
    assert plan(n0, 10, a).route == "rows"
    assert plan(n0 - 1, 10, a).route == "warps"
    assert plan(n0, 97, a).route == "warps"
    assert plan(703, 10, a, route="rows").route == "rows"
    assert plan(45000, 10, a, route="warps").route == "warps"
    with pytest.raises(ValueError, match="row tiles"):
        plan(8192, 512, a, route="rows")
    with pytest.raises(ValueError, match="no route"):
        plan(45000, 10, a, route="tiles")


def test_corr_argmax_plan_is_cached_and_follows_its_thresholds(
        monkeypatch):
    """GLISTER calls corr_argmax thousands of times at one shape: the plan
    is computed once (the same object again for every address that gives
    the same lane order) and still follows a changed threshold."""
    plan = corr_kernel.corr_argmax_plan
    a = 0x7F00_0000_0000
    first = plan(45000, 10, a, SMS)
    assert plan(45000, 10, a + 64, SMS) is first
    # 10 columns take the scalar lanes at any address: one cache entry
    assert plan(45000, 10, a + 4, SMS) is first
    monkeypatch.setattr(corr_kernel, "ARGMAX_MIN_ROWS", 45001)
    assert plan(45000, 10, a, SMS).route == "warps"
    monkeypatch.setattr(corr_kernel, "ROW_MAX_D", 9)
    assert plan(45001, 10, a, SMS).route == "warps"
    with pytest.raises(ValueError, match="row tiles"):
        plan(45000, 10, a, SMS, "rows")
    monkeypatch.undo()
    assert plan(45000, 10, a, SMS) is first


@pytest.mark.parametrize("n", [1, 703, 10240, 45000, 200000, 2 ** 31 - 1])
@pytest.mark.parametrize("p", [1, 10, 64, 65, 96])
def test_corr_argmax_rows_plan_is_the_batched_plan_at_b1(n, p):
    """Where corr_argmax takes the row tiles, its plan is the batched
    argmax's at B = 1 with the batch thresholds lifted: the launch that
    gives the batched kernel's bits."""
    a = 0x7F00_0000_0000
    got = corr_kernel.corr_argmax_plan(n, p, a, SMS, "rows")
    assert got == corr_kernel._row_plan(n, p, 1, True, p % 4 == 0, SMS)
    assert got.route == "rows" and 1 <= got.grid < 2 ** 31
    assert got.smem <= corr_kernel.BLOCK_SMEM


# -- sqdist ------------------------------------------------------------------

def test_sqdist_plan_mirrors_the_kernels_constants():
    """The plan's constants are csrc/sqdist_tc.cu's (which refuses any
    launch that does not fit them)."""
    from repro_torch.kernels import sqdist as sq
    for name, value in (("kSqTile", sq.SQ_TILE),
                        ("kSqMaxK8F32", sq.SQ_MAX_K8[4]),
                        ("kSqMaxK8Bf16", sq.SQ_MAX_K8[2]),
                        ("kSqStageBytes", sq.SQ_STAGE_BYTES),
                        ("kSqAlignSlack", sq.SQ_ALIGN_SLACK),
                        ("kSqStaticSmem", sq.SQ_STATIC_SMEM),
                        ("kSqMaxSmem", sq.BLOCK_SMEM)):
        assert _constant("sqdist_tc.cu", name) == value, name
    assert _constant("dot_tile.cuh", "kTileI") == sq.FFMA_TILE[0]
    assert _constant("dot_tile.cuh", "kTileJ") == sq.FFMA_TILE[1]


def test_sqdist_plan_by_shape_dtype_and_aliasing():
    """The resident build's sqdist(a, a) at (45 000, 65) f32 takes the
    mirrored tensor cores: the 62 128 tiles I <= J of 128 x 128 over 132
    persistent blocks, hi and lo (18 planes), TMA stores (180 000-byte
    rows); a distinct b the full grid; bf16 rows hi only, their depth
    rounded up to an even count; ragged m % 4 != 0 the blocks' own stores;
    small calls and wide rows the FFMA kernel."""
    from repro_torch.kernels import sqdist as sq
    plan = sq.sqdist_plan
    assert plan(45000, 45000, 65, 4, True) == sq.SqdistPlan(
        "tc-sym", 9, 18, 352 * 353 // 2, 132, 1024 + 65536 + 2 * 18 * 4096,
        True)
    assert plan(45000, 45000, 65, 4, False) == sq.SqdistPlan(
        "tc", 9, 18, 352 * 352, 132, 1024 + 65536 + 2 * 18 * 4096, True)
    assert plan(45000, 45000, 65, 4, True, route="tc").tiles == 352 * 352
    bf = plan(4097, 1000, 130, 2, False)
    assert (bf.route, bf.k8, bf.planes, bf.tiles, bf.tma_store) == (
        "tc", 18, 18, 33 * 8, True)
    assert plan(4097, 1000, 129, 2, False).k8 == 18
    assert plan(4097, 1000, 120, 2, False).k8 == 16
    assert plan(4097, 1000, 113, 2, False).k8 == 16
    assert plan(4097, 4097, 65, 4, True).tma_store is False
    assert plan(4097, 4097, 65, 4, True).route == "tc-sym"
    # the widest rows each type takes, and one column more
    assert plan(4097, 4096, 80, 4, False).route == "tc"
    assert plan(4097, 4096, 81, 4, False).route == "ffma"
    assert plan(4097, 4096, 160, 2, False).route == "tc"
    assert plan(4097, 4096, 161, 2, False).route == "ffma"
    with pytest.raises(ValueError, match="tensor cores"):
        plan(4097, 4096, 81, 4, False, route="tc")
    # small calls: the FFMA kernel, unless forced
    small = plan(129, 65, 3, 4, False)
    assert small == sq.SqdistPlan("ffma", 0, 0, 2 * 2, 4, 0, False)
    assert plan(129, 65, 3, 4, False, route="tc").route == "tc"
    assert plan(1, 1, 1, 4, True, route="tc-sym").tiles == 1
    with pytest.raises(ValueError, match="a is b"):
        plan(300, 300, 10, 4, False, route="tc-sym")
    with pytest.raises(ValueError, match="no route"):
        plan(300, 300, 10, 4, True, route="warps")
    with pytest.raises(ValueError, match="FFMA grid"):
        plan(65535 * 128 + 1, 4, 3, 4, False, route="ffma")


def test_sqdist_plan_takes_the_tensor_cores_from_its_threshold(monkeypatch):
    """Calls of at least TC_MIN_WORK products n m d take the tensor cores
    (the measured crossovers: 2 048^2 at d 65, 4 096^2 at d 10, the FFMA
    kernel at 1 024^2 x 65); the plan is cached and follows a changed
    threshold."""
    from repro_torch.kernels import sqdist as sq
    n0 = sq.TC_MIN_WORK // (8 * 1024)
    assert sq.sqdist_plan(n0, 1024, 8, 4, False).route == "tc"
    assert sq.sqdist_plan(n0 - 1, 1024, 8, 4, False).route == "ffma"
    for n, d, route in ((1024, 65, "ffma"), (2048, 65, "tc-sym"),
                        (2048, 10, "ffma"), (4096, 10, "tc-sym")):
        assert sq.sqdist_plan(n, n, d, 4, True).route == route, (n, d)
    first = sq.sqdist_plan(45000, 45000, 65, 4, True, SMS)
    assert sq.sqdist_plan(45000, 45000, 65, 4, True, SMS) is first
    monkeypatch.setattr(sq, "TC_MIN_WORK", 45000 * 45000 * 65 + 1)
    assert sq.sqdist_plan(45000, 45000, 65, 4, True, SMS).route == "ffma"
    monkeypatch.undo()
    assert sq.sqdist_plan(45000, 45000, 65, 4, True, SMS) is first


@pytest.mark.parametrize("itemsize", [2, 4])
def test_sqdist_tc_layouts_fit(itemsize):
    """For every d up to 200: where the plan takes the tensor cores, the
    block's operands (A and B, hi and lo for f32), staged boxes and static
    part fit 227 KB, the depth covers d in k steps of 8 (even for bf16),
    and one instantiation depth more would not have been needed; where it
    does not, the depth exceeds the kernel's most."""
    from repro_torch.kernels import sqdist as sq
    for d in range(1, 201):
        got = sq.sqdist_plan(45000, 45000, d, itemsize, True)
        k8 = -(-d // 8)
        if got.route == "tc-sym":
            assert 8 * got.k8 >= d > 8 * (got.k8 - (2 if itemsize == 2 else 1))
            assert itemsize == 4 or got.k8 % 2 == 0
            assert got.planes == (2 * got.k8 if itemsize == 4 else got.k8)
            assert got.smem == sq.sq_smem(got.planes)
            assert got.smem + sq.SQ_STATIC_SMEM <= sq.BLOCK_SMEM
        else:
            assert got.route == "ffma"
            assert k8 + (k8 % 2 if itemsize == 2 else 0) > sq.SQ_MAX_K8[
                itemsize]


@pytest.mark.parametrize("n", [1, 127, 128, 129, 4097, 45000, 10 ** 6])
@pytest.mark.parametrize("same", [False, True])
def test_sqdist_plan_grid_within_limits(n, same):
    """The tile count is the list's, every block gets at least one tile
    (grid = min(tiles, SMs)), and the ranges cover the list in order."""
    from repro_torch.kernels import sqdist as sq
    plan = sq.sqdist_plan(n, n, 65, 4, same, SMS, "tc-sym" if same else "tc")
    t = -(-n // 128)
    assert plan.tiles == (t * (t + 1) // 2 if same else t * t)
    assert plan.grid == min(plan.tiles, SMS)
    if n <= 4097:
        walked = [x for b in range(plan.grid)
                  for x in sq.block_tiles(b, plan.grid, n, n, same)]
        assert len(walked) == plan.tiles
        assert all(sq.block_tiles(b, plan.grid, n, n, same)
                   for b in range(plan.grid))
