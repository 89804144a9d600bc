"""``corr``'s launch plan (``kernels/corr.py: corr_plan``) as a pure
function, on the CPU.

The plan sends each call to one of three routes that give the same bits
(held on the card by ``test_torch_kernels_cuda.py``): the batched kernel's
row tiles at B = 1 (f32 or bf16 pools of width 1-96 from
``CORR_MIN_ROWS`` rows), the wide route (a block's rows and the residual by
bulk copy, for few wide rows) or the warp kernel.  These tests hold which
route each path's shape takes, in both dtypes, from an address on a 16-byte
boundary and from one 4 bytes past it; that the f32 row tiles are exactly
the batched plan at B = 1; that every tile's span is a multiple of 16
bytes and every layout fits a block's 227 KB of shared memory; the wide
route's grid; the cache; and that a forced route that cannot take the call
raises.
"""

from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import corr as corr_kernel  # noqa: E402

CSRC = Path(corr_kernel.__file__).resolve().parent / "csrc"
SMS = 132
A = 0x7F00_0000_0000            # an allocation's start: 16-byte aligned
ADDRS = {"aligned": A, "4 bytes off": A + 4}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _plan(n, d, dtype, addr=A, route=None, sms=SMS):
    return corr_kernel.corr_plan(n, d, ITEMSIZE[dtype], addr, sms, route)


def _vec(d, itemsize, addr):
    return addr % 16 == 0 and d % (16 // itemsize) == 0


def test_corr_plan_mirrors_the_kernels_constants():
    """The wide route's constants are csrc/corr.cu's, the row tiles'
    csrc/corr_batched.cu's (each source refuses a launch that does not fit
    them)."""
    corr_src = (CSRC / "corr.cu").read_text()
    rows_src = (CSRC / "corr_batched.cu").read_text()
    assert f"constexpr int64_t kMaxSmem = {corr_kernel.BLOCK_SMEM};" in (
        CSRC / "common.cuh").read_text()
    assert f"constexpr int kWideMaxWarps = {corr_kernel.WIDE_MAX_WARPS};" in (
        corr_src)
    assert f"constexpr int kRowMaxD = {corr_kernel.ROW_MAX_D};" in rows_src
    assert f"constexpr int kRowThreads = {corr_kernel.ROW_THREADS};" in (
        rows_src)
    # the layouts' element sizes: the residual in f32, the rows in theirs
    assert "total = rows + align128(warps * d * itemsize + 16);" in corr_src
    assert "slot_bytes = align128(rows * d * itemsize + 16);" in rows_src


@pytest.mark.parametrize("where", ADDRS)
@pytest.mark.parametrize("dtype", ITEMSIZE)
def test_corr_plan_by_path_shape(where, dtype):
    """The streaming arenas, the main path's pool and the large pools take
    the row tiles; GRAD-MATCH-PB's (703, 10), the stream paths' buffers and
    one row the warps; the LM's candidates the wide route; the wide
    regime's (8 192, 512) and the ragged (1 000, 700) the warps (measured,
    PERF.md §6: the warps are as fast there); at either dtype and
    address."""
    addr = ADDRS[where]
    for n, d in ((88064, 10), (86016, 65), (45000, 65), (45000, 10),
                 (200000, 96)):
        assert _plan(n, d, dtype, addr).route == "rows", (n, d)
    for n, d in ((703, 10), (768, 10), (768, 65), (1024, 65), (4096, 64),
                 (1, 65), (1, 10), (0, 65), (16, 4), (8192, 512),
                 (1000, 700), (45000, 97), (300, 128)):
        assert _plan(n, d, dtype, addr).route == "warps", (n, d)
    for n, d in ((16, 2048), (16, 3584), (1, 3584), (16, 700)):
        assert _plan(n, d, dtype, addr).route == "wide", (n, d)


@pytest.mark.parametrize("n", [1, 703, 16384, 45000, 88064, 200000,
                               2 ** 31 - 1])
@pytest.mark.parametrize("d", [1, 10, 12, 64, 65, 96])
@pytest.mark.parametrize("where", ADDRS)
def test_corr_f32_rows_plan_is_the_batched_plan_at_b1(n, d, where):
    """Where corr takes the row tiles in f32, its plan is the batched
    kernel's at B = 1 with the batch thresholds lifted: the launch that
    gives corr_batched's bits; in bf16 the same tile of 128 rows."""
    addr = ADDRS[where]
    got = _plan(n, d, "float32", addr, "rows")
    assert got == corr_kernel._row_plan(n, d, 1, False, _vec(d, 4, addr),
                                        SMS)
    assert got.route == "rows" and got.rows == corr_kernel.ROW_THREADS
    assert got.groups == 1 and 1 <= got.grid < 2 ** 31
    bf = _plan(n, d, "bfloat16", addr, "rows")
    assert bf == corr_kernel._row_plan(n, d, 1, False, _vec(d, 2, addr),
                                       SMS, 2)
    assert bf.rows == corr_kernel.ROW_THREADS and bf.groups == 1


@pytest.mark.parametrize("d", [10, 65, 96])
@pytest.mark.parametrize("stages", [1, 2])
def test_corr_bf16_tiles_are_16_byte_multiples_and_fit(d, stages):
    """A bf16 tile of 128 rows is a whole number of 16-byte units at every
    width (so every tile starts at the pool's own offset from a 16-byte
    boundary), its spans cover the pool exactly with a head and a tail
    under 16 bytes, and the layout fits a block's shared memory; the
    arenas' plans use it."""
    rows = corr_kernel.ROW_THREADS
    assert rows * d * 2 % 16 == 0
    smem = corr_kernel.rows_smem(d, 1, rows, stages, False, 2)
    assert smem <= corr_kernel.BLOCK_SMEM
    assert smem < corr_kernel.rows_smem(d, 1, rows, stages, False, 4)
    for offset in (0, 2, 4, 14):
        n = 1000
        spans = corr_kernel.tile_spans(n, d, offset, rows, itemsize=2)
        assert sum(s[1] for s in spans) == n
        for r0, k, head, bulk, tail in spans:
            assert head < 16 and tail < 16 and bulk % 16 == 0
            assert head + bulk + tail == k * d * 2
            assert (offset + r0 * d * 2 + head) % 16 == 0 or bulk == 0
    for n in (88064, 86016):
        plan = _plan(n, d, "bfloat16")
        assert plan.smem == corr_kernel.rows_smem(d, 1, rows, plan.stages,
                                                  False, 2)
        assert plan.stages * rows * plan.grid >= n


@pytest.mark.parametrize("dtype", ITEMSIZE)
@pytest.mark.parametrize("d", [97, 128, 512, 700, 2048, 3584, 8192, 20000])
def test_corr_wide_layout_fits_and_grid(dtype, d):
    """The wide route's layout (the barrier, the residual, the block's rows)
    fits a block's shared memory wherever the plan takes it; its blocks
    cover the rows once each (the source refuses any other grid), as many
    rows a block as fills the SMs, up to WIDE_MAX_WARPS."""
    itemsize = ITEMSIZE[dtype]
    for n in (1, 16, 131, 132, 133, 1000, 8192, 10 ** 6, 2 ** 31 - 1):
        plan = corr_kernel.wide_plan(n, d, itemsize, SMS)
        assert plan is not None and plan.route == "wide"
        assert plan.smem == corr_kernel.wide_smem(d, itemsize, plan.rows)
        assert plan.smem <= corr_kernel.BLOCK_SMEM
        assert plan.grid == -(-n // plan.rows) and plan.grid < 2 ** 31
        assert plan.rows in (1, 2, 4, corr_kernel.WIDE_MAX_WARPS)
        if plan.rows > 1:
            assert plan.grid >= SMS
        if n <= SMS:
            assert plan.rows == 1
    assert corr_kernel.wide_plan(0, d, itemsize) is None
    assert corr_kernel.wide_plan(2 ** 31, d, itemsize) is None


def test_corr_wide_layout_past_shared_memory_takes_the_warps():
    """Rows whose residual and one row do not fit a block's shared memory
    have no wide launch: the plan gives them the warps, and forcing the
    wide route raises, naming it."""
    wide = corr_kernel.wide_smem
    widest = max(d for d in range(20000, 40000, 8)
                 if wide(d, 4, 1) <= corr_kernel.BLOCK_SMEM)
    assert corr_kernel.wide_plan(16, widest, 4) is not None
    assert corr_kernel.wide_plan(16, widest + 8, 4) is None
    assert _plan(16, widest + 8, "float32").route == "warps"
    with pytest.raises(ValueError, match="wide route"):
        _plan(16, widest + 8, "float32", route="wide")
    # wider bf16 rows fit (two bytes an element, the residual still f32)
    assert corr_kernel.wide_plan(16, widest + 8, 2) is not None


def test_corr_forced_routes_that_do_not_fit_raise():
    """A forced route whose layout cannot take the call raises a
    ValueError that names it; one that can is taken at any size."""
    with pytest.raises(ValueError, match="rows route"):
        _plan(16, 3584, "float32", route="rows")
    with pytest.raises(ValueError, match="rows route"):
        _plan(45000, 97, "bfloat16", route="rows")
    with pytest.raises(ValueError, match="rows route"):
        _plan(0, 65, "float32", route="rows")
    with pytest.raises(ValueError, match="wide route"):
        _plan(0, 700, "float32", route="wide")
    with pytest.raises(ValueError, match="no route"):
        _plan(45000, 65, "float32", route="tiles")
    assert _plan(703, 10, "float32", route="rows").route == "rows"
    assert _plan(1, 65, "bfloat16", route="rows").route == "rows"
    assert _plan(45000, 65, "float32", route="wide").route == "wide"
    # the warp kernel's own grid (csrc/common.cuh: blocks_for_rows): a warp
    # a row, eight a block, capped
    assert _plan(703, 10, "float32", route="warps") == (
        corr_kernel.BatchedPlan("warps", 8, 0, 88, 0))
    assert _plan(45000, 65, "float32", route="warps").grid == (
        corr_kernel.ROWS_MAX_BLOCKS)
    assert _plan(10 ** 7, 512, "float32").grid == corr_kernel.ROWS_MAX_BLOCKS


def test_corr_plan_is_cached_and_follows_its_thresholds(monkeypatch):
    """The stream paths call corr ~34 000 times a selection at a few
    shapes: the plan is computed once (the same object again for every
    address that gives the same lane order) and still follows a changed
    threshold."""
    first = _plan(45000, 65, "float32")
    assert _plan(45000, 65, "float32", A + 64) is first
    # 65 columns take the scalar lanes at any address: one cache entry
    assert _plan(45000, 65, "float32", A + 4) is first
    assert _plan(45000, 64, "float32", A + 4) is not _plan(45000, 64,
                                                           "float32")
    monkeypatch.setattr(corr_kernel, "CORR_MIN_ROWS", 45001)
    assert _plan(45000, 65, "float32").route == "warps"
    monkeypatch.setattr(corr_kernel, "ROW_MAX_D", 64)
    assert _plan(45001, 65, "float32").route == "warps"
    with pytest.raises(ValueError, match="rows route"):
        _plan(45001, 65, "float32", route="rows")
    monkeypatch.setattr(corr_kernel, "WIDE_MAX_ROWS", 8)
    assert _plan(16, 3584, "float32").route == "warps"
    monkeypatch.setattr(corr_kernel, "WIDE_MAX_ROWS", 10 ** 6)
    monkeypatch.setattr(corr_kernel, "WIDE_MIN_BYTES", 1)
    assert _plan(8192, 512, "float32").route == "wide"
    monkeypatch.undo()
    assert _plan(45000, 65, "float32") is first
    assert _plan(16, 3584, "float32").route == "wide"


def test_corr_route_counters():
    """corr_routes counts each route beside launches, and reaches
    ``ops.launch_routes``; a CPU tensor takes the plain version, with no
    route counted."""
    import torch
    assert set(corr_kernel.corr_routes) == {"rows", "wide", "warps"}
    before = dict(corr_kernel.corr_routes)
    g = torch.ones((4, 3))
    r = torch.ones((3,))
    assert torch.equal(corr_kernel.corr(g, r), torch.full((4,), 3.0))
    assert corr_kernel.corr_routes == before
    from repro_torch.kernels import ops
    assert {f"corr/{k}" for k in before} <= set(ops.launch_routes())
