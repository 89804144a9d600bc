"""The port's plain batched scoring kernels against the JAX package's, on
the CPU.

``ref.corr_batched_ref`` and ``ref.corr_argmax_batched_ref`` are held
against ``repro/kernels/ref.py`` and against the JAX dispatch
``repro.kernels.ops.corr_batched`` / ``corr_argmax_batched`` run through
the Pallas interpreter (a ``lax.map`` of the single kernels), on the same
numpy inputs, for a shared ``(n, p)`` pool and per-problem ``(B, n, p)``
matrices.  Tolerances: scores to rtol 1e-5 and an absolute 1e-6 of
``sum_j |g_ij v_j|`` (an f32 dot's rounding scale: the libraries sum in
other orders); indices exactly, since the inputs plant no near-tie except
exact ties, which go to the lowest index in every package.  The CPU
wrappers must take exactly these plain versions.  (The CUDA kernels are
held against them on the card by ``test_torch_kernels_cuda.py``.)
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import corr as corr_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _interpret(fn, *args, **kw):
    """``fn`` under the JAX package's Pallas interpreter, restored after."""
    jops.set_backend("interpret")
    try:
        return fn(*args, **kw)
    finally:
        jops.set_backend(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,d,b", [(1, 1, 1), (7, 65, 10), (129, 8, 3),
                                   (300, 33, 32), (257, 512, 4),
                                   (45, 65, 40)])
def test_corr_batched_plain_matches_jax(n, d, b):
    rng = np.random.default_rng(n * 31 + d + b)
    g = rng.standard_normal((n, d)).astype(np.float32)
    v = rng.standard_normal((b, d)).astype(np.float32)
    got = ref.corr_batched_ref(_t(g), _t(v)).numpy()
    assert got.shape == (n, b) and got.dtype == np.float32
    atol = ATOL * np.abs(g[:, None, :] * v[None, :, :]).sum(-1)
    for want in (np.asarray(jref.corr_batched_ref(g, v)),
                 np.asarray(_interpret(jops.corr_batched, jnp.asarray(g),
                                       jnp.asarray(v)))):
        assert want.shape == (n, b)
        assert (np.abs(got - want) <= atol + RTOL * np.abs(want)).all()
    # Column b is the single plain version on vecs[b].
    for j in range(b):
        np.testing.assert_allclose(
            got[:, j], ref.corr_ref(_t(g), _t(v[j])).numpy(), rtol=RTOL,
            atol=float(atol.max()))
    # The CPU wrapper and the dispatch take the plain version.
    np.testing.assert_array_equal(corr_kernel.corr_batched(_t(g),
                                                           _t(v)).numpy(), got)
    np.testing.assert_array_equal(ops.corr_batched(_t(g), _t(v)).numpy(),
                                  got)


def _case(n, p, b, seed, shared, mask_frac=0.7):
    rng = np.random.default_rng(seed)
    shape = (n, p) if shared else (b, n, p)
    mat = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((b, p)).astype(np.float32)
    base = (3 * rng.standard_normal((n, b))).astype(np.float32)
    mask = rng.random((n, b)) < mask_frac
    return mat, w, base, mask


def _check(mat, w, base, mask, absolute):
    """The port's plain version against the JAX reference and the Pallas
    interpreter, and against B single plain calls; returns it."""
    ti, tv = ref.corr_argmax_batched_ref(_t(mat), _t(w), _t(base), _t(mask),
                                         absolute=absolute)
    b = w.shape[0]
    assert ti.dtype == torch.int32 and ti.shape == (b,) and tv.shape == (b,)
    args = tuple(jnp.asarray(a) for a in (mat, w, base, mask))
    for ji, jv in (jref.corr_argmax_batched_ref(mat, w, base, mask,
                                                absolute=absolute),
                   _interpret(jops.corr_argmax_batched, *args,
                              absolute=absolute)):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        jv = np.asarray(jv)
        fin = np.isfinite(jv)
        np.testing.assert_allclose(tv.numpy()[fin], jv[fin], rtol=RTOL)
        np.testing.assert_array_equal(tv.numpy()[~fin], jv[~fin])
    for j in range(b):
        m = mat if mat.ndim == 2 else mat[j]
        si, sv = ref.corr_argmax_ref(_t(m), _t(w[j]), _t(base[:, j]),
                                     _t(mask[:, j]), absolute=absolute)
        assert int(si) == int(ti[j])
        if np.isfinite(float(sv)):
            np.testing.assert_allclose(float(tv[j]), float(sv), rtol=RTOL)
        else:
            assert float(tv[j]) == float(sv)
    gi, gv = corr_kernel.corr_argmax_batched(_t(mat), _t(w), _t(base),
                                             _t(mask), absolute=absolute)
    np.testing.assert_array_equal(gi.numpy(), ti.numpy())
    np.testing.assert_array_equal(gv.numpy(), tv.numpy())
    return ti, tv


@pytest.mark.parametrize("n,p,b", [(1, 1, 1), (7, 65, 10), (300, 70, 32),
                                   (129, 512, 4), (64, 12, 33)])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("absolute", [False, True])
def test_corr_argmax_batched_plain_matches_jax(n, p, b, shared, absolute):
    _check(*_case(n, p, b, n * 7 + p + b, shared), absolute)


@pytest.mark.parametrize("shared", [True, False])
def test_corr_argmax_batched_ties_and_all_masked(shared):
    """Duplicated rows tie exactly and go to the lower row in every
    problem; an all-masked column gives (0, -inf) beside live ones."""
    n, p, b = 400, 24, 5
    mat, w, base, mask = _case(n, p, b, 5, shared)
    if shared:
        mat[1::2] = mat[::2]
    else:
        mat[:, 1::2] = mat[:, ::2]
    base[:] = 0.0
    mask[:] = True
    mask[:, 2] = False
    for absolute in (False, True):
        ti, tv = _check(mat, w, base, mask, absolute)
        live = [j for j in range(b) if j != 2]
        assert all(int(ti[j]) % 2 == 0 for j in live)
        assert int(ti[2]) == 0 and float(tv[2]) == float("-inf")


def test_corr_argmax_batched_single_problem():
    """B = 1 is the single kernel's contract."""
    mat, w, base, mask = _case(129, 9, 1, 11, True)
    ti, tv = _check(mat, w, base, mask, False)
    si, sv = ref.corr_argmax_ref(_t(mat), _t(w[0]), _t(base[:, 0]),
                                 _t(mask[:, 0]))
    assert int(ti[0]) == int(si) and float(tv[0]) == float(sv)


def test_batched_dispatch_modes():
    """Both modes take the plain versions for CPU tensors and launch
    nothing."""
    ops.reset_launch_counts()
    g = torch.ones((5, 3))
    v = torch.stack([torch.ones(3), 2 * torch.ones(3)])
    for mode in (None, "ref"):
        ops.set_backend(mode)
        try:
            assert ops.corr_batched(g, v).tolist() == [[3.0, 6.0]] * 5
            idx, val = ops.corr_argmax_batched(
                g, v, torch.zeros((5, 2)), torch.ones((5, 2), dtype=bool),
                absolute=True)
            assert idx.tolist() == [0, 0] and val.tolist() == [3.0, 6.0]
        finally:
            ops.set_backend(None)
    counts = ops.launch_counts()
    assert counts["corr_batched"] == counts["corr_argmax_batched"] == 0
    assert ops.launch_shapes() == {}


def _class_masks(n, b, seed, taken=0.1):
    """Per-class selection's masks: row i is a candidate of its own class
    only, and a ``taken`` share of the rows is already picked."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, b, n)
    return (np.eye(b, dtype=bool)[labels]
            & (rng.random((n, 1)) >= taken)[:, :1])


@pytest.mark.parametrize("n,p,b", [(300, 65, 10), (257, 12, 4), (64, 9, 33)])
@pytest.mark.parametrize("absolute", [False, True])
def test_corr_argmax_batched_plain_on_class_masks_matches_jax(n, p, b,
                                                              absolute):
    """The main path's masks: one-hot by class, minus the rows taken."""
    mat, w, base, _ = _case(n, p, b, n + 5 * p + b, True)
    mask = _class_masks(n, b, n + b)
    assert mask.sum(1).max() <= 1 and (~mask.any(1)).any()
    _check(mat, w, np.zeros_like(base), mask, absolute)
    _check(mat, w, base, mask, absolute)


@pytest.mark.parametrize("shared", [True, False])
def test_corr_argmax_batched_live_minus_inf_below_masked_rows(shared):
    """A live score of -inf ties with every masked row's -inf: the lowest
    index overall wins, a masked row below the live ones included; a
    problem with a finite live score picks it."""
    n, p, b = 200, 16, 4
    mat, w, base, _ = _case(n, p, b, 17, shared)
    mask = np.zeros((n, b), dtype=bool)
    mask[50:, 0] = True                 # live from row 50, all -inf
    base[:, 0] = -np.inf
    mask[30, 1] = True                  # one live -inf row, above masked 0..29
    base[30, 1] = -np.inf
    mask[::3, 2] = True                 # finite live scores
    mask[7, 3] = True                   # a live -inf at 7, finite at 9
    mask[9, 3] = True
    base[7, 3] = -np.inf
    ti, tv = _check(mat, w, base, mask, False)
    assert ti.tolist()[:2] == [0, 0]
    assert tv.tolist()[:2] == [float("-inf")] * 2
    assert np.isfinite(float(tv[2])) and int(ti[3]) == 9


@pytest.mark.parametrize("d", [1, 8, 12, 63, 64, 65, 96, 97, 512, 700])
@pytest.mark.parametrize("n", [1, 127, 129, 1001, 45000])
def test_batched_launch_plan(n, d):
    """The plan as a pure function: a shared pool of width 1-96 takes row
    tiles, every row in exactly one tile, each tile's bulk copy a multiple
    of 16 bytes from a 16-byte boundary at any start offset, the shared
    memory the layout's and within a block's 227 KB; a ring of one slot
    only where every tile has its own block, else a persistent wave;
    per-problem matrices and d > 96 take the warps."""
    for b, argmax, vec in itertools.product((1, 8, 10, 16, 32, 40),
                                            (False, True), (False, True)):
        if vec and d % 4:
            continue
        plan = corr_kernel.batched_plan(n, d, b, argmax=argmax, vec=vec)
        per_problem = corr_kernel.batched_plan(n, d, b, argmax=True,
                                               per_problem=True)
        assert per_problem.route == "warps" and per_problem.smem == 0
        if (d > corr_kernel.ROW_MAX_D or n < corr_kernel.ROW_MIN_ROWS
                or n * b < corr_kernel.ROW_MIN_PAIRS):
            assert plan.route == "warps" and plan.smem == 0
            assert 1 <= plan.grid <= 132 * corr_kernel.WARP_BLOCKS_PER_SM
            continue
        assert plan.route == "rows", (n, d, b, argmax)
        groups, per_thread = corr_kernel.row_split(b, argmax, vec)
        if -(-n // (128 * per_thread // groups)) < 132:
            groups, per_thread = min(4, 1 << (b.bit_length() - 1)), 1
        assert plan.groups == groups
        assert plan.rows == 128 * per_thread // groups
        tiles = -(-n // plan.rows)
        assert plan.smem == corr_kernel.rows_smem(d, b, plan.rows,
                                                  plan.stages, argmax)
        assert plan.smem <= corr_kernel.BLOCK_SMEM
        per_sm = min(corr_kernel.SM_SMEM // (plan.smem + 1024),
                     corr_kernel.ROW_BLOCKS_PER_SM[per_thread])
        if plan.stages == 1:
            assert plan.grid == tiles
        else:
            assert plan.stages == 2
            assert plan.grid == min(tiles, 132 * per_sm) < tiles
        # Blocks walk tiles blockIdx + k grid: each tile once.
        walked = sorted(t for blk in range(plan.grid)
                        for t in range(blk, tiles, plan.grid))
        assert walked == list(range(tiles))
        for offset in (0, 4, 8, 12):
            spans = corr_kernel.tile_spans(n, d, offset, plan.rows)
            assert [s[0] for s in spans] == list(range(0, n, plan.rows))
            assert sum(s[1] for s in spans) == n
            for r0, rows, head, bulk, tail in spans:
                assert head + bulk + tail == rows * d * 4
                assert bulk % 16 == 0 and head < 16 and tail < 16
                if bulk:
                    assert (offset + r0 * d * 4 + head) % 16 == 0
                if offset == 0 and d % 4 == 0:
                    assert head == 0        # 16-byte rows: no head


def test_batched_launch_plan_by_shape():
    """The routes, tiles and rings of the shapes the paths give the
    kernels."""
    plan = corr_kernel.batched_plan
    # gradmatch: one row a thread, every tile its own block, one slot
    # (barriers and vectors 4 480 bytes, keys 10 240, a 33 408-byte slot)
    main = plan(45000, 65, 10, argmax=True)
    assert main == corr_kernel.BatchedPlan("rows", 128, 1, 352,
                                           4480 + 10240 + 33408, 1)
    # its c0: two rows a thread, two groups of 5 problems, one slot
    c0 = plan(45000, 65, 10, argmax=False)
    assert (c0.rows, c0.groups, c0.stages, c0.grid) == (128, 2, 1, 352)
    # batched: two rows a thread, four groups, 64-row tiles, a ring
    served = plan(45000, 65, 32, argmax=True)
    assert (served.route, served.rows, served.groups) == ("rows", 64, 4)
    assert served.stages >= 2 and served.grid < -(-45000 // 64)
    # The 16-byte order keeps one row a thread.
    assert plan(45000, 64, 32, argmax=False, vec=True).groups == 1
    assert plan(4, 8192, 512, argmax=True, per_problem=True).route == "warps"
    assert plan(8192, 512, 4, argmax=False).route == "warps"
    assert plan(8192, 64, 4, argmax=True, per_problem=True).route == "warps"
    # A pool of more tiles than one wave of blocks: a persistent ring.
    big = plan(450000, 65, 10, argmax=True)
    assert (big.stages, big.grid) == (2, 264)
    # A batch whose keys and vectors overflow shared memory takes the warps.
    assert plan(45000, 96, 160, argmax=True).route == "warps"
    assert plan(45000, 96, 160, argmax=False).route == "rows"
    # A small pool or batch takes the warps: the row tiles' set-up
    # outlasts it.
    assert plan(1001, 63, 3, argmax=False).route == "warps"
    assert plan(2047, 65, 32, argmax=True).route == "warps"
    assert plan(2048, 65, 8, argmax=True).route == "rows"
    assert plan(16383, 65, 1, argmax=True).route == "warps"
    assert plan(16384, 65, 1, argmax=True).route == "rows"
    # Fewer tiles than SMs: four threads share a row's problems.
    few = plan(4097, 12, 40, argmax=True, vec=True)
    assert (few.route, few.rows, few.groups) == ("rows", 32, 4)
    assert plan(0, 65, 3, argmax=True).grid == 1
