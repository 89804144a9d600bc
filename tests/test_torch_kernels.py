"""The port's plain kernel versions against the JAX package's, on the CPU.

Each plain PyTorch version in ``repro_torch/kernels/ref.py`` is held
against ``repro/kernels/ref.py`` and against the Pallas kernel run by the
Pallas interpreter, on the same numpy inputs.  The port's kernel wrappers,
given CPU tensors, must take exactly these plain versions.  (The CUDA
kernels themselves are held against the plain versions on the card by
``test_torch_kernels_cuda.py``.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.corr import bound_max as pallas_bound_max  # noqa: E402
from repro.kernels.corr import corr as pallas_corr  # noqa: E402
from repro.kernels.corr import corr_argmax as pallas_corr_argmax  # noqa: E402
from repro.kernels.fl_gain import (  # noqa: E402
    fl_gain_argmax as pallas_fl_gain_argmax)
from repro.kernels.fl_gain import (  # noqa: E402
    fl_gain_argmax_otf as pallas_fl_gain_argmax_otf)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.lastlayer_grad import (  # noqa: E402
    hidden_grad_fused as pallas_hidden_grad)
from repro.kernels.lastlayer_grad import (  # noqa: E402
    lastlayer_grad as pallas_lastlayer_grad)
from repro.kernels.sqdist import sqdist as pallas_sqdist  # noqa: E402
from repro_torch.kernels import corr as corr_kernel  # noqa: E402
from repro_torch.kernels import fl_gain as fl_gain_kernel  # noqa: E402
from repro_torch.kernels import sqdist as sqdist_kernel  # noqa: E402
from repro_torch.kernels import lastlayer_grad as llg_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _np(a):
    return np.asarray(a)


# Ragged n and d: neither a multiple of the TPU's 128-row nor 512-col tiles.
# The absolute tolerance is 1e-6 of sum_j |g_ij r_j|, the scale of an f32
# dot product's rounding error (its worst case is ~d * 6e-8 of that sum):
# two libraries summing the same terms in different orders differ by a few
# 1e-6 on rows whose dot product cancels to near zero, already at d = 65.
@pytest.mark.parametrize("n,d", [(1, 1), (7, 65), (129, 8), (300, 96),
                                 (257, 33), (300, 700), (257, 512)])
def test_corr_plain_matches_jax(n, d):
    rng = np.random.default_rng(n * 31 + d)
    g = rng.standard_normal((n, d)).astype(np.float32)
    r = rng.standard_normal(d).astype(np.float32)
    got = ref.corr_ref(torch.from_numpy(g), torch.from_numpy(r)).numpy()
    atol = ATOL * np.abs(g * r).sum(axis=1)
    for want in (_np(jref.corr_ref(g, r)),
                 _np(pallas_corr(jnp.asarray(g), jnp.asarray(r),
                                 interpret=True))):
        assert (np.abs(got - want) <= atol + RTOL * np.abs(want)).all()
    # The wrapper takes the plain version for a CPU tensor.
    np.testing.assert_array_equal(
        corr_kernel.corr(torch.from_numpy(g), torch.from_numpy(r)).numpy(),
        got)


def _argmax_case(n, p, seed, absolute, mask_frac=0.7):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, p)).astype(np.float32)
    w = rng.standard_normal(p).astype(np.float32)
    base = (3 * rng.standard_normal(n)).astype(np.float32)
    mask = rng.random(n) < mask_frac
    return c, w, base, mask


def _check_argmax(c, w, base, mask, absolute):
    ti, tv = ref.corr_argmax_ref(torch.from_numpy(c), torch.from_numpy(w),
                                 torch.from_numpy(base),
                                 torch.from_numpy(mask), absolute=absolute)
    assert ti.dtype == torch.int32 and ti.shape == () and tv.shape == ()
    for ji, jv in (jref.corr_argmax_ref(c, w, base, mask, absolute=absolute),
                   pallas_corr_argmax(jnp.asarray(c), jnp.asarray(w),
                                      jnp.asarray(base), jnp.asarray(mask),
                                      absolute=absolute, interpret=True)):
        assert int(ti) == int(ji)
        if np.isfinite(float(jv)):
            np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
        else:
            assert float(tv) == float(jv)
    return int(ti), float(tv)


@pytest.mark.parametrize("n,p", [(1, 1), (7, 65), (300, 700), (129, 512)])
@pytest.mark.parametrize("absolute", [False, True])
def test_corr_argmax_plain_matches_jax(n, p, absolute):
    _check_argmax(*_argmax_case(n, p, n * 7 + p, absolute), absolute)


def test_corr_argmax_plain_ties_go_to_lowest_index():
    """Duplicated rows give exactly tied scores, within and across the
    TPU's 128-row tiles."""
    rng = np.random.default_rng(5)
    c = rng.standard_normal((400, 24)).astype(np.float32)
    c[1::2] = c[::2]
    w = rng.standard_normal(24).astype(np.float32)
    base = np.zeros(400, np.float32)
    mask = np.ones(400, bool)
    for absolute in (False, True):
        i, _ = _check_argmax(c, w, base, mask, absolute)
        assert i % 2 == 0
    flat = np.zeros((400, 8), np.float32)
    base2 = np.full(400, 1.5, np.float32)
    base2[[200, 333]] = 9.0
    mask[:2] = False
    i, v = _check_argmax(flat, np.zeros(8, np.float32), base2, mask, False)
    assert (i, v) == (200, 9.0)


def test_corr_argmax_plain_all_masked():
    c, w, base, _ = _argmax_case(300, 16, 9, False)
    i, v = _check_argmax(c, w, base, np.zeros(300, bool), False)
    assert (i, v) == (0, float("-inf"))


@pytest.mark.parametrize("n,c,dh", [(1, 2, 1), (7, 10, 64), (300, 37, 65)])
@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
def test_lastlayer_grad_plain_matches_jax(n, c, dh, label_dtype):
    rng = np.random.default_rng(n + c + dh)
    h = rng.standard_normal((n, dh)).astype(np.float32)
    z = (3 * rng.standard_normal((n, c))).astype(np.float32)
    y = rng.integers(0, c, n).astype(label_dtype)
    resid, hgrad = ref.lastlayer_grad_ref(torch.from_numpy(h),
                                          torch.from_numpy(z),
                                          torch.from_numpy(y))
    for jr, jh in (jref.lastlayer_grad_ref(h, z, y.astype(np.int32)),
                   pallas_lastlayer_grad(jnp.asarray(h), jnp.asarray(z),
                                         jnp.asarray(y.astype(np.int32)),
                                         interpret=True)):
        np.testing.assert_allclose(resid.numpy(), _np(jr), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(hgrad.numpy(), _np(jh), rtol=RTOL,
                                   atol=ATOL)
    wr, wh = llg_kernel.lastlayer_grad(torch.from_numpy(h),
                                       torch.from_numpy(z),
                                       torch.from_numpy(y))
    np.testing.assert_array_equal(wr.numpy(), resid.numpy())
    np.testing.assert_array_equal(wh.numpy(), hgrad.numpy())


def test_dispatch_modes_and_counts():
    """CPU tensors take the plain versions and launch nothing; 'ref' is the
    only forced mode that reaches them for CUDA tensors; unknown modes are
    refused."""
    ops.reset_launch_counts()
    g = torch.ones((5, 3))
    r = torch.ones((3,))
    for mode in (None, "ref"):
        ops.set_backend(mode)
        try:
            assert ops.corr(g, r).tolist() == [3.0] * 5
            idx, val = ops.corr_argmax(g, r, torch.zeros(5),
                                       torch.ones(5, dtype=torch.bool))
            assert (int(idx), float(val)) == (0, -3.0)
            val, idx, cnt = ops.bound_max(
                g.to(torch.bfloat16), torch.zeros(5), torch.ones(5), r, 0.0,
                3.0, torch.ones(5, dtype=torch.bool))
            assert float(val) == pytest.approx(3.0 + 3 ** 0.5)
            assert (int(idx), int(cnt)) == (0, 5)
            head = torch.zeros((3, 4))
            head[:, 0] = 1.0
            hg = ops.hidden_grad(torch.zeros((5, 4)),
                                 torch.zeros(5, dtype=torch.int32), head)
            assert hg.tolist() == [[-0.75] * 3] * 5
            if mode is not None:
                assert ops.active_mode() == mode
        finally:
            ops.set_backend(None)
    assert ops.launch_counts() == {"corr": 0, "corr_argmax": 0,
                                   "corr_batched": 0,
                                   "corr_argmax_batched": 0,
                                   "bound_max": 0, "lastlayer_grad": 0,
                                   "hidden_grad": 0, "hidden_grad_tc": 0,
                                   "fl_gain_argmax": 0,
                                   "fl_gain_argmax_otf": 0, "sqdist": 0}
    assert ops.launch_shapes() == {}
    for mode in ("pallas", "cuda"):
        with pytest.raises(ValueError):
            ops.set_backend(mode)


# ---------------------------------------------------------------------------
# bound_max: the streaming certificate's interval scan
# ---------------------------------------------------------------------------

def _bound_inputs(n, d, seed, ties=False, mask_frac=0.8):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    norms = np.sqrt((rows * rows).sum(1)).astype(np.float32)
    errn = (norms * np.abs(rng.standard_normal(n)) / 700).astype(np.float32)
    if ties:                         # every row and its sidecars twice
        rows[1::2], norms[1::2], errn[1::2] = (rows[:-1:2], norms[:-1:2],
                                               errn[:-1:2])
    r = rng.standard_normal(d).astype(np.float32)
    mask = rng.random(n) < mask_frac
    return rows, norms, errn, r, np.float32(d * 2.0 ** -23 * 1.25), mask


def _bound_port(rows, norms, errn, r, acc, thresh, mask, absolute):
    return ref.bound_max_ref(
        torch.from_numpy(rows).to(torch.bfloat16), torch.from_numpy(norms),
        torch.from_numpy(errn), torch.from_numpy(r), float(acc), thresh,
        torch.from_numpy(mask), absolute=absolute)


# n not a multiple of the TPU's 128-row tile; d = 10 and 65 are the widths
# of the streaming path's bias and per-gradient proxies.  The value is held
# to 1e-6 of max |u| (f32 dots of bf16 rows summed in another order); the
# index and the count exactly (the inputs leave no u within that of another
# maximal u or of the threshold).
@pytest.mark.parametrize("n,d", [(1, 10), (129, 10), (300, 65), (1000, 65)])
@pytest.mark.parametrize("absolute", [False, True])
@pytest.mark.parametrize("thresh", [float("-inf"), float("inf"), 0.5])
def test_bound_max_plain_matches_jax(n, d, absolute, thresh):
    rows, norms, errn, r, acc, mask = _bound_inputs(n, d, n * 7 + d)
    got = _bound_port(rows, norms, errn, r, acc, thresh, mask, absolute)
    bf = jnp.asarray(rows).astype(jnp.bfloat16)
    args = (bf, jnp.asarray(norms), jnp.asarray(errn), jnp.asarray(r),
            jnp.float32(acc), jnp.float32(thresh), jnp.asarray(mask))
    scale = float(np.abs(np.asarray(got[0]))) + 1e-30
    for want in (jref.bound_max_ref(*args, absolute=absolute),
                 pallas_bound_max(*args, absolute=absolute, interpret=True)):
        assert abs(float(got[0]) - float(want[0])) <= 1e-6 * scale
        assert int(got[1]) == int(want[1])
        assert int(got[2]) == int(want[2])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.int32
    if thresh == float("-inf"):
        assert int(got[2]) == int(mask.sum())
    if thresh == float("inf"):
        assert int(got[2]) == 0


@pytest.mark.parametrize("absolute", [False, True])
def test_bound_max_plain_ties_and_all_masked(absolute):
    rows, norms, errn, r, acc, mask = _bound_inputs(258, 65, 4, ties=True)
    full = np.ones(258, bool)
    v, i, c = _bound_port(rows, norms, errn, r, acc, float("-inf"), full,
                          absolute)
    assert int(i) % 2 == 0 and int(c) == 258
    want = jref.bound_max_ref(
        jnp.asarray(rows).astype(jnp.bfloat16), jnp.asarray(norms),
        jnp.asarray(errn), jnp.asarray(r), jnp.float32(acc),
        jnp.float32(-jnp.inf), jnp.asarray(full), absolute=absolute)
    assert int(want[1]) == int(i)
    none = np.zeros(258, bool)
    v, i, c = _bound_port(rows, norms, errn, r, acc, float("-inf"), none,
                          absolute)
    assert (float(v), int(i), int(c)) == (float("-inf"), 0, 0)
    # the wrapper takes the plain version for CPU tensors, and f32 rows too
    got = corr_kernel.bound_max(
        torch.from_numpy(rows), torch.from_numpy(norms),
        torch.from_numpy(errn), torch.from_numpy(r), float(acc),
        torch.tensor(0.0), torch.from_numpy(mask), absolute=absolute)
    want = jref.bound_max_ref(
        jnp.asarray(rows), jnp.asarray(norms), jnp.asarray(errn),
        jnp.asarray(r), jnp.float32(acc), jnp.float32(0.0),
        jnp.asarray(mask), absolute=absolute)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])


# ---------------------------------------------------------------------------
# sqdist, fl_gain_argmax, fl_gain_argmax_otf (the shapes and tolerances of
# tests/test_kernels.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(1, 1), (9, 17), (100, 90), (128, 128)])
@pytest.mark.parametrize("d", [3, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sqdist_plain_matches_jax(n, m, d, dtype):
    rng = np.random.default_rng(n * 13 + m + d)
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = rng.standard_normal((m, d)).astype(np.float32)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    got = ref.sqdist_ref(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (n, m)
    ja = jnp.asarray(a).astype(getattr(jnp, dtype))
    jb = jnp.asarray(b).astype(getattr(jnp, dtype))
    tol = 1e-3 if dtype == "float32" else 5e-2
    for want in (jref.sqdist_ref(ja, jb),
                 pallas_sqdist(ja, jb, interpret=True)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=tol,
                                   atol=tol * 10)
    np.testing.assert_array_equal(sqdist_kernel.sqdist(ta, tb).numpy(),
                                  got.numpy())


def _fl_case(seed, n, d):
    """grads, the resident similarity built from them, l_max, cover and a
    candidate mask, in numpy."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    sq = (g * g).sum(1)
    dist = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * g @ g.T, 0))
    lm = np.float32(dist.max())
    sim = (lm - dist).astype(np.float32)
    cover = np.abs(rng.standard_normal(n)).astype(np.float32)
    mask = rng.random(n) < 0.7
    return g, sim, lm, cover, mask


def _check_fl(got, wants, tol):
    """(gains, idx, val) of the port against each JAX triple: gains to
    ``tol``, the index equal, an all-masked input (0, -inf)."""
    gg, gi, gv = got
    assert gg.dtype == torch.float32 and gi.dtype == torch.int32
    assert gi.shape == () and gv.shape == ()
    for wg, wi, wv in wants:
        np.testing.assert_allclose(gg.numpy(), _np(wg), rtol=tol, atol=tol)
        if np.isfinite(float(wv)):
            assert int(gi) == int(wi)
            np.testing.assert_allclose(float(gv), float(wv), rtol=tol,
                                       atol=tol)
        else:
            assert int(gi) == int(wi) == 0 and float(gv) == float(wv)


@pytest.mark.parametrize("n", [1, 9, 128, 300])
@pytest.mark.parametrize("d", [4, 70])
def test_fl_gain_argmax_plain_matches_jax(n, d):
    _, sim, _, cover, mask = _fl_case(30 + n, n, d)
    args = (torch.from_numpy(sim), torch.from_numpy(cover),
            torch.from_numpy(mask))
    got = ref.fl_gain_argmax_ref(*args)
    jargs = (jnp.asarray(sim), jnp.asarray(cover), jnp.asarray(mask))
    _check_fl(got, (jref.fl_gain_argmax_ref(*jargs),
                    pallas_fl_gain_argmax(*jargs, interpret=True)), 1e-4)
    wrapped = fl_gain_kernel.fl_gain_argmax(*args)
    for a, b in zip(wrapped, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fl_gain_argmax_plain_ties_and_all_masked():
    """All-equal similarity: the first unmasked column wins, also when the
    tie lies in a later 128-column tile; an all-False mask gives
    (0, -inf)."""
    n = 300
    sim = np.ones((n, n), np.float32)
    cover = np.zeros(n, np.float32)
    mask = np.ones(n, bool)
    mask[0] = False
    sim2 = sim.copy()
    sim2[:, [200, 260]] = 2.0
    for s, want in ((sim, 1), (sim2, 200)):
        got = ref.fl_gain_argmax_ref(torch.from_numpy(s),
                                     torch.from_numpy(cover),
                                     torch.from_numpy(mask))
        jargs = (jnp.asarray(s), jnp.asarray(cover), jnp.asarray(mask))
        _check_fl(got, (jref.fl_gain_argmax_ref(*jargs),
                        pallas_fl_gain_argmax(*jargs, interpret=True)), 1e-4)
        assert int(got[1]) == want
    _, sim, _, cover, _ = _fl_case(32, 140, 8)
    none = np.zeros(140, bool)
    got = ref.fl_gain_argmax_ref(torch.from_numpy(sim),
                                 torch.from_numpy(cover),
                                 torch.from_numpy(none))
    jargs = (jnp.asarray(sim), jnp.asarray(cover), jnp.asarray(none))
    _check_fl(got, (jref.fl_gain_argmax_ref(*jargs),
                    pallas_fl_gain_argmax(*jargs, interpret=True)), 1e-4)


@pytest.mark.parametrize("n", [1, 9, 150, 260])
@pytest.mark.parametrize("d", [3, 64, 600])
def test_fl_gain_argmax_otf_plain_matches_jax(n, d):
    """The on-the-fly scan against the JAX on-the-fly reference, the
    Pallas kernel and the resident scan, with a third of the rows invalid
    (they demand no coverage) and sqnorms given or not."""
    g, sim, lm, cover, mask = _fl_case(31 + n, n, d)
    rok = np.arange(n) % 3 != 1
    tg = torch.from_numpy(g)
    targs = (torch.from_numpy(cover), torch.from_numpy(rok),
             torch.from_numpy(mask), torch.tensor(lm))
    got = ref.fl_gain_argmax_otf_ref(tg, *targs, block=64)
    jargs = (jnp.asarray(g), jnp.asarray(cover), jnp.asarray(rok),
             jnp.asarray(mask), jnp.asarray(lm))
    resident = jref.fl_gain_argmax_ref(
        jnp.asarray(sim * rok[:, None]), jnp.asarray(cover),
        jnp.asarray(mask))
    _check_fl(got, (jref.fl_gain_argmax_otf_ref(*jargs, block=64),
                    pallas_fl_gain_argmax_otf(*jargs, interpret=True),
                    resident), 1e-3)
    sqn = (tg * tg).sum(1)
    wrapped = fl_gain_kernel.fl_gain_argmax_otf(tg, *targs, sqnorms=sqn)
    plain = ref.fl_gain_argmax_otf_ref(tg, *targs, sqnorms=sqn)
    for a, b in zip(wrapped, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fl_gains_cols_plain_matches_jax():
    """The blocked column scan shared by the full on-the-fly scan and the
    lazy engine's wide refresh, on a candidate slice."""
    g, _, lm, cover, _ = _fl_case(34, 200, 12)
    rok = (np.arange(200) % 5 != 0).astype(np.float32)
    sqn = (g * g).sum(1)
    ids = np.arange(0, 200, 7)
    got = ref.fl_gains_cols_ref(
        torch.from_numpy(g[ids]), torch.from_numpy(sqn[ids]),
        torch.from_numpy(g), torch.from_numpy(sqn), torch.from_numpy(cover),
        torch.from_numpy(rok), torch.tensor(lm), block=64)
    want = jref.fl_gains_cols_ref(
        jnp.asarray(g[ids]), jnp.asarray(sqn[ids]), jnp.asarray(g),
        jnp.asarray(sqn), jnp.asarray(cover), jnp.asarray(rok),
        jnp.asarray(lm), block=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# hidden_grad: (softmax(Z) - onehot(Y)) @ W^T for LM heads
# ---------------------------------------------------------------------------

_HG_JAX: dict = {}


def _hg_inputs(n, v, dh):
    rng = np.random.default_rng(n * 10_007 + v * 31 + dh)
    z = (2 * rng.standard_normal((n, v))).astype(np.float32)
    y = rng.integers(0, v, n)
    w = (rng.standard_normal((dh, v)) / np.sqrt(v)).astype(np.float32)
    return z, y, w


def _hg_jax(n, v, dh):
    """JAX's ``ops.hidden_grad`` (ref mode, as on the CPU) and the Pallas
    kernel under the interpreter, once per shape: both label dtypes compare
    against them (JAX takes int64 labels as int32 without x64)."""
    if (n, v, dh) not in _HG_JAX:
        z, y, w = (jnp.asarray(a) for a in _hg_inputs(n, v, dh))
        _HG_JAX[n, v, dh] = (_np(jops.hidden_grad(z, y, w)),
                             _np(pallas_hidden_grad(z, y, w, interpret=True)))
    return _HG_JAX[n, v, dh]


# The grid of tests/test_kernels.py's hidden_grad_fused test: n = 1 and
# ragged against the TPU's 128-row tile, V ragged against its 512-wide
# chunk, d_h against its 512-wide hidden chunk; rtol/atol 2e-4 as there.
@pytest.mark.parametrize("n", [1, 60, 128])
@pytest.mark.parametrize("v", [16, 100, 513, 1024])
@pytest.mark.parametrize("dh", [32, 512, 600])
@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
def test_hidden_grad_plain_matches_jax(n, v, dh, label_dtype):
    z, y, w = _hg_inputs(n, v, dh)
    tz, ty, tw = (torch.from_numpy(z), torch.from_numpy(y.astype(label_dtype)),
                  torch.from_numpy(w))
    got = ref.hidden_grad_ref(tz, ty, tw)
    assert got.dtype == torch.float32 and got.shape == (n, dh)
    for want in _hg_jax(n, v, dh):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # The wrapper and the dispatch take the plain version for CPU tensors,
    # W contiguous or as the transpose of a contiguous (V, d_h) matrix (the
    # CPU product then sums in another order).
    for out in (llg_kernel.hidden_grad_fused(tz, ty, tw),
                ops.hidden_grad(tz, ty, tw)):
        np.testing.assert_array_equal(out.numpy(), got.numpy())
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).T
    np.testing.assert_allclose(ops.hidden_grad(tz, ty, wt).numpy(),
                               got.numpy(), rtol=1e-5, atol=1e-6)


# bf16 logits and head, as on the LM path: both packages widen the bf16
# values to f32 and compute in f32, so they are held to 1e-5 of max |out|
# (f32 sums of the same terms in another order).
@pytest.mark.parametrize("n,v,dh", [(32, 640, 128), (60, 513, 600)])
def test_hidden_grad_plain_matches_jax_bf16(n, v, dh):
    z, y, w = _hg_inputs(n, v, dh)
    jz = jnp.asarray(z).astype(jnp.bfloat16)
    jw = (jnp.asarray(w) * 8).astype(jnp.bfloat16)
    tz = torch.from_numpy(z).to(torch.bfloat16)
    tw = (torch.from_numpy(w) * 8).to(torch.bfloat16)
    assert np.array_equal(_np(jz.astype(jnp.float32)), tz.float().numpy())
    got = ref.hidden_grad_ref(tz, torch.from_numpy(y), tw).numpy()
    for want in (_np(jops.hidden_grad(jz, jnp.asarray(y), jw)),
                 _np(pallas_hidden_grad(jz, jnp.asarray(y), jw,
                                        interpret=True))):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_hidden_grad_plain_out_of_range_labels_and_rows_sum():
    """A label outside [0, V) gets a zero one-hot row (jax.nn.one_hot's
    rule); with W = 1 every row of the residual sums to 0 otherwise."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((4, 9)).astype(np.float32)
    y = np.array([0, 8, -1, 9])
    w = np.ones((2, 9), np.float32)
    got = ref.hidden_grad_ref(torch.from_numpy(z), torch.from_numpy(y),
                              torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got[:2], 0.0, atol=1e-6)
    np.testing.assert_allclose(got[2:], 1.0, rtol=1e-6)
    want = _np(jops.hidden_grad(jnp.asarray(z), jnp.asarray(y),
                                jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
