"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card and ``nvcc``; every test skips without a card.  It imports
no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import craig, greedy  # noqa: E402
from repro_torch.kernels import corr as corr_kernel  # noqa: E402
from repro_torch.kernels import fl_gain as fl_kernel  # noqa: E402
from repro_torch.kernels import lastlayer_grad as llg_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sqdist as sqdist_kernel  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("n,d", [(1, 1), (7, 65), (300, 512), (45000, 65),
                                 (8192, 512), (129, 700), (33, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_kernel_matches_plain(dev, n, d, dtype):
    rng = np.random.default_rng(n * 1000 + d)
    g = _t(rng.standard_normal((n, d)).astype(np.float32), dev)
    g = g.to(getattr(torch, dtype))
    r = _t(rng.standard_normal(d).astype(np.float32), dev)
    got = corr_kernel.corr(g, r)
    want = ref.corr_ref(g, r)
    torch.cuda.synchronize()
    scale = float(torch.sqrt((g.float() ** 2).sum(1).max() * (r ** 2).sum()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6 * max(scale, 1.0))


@pytest.mark.parametrize("n,p", [(1, 1), (7, 65), (300, 512), (45000, 65),
                                 (8192, 512), (129, 700)])
@pytest.mark.parametrize("absolute", [False, True])
def test_corr_argmax_kernel_matches_plain(dev, n, p, absolute):
    rng = np.random.default_rng(n * 7 + p)
    c = _t(rng.standard_normal((n, p)).astype(np.float32), dev)
    w = _t(rng.standard_normal(p).astype(np.float32), dev)
    base = _t(3 * rng.standard_normal(n).astype(np.float32), dev)
    mask = _t(rng.random(n) < 0.7, dev)
    gi, gv = corr_kernel.corr_argmax(c, w, base, mask, absolute=absolute)
    ri, rv = ref.corr_argmax_ref(c, w, base, mask, absolute=absolute)
    torch.cuda.synchronize()
    if int(gi) != int(ri):
        # Only a true near-tie under another summation order may differ.
        scores = base - c @ w
        if absolute:
            scores = scores.abs()
        assert bool(mask[int(gi)])
        np.testing.assert_allclose(float(scores[int(gi)]),
                                   float(scores[int(ri)]), rtol=1e-6)
    if np.isfinite(float(rv)):
        np.testing.assert_allclose(float(gv), float(rv), rtol=1e-5)
    else:
        assert float(gv) == float(rv)


def test_corr_argmax_ties_and_all_masked(dev):
    n, p = 5000, 16
    c = torch.zeros((n, p), device=dev)
    w = torch.zeros((p,), device=dev)
    base = torch.full((n,), 1.5, device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    mask[:2] = False
    gi, gv = corr_kernel.corr_argmax(c, w, base, mask)
    assert int(gi) == 2 and float(gv) == 1.5
    base[4000] = 9.0
    base[3001] = 9.0
    gi, _ = corr_kernel.corr_argmax(c, w, base, mask)
    assert int(gi) == 3001
    # duplicated rows: equal scores, lowest index wins
    rng = np.random.default_rng(3)
    g = _t(rng.standard_normal((n, 65)).astype(np.float32), dev)
    g[1::2] = g[::2]
    r = _t(rng.standard_normal(65).astype(np.float32), dev)
    zeros = torch.zeros((n,), device=dev)
    full = torch.ones((n,), dtype=torch.bool, device=dev)
    gi, _ = corr_kernel.corr_argmax(g, -r, zeros, full, absolute=True)
    assert int(gi) % 2 == 0
    none = torch.zeros((n,), dtype=torch.bool, device=dev)
    gi, gv = corr_kernel.corr_argmax(c, w, base, none)
    assert int(gi) == 0 and float(gv) == float("-inf")


@pytest.mark.parametrize("n,dh,nc", [(1, 1, 2), (45000, 64, 10), (300, 84, 10),
                                     (257, 65, 40)])
@pytest.mark.parametrize("label_dtype", ["int32", "int64"])
def test_lastlayer_grad_kernel_matches_plain(dev, n, dh, nc, label_dtype):
    rng = np.random.default_rng(n + dh + nc)
    h = _t(rng.standard_normal((n, dh)).astype(np.float32), dev)
    z = _t(3 * rng.standard_normal((n, nc)).astype(np.float32), dev)
    y = _t(rng.integers(0, nc, n), dev).to(getattr(torch, label_dtype))
    resid, hgrad = llg_kernel.lastlayer_grad(h, z, y)
    rr, rh = ref.lastlayer_grad_ref(h, z, y)
    torch.cuda.synchronize()
    np.testing.assert_allclose(resid.cpu().numpy(), rr.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hgrad.cpu().numpy(), rh.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_wrappers_count_launches_and_reject_bad_input(dev):
    before_fl = fl_kernel.launches["fl_gain_argmax"]
    sim = torch.ones((4, 4), device=dev)
    cov = torch.zeros((4,), device=dev)
    msk = torch.ones((4,), dtype=torch.bool, device=dev)
    fl_kernel.fl_gain_argmax(sim, cov, msk)
    assert fl_kernel.launches["fl_gain_argmax"] == before_fl + 1
    with pytest.raises(ValueError):
        fl_kernel.fl_gain_argmax(torch.ones((4, 5), device=dev), cov, msk)
    with pytest.raises(TypeError):
        fl_kernel.fl_gain_argmax(sim, cov, msk.float())
    with pytest.raises(TypeError):
        fl_kernel.fl_gain_argmax_otf(sim, cov, msk, msk, 1.0)
    with pytest.raises(ValueError):
        sqdist_kernel.sqdist(sim, torch.ones((3, 5), device=dev))
    assert fl_kernel.launches["fl_gain_argmax"] == before_fl + 1
    before = corr_kernel.launches["corr"]
    shaped = corr_kernel.shapes.get(("corr", 4, 3, "float32"), 0)
    g = torch.ones((4, 3), device=dev)
    corr_kernel.corr(g, torch.ones((3,), device=dev))
    assert corr_kernel.launches["corr"] == before + 1
    assert corr_kernel.shapes[("corr", 4, 3, "float32")] == shaped + 1
    with pytest.raises(TypeError):
        corr_kernel.corr(g, torch.ones((3,), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        corr_kernel.corr(g.t(), torch.ones((4,), device=dev))
    with pytest.raises(ValueError):
        corr_kernel.corr(g, torch.ones((3,)))
    assert corr_kernel.launches["corr"] == before + 1
    assert corr_kernel.shapes[("corr", 4, 3, "float32")] == shaped + 1
    # corr_argmax takes f32 only: no path scores a bf16 column cache.
    with pytest.raises(TypeError):
        corr_kernel.corr_argmax(
            g.to(torch.bfloat16), torch.ones((3,), device=dev),
            torch.zeros((4,), device=dev),
            torch.ones((4,), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# sqdist, fl_gain_argmax, fl_gain_argmax_otf
# ---------------------------------------------------------------------------

SQDIST_SHAPES = [(1, 1, 1), (9, 17, 3), (129, 65, 130), (300, 257, 65),
                 (4097, 1000, 130)]


def _sq_routes(d, dtype):
    """The routes that take an (n, d) call: the FFMA kernel always, the
    tensor cores up to 80 f32 or 160 bf16 columns."""
    return ["ffma"] + (["tc"] if d <= (80 if dtype == "float32" else 160)
                       else [])


@pytest.mark.parametrize("n,m,d", SQDIST_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sqdist_kernel_matches_plain(dev, n, m, d, dtype):
    """Each route that takes the shape (and the plan's) against the plain
    version at rtol / atol 1e-4, no negative distance, the same bits on a
    second call; one launch counted a call, by route."""
    rng = np.random.default_rng(n + m + d)
    a = _t(rng.standard_normal((n, d)).astype(np.float32), dev)
    b = _t(rng.standard_normal((m, d)).astype(np.float32), dev)
    a, b = a.to(getattr(torch, dtype)), b.to(getattr(torch, dtype))
    want = ref.sqdist_ref(a, b)
    for route in [None] + _sq_routes(d, dtype):
        before = sqdist_kernel.launches["sqdist"]
        routes = dict(sqdist_kernel.sqdist_routes)
        got = sqdist_kernel.sqdist(a, b, route=route)
        again = sqdist_kernel.sqdist(a, b, route=route)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=str(route))
        assert float(got.min()) >= 0.0
        assert torch.equal(got, again), route
        assert sqdist_kernel.launches["sqdist"] == before + 2
        taken = route or sqdist_kernel.sqdist_plan(
            n, m, d, a.element_size(), False).route
        assert sqdist_kernel.sqdist_routes[taken] == routes[taken] + 2


@pytest.mark.parametrize("n", [1, 127, 129, 4097])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sqdist_of_a_with_itself_is_bitwise_symmetric(dev, n, dtype):
    """sqdist(a, a) on the mirrored tensor cores (each pair computed once,
    written to both places) equals its transpose bit for bit at ragged n,
    within rtol / atol 1e-4 of the plain version, the same bits twice; so
    does the plan's route and the FFMA kernel (fmaf is commutative)."""
    rng = np.random.default_rng(3 * n)
    a = _t(rng.standard_normal((n, 65)).astype(np.float32), dev).to(
        getattr(torch, dtype))
    want = ref.sqdist_ref(a, a)
    for route in ("tc-sym", None, "ffma"):
        s = sqdist_kernel.sqdist(a, a, route=route)
        torch.cuda.synchronize()
        assert torch.equal(s, s.T), route
        assert torch.equal(s, sqdist_kernel.sqdist(a, a, route=route))
        np.testing.assert_allclose(s.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=str(route))
    assert sqdist_kernel.sqdist_plan(4097, 4097, 65, 4, True).route == (
        "tc-sym")


@pytest.mark.parametrize("n,m,d", [(300, 257, 65), (4097, 1000, 130),
                                   (1000, 1000, 160)])
def test_sqdist_bf16_exact_on_a_grid(dev, n, m, d):
    """bf16 rows on a 1/8 grid widen into TF32 exactly and their products
    sum exactly in f32: the tensor cores give the exact distances (those of
    an f64 computation), bit for bit, mirrored or not."""
    rng = np.random.default_rng(n + 2 * m + d)
    a = _t(np.round(rng.standard_normal((n, d)) * 8) / 8, dev).to(
        torch.bfloat16)
    b = _t(np.round(rng.standard_normal((m, d)) * 8) / 8, dev).to(
        torch.bfloat16)
    for x, y, route in ((a, b, "tc"), (a, a, "tc-sym")):
        x64, y64 = x.double(), y.double()
        exact = ((x64 * x64).sum(1)[:, None] + (y64 * y64).sum(1)[None, :]
                 - 2 * x64 @ y64.T).clamp_min(0).float()
        got = sqdist_kernel.sqdist(x, y, route=route)
        torch.cuda.synchronize()
        assert torch.equal(got, exact), route


@pytest.mark.parametrize("n,m,same", [(4097, 4097, True), (4097, 1000, False),
                                      (20000, 512, False)])
def test_sqdist_tensor_cores_f64_error(dev, n, m, same):
    """Against an f64 sqdist of the same f32 inputs both routes stay within
    1e-6 of |a_i|^2 + |b_j|^2 (the size of the terms the expanded form
    cancels; 3xTF32 keeps f32 grade)."""
    rng = np.random.default_rng(n + m)
    a = _t(rng.standard_normal((n, 65)).astype(np.float32), dev)
    b = a if same else _t(rng.standard_normal((m, 65)).astype(np.float32),
                          dev)
    a64, b64 = a.double(), b.double()
    an, bn = (a64 * a64).sum(1), (b64 * b64).sum(1)
    exact = (an[:, None] + bn[None, :] - 2 * a64 @ b64.T).clamp_min(0)
    scale = an[:, None] + bn[None, :]
    for route in ("tc-sym" if same else "tc", "ffma"):
        got = sqdist_kernel.sqdist(a, b, route=route).double()
        assert float(((got - exact).abs() / scale).max()) <= 1e-6, route


def _fl_inputs(dev, n, d, seed):
    rng = np.random.default_rng(seed)
    g = _t(rng.standard_normal((n, d)).astype(np.float32), dev)
    sim = greedy.build_sim(g)
    cover = _t(np.abs(rng.standard_normal(n)).astype(np.float32), dev)
    mask = _t(rng.random(n) < 0.7, dev)
    return g, sim, cover, mask


def _check_fl(got, want, gains_for_ties, tol=1e-4):
    gg, gi, gv = got
    wg, wi, wv = want
    np.testing.assert_allclose(gg.cpu().numpy(), wg.cpu().numpy(),
                               rtol=tol, atol=tol)
    if not np.isfinite(float(wv)):
        assert int(gi) == 0 and float(gv) == float(wv)
        return
    if int(gi) != int(wi):
        # Only a near-tie under another summation order may differ.
        a, b = float(gains_for_ties[int(gi)]), float(gains_for_ties[int(wi)])
        assert abs(a - b) <= tol * max(abs(b), 1.0)
    np.testing.assert_allclose(float(gv), float(wv), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d", [(1, 4), (9, 70), (129, 8), (300, 65),
                                 (4097, 10)])
def test_fl_gain_argmax_kernel_matches_plain(dev, n, d):
    _, sim, cover, mask = _fl_inputs(dev, n, d, n + d)
    got = fl_kernel.fl_gain_argmax(sim, cover, mask)
    want = ref.fl_gain_argmax_ref(sim, cover, mask)
    torch.cuda.synchronize()
    _check_fl(got, want, want[0])
    none = torch.zeros_like(mask)
    _check_fl(fl_kernel.fl_gain_argmax(sim, cover, none),
              ref.fl_gain_argmax_ref(sim, cover, none), want[0])


def test_fl_gain_argmax_kernel_ties(dev):
    n = 4097
    sim = torch.ones((n, n), device=dev)
    cover = torch.zeros((n,), device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    mask[0] = False
    _, gi, gv = fl_kernel.fl_gain_argmax(sim, cover, mask)
    assert int(gi) == 1 and float(gv) == float(n)
    sim[:, [3001, 4000]] = 2.0
    _, gi, _ = fl_kernel.fl_gain_argmax(sim, cover, mask)
    assert int(gi) == 3001


@pytest.mark.parametrize("n,d", [(1, 3), (9, 64), (150, 600), (260, 65),
                                 (4097, 10), (2000, 65)])
def test_fl_gain_argmax_otf_kernel_matches_plain(dev, n, d):
    g, _, cover, mask = _fl_inputs(dev, n, d, 7 * n + d)
    rok = torch.arange(n, device=dev) % 3 != 1
    lm = greedy.default_l_max(g)
    got = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm)
    want = ref.fl_gain_argmax_otf_ref(g, cover, rok, mask, lm)
    torch.cuda.synchronize()
    # 1e-3, as tests/test_kernels.py holds the Pallas kernel: each column's
    # own term sqrt(2|g_j|^2 - 2 g_j.g_j) is rounding noise of ~sqrt(eps)
    # |g_j|, which the kernel's FFMA dot and cuBLAS round differently
    # (5.5e-3 of a gain of 41 at n = 9, d = 64 on the card).
    _check_fl(got, want, want[0], tol=1e-3)
    sqn = (g * g).sum(1)
    again = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm,
                                         sqnorms=sqn)
    assert torch.equal(again[0], got[0])   # deterministic, same norms


def test_craig_on_the_card_kernels_vs_plain(dev):
    """Lazy CRAIG, resident (sqdist on the mirrored tensor cores +
    fl_gain_argmax) and on the fly, with the kernels and with the plain
    versions: the same picks."""
    rng = np.random.default_rng(40)
    g = _t(np.round(rng.standard_normal((3000, 20)) * 8).astype(np.float32)
           / 8, dev)
    lm = greedy.default_l_max(g)
    for kw in (dict(dist_fn=ops.sqdist, on_the_fly=False),
               dict(on_the_fly=True)):
        ops.reset_launch_counts()
        a = craig.craig(g, 150, method="lazy", l_max=lm, **kw)
        counts, routes = ops.launch_counts(), ops.launch_routes()
        ops.set_backend("ref")
        try:
            b = craig.craig(g, 150, method="lazy", l_max=lm, **kw)
        finally:
            ops.set_backend(None)
        assert torch.equal(a.indices, b.indices)
        np.testing.assert_allclose(float(a.err), float(b.err), rtol=1e-5)
        if kw["on_the_fly"]:
            # (3 000, 20): the plan's tensor-core route
            assert counts["fl_gain_argmax_otf_tc"] >= 1
            assert counts["fl_gain_argmax_otf"] == 0
        else:
            assert counts["sqdist"] == 1 and counts["fl_gain_argmax"] >= 1
            assert routes["sqdist/tc-sym"] == 1


def _bound_case(n, d, seed, dev, dtype="bfloat16", mask_frac=0.8):
    """bound_max inputs with rows and residual on a 1/8 grid, so every dot
    product is exact in f32 and the kernel and the plain version differ
    only in the rounding of the sidecar term (a few ulp of u)."""
    rng = np.random.default_rng(seed)
    rows = _t(np.round(rng.standard_normal((n, d)) * 8) / 8, dev).to(
        getattr(torch, dtype))
    r = _t((np.round(rng.standard_normal(d) * 8) / 8).astype(np.float32), dev)
    norms = _t(np.abs(rng.standard_normal(n)).astype(np.float32) * 3, dev)
    errn = _t(np.abs(rng.standard_normal(n)).astype(np.float32) / 512, dev)
    mask = _t(rng.random(n) < mask_frac, dev)
    return rows, norms, errn, r, float(d * 2.0 ** -23 * 1.25), mask


def _check_bound(got, want, u, mask, thresh):
    """Value to 1e-6 of max |u| (the stated tolerance), index equal unless
    the two rows' u lie within it, count equal when no masked u lies
    within it of ``thresh``."""
    (gv, gi, gc), (wv, wi, wc) = got, want
    tol = 1e-6 * float(u[mask].abs().max()) if bool(mask.any()) else 0.0
    if not bool(mask.any()):
        assert (float(gv), int(gi), int(gc)) == (float("-inf"), 0, 0)
        return
    assert abs(float(gv) - float(wv)) <= tol
    if int(gi) != int(wi):
        assert bool(mask[int(gi)])
        assert abs(float(u[int(gi)]) - float(u[int(wi)])) <= tol
    if not bool(((u - thresh).abs() <= tol)[mask].any()):
        assert int(gc) == int(wc)


@pytest.mark.parametrize("n,d", [(1, 10), (129, 65), (4097, 10),
                                 (65536, 10), (65536, 65),
                                 (88064, 10), (86016, 65)])
@pytest.mark.parametrize("absolute", [False, True])
def test_bound_max_kernel_matches_plain(dev, n, d, absolute):
    rows, norms, errn, r, acc, mask = _bound_case(n, d, n + d, dev)
    s = rows.float() @ r
    s = s.abs() if absolute else s
    u = s + (errn + acc * norms) * torch.sqrt((r * r).sum())
    srt = torch.sort(u[mask]).values
    mid = float((srt[len(srt) // 2] + srt[max(len(srt) // 2 - 1, 0)]) / 2)
    for thresh in (float("-inf"), float("inf"), mid):
        th = torch.full((), thresh, device=dev)
        got = corr_kernel.bound_max(rows, norms, errn, r, acc, th, mask,
                                    absolute=absolute)
        want = ref.bound_max_ref(rows, norms, errn, r, acc, th, mask,
                                 absolute=absolute)
        torch.cuda.synchronize()
        _check_bound(got, want, u, mask, thresh)


def test_bound_max_kernel_f32_rows_ties_and_all_masked(dev):
    rows, norms, errn, r, acc, mask = _bound_case(4096, 65, 9, dev,
                                                  dtype="float32")
    key = ("bound_max", 4096, 65, "float32")
    tallied = corr_kernel.shapes.get(key, 0)
    got = corr_kernel.bound_max(rows, norms, errn, r, acc, 0.0, mask)
    want = ref.bound_max_ref(rows, norms, errn, r, acc, 0.0, mask)
    s = rows @ r
    u = s + (errn + acc * norms) * torch.sqrt((r * r).sum())
    _check_bound(got, want, u, mask, 0.0)
    # duplicated rows and sidecars: equal u, the lowest index wins
    rows[1::2] = rows[::2]
    norms[1::2] = norms[::2]
    errn[1::2] = errn[::2]
    full = torch.ones_like(mask)
    v, i, c = corr_kernel.bound_max(rows, norms, errn, r, acc, float("-inf"),
                                    full, absolute=True)
    assert int(i) % 2 == 0 and int(c) == 4096
    none = torch.zeros_like(mask)
    v, i, c = corr_kernel.bound_max(rows, norms, errn, r, acc, float("-inf"),
                                    none)
    assert (float(v), int(i), int(c)) == (float("-inf"), 0, 0)
    assert corr_kernel.shapes[key] == tallied + 3
    before = corr_kernel.launches["bound_max"]
    with pytest.raises(TypeError):
        corr_kernel.bound_max(rows, norms.double(), errn, r, acc, 0.0, full)
    with pytest.raises(ValueError):
        corr_kernel.bound_max(rows, norms, errn, r, acc,
                              torch.zeros((2,), device=dev), full)
    assert corr_kernel.launches["bound_max"] == before
    assert corr_kernel.shapes[key] == tallied + 3


# ---------------------------------------------------------------------------
# hidden_grad: (softmax(Z) - onehot(Y)) @ W^T for LM heads
# ---------------------------------------------------------------------------

def _hg_case(dev, n, v, dh, zdt, wdt, tied, label_dtype="int64", seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed + n + v + dh)
    z = (2 * torch.randn((n, v), generator=gen, device=dev)).to(zdt)
    y = torch.randint(0, v, (n,), generator=gen, device=dev).to(
        getattr(torch, label_dtype))
    if tied:    # W = embed.T, embed (V, d_h) contiguous: the tied head
        w = (0.02 * torch.randn((v, dh), generator=gen, device=dev)).to(wdt).T
    else:
        w = (0.02 * torch.randn((dh, v), generator=gen, device=dev)).to(wdt)
    return z, y, w


def _hg_check(z, y, w):
    got = llg_kernel.hidden_grad_fused(z, y, w)
    want = ref.hidden_grad_ref(z, y, w)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    # relative to max |out| (f32 sums of the same terms in two orders)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    return got


@pytest.mark.parametrize("n", [1, 60, 128, 300])
@pytest.mark.parametrize("v", [16, 100, 513, 1024])
@pytest.mark.parametrize("dh", [32, 512, 600])
def test_hidden_grad_kernel_matches_plain(dev, n, v, dh):
    for zdt, wdt, tied, ldt in ((torch.float32, torch.float32, False,
                                 "int32"),
                                (torch.bfloat16, torch.bfloat16, True,
                                 "int64"),
                                (torch.bfloat16, torch.float32, False,
                                 "int64"),
                                (torch.float32, torch.bfloat16, True,
                                 "int32")):
        _hg_check(*_hg_case(dev, n, v, dh, zdt, wdt, tied, ldt))


# Long vocabularies over few output tiles: the kernel cuts V into slices
# summed separately and added in slice order (5, 8 and 8 slices here).
@pytest.mark.parametrize("n,v,dh", [(1, 20000, 64), (60, 33333, 100),
                                    (300, 70001, 600)])
def test_hidden_grad_kernel_with_vocabulary_slices(dev, n, v, dh):
    splits, _ = llg_kernel._vocab_split(n, v, dh, dev)
    assert splits > 1
    for zdt, tied in ((torch.float32, False), (torch.bfloat16, True)):
        z, y, w = _hg_case(dev, n, v, dh, zdt, zdt, tied)
        got = _hg_check(z, y, w)
        assert torch.equal(got, llg_kernel.hidden_grad_fused(z, y, w))


def test_hidden_grad_kernel_at_the_lm_path_shape_and_same_bits(dev):
    """(512, 256 000, 2 048) bf16 logits and a tied bf16 head, as the
    gemma-2b selection proxy gives it; two calls give the same bits."""
    z, y, w = _hg_case(dev, 512, 256_000, 2048, torch.bfloat16,
                       torch.bfloat16, True)
    first = _hg_check(z, y, w)
    again = llg_kernel.hidden_grad_fused(z, y, w)
    assert torch.equal(first, again)


def test_hidden_grad_counts_launches_and_rejects_bad_input(dev):
    z, y, w = _hg_case(dev, 8, 40, 16, torch.float32, torch.float32, False)
    before = llg_kernel.launches["hidden_grad"]
    llg_kernel.hidden_grad_fused(z, y, w)
    assert llg_kernel.launches["hidden_grad"] == before + 1
    # n = 0: an empty result and no launch
    out = llg_kernel.hidden_grad_fused(z[:0], y[:0], w)
    assert out.shape == (0, 16)
    bad = [
        (TypeError, (z.double(), y, w)),
        (TypeError, (z, y.float(), w)),
        (TypeError, (z, y, w.half())),
        (ValueError, (z.t().contiguous().t(), y, w)),      # strided logits
        (ValueError, (z, y, w[:, :20])),                   # width mismatch
        (ValueError, (z, y, torch.zeros((32, 80), device=dev)[::2, ::2])),
        (ValueError, (z, y[:4], w)),
        (ValueError, (z, y, w.cpu())),
        (ValueError, (z, y.cpu(), w)),
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            llg_kernel.hidden_grad_fused(*args)
    assert llg_kernel.launches["hidden_grad"] == before + 1


# -- the tensor-core kernel (csrc/hidden_grad_tc.cu) and the routing rule ---

def _hg_routed(z, y, w, kernel):
    """``hidden_grad_fused`` within the limit, and it launched ``kernel``
    ("hidden_grad_tc" or "hidden_grad") once and the other not at all."""
    before = dict(llg_kernel.launches)
    got = _hg_check(z, y, w)
    other = "hidden_grad" if kernel == "hidden_grad_tc" else "hidden_grad_tc"
    assert llg_kernel.launches[kernel] == before[kernel] + 1
    assert llg_kernel.launches[other] == before[other]
    return got


# Ragged against every tile and stage: n off the 64-row warpgroup and the
# 128-row block, V (a multiple of 8, as TMA needs) off the 64-entry stage,
# d_h off the 256-column tile (and below one 64-column box).
@pytest.mark.parametrize("n", [1, 60, 128, 300])
@pytest.mark.parametrize("v,dh", [(64, 256), (1000, 600), (4104, 40),
                                  (2056, 1032)])
@pytest.mark.parametrize("zdt", ["bfloat16", "float32"])
def test_hidden_grad_tc_kernel_matches_plain(dev, n, v, dh, zdt):
    for tied, ldt in ((True, "int64"), (False, "int32")):
        z, y, w = _hg_case(dev, n, v, dh, getattr(torch, zdt),
                           torch.bfloat16, tied, ldt)
        _hg_routed(z, y, w, "hidden_grad_tc")


def test_hidden_grad_tc_kernel_labels_outside_the_vocabulary(dev):
    """A label outside [0, V) gets no one-hot row, as in the plain
    version; labels at 0 and V - 1 sit at the first and last stage's
    edges."""
    for tied, ldt in ((True, torch.int64), (False, torch.int32)):
        z, y, w = _hg_case(dev, 200, 1000, 264, torch.bfloat16,
                           torch.bfloat16, tied)
        y = y.to(ldt)
        y[0::5], y[1::5], y[2::5], y[3::5] = -1, 1000, 0, 999
        if ldt == torch.int64:
            y[4::10] = 2 ** 40
        _hg_routed(z, y, w, "hidden_grad_tc")


# Long vocabularies over few output tiles: V cut into 20, 33 and 33 slices
# summed separately and added in slice order; the same bits on two calls.
@pytest.mark.parametrize("n,v,dh", [(1, 20000, 64), (60, 33336, 104),
                                    (200, 70000, 512)])
def test_hidden_grad_tc_kernel_with_vocabulary_slices(dev, n, v, dh):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, _ = llg_kernel.tc_vocab_split(n, v, dh, sms)
    assert splits > 1
    for zdt, tied in ((torch.bfloat16, True), (torch.float32, False)):
        z, y, w = _hg_case(dev, n, v, dh, zdt, torch.bfloat16, tied)
        got = _hg_routed(z, y, w, "hidden_grad_tc")
        assert torch.equal(got, llg_kernel.hidden_grad_fused(z, y, w))


def test_hidden_grad_routing_rule_on_the_card(dev):
    """Each call lands on the kernel ``takes_tensor_cores`` names, counted
    on that kernel's counter; the FFMA kernel's own entry takes the
    tensor-core kernel's inputs too."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (n, v, dh, z dtype, w dtype, tied, kernel)
        (60, 1000, 600, bf, bf, True, "hidden_grad_tc"),
        (60, 1000, 600, f32, bf, False, "hidden_grad_tc"),
        (60, 1004, 600, f32, bf, True, "hidden_grad_tc"),   # f32 rows 4 016 B
        (60, 1004, 600, f32, bf, False, "hidden_grad"),     # W rows 2 008 B
        (60, 513, 600, bf, bf, True, "hidden_grad"),        # Z rows 1 026 B
        (60, 1000, 601, bf, bf, True, "hidden_grad"),       # embed rows 1 202
        (60, 1000, 601, bf, bf, False, "hidden_grad_tc"),
        (60, 1000, 600, bf, f32, True, "hidden_grad"),      # an f32 head
        (60, 1000, 600, f32, f32, False, "hidden_grad"),
    ]
    for n, v, dh, zdt, wdt, tied, kernel in cases:
        z, y, w = _hg_case(dev, n, v, dh, zdt, wdt, tied)
        assert llg_kernel.takes_tensor_cores(
            zdt, wdt, n, v, dh, tied, z.data_ptr(),
            w.data_ptr()) == (kernel == "hidden_grad_tc")
        _hg_routed(z, y, w, kernel)
        # the FFMA kernel's own entry takes every input
        before = llg_kernel.launches["hidden_grad"]
        want = ref.hidden_grad_ref(z, y, w)
        ffma = llg_kernel.hidden_grad_ffma(z, y, w)
        torch.cuda.synchronize()
        assert llg_kernel.launches["hidden_grad"] == before + 1
        assert float((ffma - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
    # an unaligned view of aligned rows goes to the FFMA kernel
    z, y, w = _hg_case(dev, 60, 1000, 600, bf, bf, True)
    buf = torch.empty(z.numel() + 1, dtype=bf, device=dev)
    zv = buf[1:].view(z.shape)
    zv.copy_(z)
    assert zv.data_ptr() % 16 != 0
    _hg_routed(zv, y, w, "hidden_grad")


def test_hidden_grad_lm_shape_goes_to_the_tensor_cores(dev):
    """The LM path's call, (512, 256 000, 2 048) bf16 logits and the tied
    bf16 head, advances the tensor-core counter and not the FFMA one; the
    FFMA kernel's own entry agrees with it within the limit."""
    z, y, w = _hg_case(dev, 512, 256_000, 2048, torch.bfloat16,
                       torch.bfloat16, True)
    got = _hg_routed(z, y, w, "hidden_grad_tc")
    ffma = llg_kernel.hidden_grad_ffma(z, y, w)
    torch.cuda.synchronize()
    assert float((got - ffma).abs().max()) <= 1e-4 * float(
        ffma.abs().max())


# ---------------------------------------------------------------------------
# corr_batched, corr_argmax_batched (csrc/corr_batched.cu)
# ---------------------------------------------------------------------------

# B = 1 / 2 / 4 / 8 / 16 / 32-problem chunks and B > 32 (a second chunk);
# d = 65 (scalar lanes), 8 / 512 / 700 (16-byte loads where d % 4 == 0).
BATCHED = [(1, 1, 1), (7, 65, 10), (33, 8, 3), (45000, 65, 10),
           (45000, 65, 32), (300, 512, 2), (129, 700, 33), (1000, 12, 5),
           (513, 65, 64)]


@pytest.mark.parametrize("n,d,b", BATCHED)
def test_corr_batched_kernel_matches_plain_and_single_launches(dev, n, d, b):
    """Column b equals rt_corr on vecs[b] bit for bit (the same lane order
    and butterfly pairs); the plain version within the f32 dot rounding."""
    rng = np.random.default_rng(n + 3 * d + b)
    g = _t(rng.standard_normal((n, d)).astype(np.float32), dev)
    v = _t(rng.standard_normal((b, d)).astype(np.float32), dev)
    got = corr_kernel.corr_batched(g, v)
    want = ref.corr_batched_ref(g, v)
    single = torch.stack([corr_kernel.corr(g, v[j]) for j in range(b)], 1)
    torch.cuda.synchronize()
    assert got.shape == (n, b)
    assert torch.equal(got, single)
    scale = float(torch.sqrt((g ** 2).sum(1).max() * (v ** 2).sum(1).max()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6 * max(scale, 1.0))


def _batched_case(dev, n, p, b, seed, shared):
    rng = np.random.default_rng(seed)
    mat = _t(rng.standard_normal((n, p) if shared else (b, n, p)).astype(
        np.float32), dev)
    w = _t(rng.standard_normal((b, p)).astype(np.float32), dev)
    base = _t(3 * rng.standard_normal((n, b)).astype(np.float32), dev)
    mask = _t(rng.random((n, b)) < 0.7, dev)
    return mat, w, base, mask


def _check_batched_argmax(mat, w, base, mask, absolute):
    gi, gv = corr_kernel.corr_argmax_batched(mat, w, base, mask,
                                             absolute=absolute)
    ri, rv = ref.corr_argmax_batched_ref(mat, w, base, mask,
                                         absolute=absolute)
    b = w.shape[0]
    # B single launches on the warp route (never the row tiles that
    # corr_argmax shares with this kernel): the same bits.
    single = [corr_kernel.corr_argmax(mat if mat.dim() == 2 else mat[j],
                                      w[j], base[:, j].contiguous(),
                                      mask[:, j].contiguous(),
                                      absolute=absolute, route="warps")
              for j in range(b)]
    torch.cuda.synchronize()
    assert torch.equal(gi, torch.stack([s[0] for s in single]))
    assert torch.equal(gv, torch.stack([s[1] for s in single]))
    for j in range(b):
        m = mat if mat.dim() == 2 else mat[j]
        if int(gi[j]) != int(ri[j]):
            # Only a true near-tie under another summation order may differ.
            s = base[:, j] - m @ w[j]
            s = s.abs() if absolute else s
            assert bool(mask[int(gi[j]), j])
            np.testing.assert_allclose(float(s[int(gi[j])]),
                                       float(s[int(ri[j])]), rtol=1e-6)
        if np.isfinite(float(rv[j])):
            np.testing.assert_allclose(float(gv[j]), float(rv[j]), rtol=1e-5)
        else:
            assert float(gv[j]) == float(rv[j]) and int(gi[j]) == 0
    return gi, gv


@pytest.mark.parametrize("n,p,b", BATCHED)
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("absolute", [False, True])
def test_corr_argmax_batched_kernel_matches_plain_and_single_launches(
        dev, n, p, b, shared, absolute):
    _check_batched_argmax(*_batched_case(dev, n, p, b, n + p + b, shared),
                          absolute)


@pytest.mark.parametrize("shared", [True, False])
def test_corr_argmax_batched_kernel_ties_and_all_masked(dev, shared):
    n, p, b = 5000, 65, 12
    mat, w, base, mask = _batched_case(dev, n, p, b, 9, shared)
    if shared:
        mat[1::2] = mat[::2]
    else:
        mat[:, 1::2] = mat[:, ::2]
    base.zero_()
    mask.fill_(True)
    mask[:, 4] = False
    for absolute in (False, True):
        gi, gv = _check_batched_argmax(mat, w, base, mask, absolute)
        for j in range(b):
            if j == 4:
                assert int(gi[j]) == 0 and float(gv[j]) == float("-inf")
            else:
                assert int(gi[j]) % 2 == 0


# Widths on either side of the row tiles' register columns (1, 8 and 12
# take 16-byte lanes when aligned, 33 / 65 are 32 k + 1).
ROUTED = [(1, 1, 1), (7, 65, 10), (33, 8, 3), (129, 33, 17), (300, 63, 9),
          (1000, 12, 5), (513, 65, 64), (257, 96, 33), (4097, 64, 16),
          (45000, 65, 10)]


@pytest.mark.parametrize("n,d,b", ROUTED)
@pytest.mark.parametrize("route", ["rows", "warps"])
def test_batched_kernels_on_each_route(dev, monkeypatch, n, d, b, route):
    """Both routes at every width, whatever the plan would pick: the row
    tiles down to one row (their set-up threshold lifted), the warps up to
    the main path's pool (the row tiles' width bound lowered).  Each
    problem equals its single launch bit for bit."""
    if route == "rows":
        monkeypatch.setattr(corr_kernel, "ROW_MIN_ROWS", 0)
        monkeypatch.setattr(corr_kernel, "ROW_MIN_PAIRS", 0)
    else:
        monkeypatch.setattr(corr_kernel, "ROW_MAX_D", 0)
    vec = d % 4 == 0
    assert corr_kernel.batched_plan(n, d, b, argmax=True,
                                    vec=vec).route == route
    rng = np.random.default_rng(n + d + 7 * b)
    g = _t(rng.standard_normal((n, d)).astype(np.float32), dev)
    v = _t(rng.standard_normal((b, d)).astype(np.float32), dev)
    single = torch.stack([corr_kernel.corr(g, v[j]) for j in range(b)], 1)
    assert torch.equal(corr_kernel.corr_batched(g, v), single)
    base = _t(rng.standard_normal((n, b)).astype(np.float32), dev)
    for mask in (_t(rng.random((n, b)) < 0.5, dev),
                 _class_masks(dev, n, b, n + b)):
        _check_batched_argmax(g, v, base, mask, False)


def _class_masks(dev, n, b, seed, taken=0.1):
    """Per-class selection's masks: row i a candidate of its own class
    only, a ``taken`` share of the rows already picked."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, b, n)
    return _t(np.eye(b, dtype=bool)[labels]
              & (rng.random((n, 1)) >= taken), dev)


@pytest.mark.parametrize("absolute", [False, True])
def test_corr_argmax_batched_main_path_class_masks(dev, absolute):
    """The main path's call: the shared (45 000, 65) pool, B = 10, a zero
    base and one-hot class masks with a tenth of the rows taken."""
    n, p, b = 45000, 65, 10
    mat, w, _, _ = _batched_case(dev, n, p, b, 21, True)
    base = torch.zeros((n, b), device=dev)
    mask = _class_masks(dev, n, b, 22)
    assert corr_kernel.batched_plan(n, p, b, argmax=True).route == "rows"
    _check_batched_argmax(mat, -w, base, mask, absolute)


def test_corr_argmax_batched_live_minus_inf_below_masked_rows(dev):
    """A live -inf ties with the masked rows' -inf: the lowest index
    overall wins (a masked row), on both routes."""
    for n, p, shared in ((5000, 65, True), (5000, 130, True),
                         (3000, 12, False)):
        b = 4
        mat, w, base, mask = _batched_case(dev, n, p, b, 23, shared)
        mask.fill_(False)
        mask[100:, 0] = True
        base[:, 0] = float("-inf")
        mask[40, 1] = True
        base[40, 1] = float("-inf")
        mask[7, 3] = True
        base[7, 3] = float("-inf")
        mask[9, 3] = True
        mask[::5, 2] = True
        gi, gv = _check_batched_argmax(mat, w, base, mask, False)
        assert gi.tolist()[:2] == [0, 0] and int(gi[3]) == 9
        assert gv.tolist()[:2] == [float("-inf")] * 2


@pytest.mark.parametrize("n,d,b", [(4097, 64, 10), (45000, 64, 32),
                                   (1001, 65, 3), (300, 8, 40)])
def test_batched_kernels_on_an_unaligned_pool(dev, n, d, b):
    """A pool view that starts off a 16-byte boundary takes rt_corr's
    scalar order (``_vec_ok``); the batched kernels take the same, and the
    row tiles load its unaligned head and tail by plain loads."""
    rng = np.random.default_rng(n + d + b)
    buf = _t(rng.standard_normal(n * d + 1).astype(np.float32), dev)
    g = buf[1:].view(n, d)
    assert g.data_ptr() % 16 == 4 and not corr_kernel._vec_ok(g)
    v = _t(rng.standard_normal((b, d)).astype(np.float32), dev)
    single = torch.stack([corr_kernel.corr(g, v[j]) for j in range(b)], 1)
    assert torch.equal(corr_kernel.corr_batched(g, v), single)
    base = _t(rng.standard_normal((n, b)).astype(np.float32), dev)
    mask = _t(rng.random((n, b)) < 0.5, dev)
    _check_batched_argmax(g, v, base, mask, True)


def test_corr_argmax_batched_workspace_per_stream_and_after_a_failure(
        dev, monkeypatch):
    """Back-to-back calls on two streams, each with its own workspace,
    which every call leaves zero; a failed launch drops the workspace, so
    the next call starts from zeros even if the failure left keys."""
    n, p, b = 20000, 65, 10
    mat, w, base, _ = _batched_case(dev, n, p, b, 31, True)
    mask = _class_masks(dev, n, b, 32)
    want = [corr_kernel.corr_argmax(mat, w[j], base[:, j].contiguous(),
                                    mask[:, j].contiguous(), route="warps")
            for j in range(b)]
    want_i = torch.stack([x[0] for x in want])
    want_v = torch.stack([x[1] for x in want])
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        for s in (s1, s2):
            with torch.cuda.stream(s):
                got.append(corr_kernel.corr_argmax_batched(mat, w, base,
                                                           mask))
    torch.cuda.synchronize()
    for gi, gv in got:
        assert torch.equal(gi, want_i) and torch.equal(gv, want_v)
    di = mat.device.index
    keys = [(di, s.cuda_stream) for s in (s1, s2)]
    for k in keys:
        assert int(corr_kernel._workspaces[k].abs().sum()) == 0
    assert corr_kernel._workspaces[keys[0]].data_ptr() != (
        corr_kernel._workspaces[keys[1]].data_ptr())
    # A failure: a plan of three problem groups, which the kernel has no
    # form for, so the launch is refused; the workspace it left (keys
    # planted here) is dropped.
    key = (di, torch.cuda.current_stream(dev).cuda_stream)
    corr_kernel.corr_argmax_batched(mat, w, base, mask)
    corr_kernel._workspaces[key].fill_(-1)
    good = corr_kernel._plan
    assert good(mat.device, n, p, b, True).route == "rows"
    monkeypatch.setattr(corr_kernel, "_plan", lambda *a, **k: replace(
        good(*a, **k), groups=3))
    with pytest.raises(RuntimeError, match="corr_argmax_batched"):
        corr_kernel.corr_argmax_batched(mat, w, base, mask)
    assert key not in corr_kernel._workspaces
    monkeypatch.setattr(corr_kernel, "_plan", good)
    gi, gv = corr_kernel.corr_argmax_batched(mat, w, base, mask)
    assert torch.equal(gi, want_i) and torch.equal(gv, want_v)


def test_corr_argmax_batched_one_device_operation_a_call(dev):
    """After the first call made the workspace, a call is one kernel: no
    memset, no decode launch."""
    from torch.profiler import ProfilerActivity, profile
    n, p, b = 45000, 65, 10
    mat, w, base, _ = _batched_case(dev, n, p, b, 41, True)
    mask = _class_masks(dev, n, b, 42)
    for m, v in ((mat, w), (mat[:, :64].contiguous(),      # 16-byte lanes
                            w[:, :64].contiguous())):
        corr_kernel.corr_argmax_batched(m, v, base, mask)
        torch.cuda.synchronize()
        for _ in range(3):  # a trace with no record at all lost them
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                corr_kernel.corr_argmax_batched(m, v, base, mask)
                torch.cuda.synchronize()
            ops = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            if ops:
                break
        assert len(ops) == 1, [e.name for e in ops]


def test_batched_wrappers_count_reject_and_take_plain_on_the_cpu(dev):
    g = torch.ones((6, 3), device=dev)
    v = torch.ones((2, 3), device=dev)
    base = torch.zeros((6, 2), device=dev)
    mask = torch.ones((6, 2), dtype=torch.bool, device=dev)
    before = dict(corr_kernel.launches)
    key = ("corr_batched", 6, 3, "float32", 2, False)
    shaped = corr_kernel.shapes.get(key, 0)
    corr_kernel.corr_batched(g, v)
    corr_kernel.corr_argmax_batched(g, v, base, mask)
    assert corr_kernel.launches["corr_batched"] == before["corr_batched"] + 1
    assert (corr_kernel.launches["corr_argmax_batched"]
            == before["corr_argmax_batched"] + 1)
    assert corr_kernel.shapes[key] == shaped + 1
    bad = [
        (TypeError, lambda: corr_kernel.corr_batched(g.double(), v)),
        (ValueError, lambda: corr_kernel.corr_batched(g, v[:, :2])),
        (ValueError, lambda: corr_kernel.corr_batched(g, v.cpu())),
        (TypeError, lambda: corr_kernel.corr_argmax_batched(
            g.to(torch.bfloat16), v, base, mask)),
        (ValueError, lambda: corr_kernel.corr_argmax_batched(
            g, v, base.T, mask)),
        (TypeError, lambda: corr_kernel.corr_argmax_batched(
            g, v, base, mask.float())),
        (ValueError, lambda: corr_kernel.corr_argmax_batched(
            g[None].expand(2, 6, 3), v, base, mask)),
        (ValueError, lambda: corr_kernel.corr_argmax_batched(
            g, v, base, mask[:, :1])),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()
    assert corr_kernel.launches["corr_batched"] == before["corr_batched"] + 1
    assert (corr_kernel.launches["corr_argmax_batched"]
            == before["corr_argmax_batched"] + 1)
    # CPU tensors take the plain versions and launch nothing.
    got = corr_kernel.corr_batched(g.cpu(), v.cpu())
    assert got.device.type == "cpu" and got.tolist() == [[3.0, 3.0]] * 6
    gi, _ = corr_kernel.corr_argmax_batched(g.cpu(), v.cpu(), base.cpu(),
                                            mask.cpu())
    assert gi.device.type == "cpu" and gi.tolist() == [0, 0]
    assert corr_kernel.launches["corr_batched"] == before["corr_batched"] + 1


def test_batched_omp_on_the_card_equals_single_solves(dev):
    """omp_select_batched and per-class selection on the card, kernels
    on: each row picks what the single solve picks (weights and err to
    rtol 1e-4 / atol 1e-5), and the kernels launch."""
    from repro_torch.core import omp

    rng = np.random.default_rng(12)
    g = _t(rng.standard_normal((3000, 65)).astype(np.float32), dev)
    labels = _t(rng.integers(0, 6, 3000), dev)
    targets = torch.stack([g[labels == c].sum(0) for c in range(6)])
    ops.reset_launch_counts()
    bi, bw, bm, be = omp.omp_select_batched(g, targets, k=40, lam=0.3)
    counts = ops.launch_counts()
    assert counts["corr_batched"] == 1 and counts["corr_argmax_batched"] == 40
    for c in range(6):
        si, sw, sm, se = omp.omp_select(g, targets[c], k=40, lam=0.3)
        assert torch.equal(bi[c], si) and torch.equal(bm[c], sm)
        np.testing.assert_allclose(bw[c].cpu().numpy(), sw.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(be[c]), float(se), rtol=1e-4,
                                   atol=1e-5)
    idx, w, mask = omp.omp_select_per_class(g, labels, targets, 6, 30,
                                            lam=0.5)
    for c in range(6):
        si, sw, sm, _ = omp.omp_select(g, targets[c], k=30, lam=0.5,
                                       valid=labels == c)
        assert torch.equal(idx[c * 30:(c + 1) * 30], si)
        np.testing.assert_allclose(w[c * 30:(c + 1) * 30].cpu().numpy(),
                                   sw.cpu().numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# lastlayer_grad and bound_max: the tile routes against the kernels they
# replace (the warps, the row loop), bit for bit
# ---------------------------------------------------------------------------

def _one_device_op(fn):
    """The device operations one call of ``fn`` makes (``torch.profiler``;
    a trace with no record at all lost them and is taken again)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops_ = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops_:
            break
    return ops_


def _llg_case(dev, n, dh, nc, label_dtype, seed, outside=False):
    rng = np.random.default_rng(seed)
    h = _t(np.maximum(rng.standard_normal((n, dh)), 0).astype(np.float32),
           dev)
    z = _t((3 * rng.standard_normal((n, nc))).astype(np.float32), dev)
    y = rng.integers(0, nc, n)
    if outside:                         # labels outside [0, C): no one-hot
        y[::7] = -1
        y[3::7] = nc
    return h, z, _t(y, dev).to(getattr(torch, label_dtype))


def _llg_routes_equal(h, z, y):
    tiles = llg_kernel.lastlayer_grad(h, z, y, route="tiles")
    warps = llg_kernel.lastlayer_grad(h, z, y, route="warps")
    torch.cuda.synchronize()
    assert torch.equal(tiles[0], warps[0]) and torch.equal(tiles[1], warps[1])
    return tiles


# (n, d_h, C): the main path, the stream path's chunk, a tail tile of one
# row and of 127, n below one tile, odd widths, C from 1 to 32.
LLG_SHAPES = [(45000, 64, 10), (1024, 64, 10), (4097, 64, 10),
              (4223, 65, 10), (5, 64, 10), (100, 84, 32), (3000, 1, 1),
              (2001, 7, 3), (513, 300, 17)]


@pytest.mark.parametrize("n,dh,nc", LLG_SHAPES)
@pytest.mark.parametrize("label_dtype", ["int32", "int64"])
def test_lastlayer_grad_tiles_equal_warps(dev, n, dh, nc, label_dtype):
    """The tile route gives the warp route's bits, on tail tiles, below
    one tile, at every C it takes, with either label type; and both stay
    within the plain version's tolerance."""
    h, z, y = _llg_case(dev, n, dh, nc, label_dtype, n + dh + nc)
    resid, hgrad = _llg_routes_equal(h, z, y)
    rr, rh = ref.lastlayer_grad_ref(h, z, y)
    assert torch.allclose(resid, rr, rtol=1e-5, atol=1e-6)
    assert torch.allclose(hgrad, rh, rtol=1e-5, atol=1e-6)


def test_lastlayer_grad_tiles_labels_outside_and_the_ring(dev, monkeypatch):
    """Labels outside [0, C) (no one-hot, hgrad 0) on both routes; then a
    ring of two slots in a persistent wave (one block an SM forced), and
    n past one wave, each equal to the warps."""
    h, z, y = _llg_case(dev, 45000, 64, 10, "int64", 3, outside=True)
    _llg_routes_equal(h, z, y)
    monkeypatch.setattr(llg_kernel, "TILE_BLOCKS_PER_SM", 1)
    plan = llg_kernel.lastlayer_plan(45000, 64, 10, [0] * 5,
                                     torch.cuda.get_device_properties(
                                         dev).multi_processor_count)
    assert plan.stages == 2 and plan.grid < -(-45000 // plan.rows)
    _llg_routes_equal(h, z, y)
    monkeypatch.undo()
    h, z, y = _llg_case(dev, 100_003, 64, 10, "int32", 4)
    assert llg_kernel.lastlayer_plan(
        100_003, 64, 10, [0] * 5, 132, 4).stages == 2
    _llg_routes_equal(h, z, y)


def test_lastlayer_grad_rows_independent_of_position(dev):
    """A row's bits depend on that row alone: the streaming engine's
    1 024-row chunks (either route) equal the whole call's rows."""
    h, z, y = _llg_case(dev, 45000, 64, 10, "int64", 5)
    resid, hgrad = llg_kernel.lastlayer_grad(h, z, y)
    for lo in (0, 1024, 43 * 1024):
        hi = min(lo + 1024, 45000)
        for route in ("tiles", "warps"):
            r, g = llg_kernel.lastlayer_grad(h[lo:hi].contiguous(),
                                             z[lo:hi].contiguous(),
                                             y[lo:hi].contiguous(),
                                             route=route)
            assert torch.equal(r, resid[lo:hi]) and torch.equal(g,
                                                                hgrad[lo:hi])


def test_lastlayer_grad_unaligned_or_wide_takes_the_warps(dev):
    """logits[1:] of an (n, 10) matrix starts 40 bytes in: the plan sends
    it to the warps, and forcing the tiles raises; so does C = 37."""
    h, z, y = _llg_case(dev, 4097, 64, 10, "int64", 6)
    zv = z[1:]
    assert zv.is_contiguous() and zv.data_ptr() % 16 == 8
    before = dict(llg_kernel.lastlayer_routes)
    got = llg_kernel.lastlayer_grad(h[1:], zv, y[1:])
    assert llg_kernel.lastlayer_routes["warps"] == before["warps"] + 1
    want = llg_kernel.lastlayer_grad(h[1:], zv.contiguous().clone(), y[1:],
                                     route="warps")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="tile route"):
        llg_kernel.lastlayer_grad(h[1:], zv, y[1:], route="tiles")
    h, z, y = _llg_case(dev, 4097, 64, 37, "int64", 7)
    before = dict(llg_kernel.lastlayer_routes)
    llg_kernel.lastlayer_grad(h, z, y)
    assert llg_kernel.lastlayer_routes["warps"] == before["warps"] + 1
    with pytest.raises(ValueError, match="tile route"):
        llg_kernel.lastlayer_grad(h, z, y, route="tiles")


def test_lastlayer_grad_one_device_operation_a_call(dev):
    h, z, y = _llg_case(dev, 45000, 64, 10, "int64", 8)
    for route in ("tiles", "warps"):
        ops_ = _one_device_op(
            lambda: llg_kernel.lastlayer_grad(h, z, y, route=route))
        assert len(ops_) == 1, ops_


def _arena_mask(dev, n, used, seed):
    """An arena's mask: the first ``used`` rows cached with a tenth taken,
    the rest empty slots."""
    rng = np.random.default_rng(seed)
    m = np.zeros(n, dtype=bool)
    m[:used] = rng.random(used) > 0.1
    return _t(m, dev)


def _bound_routes_equal(rows, norms, errn, r, acc, th, mask, absolute):
    tiles = corr_kernel.bound_max(rows, norms, errn, r, acc, th, mask,
                                  absolute, route="tiles")
    loop = corr_kernel.bound_max(rows, norms, errn, r, acc, th, mask,
                                 absolute, route="rows")
    torch.cuda.synchronize()
    for a, b in zip(tiles, loop):
        assert torch.equal(a, b), (tiles, loop)
    return tiles


# (n, d, dtype, used rows): the two arenas with their empty halves, a tail
# tile of one row and of 200, n below one tile, f32 rows, and widths whose
# stride takes the skewed column walk (d 64 bf16, d 32 f32).
BOUND_SHAPES = [(88064, 10, "bfloat16", 45056), (86016, 65, "bfloat16",
                                                 45056),
                (4097, 10, "bfloat16", 4097), (4296, 65, "bfloat16", 3000),
                (100, 65, "bfloat16", 100), (4096, 65, "float32", 4096),
                (1000, 3, "float32", 700), (4096, 64, "bfloat16", 4096),
                (5000, 32, "float32", 3000)]


@pytest.mark.parametrize("n,d,dtype,used", BOUND_SHAPES)
@pytest.mark.parametrize("absolute", [False, True])
def test_bound_max_tiles_equal_the_row_loop(dev, n, d, dtype, used,
                                            absolute):
    """The tile route's (val, idx, count) equal the row loop's bit for
    bit at thresholds -inf, +inf and mid-gap, and stay within the plain
    version's tolerance; the workspace reads zero after every call."""
    rows, norms, errn, r, acc, _ = _bound_case(n, d, n + d, dev, dtype=dtype)
    mask = _arena_mask(dev, n, used, n + 1)
    s = rows.float() @ r
    s = s.abs() if absolute else s
    u = s + (errn + acc * norms) * torch.sqrt((r * r).sum())
    srt = torch.sort(u[mask]).values
    mid = float((srt[len(srt) // 2] + srt[len(srt) // 2 - 1]) / 2)
    for thresh in (float("-inf"), float("inf"), mid):
        th = torch.full((), thresh, device=dev)
        got = _bound_routes_equal(rows, norms, errn, r, acc, th, mask,
                                  absolute)
        want = ref.bound_max_ref(rows, norms, errn, r, acc, th, mask,
                                 absolute=absolute)
        _check_bound(got, want, u, mask, thresh)
    key = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    assert int(corr_kernel._bound_workspaces[key].abs().sum()) == 0


def test_bound_max_tiles_masks_ties_and_the_ring(dev, monkeypatch):
    """All masked, one dead tile among live ones, planted ties (the lowest
    index wins on both routes), then a ring of two slots in a persistent
    wave (one block an SM forced): each equal to the row loop."""
    n, d = 88064, 10
    rows, norms, errn, r, acc, _ = _bound_case(n, d, 11, dev)
    none = torch.zeros((n,), dtype=torch.bool, device=dev)
    v, i, c = _bound_routes_equal(rows, norms, errn, r, acc, 0.0, none,
                                  False)
    assert (float(v), int(i), int(c)) == (float("-inf"), 0, 0)
    one_dead = _arena_mask(dev, n, n, 12)
    one_dead[256 * 5:256 * 6] = False   # tile 5 has no live row
    _bound_routes_equal(rows, norms, errn, r, acc, 0.0, one_dead, True)
    dup, dn, de = rows.clone(), norms.clone(), errn.clone()
    dup[1::2], dn[1::2], de[1::2] = dup[::2], dn[::2], de[::2]
    every = torch.ones_like(none)
    _, i, c = _bound_routes_equal(dup, dn, de, r, acc, float("-inf"), every,
                                  True)
    assert int(i) % 2 == 0 and int(c) == n
    monkeypatch.setattr(corr_kernel, "BOUND_BLOCKS_PER_SM", 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = corr_kernel.bound_max_plan(n, d, 2, 0, 0, sms, "tiles")
    assert plan.stages == 2 and plan.grid < -(-n // 256)
    mask = _arena_mask(dev, n, 45056, 13)
    for absolute in (False, True):
        _bound_routes_equal(rows, norms, errn, r, acc, 0.0, mask, absolute)
        _bound_routes_equal(rows, norms, errn, r, acc, 0.0, one_dead,
                            absolute)


def test_bound_max_unaligned_rows_take_the_row_loop(dev):
    """rows[1:] of a bf16 (n, 65) arena starts 130 bytes in: the plan
    sends it to the row loop, and forcing the tiles raises."""
    n, d = 8193, 65
    rows, norms, errn, r, acc, _ = _bound_case(n, d, 14, dev)
    mask = _arena_mask(dev, n, n, 15)
    view = rows[1:]
    assert view.data_ptr() % 16 == 2
    before = dict(corr_kernel.bound_routes)
    got = corr_kernel.bound_max(view, norms[1:], errn[1:], r, acc, 0.0,
                                mask[1:].clone())
    assert corr_kernel.bound_routes["rows"] == before["rows"] + 1
    want = corr_kernel.bound_max(view.clone(), norms[1:], errn[1:], r, acc,
                                 0.0, mask[1:].clone(), route="tiles")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="tile route"):
        corr_kernel.bound_max(view, norms[1:], errn[1:], r, acc, 0.0,
                              mask[1:].clone(), route="tiles")


def test_bound_max_one_device_operation_and_its_workspace(dev, monkeypatch):
    """One device operation a call on both routes (four before: two
    memsets, the kernel, a decode launch); a workspace per stream, zero
    after every call; a refused launch drops it, and the next call starts
    from zeros."""
    n, d = 86016, 65
    rows, norms, errn, r, acc, _ = _bound_case(n, d, 16, dev)
    mask = _arena_mask(dev, n, 45056, 17)
    th = torch.zeros((), device=dev)
    for route in ("tiles", "rows"):
        ops_ = _one_device_op(lambda: corr_kernel.bound_max(
            rows, norms, errn, r, acc, th, mask, route=route))
        assert len(ops_) == 1, ops_
    want = corr_kernel.bound_max(rows, norms, errn, r, acc, th, mask)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        for s in (s1, s2):
            with torch.cuda.stream(s):
                got.append(corr_kernel.bound_max(rows, norms, errn, r, acc,
                                                 th, mask))
    torch.cuda.synchronize()
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))
    di = dev.index or 0
    for s in (s1, s2):
        assert int(corr_kernel._bound_workspaces[
            (di, s.cuda_stream)].abs().sum()) == 0
    key = (di, torch.cuda.current_stream(dev).cuda_stream)
    corr_kernel._bound_workspaces[key].fill_(-1)
    good = corr_kernel.bound_max_plan
    monkeypatch.setattr(corr_kernel, "bound_max_plan", lambda *a, **k: replace(
        good(*a, **k), stages=3))
    with pytest.raises(RuntimeError, match="bound_max"):
        corr_kernel.bound_max(rows, norms, errn, r, acc, th, mask)
    assert key not in corr_kernel._bound_workspaces
    monkeypatch.setattr(corr_kernel, "bound_max_plan", good)
    got = corr_kernel.bound_max(rows, norms, errn, r, acc, th, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# fl_gain_argmax_otf on the tensor cores (csrc/fl_gain_tc.cu)
# ---------------------------------------------------------------------------

def _otf_case(dev, n, d, seed, grid=False):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    if grid:    # multiples of 1/8: every distance exact in f32
        g = np.round(g * 8).astype(np.float32) / 8
    g = _t(g, dev)
    cover = _t(np.abs(rng.standard_normal(n)).astype(np.float32) * 4, dev)
    rok = _t(rng.random(n) > 0.1, dev)
    mask = _t(rng.random(n) < 0.7, dev)
    return g, cover, rok, mask, greedy.default_l_max(g), (g * g).sum(1)


def _gains64(g, sqn, cover, rok, lm, block=2048):
    """The on-the-fly gains of the same f32 inputs, in f64."""
    g64, s64 = g.double(), sqn.double()
    out = torch.zeros((g.shape[0],), dtype=torch.float64, device=g.device)
    for lo in range(0, g.shape[0], block):
        d2 = (s64[lo:lo + block, None] + s64[None, :]
              - 2.0 * (g64[lo:lo + block] @ g64.T))
        sv = ((float(lm) - d2.clamp_min(0.0).sqrt())
              * rok[lo:lo + block].double()[:, None])
        out += (sv - cover[lo:lo + block].double()[:, None]).clamp_min(
            0.0).sum(0)
    return out


@pytest.mark.parametrize("n,d", [(1, 3), (9, 64), (129, 65), (300, 10),
                                 (260, 65), (777, 1), (1000, 104),
                                 (2000, 73), (4097, 10)])
def test_fl_gain_otf_tensor_cores_match_ffma_and_plain(dev, n, d):
    """The tensor-core route against the FFMA route and the plain version
    at ragged n and d, at the on-the-fly tolerance (1e-3: each column's
    own term is rounding noise of ~sqrt(eps)|g_j|, rounded differently by
    each); the same bits on a second call; an all-masked input (0, -inf)."""
    g, cover, rok, mask, lm, sqn = _otf_case(dev, n, d, 11 * n + d)
    assert fl_kernel.fl_gain_otf_plan(n, d).route == "tc"
    before = dict(fl_kernel.launches)
    tc = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm, sqnorms=sqn)
    again = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm,
                                         sqnorms=sqn)
    ffma = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm, sqnorms=sqn,
                                        route="ffma")
    want = ref.fl_gain_argmax_otf_ref(g, cover, rok, mask, lm, sqnorms=sqn)
    torch.cuda.synchronize()
    assert fl_kernel.launches["fl_gain_argmax_otf_tc"] == (
        before["fl_gain_argmax_otf_tc"] + 2)
    assert fl_kernel.launches["fl_gain_argmax_otf"] == (
        before["fl_gain_argmax_otf"] + 1)
    assert all(torch.equal(a, b) for a, b in zip(tc, again))
    _check_fl(tc, want, want[0], tol=1e-3)
    _check_fl(tc, ffma, want[0], tol=1e-3)
    none = torch.zeros_like(mask)
    _, gi, gv = fl_kernel.fl_gain_argmax_otf(g, cover, rok, none, lm,
                                             sqnorms=sqn)
    assert int(gi) == 0 and float(gv) == float("-inf")


@pytest.mark.parametrize("d", [10, 65, 104])
def test_fl_gain_otf_tensor_cores_f64_error(dev, d):
    """The 3xTF32 products keep f32 grade: against an f64 scan of the same
    inputs the gains of 16 384 rows are within 1e-6 of the largest (a
    tenth of the lazy greedy's on-the-fly certification margin), as the
    FFMA kernel's are."""
    n = 16384
    g, cover, rok, mask, lm, sqn = _otf_case(dev, n, d, n + 5 * d)
    g64 = _gains64(g, sqn, cover, rok, lm)
    scale = float(g64.abs().max())
    for route in ("tc", "ffma"):
        got = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm,
                                           sqnorms=sqn, route=route)[0]
        assert float((got.double() - g64).abs().max()) <= 1e-6 * scale


def test_fl_gain_otf_tensor_cores_exact_on_a_grid(dev):
    """On a 1/8 grid hi is exact and lo is 0, so every distance is exact:
    the tensor cores' and the FFMA kernel's gains differ only in the order
    of their column sums, far inside the lazy greedy's 1e-5 margin."""
    g, cover, rok, mask, lm, sqn = _otf_case(dev, 3001, 20, 5, grid=True)
    tc = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm, sqnorms=sqn)
    ffma = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm, sqnorms=sqn,
                                        route="ffma")
    torch.cuda.synchronize()
    np.testing.assert_allclose(tc[0].cpu().numpy(), ffma[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_fl_gain_otf_tensor_cores_ties(dev):
    """Equal columns give equal gains bit for bit (every column's sum runs
    in the same order), so the lowest unmasked index wins: all rows equal,
    then one duplicated row."""
    n, d = 4097, 16
    g = torch.full((n, d), 0.5, device=dev)
    cover = torch.zeros((n,), device=dev)
    rok = torch.ones((n,), dtype=torch.bool, device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    mask[0] = False
    lm = torch.tensor(3.0, device=dev)
    gains, gi, gv = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm)
    assert int(gi) == 1 and float(gv) == float(gains[1])
    assert bool((gains == gains[0]).all())
    g, cover, rok, _, lm, _ = _otf_case(dev, n, d, 9, grid=True)
    g[4000] = g[3001]
    gains, _, _ = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm)
    assert float(gains[3001]) == float(gains[4000])
    only = torch.zeros_like(mask)
    only[[3001, 4000]] = True
    _, gi, gv = fl_kernel.fl_gain_argmax_otf(g, cover, rok, only, lm)
    assert int(gi) == 3001 and float(gv) == float(gains[3001])


def test_fl_gain_otf_plan_on_the_card(dev):
    """d_pad past 104 takes the FFMA kernel (a forced tensor-core route
    raises before anything launches); d <= 104 the tensor cores."""
    g, cover, rok, mask, lm, sqn = _otf_case(dev, 300, 105, 3)
    before = dict(fl_kernel.launches)
    got = fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm, sqnorms=sqn)
    with pytest.raises(ValueError):
        fl_kernel.fl_gain_argmax_otf(g, cover, rok, mask, lm, sqnorms=sqn,
                                     route="tc")
    assert fl_kernel.launches["fl_gain_argmax_otf"] == (
        before["fl_gain_argmax_otf"] + 1)
    assert fl_kernel.launches["fl_gain_argmax_otf_tc"] == (
        before["fl_gain_argmax_otf_tc"])
    want = ref.fl_gain_argmax_otf_ref(g, cover, rok, mask, lm, sqnorms=sqn)
    _check_fl(got, want, want[0], tol=1e-3)


def test_fl_gain_otf_sqrt_is_ieee_on_every_float(dev):
    """The epilogue's branch-free roots are sqrtf bit for bit on every
    float they take (2^31 inputs, on the card)."""
    from repro_torch.kernels import build
    bad = torch.zeros((1,), dtype=torch.int64, device=dev)
    code = build.lib().rt_sqrt_rn_mismatches(
        dev.index or 0, bad.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "sqrt_rn_check")
    torch.cuda.synchronize()
    assert int(bad) == 0


def test_fl_gain_otf_tensor_cores_two_device_operations(dev):
    """A call is the prologue (TF32 halves, the key and counter zeroed) and
    the scan, whose last block decodes the argmax: no memset, no decode
    launch."""
    g, cover, rok, mask, lm, sqn = _otf_case(dev, 4097, 65, 2)
    ops_ = _one_device_op(lambda: fl_kernel.fl_gain_argmax_otf(
        g, cover, rok, mask, lm, sqnorms=sqn))
    assert len(ops_) == 2, ops_


# ---------------------------------------------------------------------------
# corr_argmax's routes (csrc/corr.cu warps, corr_batched.cu row tiles at B 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p", [(1, 1), (7, 65), (33, 8), (129, 96),
                                 (703, 10), (4097, 12), (45000, 10),
                                 (45000, 65), (20000, 64)])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("absolute", [False, True])
def test_corr_argmax_routes_equal(dev, n, p, aligned, absolute):
    """The row tiles at B = 1 and the warp kernel give the same (index,
    score) bits at every width, from an aligned pool and from one off a
    16-byte boundary, each one device operation."""
    rng = np.random.default_rng(n + p)
    off = 0 if aligned else 1
    buf = _t(rng.standard_normal(n * p + off).astype(np.float32), dev)
    c = buf[off:].view(n, p)
    w = _t(rng.standard_normal(p).astype(np.float32), dev)
    base = _t(rng.standard_normal(n).astype(np.float32), dev)
    mask = _t(rng.random(n) < 0.5, dev)
    rows = corr_kernel.corr_argmax(c, w, base, mask, absolute=absolute,
                                   route="rows")
    warps = corr_kernel.corr_argmax(c, w, base, mask, absolute=absolute,
                                    route="warps")
    torch.cuda.synchronize()
    assert torch.equal(rows[0], warps[0]) and torch.equal(rows[1], warps[1])
    ri, rv = ref.corr_argmax_ref(c, w, base, mask, absolute=absolute)
    if int(rows[0]) != int(ri):
        s = base - c @ w
        s = s.abs() if absolute else s
        np.testing.assert_allclose(float(s[int(rows[0])]),
                                   float(s[int(ri)]), rtol=1e-6)
    np.testing.assert_allclose(float(rows[1]), float(rv), rtol=1e-5)
    if not absolute:
        for route in ("rows", "warps"):
            ops_ = _one_device_op(lambda: corr_kernel.corr_argmax(
                c, w, base, mask, route=route))
            assert len(ops_) == 1, ops_


def test_corr_argmax_plan_on_the_card(dev):
    """GLISTER's (45 000, 10) takes the row tiles, GRAD-MATCH-PB's
    (703, 10) and the wide regime's p 512 the warps, each counted by
    route; a width the row tiles have no form for refuses a forced rows
    route before anything launches."""
    rng = np.random.default_rng(4)
    before = dict(corr_kernel.argmax_routes)
    for n, p, route in ((45000, 10, "rows"), (703, 10, "warps"),
                        (8192, 512, "warps")):
        c = _t(rng.standard_normal((n, p)).astype(np.float32), dev)
        w = _t(rng.standard_normal(p).astype(np.float32), dev)
        zeros = torch.zeros((n,), device=dev)
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
        corr_kernel.corr_argmax(c, w, zeros, mask)
        assert corr_kernel.argmax_routes[route] == before[route] + 1
        before[route] += 1
    with pytest.raises(ValueError):
        corr_kernel.corr_argmax(c, w, zeros, mask, route="rows")


def test_corr_argmax_workspace_per_stream_and_after_a_failure(
        dev, monkeypatch):
    """Back-to-back calls on two streams, each with its own workspace,
    which every call on either route leaves zero; a refused launch drops
    the workspace, so the next call starts from zeros even if the failure
    left a key."""
    n, p = 45000, 10
    rng = np.random.default_rng(51)
    c = _t(rng.standard_normal((n, p)).astype(np.float32), dev)
    w = _t(rng.standard_normal(p).astype(np.float32), dev)
    base = torch.zeros((n,), device=dev)
    mask = _t(rng.random(n) < 0.9, dev)
    want = corr_kernel.corr_argmax(c, w, base, mask, route="warps")
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        for s in (s1, s2):
            with torch.cuda.stream(s):
                for route in ("rows", "warps"):
                    got.append(corr_kernel.corr_argmax(c, w, base, mask,
                                                       route=route))
    torch.cuda.synchronize()
    for gi, gv in got:
        assert torch.equal(gi, want[0]) and torch.equal(gv, want[1])
    di = dev.index or 0
    keys = [(di, s.cuda_stream) for s in (s1, s2)]
    for k in keys:
        assert int(corr_kernel._workspaces[k].abs().sum()) == 0
    assert corr_kernel._workspaces[keys[0]].data_ptr() != (
        corr_kernel._workspaces[keys[1]].data_ptr())
    key = (di, torch.cuda.current_stream(dev).cuda_stream)
    corr_kernel._workspaces[key].fill_(-1)
    good = corr_kernel.corr_argmax_plan
    monkeypatch.setattr(corr_kernel, "corr_argmax_plan",
                        lambda *a, **k: replace(good(*a, **k), groups=3))
    with pytest.raises(RuntimeError, match="corr_argmax"):
        corr_kernel.corr_argmax(c, w, base, mask)
    assert key not in corr_kernel._workspaces
    monkeypatch.setattr(corr_kernel, "corr_argmax_plan", good)
    for route in ("rows", "warps"):
        gi, gv = corr_kernel.corr_argmax(c, w, base, mask, route=route)
        assert torch.equal(gi, want[0]) and torch.equal(gv, want[1])


# ---------------------------------------------------------------------------
# corr's routes (csrc/corr.cu warps and wide, corr_batched.cu row tiles at B 1)
# ---------------------------------------------------------------------------

# d <= 96 (the row tiles: scalar lanes at 65, 16-byte lanes at 8 / 12 / 96
# where aligned), wider (the wide route: 16-byte lanes where aligned), the
# streaming arenas' widths and the LM's candidates.
CORR_ROUTED = [(1, 1), (7, 65), (33, 8), (129, 96), (703, 10), (4097, 12),
               (45000, 65), (88064, 10), (129, 97), (300, 512), (1000, 700),
               (16, 2048), (16, 3584), (3, 40000)]


def _corr_case(dev, n, d, dtype, aligned, seed):
    """An (n, d) pool of ``dtype`` that starts on a 16-byte boundary, or 4
    bytes past one, and an f32 residual."""
    rng = np.random.default_rng(seed)
    t = getattr(torch, dtype)
    off = 0 if aligned else 4 // torch.empty((), dtype=t).element_size()
    buf = _t(rng.standard_normal(n * d + off).astype(np.float32), dev).to(t)
    r = _t(rng.standard_normal(d).astype(np.float32), dev)
    return buf[off:].view(n, d), r


def _corr_routes(g, r):
    """Each route whose layout takes ``g``, by name."""
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    out = []
    for route in ("rows", "wide", "warps"):
        try:
            corr_kernel.corr_plan(*g.shape, g.element_size(), g.data_ptr(),
                                  sms, route)
        except ValueError:
            continue
        out.append(route)
    return out


@pytest.mark.parametrize("n,d", CORR_ROUTED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [True, False])
def test_corr_routes_equal_the_warps(dev, n, d, dtype, aligned):
    """Every route that takes the pool gives the warp kernel's bits, from a
    pool on a 16-byte boundary and from one 4 bytes past it; the plan's
    route is one of them, and the plain version agrees within the f32 dot
    rounding."""
    g, r = _corr_case(dev, n, d, dtype, aligned, n + d)
    warps = corr_kernel.corr(g, r, route="warps")
    routes = _corr_routes(g, r)
    got = {route: corr_kernel.corr(g, r, route=route) for route in routes}
    plan = corr_kernel.corr(g, r)
    torch.cuda.synchronize()
    for route, s in got.items():
        assert torch.equal(s, warps), route
    assert torch.equal(plan, warps)
    if d <= corr_kernel.ROW_MAX_D:
        assert "rows" in routes
    if d <= 8192:
        assert "wide" in routes
    want = ref.corr_ref(g, r)
    scale = float(torch.sqrt((g.float() ** 2).sum(1).max() * (r ** 2).sum()))
    np.testing.assert_allclose(plan.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6 * max(scale, 1.0))


@pytest.mark.parametrize("d", [10, 65, 700])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_row_independent_of_position(dev, d, dtype):
    """A row's score depends on that row alone: the same bits whether it
    sits in a (1, d), a (1 024, d) or an (88 064, d) matrix, at any place,
    on any route (the streaming engine's buffers, chunks and arenas and the
    in-memory solver score the same rows at all three)."""
    big, r = _corr_case(dev, 88064, d, dtype, True, d)
    whole = corr_kernel.corr(big, r)
    for i in (0, 1, 127, 128, 5000, 88063):
        lo = min(i, 88064 - 1024)
        mats = (big[i:i + 1].clone(), big[lo:lo + 1024].clone(), big)
        for m, at in zip(mats, (0, i - lo, i)):
            for route in [None] + _corr_routes(m, r):
                s = corr_kernel.corr(m, r, route=route)
                assert torch.equal(s[at], whole[i]), (i, m.shape, route)


@pytest.mark.parametrize("n,d,b", [(45000, 65, 10), (45000, 65, 32),
                                   (4097, 12, 5), (45000, 10, 10)])
@pytest.mark.parametrize("aligned", [True, False])
def test_corr_batched_columns_equal_corr_on_the_rows_route(dev, n, d, b,
                                                           aligned):
    """Column b of corr_batched equals corr on vecs[b] launched on the row
    tiles at B = 1, and on the warps."""
    g, _ = _corr_case(dev, n, d, "float32", aligned, n + b)
    v = _t(np.random.default_rng(b).standard_normal((b, d)).astype(
        np.float32), dev)
    got = corr_kernel.corr_batched(g, v)
    for route in ("rows", "warps"):
        single = torch.stack([corr_kernel.corr(g, v[j], route=route)
                              for j in range(b)], 1)
        torch.cuda.synchronize()
        assert torch.equal(got, single), route


def _graph_nodes(fn):
    """(the device operations one call of ``fn`` enqueues, its output): the
    nodes of a CUDA graph that captures the call, and what the graph's
    replay gives (deterministic, where a profiler trace late in a long
    process can come back empty); ``fn`` runs once before, uncaptured."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    count = ctypes.c_size_t(0)
    code = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    assert code == 0, code
    return count.value, out


@pytest.mark.parametrize("n,d,dtype", [(45000, 65, "float32"),
                                       (88064, 10, "bfloat16"),
                                       (16, 3584, "float32"),
                                       (1000, 700, "bfloat16"),
                                       (703, 10, "float32")])
def test_corr_one_device_operation_a_call(dev, n, d, dtype):
    """A call is one device operation on every route that takes the pool,
    and the captured call gives the same bits."""
    g, r = _corr_case(dev, n, d, dtype, True, 3)
    want = corr_kernel.corr(g, r, route="warps")
    for route in _corr_routes(g, r):
        nodes, got = _graph_nodes(lambda: corr_kernel.corr(g, r,
                                                           route=route))
        assert nodes == 1 and torch.equal(got, want), (route, nodes)


def test_corr_plan_on_the_card_counts_routes(dev):
    """The plan's picks, counted by route: the main path's (45 000, 65) and
    the bf16 arenas the row tiles, GRAD-MATCH-PB's (703, 10), one row and
    the wide regime's (8 192, 512) the warps, the LM's candidates the wide
    route; a forced route that cannot take the pool raises before anything
    launches."""
    before = dict(corr_kernel.corr_routes)
    for n, d, dtype, route in ((45000, 65, "float32", "rows"),
                               (88064, 10, "bfloat16", "rows"),
                               (86016, 65, "bfloat16", "rows"),
                               (703, 10, "float32", "warps"),
                               (1, 65, "float32", "warps"),
                               (16, 2048, "float32", "wide"),
                               (16, 3584, "float32", "wide"),
                               (8192, 512, "float32", "warps")):
        g, r = _corr_case(dev, n, d, dtype, True, 5)
        corr_kernel.corr(g, r)
        before[route] += 1
        assert corr_kernel.corr_routes == before, (n, d, dtype)
    launched = corr_kernel.launches["corr"]
    g, r = _corr_case(dev, 16, 3584, "float32", True, 5)
    with pytest.raises(ValueError, match="rows route"):
        corr_kernel.corr(g, r, route="rows")
    g, r = _corr_case(dev, 2, 60000, "float32", True, 5)
    with pytest.raises(ValueError, match="wide route"):
        corr_kernel.corr(g, r, route="wide")
    with pytest.raises(ValueError, match="no route"):
        corr_kernel.corr(g, r, route="tiles")
    assert corr_kernel.launches["corr"] == launched
    assert corr_kernel.corr_routes == before
