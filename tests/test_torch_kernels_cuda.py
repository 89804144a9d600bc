"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card and ``nvcc``; every test skips without a card.  It imports
no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

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
    g = torch.ones((4, 3), device=dev)
    corr_kernel.corr(g, torch.ones((3,), device=dev))
    assert corr_kernel.launches["corr"] == before + 1
    with pytest.raises(TypeError):
        corr_kernel.corr(g, torch.ones((3,), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        corr_kernel.corr(g.t(), torch.ones((4,), device=dev))
    with pytest.raises(ValueError):
        corr_kernel.corr(g, torch.ones((3,)))
    assert corr_kernel.launches["corr"] == before + 1
    # corr_argmax takes f32 only: no path scores a bf16 column cache.
    with pytest.raises(TypeError):
        corr_kernel.corr_argmax(
            g.to(torch.bfloat16), torch.ones((3,), device=dev),
            torch.zeros((4,), device=dev),
            torch.ones((4,), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# sqdist, fl_gain_argmax, fl_gain_argmax_otf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (9, 17, 3), (129, 65, 130),
                                   (300, 257, 65), (4097, 1000, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sqdist_kernel_matches_plain(dev, n, m, d, dtype):
    rng = np.random.default_rng(n + m + d)
    a = _t(rng.standard_normal((n, d)).astype(np.float32), dev)
    b = _t(rng.standard_normal((m, d)).astype(np.float32), dev)
    a, b = a.to(getattr(torch, dtype)), b.to(getattr(torch, dtype))
    got = sqdist_kernel.sqdist(a, b)
    want = ref.sqdist_ref(a, b)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert float(got.min()) >= 0.0


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
    """Lazy CRAIG, resident (sqdist + fl_gain_argmax) and on the fly,
    with the kernels and with the plain versions: the same picks."""
    rng = np.random.default_rng(40)
    g = _t(np.round(rng.standard_normal((3000, 20)) * 8).astype(np.float32)
           / 8, dev)
    lm = greedy.default_l_max(g)
    for kw in (dict(dist_fn=ops.sqdist, on_the_fly=False),
               dict(on_the_fly=True)):
        ops.reset_launch_counts()
        a = craig.craig(g, 150, method="lazy", l_max=lm, **kw)
        counts = ops.launch_counts()
        ops.set_backend("ref")
        try:
            b = craig.craig(g, 150, method="lazy", l_max=lm, **kw)
        finally:
            ops.set_backend(None)
        assert torch.equal(a.indices, b.indices)
        np.testing.assert_allclose(float(a.err), float(b.err), rtol=1e-5)
        if kw["on_the_fly"]:
            assert counts["fl_gain_argmax_otf"] >= 1
        else:
            assert counts["sqdist"] == 1 and counts["fl_gain_argmax"] >= 1
