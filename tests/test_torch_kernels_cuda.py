"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card and ``nvcc``; every test skips without a card.  It imports
no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import corr as corr_kernel  # noqa: E402
from repro_torch.kernels import lastlayer_grad as llg_kernel  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


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
