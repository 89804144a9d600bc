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
from repro.kernels.corr import corr as pallas_corr  # noqa: E402
from repro.kernels.corr import corr_argmax as pallas_corr_argmax  # noqa: E402
from repro.kernels.lastlayer_grad import (  # noqa: E402
    lastlayer_grad as pallas_lastlayer_grad)
from repro_torch.kernels import corr as corr_kernel  # noqa: E402
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
            if mode is not None:
                assert ops.active_mode() == mode
        finally:
            ops.set_backend(None)
    assert ops.launch_counts() == {"corr": 0, "corr_argmax": 0,
                                   "lastlayer_grad": 0}
    for mode in ("pallas", "cuda"):
        with pytest.raises(ValueError):
            ops.set_backend(mode)
