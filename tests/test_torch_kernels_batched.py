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
