"""The port's anytime OMP sessions against the JAX package's, on the CPU.

The cases of ``tests/test_serve.py``'s anytime section, run through both
packages on the same numpy inputs.  Across packages the standard is
``_assert_parity`` of ``tests/test_omp_parity.py``: indices and masks
equal, weights and ``err`` to rtol 1e-4 / atol 1e-5 (the two libraries
sum in other orders).  Inside the port the session engine promises more
and is held to it bit for bit: a chained extension equals a direct one
(the Gram included), and every row of a trajectory equals a fresh start
at that budget, because both run the same round body on the same shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import omp as jomp  # noqa: E402
from repro_torch.core import omp as tomp  # noqa: E402


def _pool(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_parity(got, want, what):
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]),
                                  err_msg=f"{what}: indices differ")
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]),
                                  err_msg=f"{what}: masks differ")
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: weights differ")
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: err differs")


def _assert_same_bits(a, b, what):
    for x, y, name in zip(a, b, ("indices", "weights", "mask", "err")):
        assert torch.equal(x, y), f"{what}: {name} differ"


def _both(g, target, ks, valid=None, **kw):
    """Start at ks[0] and extend through ks[1:] in both packages; returns
    (port session, JAX session)."""
    t = tomp.omp_session_start(torch.from_numpy(g), torch.from_numpy(target),
                               ks[0], valid=None if valid is None
                               else torch.from_numpy(valid), **kw)
    j = jomp.omp_session_start(jnp.asarray(g), jnp.asarray(target), ks[0],
                               valid=None if valid is None
                               else jnp.asarray(valid), **kw)
    for k in ks[1:]:
        t = tomp.omp_session_extend(torch.from_numpy(g), t, k)
        j = jomp.omp_session_extend(jnp.asarray(g), j, k)
    return t, j


GRID = [
    # (seed, n, d, k_first, k_ext): test_serve.py's grid, extensions
    # crossing the narrow/wide regimes and block boundaries
    (0, 96, 12, 8, 16),
    (1, 160, 48, 10, 24),
    (2, 200, 8, 6, 16),
    (3, 64, 32, 24, 96),     # k' > n: the masked tail must agree too
]


@pytest.mark.parametrize("seed,n,d,k1,k2", GRID)
@pytest.mark.parametrize("lam", [1e-6, 0.3])
def test_extension_matches_jax_and_oneshot(seed, n, d, k1, k2, lam):
    g = _pool(seed, n, d)
    target = g.sum(axis=0)
    t, j = _both(g, target, (k1, k2), lam=lam)
    _assert_parity(tomp.session_result(t), jomp.session_result(j),
                   f"port vs JAX session {k1}->{k2}")
    one = tomp.omp_select(torch.from_numpy(g), torch.from_numpy(target),
                          k=k2, lam=lam)
    _assert_parity(tomp.session_result(t), one,
                   f"port session vs port omp_select {k1}->{k2}")
    assert t.k == k2 and t.st.indices.shape[0] == tomp._block_cap(k2, 128)


def test_extension_duplicate_rows():
    g = _pool(10, 80, 12)
    g[1::2] = g[::2]
    t, j = _both(g, g.sum(axis=0), (9, 24), lam=0.2)
    _assert_parity(tomp.session_result(t), jomp.session_result(j),
                   "duplicates")


def test_extension_beyond_the_valid_pool():
    """k' far above the 9 valid rows: the masked tail agrees."""
    g = _pool(12, 72, 10)
    valid = np.arange(72) < 9
    target = (g * valid[:, None]).sum(axis=0)
    t, j = _both(g, target, (5, 32), lam=0.2, valid=valid)
    _assert_parity(tomp.session_result(t), jomp.session_result(j),
                   "masked, k' >= n_valid")
    assert sorted(_np(t.indices)[:9].tolist()) == list(range(9))


def test_absolute_scores_session():
    g = _pool(15, 140, 20)
    target = -(g[:40].sum(axis=0))
    t, j = _both(g, target, (5, 12), lam=0.1, positive=False)
    _assert_parity(tomp.session_result(t), jomp.session_result(j),
                   "absolute")


def test_block_8_crosses_wide_to_narrow():
    """block=8 on d=20: widths 8 and 16 are wide, 24 and 32 narrow; the
    extensions stop inside blocks and on their edges."""
    g = _pool(17, 150, 20)
    target = g.sum(axis=0)
    t, j = _both(g, target, (3, 8, 13, 27), lam=0.3, block=8)
    _assert_parity(tomp.session_result(t), jomp.session_result(j),
                   "block 8")
    assert t.st.colcache.shape[1] == 16 and t.st.weights.shape[0] == 32
    direct = tomp.omp_session_start(torch.from_numpy(g),
                                    torch.from_numpy(target), 27, lam=0.3,
                                    block=8)
    _assert_same_bits(tomp.session_result(t), tomp.session_result(direct),
                      "block 8 chained vs direct")


def test_chained_extension_bit_identical():
    """extend(k1); extend(k2) == extend(k2) directly, bit for bit, the
    caches included: the resume is a resume, not a re-solve."""
    g = torch.from_numpy(_pool(4, 150, 24))
    target = g.sum(dim=0)
    chained = tomp.omp_session_start(g, target, 7, lam=0.1)
    chained = tomp.omp_session_extend(g, chained, 19)
    chained = tomp.omp_session_extend(g, chained, 40)
    direct = tomp.omp_session_start(g, target, 40, lam=0.1)
    _assert_same_bits(tomp.session_result(chained),
                      tomp.session_result(direct), "chained vs direct")
    for name in ("gram", "gram_absrow", "tcorr", "rows", "colcache",
                 "residual"):
        assert torch.equal(getattr(chained.st, name),
                           getattr(direct.st, name)), name


def test_extension_leaves_the_old_session_as_it_was():
    g = torch.from_numpy(_pool(8, 90, 16))
    target = g.sum(dim=0)
    s1 = tomp.omp_session_start(g, target, 5, lam=0.2)
    before = [t.clone() for t in tomp.session_result(s1)]
    s2 = tomp.omp_session_extend(g, s1, 11)
    _assert_same_bits(tomp.session_result(s1), before, "old session")
    assert s2.k == 11 and s1.k == 5
    assert torch.equal(s2.indices[:5], before[0])     # prefix property


def test_extension_shrink_and_noop():
    g = torch.from_numpy(_pool(5, 64, 16))
    target = g.sum(dim=0)
    sess = tomp.omp_session_start(g, target, 12)
    assert tomp.omp_session_extend(g, sess, 12) is sess
    with pytest.raises(ValueError, match="shrink"):
        tomp.omp_session_extend(g, sess, 6)


def test_session_prefix_result():
    g = _pool(9, 120, 14)
    target = g.sum(axis=0)
    t, j = _both(g, target, (20,), lam=0.2)
    for k in (0, 1, 7, 20):
        got = tomp.session_prefix_result(t, k)
        want = jomp.session_prefix_result(j, k)
        assert got[0].shape == (k,)
        _assert_parity(got, want, f"prefix {k}")
        assert torch.equal(got[0], t.indices[:k])
        assert torch.equal(got[1], t.weights[:k])
        assert got[3] is t.err
        fresh = tomp.omp_select(torch.from_numpy(g), torch.from_numpy(target),
                                k=k, lam=0.2) if k else None
        if fresh is not None:
            assert torch.equal(got[0], fresh[0])     # certified indices
    with pytest.raises(ValueError, match="extend"):
        tomp.session_prefix_result(t, 21)


@pytest.mark.parametrize("block", [128, 8])
def test_trajectory_rows_equal_fresh_starts(block):
    g = _pool(6, 110, 12)
    target = g.sum(axis=0)
    k_max = 20
    sess, traj = tomp.omp_session_trajectory(
        torch.from_numpy(g), torch.from_numpy(target), k_max, lam=0.3,
        block=block)
    assert traj.weights_traj.shape == (k_max, k_max)
    assert traj.indices.dtype == np.int32 and traj.mask.dtype == bool
    assert not np.triu(traj.weights_traj, 1).any()
    for t in (1, 5, 12, 16, 20):
        fresh = tomp.omp_session_start(torch.from_numpy(g),
                                       torch.from_numpy(target), t, lam=0.3,
                                       block=block)
        np.testing.assert_array_equal(traj.indices[:t], _np(fresh.indices))
        np.testing.assert_array_equal(traj.mask[:t], _np(fresh.mask))
        np.testing.assert_array_equal(traj.weights_traj[t - 1, :t],
                                      _np(fresh.weights))
        assert traj.err_trace[t - 1] == float(fresh.err)
    _assert_same_bits(tomp.session_result(sess),
                      tomp.session_result(tomp.omp_session_start(
                          torch.from_numpy(g), torch.from_numpy(target),
                          k_max, lam=0.3, block=block)), "final session")
    _, jtraj = jomp.omp_session_trajectory(jnp.asarray(g),
                                           jnp.asarray(target), k_max,
                                           lam=0.3, block=block)
    np.testing.assert_array_equal(traj.indices, jtraj.indices)
    np.testing.assert_array_equal(traj.mask, jtraj.mask)
    np.testing.assert_allclose(traj.weights_traj, jtraj.weights_traj,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(traj.err_trace, jtraj.err_trace, rtol=1e-4,
                               atol=1e-5)


def test_trajectory_rejects_empty_budget():
    g = torch.ones((4, 2))
    with pytest.raises(ValueError):
        tomp.omp_session_trajectory(g, g.sum(0), 0)
