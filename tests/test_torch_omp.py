"""The port's OMP and GRAD-MATCH against the JAX package, on the CPU.

Same numpy inputs into both packages; the standard is ``_assert_parity`` of
``tests/test_omp_parity.py``: indices and masks equal, weights and ``err``
to rtol 1e-4 / atol 1e-5.  The JAX dense solver is the oracle for both of
the port's solvers.  The cases are those of ``test_omp_parity.py``, plus
a block size of 8 and 32 rounds that moves the wide/narrow switch and the
prefix-block boundary into the first rounds, and one solve of 140 rounds
across the default 128-round block.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gradmatch as jgm  # noqa: E402
from repro.core import omp as jomp  # noqa: E402
from repro_torch.core import gradmatch as tgm  # noqa: E402
from repro_torch.core import omp as tomp  # noqa: E402


def _pool(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _assert_parity(a, b, what):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]),
                                  err_msg=f"{what}: indices differ")
    np.testing.assert_array_equal(np.asarray(a[2]), np.asarray(b[2]),
                                  err_msg=f"{what}: masks differ")
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]),
                               rtol=1e-4, atol=1e-5,
                               err_msg=f"{what}: weights differ")
    np.testing.assert_allclose(float(a[3]), float(b[3]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: err differs")


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _run_both(g, target, k, lam, valid=None, positive=True, eps=1e-10,
              block=128):
    """(JAX dense oracle, port incremental, port dense) as numpy tuples."""
    oracle = jomp.omp_select_dense(
        jnp.asarray(g), jnp.asarray(target, jnp.float32), k=k, lam=lam,
        eps=eps, valid=None if valid is None else jnp.asarray(valid),
        positive=positive)
    inc = tomp.omp_select(_t(g), _t(np.asarray(target, np.float32)), k=k,
                          lam=lam, eps=eps, valid=_t(valid),
                          positive=positive, block=block)
    dense = tomp.omp_select_dense(_t(g), _t(np.asarray(target, np.float32)),
                                  k=k, lam=lam, eps=eps, valid=_t(valid),
                                  positive=positive)
    return oracle, inc, dense


def _check(g, target, k, lam, what, **kw):
    oracle, inc, dense = _run_both(g, target, k, lam, **kw)
    _assert_parity(inc, oracle, f"port incremental vs JAX dense ({what})")
    _assert_parity(dense, oracle, f"port dense vs JAX dense ({what})")
    return inc


GRID = [
    # (seed, n, d, k, block): wide + narrow regimes, k crossing blocks
    (0, 96, 12, 16, 128),
    (1, 160, 48, 24, 128),
    (2, 200, 8, 16, 128),     # narrow proxies, k > d
    (3, 64, 32, 96, 128),     # k > n
    (0, 96, 12, 16, 8),       # wide block, then narrow blocks
    (1, 160, 48, 60, 32),     # two wide blocks, then narrow
    (4, 400, 96, 140, 128),   # across the 128-round block boundary
]


@pytest.mark.parametrize("seed,n,d,k,block", GRID)
@pytest.mark.parametrize("lam", [1e-6, 0.3])
def test_omp_parity_random_pools(seed, n, d, k, block, lam):
    g = _pool(seed, n, d)
    _check(g, g.sum(axis=0), k, lam, f"grid {seed}", block=block)


def test_omp_parity_duplicate_rows():
    g = _pool(10, 80, 12)
    g[1::2] = g[::2]                       # every row duplicated
    _check(g, g.sum(axis=0), 24, 0.2, "duplicates")


def test_omp_parity_zero_gradient_rows():
    g = _pool(11, 96, 16)
    g[20:60] = 0.0
    inc = _check(g, g.sum(axis=0), 20, 0.1, "zero rows")
    sel = inc[0].numpy()[inc[2].numpy()]
    assert not np.any((sel >= 20) & (sel < 60))


def test_omp_parity_k_exceeds_valid_pool():
    g = _pool(12, 72, 10)
    valid = np.arange(72) < 9
    _check(g, (g * valid[:, None]).sum(axis=0), 32, 0.2, "k >= n_valid",
           valid=valid)


def test_omp_parity_all_masked_valid():
    g = _pool(13, 64, 8)
    valid = np.zeros((64,), bool)
    inc = _check(g, (g * valid[:, None]).sum(axis=0), 8, 0.2, "all masked",
                 valid=valid)
    assert int(inc[2].sum()) == 0


def test_omp_parity_random_valid_mask():
    rng = np.random.default_rng(14)
    g = _pool(14, 120, 24)
    valid = rng.random(120) < 0.4
    inc = _check(g, (g * valid[:, None]).sum(axis=0), 16, 0.2, "valid mask",
                 valid=valid)
    assert valid[inc[0].numpy()[inc[2].numpy()]].all()


def test_omp_parity_absolute_scores():
    g = _pool(15, 140, 20)
    _check(g, -(g[:40].sum(axis=0)), 12, 0.1, "absolute", positive=False)


def test_omp_parity_eps_stop():
    g = _pool(16, 50, 40)
    inc = _check(g, g[7] * 2.0 + g[31] * 1.0, 10, 1e-8, "eps stop",
                 eps=1e-6)
    assert int(inc[2].sum()) == 2


@pytest.mark.parametrize("method", ["incremental", "dense"])
def test_last_candidate_selectable_late_round(method):
    """Candidate n-1 is the best pick in round 2 (the reference's
    scatter-sentinel regression)."""
    n, d = 33, 6
    rng = np.random.default_rng(99)
    g = 0.01 * rng.standard_normal((n, d)).astype(np.float32)
    g[0, 0] = 10.0
    g[n - 1] = 0.0
    g[n - 1, 1] = 1.0
    target = np.zeros((d,), np.float32)
    target[0], target[1] = 20.0, 3.0
    idx, _, mask, _ = tomp.omp_select(_t(g), _t(target), k=4, lam=1e-6,
                                      method=method)
    sel = idx.numpy()[mask.numpy()].tolist()
    assert n - 1 in sel and sel[0] == 0 and len(sel) == len(set(sel))


def test_omp_rejects_unknown_method():
    with pytest.raises(ValueError):
        tomp.omp_select(torch.ones((4, 2)), torch.ones(2), k=1,
                        method="lazy")


@pytest.mark.parametrize("k,sizes", [(10, [5, 5, 5]), (7, [1, 10, 3]),
                                     (100, [4, 6]), (3, [0, 2, 9]),
                                     (11, [3, 3, 3, 3])])
def test_split_budget_matches_jax(k, sizes):
    got = tomp.split_budget(k, sizes)
    np.testing.assert_array_equal(got, jomp.split_budget(k, sizes))
    assert got.sum() == min(k, sum(sizes)) and (got <= sizes).all()


def test_split_budget_rejects_bad_sizes():
    for bad in ([], [[1, 2]], [3, -1]):
        with pytest.raises(ValueError):
            tomp.split_budget(3, bad)


def _labels(seed, n, c):
    return np.random.default_rng(seed).integers(0, c, n).astype(np.int32)


@pytest.mark.parametrize("quotas", [None, [3, 7, 0, 5]])
def test_omp_select_per_class_matches_jax(quotas):
    g = _pool(20, 160, 12)
    y = _labels(20, 160, 4)
    onehot = np.eye(4, dtype=np.float32)[y]
    targets = onehot.T @ g
    want = jomp.omp_select_per_class(jnp.asarray(g), jnp.asarray(y),
                                     jnp.asarray(targets), 4, 6, lam=0.5,
                                     quotas=quotas)
    got = tomp.omp_select_per_class(_t(g), _t(y).long(), _t(targets), 4, 6,
                                    lam=0.5, quotas=quotas)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-5)
    err_j = jomp.matching_error(jnp.asarray(g), jnp.asarray(targets.sum(0)),
                                *want, lam=0.5)
    err_t = tomp.matching_error(_t(g), _t(targets.sum(0)), *got, lam=0.5)
    np.testing.assert_allclose(float(err_t), float(err_j), rtol=1e-4,
                               atol=1e-5)


def _sel_parity(a, b, what):
    _assert_parity((a.indices, a.weights, a.mask, a.err),
                   (b.indices, b.weights, b.mask, b.err), what)


def test_gradmatch_matches_jax():
    g = _pool(21, 150, 20)
    valid = np.random.default_rng(21).random(150) < 0.6
    _sel_parity(tgm.gradmatch(_t(g), 12, lam=0.5),
                jgm.gradmatch(jnp.asarray(g), 12, lam=0.5), "gradmatch")
    _sel_parity(tgm.gradmatch(_t(g), 12, lam=0.5, valid=_t(valid)),
                jgm.gradmatch(jnp.asarray(g), 12, lam=0.5,
                              valid=jnp.asarray(valid)), "gradmatch valid")


def test_gradmatch_per_class_matches_jax():
    g = _pool(22, 300, 17)
    y = _labels(22, 300, 5)
    y[:4] = 7                               # out of range: not candidates
    got = tgm.gradmatch_per_class(_t(g), _t(y).long(), 5, 31)
    want = jgm.gradmatch_per_class(jnp.asarray(g), jnp.asarray(y), 5, 31)
    _sel_parity(got, want, "gradmatch_per_class")
    assert int(got.mask.sum()) == 31


def test_gradmatch_pb_matches_jax():
    g = _pool(23, 330, 10)                  # ragged: 330 = 20 * 16 + 10
    got = tgm.gradmatch_pb(_t(g), 16, 6)
    want = jgm.gradmatch_pb(jnp.asarray(g), 16, 6)
    _sel_parity(got, want, "gradmatch_pb")
    ex_t = tgm.expand_batch_selection(got, 16, 330)
    ex_j = jgm.expand_batch_selection(want, 16, 330)
    _sel_parity(ex_t, ex_j, "expand_batch_selection")
    np.testing.assert_allclose(float(ex_t.weights.sum()), 1.0, rtol=1e-6)
