"""The port's greedy engine, CRAIG and GLISTER against the JAX package, on
the CPU (the cases of ``tests/test_greedy_parity.py``).

Same numpy inputs into both packages.  Indices, masks and ``GreedyStats``
must be equal; gains, ``cover``, weights and ``err`` agree to rtol 1e-5 /
atol 1e-5.

The pools are standard normal draws rounded to multiples of 1/8.  Every
dot product and squared norm of such rows is exact in f32, so both
packages build bit-identical distances.  With unrounded draws the two
BLAS libraries round ``|g_i|^2 + |g_j|^2 - 2 g_i.g_j`` differently; on the
diagonal that is a few 1e-6 either side of 0, which the sqrt turns into
~1e-3 of similarity in one package and 0 in the other, and genuine
near-ties of the greedy then break differently.  That noise is the
reference's formula, not the engine under test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import craig as jcraig  # noqa: E402
from repro.core import glister as jglister  # noqa: E402
from repro.core import greedy as jg  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro_torch.core import craig as tcraig  # noqa: E402
from repro_torch.core import glister as tglister  # noqa: E402
from repro_torch.core import greedy as tg  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402

RTOL = ATOL = 1e-5


def _pool(seed, n, d):
    rng = np.random.default_rng(seed)
    return (np.round(rng.standard_normal((n, d)) * 8) / 8).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_same(port, ref, what, stats=True):
    """A port GreedyResult against a JAX one."""
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(ref.indices),
                                  err_msg=f"{what}: indices differ")
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask),
                                  err_msg=f"{what}: masks differ")
    np.testing.assert_allclose(port.gains.numpy(), np.asarray(ref.gains),
                               rtol=RTOL, atol=ATOL,
                               err_msg=f"{what}: gains differ")
    np.testing.assert_allclose(port.cover.numpy(), np.asarray(ref.cover),
                               rtol=RTOL, atol=ATOL,
                               err_msg=f"{what}: cover differs")
    if stats:
        assert port.stats == tg.GreedyStats(**vars(ref.stats)), what


def _assert_sel(port, ref, what):
    """A port SelectionResult against a JAX one."""
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(ref.indices),
                                  err_msg=f"{what}: indices differ")
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask),
                                  err_msg=f"{what}: masks differ")
    np.testing.assert_allclose(port.weights.numpy(),
                               np.asarray(ref.weights), rtol=RTOL,
                               atol=ATOL, err_msg=f"{what}: weights differ")
    np.testing.assert_allclose(float(port.err), float(ref.err), rtol=RTOL,
                               atol=ATOL, err_msg=f"{what}: err differs")


def _both(g, k, valid=None, **kw):
    """(port, JAX) fl_greedy on the same inputs."""
    port = tg.fl_greedy(_t(g), k, valid=_t(valid), **kw)
    ref = jg.fl_greedy(_j(g), k, valid=_j(valid), **kw)
    return port, ref


GRID = [
    # (seed, n, d, k, B): B crossing and not crossing n, k near and past n
    (0, 96, 12, 16, 8),
    (1, 160, 24, 40, 16),
    (2, 200, 8, 24, 64),
    (3, 64, 16, 96, 32),     # k > n: the exhausted-pool tail must agree
    (4, 50, 6, 50, 4),       # k == n, tiny refresh block
]


@pytest.mark.parametrize("seed,n,d,k,B", GRID)
@pytest.mark.parametrize("tier", ["dense", "lazy", "lazy-otf"])
def test_fl_greedy_matches_jax(seed, n, d, k, B, tier):
    """Each tier against the same tier of the JAX package (stats equal),
    and every tier index-identical to the JAX dense oracle; the on-the-fly
    tier under the shared ``default_l_max`` offset."""
    g = _pool(seed, n, d)
    kw = dict(block=B)
    if tier == "lazy-otf":
        lm = float(jg.default_l_max(_j(g)))
        assert float(tg.default_l_max(_t(g))) == lm
        kw.update(l_max=lm, on_the_fly=True)
    method = "dense" if tier == "dense" else "lazy"
    port, ref = _both(g, k, method=method, **kw)
    _assert_same(port, ref, f"{tier} {(n, d, k, B)}")
    oracle = jg.fl_greedy(_j(g), k, method="dense",
                          l_max=kw.get("l_max"))
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(oracle.indices))


def test_lazy_duplicate_rows_match_jax():
    """Exactly tied gains: lowest-index tie-breaking must agree."""
    rng = np.random.default_rng(10)
    g = (np.round(rng.standard_normal((80, 12)) * 8) / 8).astype(np.float32)
    g[1::2] = g[::2]                       # every row duplicated
    for B in (4, 16, 80):
        port, ref = _both(g, 24, method="lazy", block=B)
        _assert_same(port, ref, f"duplicates B={B}")
        sel = port.indices.numpy()[port.mask.numpy()]
        assert len(sel) == len(set(sel.tolist()))
    port, ref = _both(g, 24, method="dense")
    _assert_same(port, ref, "duplicates dense")


def test_lazy_all_equal_similarity():
    """Identical rows: every gain ties every round, certification never
    fires and the rescans pick 0, 1, 2, ..."""
    rng = np.random.default_rng(11)
    g = np.tile(rng.standard_normal((1, 8)).astype(np.float32), (50, 1))
    port, ref = _both(g, 10, method="lazy", block=4)
    _assert_same(port, ref, "all-equal similarity")
    np.testing.assert_array_equal(port.indices.numpy(), np.arange(10))
    assert port.stats.certified_rounds == 0


def test_lazy_masked_pool():
    rng = np.random.default_rng(12)
    g = _pool(12, 120, 16)
    valid = rng.random(120) < 0.4
    for method in ("dense", "lazy"):
        port, ref = _both(g, 20, valid=valid, method=method, block=16)
        _assert_same(port, ref, f"masked pool {method}")
        sel = port.indices.numpy()[port.mask.numpy()]
        assert valid[sel].all()


def test_k_exceeds_valid_pool_masks_tail():
    """k >= #valid: every tier stops growing instead of duplicating."""
    g = _pool(13, 40, 8)
    valid = np.arange(40) < 7
    for method in ("dense", "lazy", "stochastic"):
        port, ref = _both(g, 16, valid=valid, method=method, block=8)
        assert int(port.mask.sum()) == 7, method
        sel = port.indices.numpy()[port.mask.numpy()]
        assert len(sel) == len(set(sel.tolist()))
        assert (port.indices.numpy()[~port.mask.numpy()] == -1).all()
        if method != "stochastic":
            _assert_same(port, ref, f"k > #valid {method}")


@pytest.mark.parametrize("seed,n,d,k,B", GRID[:3])
def test_accepted_gains_nonincreasing(seed, n, d, k, B):
    """Submodularity certificate: accepted gains never increase."""
    g = _t(_pool(seed, n, d))
    for method in ("dense", "lazy"):
        res = tg.fl_greedy(g, k, method=method, block=B)
        gains = res.gains.numpy()[res.mask.numpy()]
        assert (np.diff(gains) <= 1e-4 * (1 + np.abs(gains[:-1]))).all(), \
            (method, gains)


def test_lazy_certification_counts_match_jax():
    """The certification accounting (the engine's performance claim)
    equals the reference's on an i.i.d. pool, and most rounds certify."""
    g = _pool(21, 512, 32)
    port, ref = _both(g, 128, method="lazy", block=32)
    _assert_same(port, ref, "certification pool")
    s = port.stats
    assert s.rounds == 128
    assert s.certified_rounds >= 0.8 * (s.rounds - 1), s
    assert s.rescans <= 0.2 * s.rounds + 1, s


def test_lazy_wide_escalation_and_max_tries_zero():
    """max_tries=0 sends every round to the wide block, then the rescan;
    the stats still match the reference's."""
    g = _pool(23, 300, 10)
    for otf in (False, True):
        lm = float(jg.default_l_max(_j(g)))
        port, ref = _both(g, 30, method="lazy", block=4, max_tries=0,
                          l_max=lm, on_the_fly=otf)
        _assert_same(port, ref, f"max_tries=0 otf={otf}")
        assert port.stats.block_evals == 0


def test_stochastic_seeded_determinism_and_full_sample():
    """The stochastic tier cannot share JAX's random stream; it is held to
    the reference's own properties: a seed fixes the picks, picks never
    repeat, and a sample covering the pool is the dense greedy."""
    g = _t(_pool(14, 200, 16))

    def run(seed, sample):
        gen = torch.Generator().manual_seed(seed)
        return tg.fl_greedy(g, 24, method="stochastic", generator=gen,
                            sample=sample)

    a, b, c = run(5, 16), run(5, 16), run(6, 16)
    np.testing.assert_array_equal(a.indices.numpy(), b.indices.numpy())
    for res in (a, c):
        sel = res.indices.numpy()[res.mask.numpy()]
        assert len(sel) == len(set(sel.tolist())) == 24
    # the default generator is seeded 0
    np.testing.assert_array_equal(
        tg.fl_greedy(g, 24, method="stochastic", sample=16).indices.numpy(),
        run(0, 16).indices.numpy())
    full = run(5, 200)
    dense = jg.fl_greedy(_j(g.numpy()), 24, method="dense")
    np.testing.assert_array_equal(full.indices.numpy(),
                                  np.asarray(dense.indices))
    np.testing.assert_allclose(full.cover.numpy(), np.asarray(dense.cover),
                               rtol=RTOL, atol=ATOL)


def test_stochastic_otf_full_sample_is_dense():
    g = _pool(24, 90, 7)
    lm = float(jg.default_l_max(_j(g)))
    res = tg.fl_greedy(_t(g), 12, method="stochastic", sample=90, l_max=lm,
                       on_the_fly=True,
                       generator=torch.Generator().manual_seed(1))
    dense = jg.fl_greedy(_j(g), 12, method="dense", l_max=lm)
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(dense.indices))


def test_taken_mask_sentinel_and_last_row():
    """Unused slots go to the out-of-bounds sentinel; a genuine pick of row
    n - 1 is kept."""
    idx = torch.tensor([4, 0, -1, 2], dtype=torch.int32)
    mask = torch.tensor([True, True, False, False])
    got = tg.taken_mask(idx, mask, 5)
    want = jg.taken_mask(_j(idx.numpy()), _j(mask.numpy()), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [True, False, False, False, True]


# ---------------------------------------------------------------------------
# CRAIG / GLISTER on top of the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["dense", "lazy"])
def test_craig_full_result_matches_jax(method):
    """Indices, cluster-size weights and the facility-location deficit."""
    g = _pool(16, 150, 20)
    port = tcraig.craig(_t(g), 30, method=method)
    _assert_sel(port, jcraig.craig(_j(g), 30, method=method),
                f"craig {method}")
    _assert_sel(port, jcraig.craig(_j(g), 30, method="dense"),
                f"craig {method} vs JAX dense")


def test_craig_objective_excludes_invalid_rows():
    """Zeroed-out rows demand no coverage: the deficit over a masked pool
    equals that of the pool of valid rows alone."""
    g = _pool(17, 60, 8)
    valid = np.arange(60) < 40
    sel = tcraig.craig(_t(g), 10, valid=_t(valid), l_max=10.0)
    _assert_sel(sel, jcraig.craig(_j(g), 10, valid=_j(valid), l_max=10.0),
                "craig masked")
    sel_sub = tcraig.craig(_t(g[:40]), 10, l_max=10.0)
    np.testing.assert_allclose(float(sel.err), float(sel_sub.err),
                               rtol=1e-4)


def test_pairwise_sim_matches_jax_and_offsets_consistently():
    g = _pool(18, 30, 6)
    base = tcraig.pairwise_sim(_t(g))
    # The squared distances are exact; XLA's CPU sqrt can differ by an ulp.
    np.testing.assert_allclose(base.numpy(),
                               np.asarray(jcraig.pairwise_sim(_j(g))),
                               rtol=1e-6, atol=1e-6)
    shifted = tcraig.pairwise_sim(_t(g), l_max=7.5)
    dist = base.max() - base
    np.testing.assert_allclose(shifted.numpy(), (7.5 - dist).numpy(),
                               rtol=1e-5, atol=1e-5)
    # dist_fn: the sqdist dispatch builds the same matrix
    from repro_torch.kernels import ops
    np.testing.assert_allclose(
        tg.build_sim(_t(g), l_max=7.5, dist_fn=ops.sqdist).numpy(),
        shifted.numpy(), rtol=1e-6, atol=1e-6)


def test_resolve_fl_scan_cutover_and_errors():
    assert tg._OTF_AUTO_BYTES == jg._OTF_AUTO_BYTES
    for n in (8192, 11585, 11586, 45000):
        assert tg.auto_on_the_fly(n) == jg.auto_on_the_fly(n)
    g = _t(_pool(25, 20, 4))
    with pytest.raises(ValueError):
        tg.resolve_fl_scan(g, None, "dense", on_the_fly=True)
    with pytest.raises(ValueError):
        tg.resolve_fl_scan(None, None, "lazy")
    with pytest.raises(ValueError):
        tg.resolve_fl_scan(None, torch.zeros((20, 20)), "lazy",
                           on_the_fly=True)
    with pytest.raises(ValueError):
        tg.fl_greedy(g, 3, method="nope")


def test_craig_otf_never_needs_resident_sim(monkeypatch):
    """on_the_fly=True runs from grads alone and matches the dense oracle
    under the same offset."""
    g = _pool(19, 180, 24)
    lm = float(jg.default_l_max(_j(g)))

    def no_sim(*a, **k):
        raise AssertionError("the on-the-fly path built a resident sim")

    dense = jcraig.craig(_j(g), 20, method="dense", l_max=lm)
    monkeypatch.setattr(tg, "pairwise_sim", no_sim)
    monkeypatch.setattr(tg, "build_sim", no_sim)
    port = tcraig.craig(_t(g), 20, method="lazy", l_max=lm, on_the_fly=True)
    _assert_sel(port, jcraig.craig(_j(g), 20, method="lazy", l_max=lm,
                                   on_the_fly=True), "craig otf")
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(dense.indices))
    np.testing.assert_allclose(port.weights.numpy(),
                               np.asarray(dense.weights), rtol=1e-4,
                               atol=1e-5)


def test_craig_pb_matches_jax():
    g = _pool(26, 640, 10)
    port = tcraig.craig_pb(_t(g), 32, 6)
    _assert_sel(port, jcraig.craig_pb(_j(g), 32, 6), "craig_pb")
    assert port.indices.shape == (6,)


def test_glister_matches_jax_and_semantics():
    """Uniform weights, no duplicates, the first pick is the plain argmax
    of g @ v, and the picks equal the reference's."""
    g = _pool(20, 64, 12)
    tgt = g.sum(0)
    port = tglister.glister(_t(g), _t(tgt), 8)
    _assert_sel(port, jglister.glister(_j(g), _j(tgt), 8), "glister")
    idx = port.indices.numpy()[port.mask.numpy()]
    assert len(idx) == len(set(idx.tolist())) == 8
    assert idx[0] == int(np.argmax(g @ tgt))
    np.testing.assert_allclose(port.weights.numpy(), np.full(8, 1 / 8),
                               rtol=1e-5)


def test_glister_k_exceeds_valid_pool():
    g = _pool(22, 20, 6)
    valid = np.arange(20) < 5
    port = tglister.glister(_t(g), _t(g.sum(0)), 12, valid=_t(valid))
    _assert_sel(port, jglister.glister(_j(g), _j(g.sum(0)), 12,
                                       valid=_j(valid)), "glister k>#valid")
    assert int(port.mask.sum()) == 5
    assert valid[port.indices.numpy()[port.mask.numpy()]].all()


@pytest.mark.parametrize("strategy", ["craig", "craig-lazy",
                                      "craig-lazy-otf", "craig-pb",
                                      "glister"])
def test_select_strategies_match_jax(strategy):
    """``select()`` dispatches each new strategy as the reference does."""
    g = _pool(27, 256, 10)
    port = tsel.select(strategy, None, _t(g), 32, batch_size=8)
    ref = jsel.select(strategy, jax.random.PRNGKey(0), _j(g), 32,
                      batch_size=8)
    _assert_sel(port, ref, strategy)


def test_select_craig_stochastic_draws_from_the_generator():
    g = _t(_pool(28, 256, 10))

    def pick(gen):
        return tsel.select("craig-stochastic", gen, g, 32).indices

    a = pick(torch.Generator().manual_seed(3))
    assert torch.equal(a, pick(torch.Generator().manual_seed(3)))
    assert torch.equal(pick(None), pick(torch.Generator().manual_seed(0)))
    sel = tsel.select("craig-stochastic", None, g, 32)
    assert bool(sel.mask.all()) and len(set(sel.indices.tolist())) == 32
    np.testing.assert_allclose(float(sel.weights.sum()), 1.0, rtol=1e-5)
