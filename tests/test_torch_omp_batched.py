"""The port's batched OMP against the JAX package's and against the port's
single solves, on the CPU, and per-class GRAD-MATCH on the batched engine.

Same numpy inputs into both packages.  The standard is ``_assert_parity``
of ``tests/test_omp_parity.py``: indices and masks equal, weights and
``err`` to rtol 1e-4 / atol 1e-5, because the batched solver runs the same
math as B single solves with batched reductions, which round in another
order (so does JAX against the port).  The cases are those of
``tests/test_serve.py``'s batched section plus ``absolute``, B = 1, a
(B, n) and an (n,) mask, and per-class selection with and without quotas.
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


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_parity(got, want, what):
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]),
                                  err_msg=f"{what}: indices differ")
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]),
                                  err_msg=f"{what}: masks differ")
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: weights differ")
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: err differs")


def _targets(g):
    n = g.shape[0]
    return np.stack([g.sum(axis=0), g[: n // 2].sum(axis=0),
                     g[3] * 2.0 + g[7], g[::3].sum(axis=0)])


def _check_rows(g, targets, k, valid=None, **kw):
    """Port batched vs JAX batched, and each row vs the port's single
    solve of that target."""
    tv = None if valid is None else torch.from_numpy(valid)
    jv = None if valid is None else jnp.asarray(valid)
    got = tomp.omp_select_batched(torch.from_numpy(g),
                                  torch.from_numpy(targets), k=k, valid=tv,
                                  **kw)
    assert got[0].shape == (targets.shape[0], k) and got[3].shape == (
        targets.shape[0],)
    want = jomp.omp_select_batched(jnp.asarray(g), jnp.asarray(targets),
                                   k=k, valid=jv, **kw)
    _assert_parity(got, want, "port vs JAX batched")
    for b in range(targets.shape[0]):
        vb = None if valid is None else (tv if tv.dim() == 1 else tv[b])
        one = tomp.omp_select(torch.from_numpy(g),
                              torch.from_numpy(targets[b]), k=k, valid=vb,
                              **kw)
        _assert_parity(tuple(x[b] for x in got), one, f"batch row {b}")
    return got


@pytest.mark.parametrize("seed,n,d,k", [(0, 96, 12, 16), (1, 160, 48, 24),
                                        (3, 64, 32, 96)])
def test_batched_matches_jax_and_single_solves(seed, n, d, k):
    g = _pool(seed, n, d)
    _check_rows(g, _targets(g), k, lam=0.3)


def test_batched_wide_regime_and_block_edges():
    """d = 200 and B = 2: the first blocks of 8 are wide (hi * B <= d),
    so the per-problem column cache and corr_batched's new columns run,
    then narrow."""
    g = _pool(2, 150, 200)
    targets = _targets(g)[:2]
    _check_rows(g, targets, 130, lam=0.3, block=8)


def test_batched_per_request_valid_masks():
    g = _pool(6, 120, 20)
    valids = np.random.default_rng(6).random((3, 120)) < 0.5
    targets = np.stack([(g * valids[b][:, None]).sum(axis=0)
                        for b in range(3)])
    idx, _, mask, _ = _check_rows(g, targets, 16, valid=valids, lam=0.2)
    for b in range(3):
        assert valids[b][_np(idx[b])[_np(mask[b])]].all()


def test_batched_shared_valid_mask():
    g = _pool(8, 100, 16)
    valid = np.random.default_rng(8).random(100) < 0.6
    _check_rows(g, _targets(g), 12, valid=valid, lam=0.2)


def test_batched_absolute_scores():
    g = _pool(15, 140, 20)
    targets = np.stack([-(g[:40].sum(axis=0)), g[50] - 2 * g[60]])
    _check_rows(g, targets, 12, lam=0.1, positive=False)


def test_batched_single_problem():
    g = _pool(4, 90, 10)
    _check_rows(g, g.sum(axis=0)[None], 30, lam=0.2)


def test_batched_dense_method():
    g = _pool(7, 80, 16)
    targets = np.stack([g.sum(axis=0), g[5] * 3.0])
    got = tomp.omp_select_batched(torch.from_numpy(g),
                                  torch.from_numpy(targets), k=12,
                                  method="dense")
    want = jomp.omp_select_batched(jnp.asarray(g), jnp.asarray(targets),
                                   k=12, method="dense")
    _assert_parity(got, want, "dense batched")
    for b in range(2):
        one = tomp.omp_select(torch.from_numpy(g),
                              torch.from_numpy(targets[b]), k=12,
                              method="dense")
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)          # the same loop of solves
    with pytest.raises(ValueError):
        tomp.omp_select_batched(torch.from_numpy(g),
                                torch.from_numpy(targets), k=2,
                                method="lazy")


def _labels(seed, n, c):
    return np.random.default_rng(seed).integers(0, c, n).astype(np.int32)


@pytest.mark.parametrize("quotas", [None, [9, 30, 0, 17, 4]])
@pytest.mark.parametrize("method", ["incremental", "dense"])
def test_per_class_on_the_batched_engine_matches_jax(quotas, method):
    """Five classes, 26 rounds each without quotas (past d = 14: wide,
    then narrow) or max(quotas) = 30, against JAX's vmapped per-class
    solve and the port's own single solves class by class."""
    g = _pool(30, 400, 14)
    y = _labels(30, 400, 5)
    y[:3] = 9                               # out of range: not candidates
    targets = (np.eye(5, dtype=np.float32)[np.clip(y, 0, 4)]
               * (y < 5)[:, None]).T @ g
    want = jomp.omp_select_per_class(jnp.asarray(g), jnp.asarray(y),
                                     jnp.asarray(targets), 5, 26, lam=0.5,
                                     quotas=quotas, method=method)
    got = tomp.omp_select_per_class(torch.from_numpy(g),
                                    torch.from_numpy(y).long(),
                                    torch.from_numpy(targets), 5, 26,
                                    lam=0.5, quotas=quotas, method=method)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=1e-4,
                               atol=1e-5)
    k = 26 if quotas is None else 30
    for c in range(5):
        idx, w, mask, _ = tomp.omp_select(
            torch.from_numpy(g), torch.from_numpy(targets[c]), k=k, lam=0.5,
            valid=torch.from_numpy(y == c), method=method)
        keep = slice(c * k, (c + 1) * k)
        if quotas is None:
            _assert_parity((got[0][keep], got[1][keep], got[2][keep], 0.0),
                           (idx, w, mask, 0.0), f"class {c}")
        else:
            live = torch.arange(k) < quotas[c]
            assert torch.equal(got[0][keep], torch.where(mask & live, idx,
                                                         -1))


def test_per_class_takes_the_single_regime(monkeypatch):
    """Per-class blocks take omp_select's regime (hi <= d): d = 14, k = 10,
    five classes.  The public batched rule (hi * B <= d) would score
    narrow; per-class scores wide, building a new column every round."""
    calls = []
    real = tomp.ops.corr_batched

    def counting(grads, vecs):
        calls.append(tuple(vecs.shape))
        return real(grads, vecs)

    monkeypatch.setattr(tomp.ops, "corr_batched", counting)
    g = _pool(31, 200, 14)
    y = _labels(31, 200, 5)
    targets = np.eye(5, dtype=np.float32)[y].T @ g
    tomp.omp_select_per_class(torch.from_numpy(g), torch.from_numpy(y),
                              torch.from_numpy(targets), 5, 10)
    assert calls == [(5, 14)] * 11           # c0, then one column a round
    calls.clear()
    tomp.omp_select_batched(torch.from_numpy(g), torch.from_numpy(targets),
                            k=10)
    assert calls == [(5, 14)]                # c0 only: narrow


def test_gradmatch_per_class_slice_matches_jax():
    """The slice as a whole: GRAD-MATCH per class with the budget split
    exactly, on one seeded pool, in both packages."""
    g = _pool(32, 600, 17)
    y = _labels(32, 600, 6)
    got = tgm.gradmatch_per_class(torch.from_numpy(g),
                                  torch.from_numpy(y).long(), 6, 57)
    want = jgm.gradmatch_per_class(jnp.asarray(g), jnp.asarray(y), 6, 57)
    _assert_parity((got.indices, got.weights, got.mask, got.err),
                   (want.indices, want.weights, want.mask, want.err),
                   "gradmatch_per_class")
    assert int(got.mask.sum()) == 57


@pytest.mark.parametrize("b", [1, 3])
def test_batched_leaves_the_callers_masks_alone(b):
    """The running availability mask is the solver's own copy: a (B, n)
    or (n,) ``valid`` (B = 1 makes its transpose contiguous, a view)
    comes back unchanged."""
    g = _pool(33, 60, 6)
    targets = _targets(g)[:b]
    for valid in (np.random.default_rng(33).random((b, 60)) < 0.7,
                  np.random.default_rng(34).random(60) < 0.7):
        tv = torch.from_numpy(valid.copy())
        tomp.omp_select_batched(torch.from_numpy(g),
                                torch.from_numpy(targets), k=8, valid=tv)
        np.testing.assert_array_equal(tv.numpy(), valid)
    y = _labels(33, 60, b)
    ty = torch.from_numpy(y.copy())
    tomp.omp_select_per_class(torch.from_numpy(g), ty,
                              torch.from_numpy(targets), b, 5)
    np.testing.assert_array_equal(ty.numpy(), y)
