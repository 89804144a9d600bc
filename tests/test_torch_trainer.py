"""The port's trainer (the paper's Algorithm 1) on the CPU: its first
selection round against the JAX trainer's, from the same numpy dataset and
converted parameters; GRAD-MATCHPB learning end to end; the strategy
dispatch and schedule checks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper import PaperHParams as JHP  # noqa: E402
from repro.configs.paper import mlp as jmlp  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models.classifier import init_classifier  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs.paper import PaperHParams, mlp  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core.random_sel import random_select  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.loader import SubsetLoader  # noqa: E402
from repro_torch.models.classifier import params_from_jax  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402


@pytest.fixture(scope="module")
def numpy_data():
    ds = jsyn.make_classification(jax.random.PRNGKey(0), n=1024, dim=24,
                                  num_classes=8, sep=5.0)
    train, val = jsyn.split(ds, jax.random.PRNGKey(1))
    return tuple((np.array(d.x), np.array(d.y)) for d in (train, val))


def _cfg(mod, hp, **kw):
    kw.setdefault("budget", 0.25)
    kw.setdefault("epochs", 12)
    kw.setdefault("batch_size", 32)
    kw.setdefault("hp", hp(select_every=4))
    return mod.TrainerConfig(**kw)


@pytest.mark.parametrize("strategy", ["gradmatch", "gradmatch-pb",
                                      "craig-pb", "glister"])
def test_first_selection_round_matches_jax(numpy_data, strategy):
    (xt, yt), (xv, yv) = numpy_data
    params = jax.tree_util.tree_map(
        np.asarray, init_classifier(jmlp(in_dim=24, num_classes=8),
                                    jax.random.PRNGKey(3)))
    jt = jtrainer.AdaptiveTrainer(
        jmlp(in_dim=24, num_classes=8), _cfg(jtrainer, JHP, strategy=strategy),
        jsyn.Dataset(jnp.asarray(xt), jnp.asarray(yt), 8),
        jsyn.Dataset(jnp.asarray(xv), jnp.asarray(yv), 8))
    want, _ = jt._run_selection(params, jax.random.PRNGKey(5))
    tt = ttrainer.AdaptiveTrainer(
        mlp(in_dim=24, num_classes=8),
        _cfg(ttrainer, PaperHParams, strategy=strategy),
        tsyn.Dataset(torch.from_numpy(xt), torch.from_numpy(yt).long(), 8),
        tsyn.Dataset(torch.from_numpy(xv), torch.from_numpy(yv).long(), 8),
        device="cpu")
    got, _ = tt._run_selection(
        params_from_jax(mlp(in_dim=24, num_classes=8), params, "cpu"),
        None)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.err), float(want.err), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("strategy", ["craig-lazy", "craig-lazy-otf"])
def test_first_craig_round_matches_jax_on_exact_proxies(numpy_data,
                                                         strategy,
                                                         monkeypatch):
    """The CRAIG tiers' first selection round against the JAX trainer's.

    Both trainers get the same proxies: the JAX model's, rounded to
    multiples of 1/64, so every distance CRAIG builds from them is exact
    in f32 in both packages.  From the models' own proxies (equal to a few
    ulps) the two packages' ``|g_i|^2 + |g_j|^2 - 2 g_i.g_j`` differ by up
    to ~4e-3 of similarity on the diagonal after the sqrt, which moves
    near-tied picks; ``tests/test_torch_greedy.py`` holds the engine on
    exact inputs and ``tests/test_torch_model.py`` the proxies.  The two
    proxies differ, so a wrong proxy choice (per-gradient for
    ``craig-lazy``, bias for ``craig-lazy-otf``) changes the picks.
    """
    (xt, yt), (xv, yv) = numpy_data
    cfg = jmlp(in_dim=24, num_classes=8)
    params = jax.tree_util.tree_map(
        np.asarray, init_classifier(cfg, jax.random.PRNGKey(3)))
    jt = jtrainer.AdaptiveTrainer(
        cfg, _cfg(jtrainer, JHP, strategy=strategy),
        jsyn.Dataset(jnp.asarray(xt), jnp.asarray(yt), 8),
        jsyn.Dataset(jnp.asarray(xv), jnp.asarray(yv), 8))
    pcg, bias = (np.round(np.asarray(p) * 64).astype(np.float32) / 64
                 for p in jt.proxy_fn(params, jnp.asarray(xt),
                                      jnp.asarray(yt)))
    jt.proxy_fn = lambda *_: (jnp.asarray(pcg), jnp.asarray(bias))
    want, _ = jt._run_selection(params, jax.random.PRNGKey(5))
    monkeypatch.setattr(
        ttrainer.steps_lib, "make_proxy_fn",
        lambda model: lambda x, y: (torch.from_numpy(pcg),
                                    torch.from_numpy(bias)))
    tt = ttrainer.AdaptiveTrainer(
        mlp(in_dim=24, num_classes=8),
        _cfg(ttrainer, PaperHParams, strategy=strategy),
        tsyn.Dataset(torch.from_numpy(xt), torch.from_numpy(yt).long(), 8),
        tsyn.Dataset(torch.from_numpy(xv), torch.from_numpy(yv).long(), 8),
        device="cpu")
    got, _ = tt._run_selection(tt.init_model(), None)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.err), float(want.err), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("strategy", ["craig-lazy", "glister"])
def test_craig_and_glister_train_on_cpu(strategy):
    """The new strategies through ``run()``: two selection rounds, a
    subset of the budget, learning above chance."""
    ds = tsyn.make_classification(n=1024, dim=24, num_classes=8, sep=5.0,
                                  device="cpu")
    train, val = tsyn.split(ds)
    rep = ttrainer.AdaptiveTrainer(
        mlp(in_dim=24, num_classes=8),
        _cfg(ttrainer, PaperHParams, strategy=strategy, epochs=8), train,
        val, device="cpu").run()
    assert rep.selection_rounds == 2
    assert rep.subset_size == int(train.n * 0.25)
    assert rep.final_acc > 0.25


def test_gradmatch_pb_learns_on_cpu():
    ds = tsyn.make_classification(n=1024, dim=24, num_classes=8, sep=5.0,
                                  device="cpu")
    train, val = tsyn.split(ds)
    rep = ttrainer.AdaptiveTrainer(
        mlp(in_dim=24, num_classes=8),
        _cfg(ttrainer, PaperHParams, strategy="gradmatch-pb"), train, val,
        device="cpu").run()
    assert rep.final_acc > 0.3          # well above 1/8 chance
    assert rep.selection_rounds == 3
    assert rep.subset_size <= int(train.n * 0.25) + 32
    # work: 3 proxy passes over the pool + 3 units per trained example
    assert rep.work_units == 3 * train.n + 3.0 * 12 * (
        rep.subset_size // 32) * 32


@pytest.mark.parametrize("kw,min_acc", [
    (dict(strategy="gradmatch-pb", warm_start=True, epochs=16), 0.25),
    (dict(strategy="gradmatch", is_valid=True), 0.25),
    (dict(strategy="gradmatch", per_class=False, epochs=8), 0.25),
    (dict(strategy="full", early_stop_frac=0.5), 0.25),
    (dict(strategy="random", epochs=8), 0.25)])
def test_trainer_variants_run_on_cpu(kw, min_acc):
    """The -WARM, isValid, pooled, FULL-EARLYSTOP and RANDOM schedules of
    the reference trainer (``tests/test_trainer.py``'s sizes)."""
    ds = tsyn.make_classification(n=1024, dim=24, num_classes=8, sep=5.0,
                                  device="cpu")
    train, val = tsyn.split(ds)
    rep = ttrainer.AdaptiveTrainer(
        mlp(in_dim=24, num_classes=8), _cfg(ttrainer, PaperHParams, **kw),
        train, val, device="cpu").run()
    assert rep.final_acc > min_acc
    if kw.get("warm_start"):
        assert rep.strategy.endswith("-warm")
    if kw["strategy"] == "full":
        assert rep.selection_rounds == 0 and rep.subset_size == train.n
        assert rep.work_units == 3.0 * 6 * (train.n // 32) * 32


def _check_result(sel, n, k):
    idx, w, mask = sel.indices, sel.weights, sel.mask
    assert idx.shape == w.shape == mask.shape == (k,)
    assert idx.dtype == torch.int32 and mask.dtype == torch.bool
    assert bool(mask.all())
    assert len(set(idx.tolist())) == k
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    np.testing.assert_allclose(float(w.sum()), 1.0, rtol=1e-5)
    assert float(sel.err) == 0.0


def test_random_and_full_invariants():
    proxies = torch.randn((200, 7), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    _check_result(tsel.select("random", gen, proxies, 30), 200, 30)
    full = tsel.select("full", None, proxies, 30)
    _check_result(full, 200, 200)
    assert full.indices.tolist() == list(range(200))
    valid = torch.arange(200) % 3 == 0
    sel = random_select(torch.Generator().manual_seed(2), 200, 20, valid)
    _check_result(sel, 200, 20)
    assert bool(valid[sel.indices.long()].all())


def test_strategies_not_ported_raise():
    proxies = torch.zeros((10, 2))
    for name in jsel.STRATEGIES:
        if name in tsel.STRATEGIES:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsel.select(name, None, proxies, 3)
    with pytest.raises(ValueError):
        tsel.select("nope", None, proxies, 3)
    ds = tsyn.make_classification(n=64, dim=4, num_classes=2, device="cpu")
    for kw in ({"strategy": "gradmatch-stream"},
               {"checkpoint_dir": "/nonexistent"}):
        with pytest.raises(NotImplementedError):
            ttrainer.AdaptiveTrainer(mlp(in_dim=4, num_classes=2),
                                     ttrainer.TrainerConfig(**kw), ds, ds,
                                     device="cpu")


@pytest.mark.parametrize("total,frac,kappa", [(60, 0.1, 0.5), (20, 0.3, 1.0),
                                              (7, 0.05, 0.5)])
def test_warm_start_epochs_match_jax(total, frac, kappa):
    assert tsel.warm_start_epochs(total, frac, kappa) == \
        jsel.warm_start_epochs(total, frac, kappa)


def test_schedule_validation():
    for bad in (dict(total_epochs=0, budget_frac=0.1),
                dict(total_epochs=10, budget_frac=1.0),
                dict(total_epochs=10, budget_frac=0.1, kappa=0.0)):
        with pytest.raises(ValueError):
            tsel.warm_start_epochs(**bad)
    for bad in (dict(select_every=0), dict(warm_epochs=-1),
                dict(warm_epochs=5, total_epochs=5)):
        with pytest.raises(ValueError):
            tsel.SelectionSchedule(**bad)
    s = tsel.SelectionSchedule(select_every=3, warm_epochs=2)
    assert [e for e in range(10) if s.is_selection_epoch(e)] == [2, 5, 8]


def test_synthetic_data_and_split():
    ds = tsyn.make_classification(n=500, dim=6, num_classes=4, device="cpu")
    assert ds.x.shape == (500, 6) and ds.x.dtype == torch.float32
    assert ds.y.dtype == torch.int64 and set(ds.y.tolist()) == {0, 1, 2, 3}
    again = tsyn.make_classification(n=500, dim=6, num_classes=4,
                                      device="cpu")
    assert torch.equal(ds.x, again.x)             # seeded
    train, val = tsyn.split(ds)
    assert (train.n, val.n) == (450, 50)
    rows = {tuple(r) for r in train.x.tolist()} | {
        tuple(r) for r in val.x.tolist()}
    assert len(rows) == 500                       # a partition of the rows
    imb, clean = tsyn.make_imbalanced(n=2000, dim=6, num_classes=10,
                                      device="cpu")
    counts = torch.bincount(imb.y, minlength=10)
    assert int(counts[:3].max()) < int(counts[3:].min()) // 3
    assert clean.n == 200


def test_subset_loader_batches():
    x = torch.arange(40, dtype=torch.float32)[:, None]
    y = torch.arange(40)
    loader = SubsetLoader(x, y, batch_size=4, seed=0)
    assert loader.subset_size == 40 and loader.steps_per_epoch() == 10
    idx = torch.tensor([5, -1, 7, 9, 11, 2, 30], dtype=torch.int32)
    w = torch.tensor([0.1, 0.5, 0.2, 0.3, 0.0, 0.4, 0.6])
    mask = torch.tensor([True, True, True, True, True, True, False])
    loader.set_selection(idx, w, mask)
    assert loader.subset_size == 5               # -1 and off-mask dropped
    seen = []
    for _ in range(3):
        for batch in loader.epoch_batches():
            assert batch["x"].shape == (4, 1)
            np.testing.assert_allclose(float(batch["weights"].sum()), 1.0,
                                       rtol=1e-6)
            assert torch.equal(batch["x"][:, 0].long(), batch["y"])
            seen += batch["y"].tolist()
    assert set(seen) <= {5, 7, 9, 11, 2}
