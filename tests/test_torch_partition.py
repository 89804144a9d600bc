"""The port's partition-and-merge selection (``repro_torch/core/partition.py``)
against the JAX package's, on the CPU.

Same numpy inputs into both packages.  The standard is ``_assert_parity``
of ``tests/test_omp_parity.py``: indices and masks equal, weights and
``err`` to rtol 1e-4 / atol 1e-5.  Each test of ``tests/test_partition.py``
that touches ``partition``, ``select`` or ``split_budget`` has its mirror
here, with the port's result held against JAX's where JAX gives one, and
the reference's promises kept inside the port: P = 1 gives the single
solver's set, the class kind gives ``gradmatch_per_class``'s set, the
device-grouped path gives the default path's picks, the streaming
partitions give the in-memory contiguous ones bit for bit on indices and
masks.  Added: ``select()``'s rejection of ``partitions=``, and the
device-grouped solves on three (patched) local devices, where the groups
and the ragged tail show.  The pools are few and shared, so that JAX
compiles little.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper import PaperHParams as JHP  # noqa: E402
from repro.configs.paper import mlp as jmlp  # noqa: E402
from repro.core import craig as jcraig  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import gradmatch as jgm  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.core.omp import split_budget as j_split_budget  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models.classifier import init_classifier  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs.paper import PaperHParams, mlp  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import gradmatch as tgm  # noqa: E402
from repro_torch.core import omp as tomp  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.core.gradmatch import SelectionResult  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models.classifier import params_from_jax  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

CPU = "cpu"


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


def _selected(res):
    return _np(res.indices)[_np(res.mask)]


def _check_result(res, n):
    idx, w, m = _np(res.indices), _np(res.weights), _np(res.mask)
    assert np.all(w >= 0) and np.all(w[~m] == 0)
    if m.any():
        np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-5)
    assert np.all((idx[m] >= 0) & (idx[m] < n))
    assert np.all(idx[~m] == -1)
    sel = idx[m]
    assert len(np.unique(sel)) == len(sel), "duplicate selections"
    assert np.isfinite(float(res.err))


def _same_stats(got, want):
    assert got.num_parts == want.num_parts and got.kind == want.kind
    assert tuple(got.quotas) == tuple(want.quotas)
    assert (got.union_size, got.merged) == (want.union_size, want.merged)


# ---------------------------------------------------------------------------
# split_budget units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,k,want", [
    ([5, 3, 2], 7, [3, 2, 2]),      # remainder to the largest first
    ([10, 1, 1], 9, [7, 1, 1]),     # cap at size, surplus rebalanced
    ([2, 3], 99, [2, 3]),           # k beyond the pool: everything
    ([0, 4, 0], 3, [0, 3, 0]),      # empty partitions get nothing
    ([4, 4], 0, [0, 0]),            # zero budget
    ([3, 5], 8, [3, 5]),            # exact fill
    ([0, 0, 0], 5, [0, 0, 0]),      # every class empty
    ([5] * 7, 3, [1, 1, 1, 0, 0, 0, 0]),   # C > k: ties by class id
    ([1, 9, 1], 2, [1, 1, 0]),      # C > k: one each, largest first
])
def test_split_budget_cases(sizes, k, want):
    got = tpart.split_budget(k, np.asarray(sizes, np.int64))
    np.testing.assert_array_equal(got, np.asarray(want, np.int64))
    np.testing.assert_array_equal(
        got, j_split_budget(k, np.asarray(sizes, np.int64)))


def test_split_budget_rejects_bad_sizes():
    assert tpart.split_budget is tomp.split_budget
    for fn in (tpart.split_budget, j_split_budget):
        with pytest.raises(ValueError, match="non-empty"):
            fn(4, np.asarray([], np.int64))
        with pytest.raises(ValueError, match="negative"):
            fn(4, np.asarray([3, -1], np.int64))


def test_split_budget_starvation_sums_exactly():
    sizes = np.asarray([2, 7, 1, 7, 3], np.int64)
    q = tpart.split_budget(3, sizes)
    assert q.sum() == 3 and int((q == 0).sum()) == 2
    np.testing.assert_array_equal(q, [0, 1, 0, 1, 1])
    np.testing.assert_array_equal(q, j_split_budget(3, sizes))


def test_per_class_all_rows_invalid():
    g = _pool(9, 20, 8)
    labels = np.full(20, -1, np.int64)
    got = tgm.gradmatch_per_class(torch.from_numpy(g),
                                  torch.from_numpy(labels), 4, 6)
    want = jgm.gradmatch_per_class(jnp.asarray(g), jnp.asarray(labels), 4, 6)
    assert int(got.mask.sum()) == 0 == int(np.asarray(want.mask).sum())


@pytest.mark.parametrize("seed", range(5))
def test_split_budget_invariants_random(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 40, size=rng.integers(1, 9))
    k = int(rng.integers(0, 80))
    q = tpart.split_budget(k, sizes)
    np.testing.assert_array_equal(q, j_split_budget(k, sizes))
    assert q.sum() == min(k, sizes.sum())
    assert np.all(q <= sizes) and np.all(q >= 0)
    for i in range(len(sizes)):
        for j in range(len(sizes)):
            if sizes[i] > sizes[j] and q[i] < q[j]:
                assert q[i] == sizes[i], (sizes, k, q)


# ---------------------------------------------------------------------------
# per-class budget split
# ---------------------------------------------------------------------------

PER_CLASS_GRID = [
    # (seed, n, num_classes, k, label_fn); one pool width, so JAX compiles
    # one solver a (n, k) pair
    (0, 50, 4, 10, lambda n: np.arange(n) % 4),            # k % C != 0
    (1, 40, 3, 24, lambda n: np.repeat([0, 1, 2], [20, 3, 17])),  # tiny
    (2, 30, 3, 5, lambda n: np.zeros(n, np.int64)),        # one class
    (3, 18, 4, 50, lambda n: np.arange(n) % 4),            # k >= n
    (4, 44, 4, 13, lambda n: np.where(np.arange(n) % 11 == 0, -1,
                                      np.arange(n) % 4)),  # invalid labels
]


@pytest.mark.parametrize("seed,n,C,k,label_fn", PER_CLASS_GRID)
def test_per_class_budget_exact(seed, n, C, k, label_fn):
    g = _pool(seed, n, 8)
    labels = np.asarray(label_fn(n), np.int64)
    n_valid = int(((labels >= 0) & (labels < C)).sum())
    got = tgm.gradmatch_per_class(torch.from_numpy(g),
                                  torch.from_numpy(labels), C, k)
    want = jgm.gradmatch_per_class(jnp.asarray(g), jnp.asarray(labels), C, k)
    _assert_parity(got, want, "per-class port vs JAX")
    _check_result(got, n)
    sel = _selected(got)
    assert len(sel) == min(k, n_valid)
    sizes = np.bincount(labels[(labels >= 0) & (labels < C)], minlength=C)
    np.testing.assert_array_equal(np.bincount(labels[sel], minlength=C),
                                  tpart.split_budget(k, sizes))


def test_per_class_err_is_true_objective():
    g = _pool(7, 60, 8)
    labels = np.arange(60) % 3
    got = tgm.gradmatch_per_class(torch.from_numpy(g),
                                  torch.from_numpy(labels), 3, 12)
    # (err against JAX's: test_per_class_budget_exact)
    assert float(got.err) > 0.0 and int(got.mask.sum()) == 12
    target = torch.from_numpy(g).sum(dim=0)
    best = min(float(tomp.matching_error(
        torch.from_numpy(g), target, got.indices, got.weights * float(s),
        got.mask, lam=0.5)) for s in np.linspace(0.5, 3.0, 200))
    assert float(got.err) <= best + 1e-3


def test_select_dispatch_uses_fixed_split():
    g = _pool(9, 50, 8)
    labels = np.arange(50) % 4
    got = tsel.select("gradmatch", None, torch.from_numpy(g), 10,
                      labels=torch.from_numpy(labels), num_classes=4)
    want = jsel.select("gradmatch", jax.random.PRNGKey(0), jnp.asarray(g),
                       10, labels=jnp.asarray(labels), num_classes=4)
    assert int(got.mask.sum()) == 10
    _assert_parity(got, want, "select('gradmatch') port vs JAX")


# ---------------------------------------------------------------------------
# partition plans
# ---------------------------------------------------------------------------

def _same_plan(got, want):
    assert (got.kind, got.num_parts) == (want.kind, want.num_parts)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    for f in ("assign", "bounds"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_make_plan_kinds():
    labels = np.arange(30) % 3
    plan = tpart.make_plan(30, labels=torch.from_numpy(labels),
                           num_classes=3)
    assert plan.kind == "class" and plan.num_parts == 3
    np.testing.assert_array_equal(plan.sizes, [10, 10, 10])
    _same_plan(plan, jpart.make_plan(30, labels=labels, num_classes=3))

    plan = tpart.make_plan(100, partitions=4)
    assert plan.kind == "hash" and plan.num_parts == 4
    assert plan.sizes.sum() == 100
    np.testing.assert_array_equal(plan.assign,
                                  tpart.make_plan(100, partitions=4).assign)
    _same_plan(plan, jpart.make_plan(100, partitions=4))   # the hash ids

    plan = tpart.make_plan(103, partitions=4, kind="contiguous")
    assert plan.bounds[0] == 0 and plan.bounds[-1] == 103
    assert plan.sizes.sum() == 103
    _same_plan(plan, jpart.make_plan(103, partitions=4, kind="contiguous"))

    valid = np.ones(40, bool)
    valid[::5] = False
    plan = tpart.make_plan(40, partitions=2, kind="hash", valid=valid)
    assert plan.sizes.sum() == int(valid.sum())
    _same_plan(plan, jpart.make_plan(40, partitions=2, kind="hash",
                                     valid=valid))
    # partitions=0: max(local devices, 2), as JAX gives on one CPU device
    assert tpart.make_plan(50).num_parts == 2 == jpart.make_plan(50).num_parts
    assert tpart.make_plan(50, devices=3).num_parts == 3

    with pytest.raises(ValueError, match="unknown partition kind"):
        tpart.make_plan(10, kind="banana")
    with pytest.raises(ValueError, match="needs labels"):
        tpart.make_plan(10, kind="class")


def test_subrange_chunks_and_offset_fetch():
    g = _pool(11, 100, 4)
    it = tstream.array_chunks(g, 16)
    for lo, hi in [(0, 100), (10, 90), (17, 33), (95, 100)]:
        sub = tstream.subrange_chunks(it, lo, hi)
        rows = np.concatenate([np.asarray(c) for c, _ in sub()])
        np.testing.assert_array_equal(rows, g[lo:hi])
        jrows = np.concatenate([np.asarray(c) for c, _ in
                                jstream.subrange_chunks(
                                    jstream.array_chunks(g, 16), lo, hi)()])
        np.testing.assert_array_equal(rows, jrows)
    fetch = tstream.offset_row_fetch(tstream.array_row_fetch(g), 20)
    np.testing.assert_array_equal(np.asarray(fetch(np.array([0, 5, 9]))),
                                  g[[20, 25, 29]])


# ---------------------------------------------------------------------------
# partition-merge parity
# ---------------------------------------------------------------------------

def _both(g, k, **kw):
    """The port's and JAX's ``gradmatch_partitioned`` on the same inputs,
    held to parity; returns the port's."""
    got = tpart.gradmatch_partitioned(g, k, device=CPU, **kw)
    want = jpart.gradmatch_partitioned(g, k, **kw)
    _assert_parity(got, want, f"partitioned {kw} port vs JAX")
    _same_stats(got.stats, want.stats)
    return got


def test_single_partition_matches_single_solver():
    g = _pool(13, 300, 8)
    single = tgm.gradmatch(torch.from_numpy(g), 20)
    for kind in ("hash", "contiguous"):
        res = _both(g, 20, partitions=1, kind=kind)
        _check_result(res, 300)
        np.testing.assert_array_equal(np.sort(_selected(res)),
                                      np.sort(_selected(single)),
                                      err_msg=f"P=1 {kind} != single solver")


@pytest.mark.parametrize("partitions", [2, 4])
@pytest.mark.parametrize("kind", ["hash", "contiguous"])
def test_partitioned_objective_near_single_solver(partitions, kind):
    g = _pool(17, 400, 8)
    k = 24
    single = tgm.gradmatch(torch.from_numpy(g), k)
    res = _both(g, k, partitions=partitions, kind=kind)
    _check_result(res, 400)
    assert res.stats.num_parts == partitions
    assert res.stats.union_size >= res.stats.merged
    assert res.stats.merged == int(res.mask.sum())
    tnorm = float((torch.from_numpy(g).sum(dim=0) ** 2).sum())
    gap = (float(res.err) - float(single.err)) / tnorm
    assert gap <= 0.05, f"P={partitions} {kind}: objective gap {gap:.4f}"


def test_class_partitioning_matches_gradmatch_per_class():
    g = _pool(19, 120, 8)
    labels = np.arange(120) % 4
    per_class = tgm.gradmatch_per_class(torch.from_numpy(g),
                                        torch.from_numpy(labels), 4, 20)
    res = _both(g, 20, labels=labels, num_classes=4)
    assert res.stats.kind == "class"
    np.testing.assert_array_equal(np.sort(_selected(res)),
                                  np.sort(_selected(per_class)))
    # from tensors, the same as from numpy
    t = tpart.gradmatch_partitioned(torch.from_numpy(g), 20,
                                    labels=torch.from_numpy(labels),
                                    num_classes=4)
    assert torch.equal(t.indices, res.indices)


def test_explicit_target_and_valid():
    g = _pool(23, 200, 8)
    target = _pool(24, 1, 8)[0] * 5
    valid = np.ones(200, bool)
    valid[::7] = False
    res = _both(g, 16, partitions=3, target=target, valid=valid)
    _check_result(res, 200)
    assert valid[_selected(res)].all(), "selected a masked row"


@pytest.mark.parametrize("kw", [dict(partitions=4),
                                # class 3 has no rows: an empty partition
                                dict(labels=np.arange(200) % 3,
                                     num_classes=4)])
def test_pmap_path_matches_vmap_path(kw):
    g = _pool(29, 200, 8)
    a = _both(g, 16, use_pmap=False, **kw)
    b = _both(g, 16, use_pmap=True, **kw)
    assert torch.equal(a.indices, b.indices) and torch.equal(a.mask, b.mask)
    np.testing.assert_allclose(_np(a.weights), _np(b.weights), rtol=1e-5,
                               atol=1e-7)


def test_selection_dispatch_partitioned():
    g = _pool(31, 160, 8)
    labels = np.arange(160) % 4
    key = jax.random.PRNGKey(0)
    got = tsel.select("gradmatch-partitioned", None, torch.from_numpy(g), 16,
                      labels=torch.from_numpy(labels), num_classes=4)
    want = jsel.select("gradmatch-partitioned", key, jnp.asarray(g), 16,
                       labels=jnp.asarray(labels), num_classes=4)
    assert got.stats.kind == "class"
    _assert_parity(got, want, "select, class kind")
    _same_stats(got.stats, want.stats)
    tgt = _pool(32, 1, 8)[0]
    got = tsel.select("gradmatch-partitioned", None, torch.from_numpy(g), 16,
                      labels=torch.from_numpy(labels), num_classes=4,
                      val_target=torch.from_numpy(tgt), partitions=3)
    want = jsel.select("gradmatch-partitioned", key, jnp.asarray(g), 16,
                       labels=jnp.asarray(labels), num_classes=4,
                       val_target=jnp.asarray(tgt), partitions=3)
    assert got.stats.kind == "hash" and got.stats.num_parts == 3
    _assert_parity(got, want, "select, hash kind under val_target")
    _check_result(got, 160)


@pytest.mark.parametrize("strategy,partitions,match", [
    ("gradmatch", 3, "only applies"),
    ("gradmatch-stream", 2, "only applies"),
    ("gradmatch-partitioned", 0, "must be >= 1"),
    ("gradmatch-partitioned", -2, "must be >= 1"),
])
def test_select_rejects_the_partitions_knob(strategy, partitions, match):
    g = _pool(31, 16, 4)
    with pytest.raises(ValueError, match=match):
        tsel.select(strategy, None, torch.from_numpy(g), 4,
                    partitions=partitions)
    with pytest.raises(ValueError, match=match):
        jsel.select(strategy, jax.random.PRNGKey(0), jnp.asarray(g), 4,
                    partitions=partitions)


# ---------------------------------------------------------------------------
# the device-grouped partition solves on three local devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partitions", [3, 4, 7])
def test_pmap_groups_on_three_devices(monkeypatch, partitions):
    """Groups of three partitions, a ragged tail at P = 4 and 7: the same
    picks as the default path and as JAX's partition solves."""
    g = _pool(29, 200, 8)
    default = tpart.gradmatch_partitioned(g, 16, partitions=partitions,
                                          use_pmap=False, device=CPU)
    monkeypatch.setattr(tdist, "local_devices",
                        lambda dev: [torch.device(CPU)] * 3)
    grouped = tpart.gradmatch_partitioned(g, 16, partitions=partitions,
                                          device=CPU)     # auto: > 1 device
    assert torch.equal(grouped.indices, default.indices)
    assert torch.equal(grouped.mask, default.mask)
    np.testing.assert_allclose(_np(grouped.weights), _np(default.weights),
                               rtol=1e-5, atol=1e-7)
    # pmap_partition_omp itself, partition-local ids, against JAX's
    plan = tpart.make_plan(200, partitions)
    gid = [np.flatnonzero(plan.assign == p) for p in range(partitions)]
    n_max = max(len(x) for x in gid)
    parts = np.zeros((partitions, n_max, 8), np.float32)
    pvalid = np.zeros((partitions, n_max), bool)
    for p, x in enumerate(gid):
        parts[p, :len(x)] = g[x]
        pvalid[p, :len(x)] = True
    targets = (parts * pvalid[:, :, None]).sum(axis=1)
    got = tdist.pmap_partition_omp(parts, targets, pvalid, 6, device=CPU)
    want = jdist.pmap_partition_omp(parts, targets, pvalid, 6)
    assert got[0].shape == (partitions, 6)
    _assert_parity(got, want, f"pmap_partition_omp P={partitions}")


# ---------------------------------------------------------------------------
# out-of-core streaming path
# ---------------------------------------------------------------------------

def test_stream_matches_inmemory_contiguous():
    g = _pool(37, 500, 8)
    mem = tpart.gradmatch_partitioned(g, 24, partitions=4,
                                      kind="contiguous", device=CPU)
    st = tpart.gradmatch_partitioned_stream(pool=g, k=24, partitions=4,
                                            chunk_size=64, device=CPU)
    assert torch.equal(st.indices, mem.indices)
    assert torch.equal(st.mask, mem.mask)
    np.testing.assert_allclose(_np(st.weights), _np(mem.weights), rtol=1e-5,
                               atol=1e-7)
    assert st.stats.stream is not None
    assert st.stats.stream.pool_size == 500
    assert st.stats.stream.rounds == sum(st.stats.quotas) == 24
    assert st.stats.stream.chunks > 0
    want = jpart.gradmatch_partitioned_stream(pool=g, k=24, partitions=4,
                                              chunk_size=64)
    _assert_parity(st, want, "stream port vs JAX")
    _same_stats(st.stats, want.stats)
    want_stream = vars(want.stats.stream)
    assert {k: v for k, v in vars(st.stats.stream).items()
            if k in want_stream} == want_stream


def test_stream_explicit_target_matches_inmemory():
    g = _pool(41, 300, 8)
    target = _pool(42, 1, 8)[0] * 3
    mem = tpart.gradmatch_partitioned(g, 16, partitions=3,
                                      kind="contiguous", target=target,
                                      device=CPU)
    st = tpart.gradmatch_partitioned_stream(pool=g, k=16, partitions=3,
                                            target=target, chunk_size=50,
                                            device=CPU)
    assert torch.equal(st.indices, mem.indices)
    want = jpart.gradmatch_partitioned_stream(pool=g, k=16, partitions=3,
                                              target=target, chunk_size=50)
    _assert_parity(st, want, "stream with a target, port vs JAX")


def test_stream_factory_without_row_fetch():
    g = _pool(43, 260, 8)

    def factory():
        for i in range(0, 260, 64):
            c = g[i:i + 64]
            yield c, np.ones(c.shape[0], bool)

    with_fetch = tpart.gradmatch_partitioned_stream(pool=g, k=16,
                                                    partitions=2, device=CPU)
    no_fetch = tpart.gradmatch_partitioned_stream(pool_iter=factory, k=16,
                                                  partitions=2, device=CPU)
    # the union gathered by one loader scan: the same selection (the
    # targets sum chunks of 64 rows against one chunk of the whole pool)
    assert torch.equal(no_fetch.indices, with_fetch.indices)
    np.testing.assert_allclose(_np(no_fetch.weights),
                               _np(with_fetch.weights), rtol=1e-5, atol=1e-7)
    want = jpart.gradmatch_partitioned_stream(pool_iter=factory, k=16,
                                              partitions=2)
    _assert_parity(no_fetch, want, "factory stream, port vs JAX")
    # the gather pass is counted, as in the reference
    want_stream = vars(want.stats.stream)
    assert {k: v for k, v in vars(no_fetch.stats.stream).items()
            if k in want_stream} == want_stream


# ---------------------------------------------------------------------------
# stats propagation
# ---------------------------------------------------------------------------

def test_expand_batch_selection_keeps_stats():
    sentinel = tpart.PartitionStats(2, "hash", (2, 2), 4, 4)
    sel = SelectionResult(torch.tensor([1, 0], dtype=torch.int32),
                          torch.tensor([0.5, 0.5]),
                          torch.ones((2,), dtype=torch.bool),
                          torch.tensor(0.1), sentinel)
    ex = tgm.expand_batch_selection(sel, batch_size=4, n_examples=8)
    assert ex.stats is sentinel
    assert int(ex.mask.sum()) == 8


def test_expand_if_pb_keeps_stream_stats():
    g = _pool(47, 96, 8)
    sel = tsel.select("gradmatch-pb", None, torch.from_numpy(g), 32,
                      batch_size=8)
    ex = tsel.expand_if_pb("gradmatch-pb", sel, 8, 96)
    assert ex.stats is sel.stats
    want = jsel.select("gradmatch-pb", jax.random.PRNGKey(0),
                       jnp.asarray(g), 32, batch_size=8)
    _assert_parity(sel, want, "gradmatch-pb port vs JAX")


# ---------------------------------------------------------------------------
# craig-lazy-otf dispatch
# ---------------------------------------------------------------------------

def test_craig_lazy_otf_matches_craig_lazy():
    # a pool on a 1/8 grid: exact distances in f32 in both packages
    g = np.round(_pool(53, 96, 8) * 8) / 8
    g = g.astype(np.float32)
    lazy = tsel.select("craig-lazy", None, torch.from_numpy(g), 12)
    otf = tsel.select("craig-lazy-otf", None, torch.from_numpy(g), 12)
    assert torch.equal(otf.indices, lazy.indices)
    assert torch.equal(otf.mask, lazy.mask)
    want = jcraig.craig(jnp.asarray(g), 12, method="lazy")
    np.testing.assert_array_equal(_np(lazy.indices), _np(want.indices))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_first_partitioned_selection_matches_jax():
    """``AdaptiveTrainer`` runs the strategy through ``select()`` on the
    bias proxies, one partition a class, as the JAX trainer does: its first
    selection against JAX's from the same data and parameters."""
    ds = jsyn.make_classification(jax.random.PRNGKey(0), n=512, dim=24,
                                  num_classes=8, sep=5.0)
    train, val = jsyn.split(ds, jax.random.PRNGKey(1))
    (xt, yt), (xv, yv) = ((np.array(d.x), np.array(d.y))
                          for d in (train, val))
    params = jax.tree_util.tree_map(
        np.asarray, init_classifier(jmlp(in_dim=24, num_classes=8),
                                    jax.random.PRNGKey(3)))

    def cfg(mod, hp):
        return mod.TrainerConfig(strategy="gradmatch-partitioned",
                                 budget=0.25, epochs=2, batch_size=32,
                                 hp=hp(select_every=1))

    jt = jtrainer.AdaptiveTrainer(
        jmlp(in_dim=24, num_classes=8), cfg(jtrainer, JHP),
        jsyn.Dataset(jnp.asarray(xt), jnp.asarray(yt), 8),
        jsyn.Dataset(jnp.asarray(xv), jnp.asarray(yv), 8))
    want, _ = jt._run_selection(params, jax.random.PRNGKey(5))
    tt = ttrainer.AdaptiveTrainer(
        mlp(in_dim=24, num_classes=8), cfg(ttrainer, PaperHParams),
        tsyn.Dataset(torch.from_numpy(xt), torch.from_numpy(yt).long(), 8),
        tsyn.Dataset(torch.from_numpy(xv), torch.from_numpy(yv).long(), 8),
        device=CPU)
    model = params_from_jax(mlp(in_dim=24, num_classes=8), params, CPU)
    got, _ = tt._run_selection(model, None)
    _assert_parity(got, want, "trainer's first partitioned selection")
    assert got.stats.kind == "class" and got.stats.num_parts == 8
    _same_stats(got.stats, want.stats)
    rep = tt.run(model)
    assert rep.selection_rounds == 2 and rep.subset_size == int(
        0.25 * len(xt))
