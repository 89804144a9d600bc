"""The port's streaming GRAD-MATCH (``repro_torch/core/streaming.py``)
against the JAX package's, on the CPU.

Same numpy inputs into both packages.  The standard is ``_assert_parity``
of ``tests/test_omp_parity.py`` (indices and masks equal, weights and
``err`` to rtol 1e-4 / atol 1e-5) against the JAX dense oracle or the JAX
solver its own test uses, and ``SelectStats`` equal to the JAX streaming
engine's, field by field (the port's extra ``host_syncs`` aside).  The
cases are the streaming halves of ``tests/test_omp_parity.py`` and
``tests/test_streaming.py`` (bar the serve admission and pmap scorer
cases, whose modules are not ported), the compressed cache's arena against
JAX's ``_compress_chunk``, and the recovery paths of
``tests/test_resilience.py`` that the port has.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gradmatch as jgm  # noqa: E402
from repro.core import streaming as J  # noqa: E402
from repro.core.omp import omp_select as j_omp  # noqa: E402
from repro.core.omp import omp_select_dense as j_dense  # noqa: E402
from repro.resilience import RetryPolicy as JRetry  # noqa: E402
from repro_torch.core import proxies as tproxies  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core import streaming as T  # noqa: E402
from repro_torch.data.loader import ChunkedPool  # noqa: E402
from repro_torch.resilience import faults as tfaults  # noqa: E402
from repro_torch.resilience.recovery import (RetryExhausted,  # noqa: E402
                                             RetryPolicy, with_retries)

CPU = "cpu"
STREAM = dict(buffer_size=16, chunk_topm=8)
CHUNK = 48   # not a divisor of the pool sizes below
FAST = RetryPolicy(max_retries=8, backoff_s=0.0, sleep=lambda s: None)
JFAST = JRetry(max_retries=8, backoff_s=0.0, sleep=lambda s: None)


def _pool(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_parity(a, b, what):
    np.testing.assert_array_equal(_np(a[0]), _np(b[0]),
                                  err_msg=f"{what}: indices differ")
    np.testing.assert_array_equal(_np(a[2]), _np(b[2]),
                                  err_msg=f"{what}: masks differ")
    np.testing.assert_allclose(_np(a[1]), _np(b[1]), rtol=1e-4, atol=1e-5,
                               err_msg=f"{what}: weights differ")
    np.testing.assert_allclose(float(a[3]), float(b[3]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: err differs")


def _assert_stats(port, jax_stats):
    """Every field of the reference's SelectStats equal."""
    want = vars(jax_stats)
    got = {k: v for k, v in vars(port).items() if k in want}
    assert got == want, {k: (got[k], want[k]) for k in want
                         if got[k] != want[k]}


def _both(g, target, k, chunk=CHUNK, valid=None, fetch=False, **kw):
    """(port result, JAX result) of omp_select_streaming on the same numpy
    pool; ``fetch`` gives both their array row fetch."""
    jkw, tkw = dict(kw), dict(kw)
    if fetch:
        jkw["row_fetch"] = J.array_row_fetch(g)
        tkw["row_fetch"] = T.array_row_fetch(g)
    want = J.omp_select_streaming(J.array_chunks(g, chunk, valid=valid),
                                  jnp.asarray(target), k, **jkw)
    got = T.omp_select_streaming(T.array_chunks(g, chunk, valid=valid),
                                 target, k, device=CPU, **tkw)
    _assert_stats(got.stats, want.stats)
    return got, want


def _port(g, target, k, chunk=CHUNK, valid=None, fetch=False, **kw):
    """The port alone, where the reference's own test compares with the
    in-memory solver only (JAX's streaming engine compiles each new shape
    for seconds)."""
    if fetch:
        kw["row_fetch"] = T.array_row_fetch(g)
    return T.omp_select_streaming(T.array_chunks(g, chunk, valid=valid),
                                  target, k, device=CPU, **kw)


def _oracle(g, target, k, valid=None, **kw):
    return j_dense(jnp.asarray(g), jnp.asarray(target, jnp.float32), k=k,
                   valid=None if valid is None else jnp.asarray(valid), **kw)


def _res(out):
    return out.indices, out.weights, out.mask, out.err


# ---------------------------------------------------------------------------
# tests/test_omp_parity.py: streaming vs the dense oracle
# ---------------------------------------------------------------------------

GRID = [(0, 96, 12, 16), (1, 160, 48, 24), (2, 200, 8, 16), (3, 64, 32, 96)]


@pytest.mark.parametrize("seed,n,d,k", GRID)
@pytest.mark.parametrize("lam", [1e-6, 0.3])
def test_parity_random_pools(seed, n, d, k, lam):
    g = _pool(seed, n, d)
    target = g.sum(axis=0)
    got, _ = _both(g, target, k, lam=lam, **STREAM)
    _assert_parity(_res(got), _oracle(g, target, k, lam=lam), "random")


def _degenerate(case):
    """(g, target, k, lam, valid, kwargs) of the degenerate parity cases."""
    if case == "duplicates":
        g = _pool(10, 80, 12)
        g[1::2] = g[::2]
        return g, g.sum(0), 24, 0.2, None, {}
    if case == "zero-rows":
        g = _pool(11, 96, 16)
        g[20:60] = 0.0
        return g, g.sum(0), 20, 0.1, None, {}
    if case == "k-exceeds-valid":
        g = _pool(12, 72, 10)
        valid = np.arange(72) < 9
        return g, (g * valid[:, None]).sum(0), 32, 0.2, valid, {}
    if case == "all-masked":
        g = _pool(13, 64, 8)
        valid = np.zeros((64,), bool)
        return g, (g * valid[:, None]).sum(0), 8, 0.2, valid, {}
    if case == "random-valid":
        g = _pool(14, 120, 24)
        valid = np.random.default_rng(14).random(120) < 0.4
        return g, (g * valid[:, None]).sum(0), 16, 0.2, valid, {}
    if case == "absolute":
        g = _pool(15, 140, 20)
        return g, -(g[:40].sum(0)), 12, 0.1, None, {"positive": False}
    g = _pool(16, 50, 40)                               # eps stop
    return g, g[7] * 2.0 + g[31] * 1.0, 10, 1e-8, None, {"eps": 1e-6}


@pytest.mark.parametrize("case", ["duplicates", "zero-rows",
                                  "k-exceeds-valid", "all-masked",
                                  "random-valid", "absolute", "eps-stop"])
def test_parity_degenerate_pools(case):
    g, target, k, lam, valid, kw = _degenerate(case)
    got, _ = _both(g, target, k, valid=valid, lam=lam, **STREAM, **kw)
    _assert_parity(_res(got), _oracle(g, target, k, valid=valid, lam=lam,
                                      **kw), case)
    sel = got.indices[got.mask].numpy()
    if case == "zero-rows":
        assert not np.any((sel >= 20) & (sel < 60))
    if case == "all-masked":
        assert int(got.mask.sum()) == 0
    if case == "random-valid":
        assert valid[sel].all()
    if case == "eps-stop":
        assert int(got.mask.sum()) == 2


def test_last_candidate_selectable_late_round():
    """Candidate n-1 becomes the best pick in round 2 (the scatter-sentinel
    regression of the reference)."""
    rng = np.random.default_rng(99)
    n, d = 33, 6
    g = 0.01 * rng.standard_normal((n, d)).astype(np.float32)
    g[0, 0] = 10.0
    g[n - 1] = 0.0
    g[n - 1, 1] = 1.0
    target = np.zeros((d,), np.float32)
    target[0], target[1] = 20.0, 3.0
    got, want = _both(g, target, 4, chunk=8, lam=1e-6, buffer_size=4,
                      chunk_topm=2)
    sel = got.indices[got.mask].tolist()
    assert n - 1 in sel and len(sel) == len(set(sel))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))


MR_GRID = [
    # (n, d, k, buffer, chunk, cache_bytes): cache ample / LRU-bounded /
    # thrashing, buffers from tiny to pool-sized
    (256, 16, 48, 32, 96, 1 << 20),
    (256, 16, 48, 64, 64, 6000),
    (320, 24, 40, 16, 100, 64),
    (192, 12, 32, 256, 48, 1 << 20),
]


@pytest.mark.parametrize("n,d,k,buf,chunk,cbytes", MR_GRID)
@pytest.mark.parametrize("variant", ["plain", "dups", "masked", "kbig"])
def test_multiround_grid_parity(n, d, k, buf, chunk, cbytes, variant):
    g = _pool(100 + n + k, n, d)
    valid = None
    if variant == "dups":
        g[1::2] = g[::2]
    elif variant == "masked":
        valid = np.random.default_rng(n).random(n) < 0.5
    elif variant == "kbig":
        valid = np.arange(n) < (k // 2)
    target = (g if valid is None else g * valid[:, None]).sum(axis=0)
    got, _ = _both(g, target, k, chunk=chunk, valid=valid, fetch=True,
                   buffer_size=buf, cache_bytes=cbytes)
    ref = j_omp(jnp.asarray(g), jnp.asarray(target), k=k,
                valid=None if valid is None else jnp.asarray(valid))
    _assert_parity(_res(got), ref, f"multiround[{variant}]")
    assert got.stats.rounds <= k
    if variant == "plain" and cbytes >= (1 << 20):
        assert got.stats.passes <= max(k // 8 + 2, 2), got.stats.summary()


# ---------------------------------------------------------------------------
# tests/test_streaming.py
# ---------------------------------------------------------------------------

def _ref(g, target, k, **kw):
    return j_omp(jnp.asarray(g), jnp.asarray(target), k=k, **kw)


def test_chunk_size_invariant():
    g = _pool(0, 256, 24)
    target = g.sum(axis=0)
    ref = _ref(g, target, 32, lam=0.2)
    for cs in (32, 100, 256, 1000):
        got = _port(g, target, 32, chunk=cs, lam=0.2, buffer_size=64)
        _assert_parity(_res(got), ref, f"chunk {cs}")


def test_buffer_size_invariant():
    g = _pool(1, 192, 16)
    target = g.sum(axis=0)
    ref = _ref(g, target, 24, lam=0.3)
    passes = []
    for m in (4, 32, 256):
        got = _port(g, target, 24, chunk=64, lam=0.3, buffer_size=m)
        _assert_parity(_res(got), ref, f"buffer {m}")
        passes.append(got.stats.passes)
    assert passes[-1] == 1 and passes[0] >= passes[-1]


def test_chunk_topm_smaller_than_buffer():
    g = _pool(2, 160, 12)
    target = g.sum(axis=0)
    got = _port(g, target, 20, chunk=40, lam=0.2, buffer_size=32,
                chunk_topm=4)
    _assert_parity(_res(got), _ref(g, target, 20, lam=0.2), "topm")


def test_multi_pass_and_certified_accounting():
    g = _pool(3, 100, 8)
    target = g.sum(axis=0)
    got = _port(g, target, 120, chunk=32, lam=0.2, buffer_size=16)
    s = got.stats
    assert s.passes > 1 and s.rounds == 120 and s.certified_rounds > 0
    assert s.pool_size == 100
    _assert_parity(_res(got), _ref(g, target, 120, lam=0.2), "k > n")


def test_out_of_core_memmap_pool(tmp_path):
    n, d = 4096, 32
    g = _pool(4, n, d)
    mm = np.memmap(tmp_path / "pool.f32", dtype=np.float32, mode="w+",
                   shape=(n, d))
    mm[:] = g
    mm.flush()
    del mm
    pool = np.memmap(tmp_path / "pool.f32", dtype=np.float32, mode="r",
                     shape=(n, d))
    target, total = T.streaming_target(T.array_chunks(pool, 512),
                                       device=CPU)
    assert total == n
    np.testing.assert_allclose(target.numpy(), g.sum(axis=0), rtol=1e-5,
                               atol=1e-4)
    out = T.omp_select_streaming(T.array_chunks(pool, 512), g.sum(axis=0),
                                 48, lam=0.2, buffer_size=128, device=CPU)
    _assert_parity(_res(out), _ref(g, g.sum(axis=0), 48, lam=0.2),
                   "memmap")
    ChunkedPool(pool)
    os.truncate(tmp_path / "pool.f32", n * d * 2)     # half the file
    with pytest.raises(ValueError, match="truncated"):
        ChunkedPool(pool)


def test_gradmatch_streaming_wrappers():
    g = _pool(5, 200, 16)
    ref = jgm.gradmatch(jnp.asarray(g), k=24, lam=0.5)
    for pool in (g, torch.from_numpy(g)):
        # a tensor's device is the solve's; numpy rows name theirs
        sel = T.gradmatch_streaming_array(
            pool, 24, lam=0.5, chunk_size=64, buffer_size=64,
            device=CPU if isinstance(pool, np.ndarray) else None)
        np.testing.assert_array_equal(sel.indices.numpy(),
                                      np.asarray(ref.indices))
        np.testing.assert_allclose(sel.weights.numpy(),
                                   np.asarray(ref.weights), rtol=1e-4,
                                   atol=1e-5)
    sel2 = T.gradmatch_streaming(T.array_chunks(g, 64), 24, lam=0.5,
                                 buffer_size=64, device=CPU)
    np.testing.assert_array_equal(sel2.indices.numpy(),
                                  np.asarray(ref.indices))
    want = J.gradmatch_streaming(J.array_chunks(g, 64), 24, lam=0.5,
                                 buffer_size=64)
    _assert_stats(sel2.stats, want.stats)


def test_select_dispatch_stream_strategy():
    from repro.core import selection as jsel
    import jax

    g = _pool(6, 128, 12)
    a = tsel.select("gradmatch", None, torch.from_numpy(g), k=16,
                    per_class=False)
    b = tsel.select("gradmatch-stream", None, torch.from_numpy(g), k=16,
                    chunk_size=48, stream_buffer=32)
    c = jsel.select("gradmatch-stream", jax.random.PRNGKey(0),
                    jnp.asarray(g), k=16, chunk_size=48, stream_buffer=32)
    for other in (a, c):
        np.testing.assert_array_equal(b.indices.numpy(),
                                      np.asarray(other.indices))
        np.testing.assert_allclose(b.weights.numpy(),
                                   np.asarray(other.weights), rtol=1e-4,
                                   atol=1e-5)
    assert isinstance(b.stats, T.SelectStats)
    _assert_stats(b.stats, c.stats)
    assert a.stats is None
    with pytest.raises(ValueError, match="stream_cache_bytes"):
        tsel.select("gradmatch-stream", None, torch.from_numpy(g), k=16,
                    stream_cache_bytes=0)


def test_chunked_pool_iteration():
    x = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    y = np.arange(23)
    for xs, ys in ((x, y), (torch.from_numpy(x), torch.from_numpy(y))):
        pool = ChunkedPool(xs, ys, chunk_size=10)
        assert pool.n == 23 and pool.num_chunks() == 3
        for _ in range(2):                 # re-iterable, same order
            chunks = list(pool.chunks())
            assert [c[2] for c in chunks] == [0, 10, 20]
            assert [c[0].shape[0] for c in chunks] == [10, 10, 3]
            np.testing.assert_array_equal(
                np.concatenate([_np(c[0]) for c in chunks]), x)
            np.testing.assert_array_equal(
                np.concatenate([_np(c[1]) for c in chunks]), y)
    valid = np.arange(23) % 2 == 0
    got = list(T.chunked_pool_iter(ChunkedPool(x, None, 10), valid)())
    np.testing.assert_array_equal(np.concatenate([v for _, v in got]), valid)


def _toy_proxy_fn():
    from repro_torch.configs.paper import mlp
    from repro_torch.models.classifier import ClassifierNet
    from repro_torch.train.steps import make_proxy_fn

    model = ClassifierNet(mlp(in_dim=8, num_classes=5),
                          generator=torch.Generator().manual_seed(0))
    return make_proxy_fn(model)


def test_proxy_chunk_stream_and_row_fetch_match_full_extraction():
    """Chunked proxy extraction equals the full-pool extraction, and the
    row fetch gives the scan's rows bit for bit."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((75, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, 75))
    proxy_fn = _toy_proxy_fn()
    pool = ChunkedPool(x, y, chunk_size=32)
    for pick, which in (("bias", 1), ("per_class", 0)):
        chunks = tproxies.proxy_chunk_stream(pool.chunks, proxy_fn, pick)
        got = torch.cat([p for p, _ in chunks()])
        np.testing.assert_allclose(got.numpy(),
                                   proxy_fn(x, y)[which].numpy(), rtol=1e-6,
                                   atol=1e-7)
        ids = np.array([74, 3, 40, 31, 32, 64, 0])     # tail chunk included
        rows = tproxies.proxy_row_fetch(x, y, proxy_fn, 32, pick)(ids)
        assert torch.equal(rows, got[torch.from_numpy(ids)])


def test_streaming_guard_on_empty_iterator():
    out = T.omp_select_streaming(lambda: iter(()), np.ones((8,), np.float32),
                                 4, device=CPU)
    assert int(out.mask.sum()) == 0 and out.stats.passes == 0
    with pytest.raises(ValueError, match="empty"):
        T.streaming_target(lambda: iter(()), device=CPU)


def test_multi_round_certification_with_cache():
    n, d, k = 1024, 32, 96
    g = _pool(20, n, d)
    target = g.sum(axis=0)
    got, _ = _both(g, target, k, chunk=256, fetch=True, buffer_size=128)
    _assert_parity(_res(got), _ref(g, target, k), "cache")
    s = got.stats
    assert s.passes <= k // 8 + 2, s.summary()
    assert s.certified_rounds >= 0.5 * s.rounds, s.summary()
    assert s.cache_hit_rate == 1.0, s.summary()


def test_cache_thrash_smaller_than_chunk():
    g = _pool(21, 300, 16)
    target = g.sum(axis=0)
    got = _port(g, target, 24, chunk=100, fetch=True, buffer_size=32,
                cache_bytes=64)
    _assert_parity(_res(got), _ref(g, target, 24), "thrash")
    assert got.stats.cache_hits == 0 and got.stats.passes >= 1


def test_cache_lru_eviction_partial_coverage():
    n, d, chunk = 512, 16, 128
    g = _pool(22, n, d)
    target = g.sum(axis=0)
    cbytes = 2 * 128 * (2 * d + 15) + 64                 # ~2 of 4 chunks
    cache = T.ChunkCache(cbytes, d, device=CPU)
    out = T.omp_select_streaming(T.array_chunks(g, chunk), target, 48,
                                 buffer_size=64, cache=cache,
                                 row_fetch=T.array_row_fetch(g), device=CPU)
    jcache = J.ChunkCache(cbytes, d)
    want = J.omp_select_streaming(J.array_chunks(g, chunk),
                                  jnp.asarray(target), 48, buffer_size=64,
                                  cache=jcache,
                                  row_fetch=J.array_row_fetch(g))
    _assert_parity(_res(out), _ref(g, target, 48), "lru")
    _assert_stats(out.stats, want.stats)
    assert cache.stats() == jcache.stats()
    assert cache.cap_slots < 4 and cache.evictions > 0
    assert out.stats.cache_misses > 0


def _near_rank_one(seed, n, d):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((d,)).astype(np.float32)
    return np.tile(base, (n, 1)) + 1e-3 * rng.standard_normal(
        (n, d)).astype(np.float32)


def test_adversarial_bf16_resolution_pool():
    """Rows that differ below bf16 resolution: the interval bound almost
    never certifies, and the engine fails closed into repairs and rescans
    (the dense solver is the oracle, as in the reference's test)."""
    g = _near_rank_one(23, 96, 16)
    target = g.sum(axis=0)
    got, _ = _both(g, target, 12, chunk=32, fetch=True, buffer_size=16,
                   chunk_topm=8)
    _assert_parity(_res(got), _oracle(g, target, 12), "adversarial")
    assert got.stats.passes <= 12 + 2


def test_pass_budget_error_carries_stats():
    g = _pool(24, 128, 8)
    with pytest.raises(T.StreamingPassBudgetError) as ei:
        T.omp_select_streaming(T.array_chunks(g, 64), g.sum(axis=0), 64,
                               buffer_size=4, chunk_topm=2, cache_bytes=0,
                               max_passes=1, device=CPU)
    assert ei.value.stats.passes == 1 and ei.value.cap == 1
    assert "passes=1" in str(ei.value)
    assert T.StreamStats is T.SelectStats


def test_unstable_iterator_detected_by_cache():
    g = _pool(27, 128, 8)
    state = {"n": 0}

    def unstable():
        state["n"] += 1
        cs = 32 if state["n"] == 1 else 48     # offsets shift on pass 2
        for lo in range(0, 128, cs):
            yield g[lo:lo + cs], None

    with pytest.raises(RuntimeError, match="unstable"):
        T.omp_select_streaming(unstable, g.sum(axis=0), 64, buffer_size=8,
                               chunk_topm=4, device=CPU)


def test_refill_non_power_of_two_arena():
    n, d, chunk = 384, 16, 128
    g = _near_rank_one(30, n, d)
    target = g.sum(axis=0)
    cbytes = 3 * 128 * T.ChunkCache(0, d, device=CPU).bytes_per_row + 47
    cache = T.ChunkCache(cbytes, d, device=CPU)
    assert cache.cap_rows_budget not in (256, 512)
    out = T.omp_select_streaming(T.array_chunks(g, chunk), target, 48,
                                 buffer_size=96, cache=cache,
                                 row_fetch=T.array_row_fetch(g), device=CPU)
    want = J.omp_select_streaming(J.array_chunks(g, chunk),
                                  jnp.asarray(target), 48, buffer_size=96,
                                  cache=J.ChunkCache(cbytes, d),
                                  row_fetch=J.array_row_fetch(g))
    _assert_stats(out.stats, want.stats)
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(_oracle(g, target, 48)[0]))


def test_repair_annex_overflow_clamped():
    g = _near_rank_one(31, 512, 24)
    target = g.sum(axis=0)
    got, _ = _both(g, target, 64, chunk=128, fetch=True, buffer_size=48,
                   repair_slots=200)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(_oracle(g, target, 64)[0]))


# ---------------------------------------------------------------------------
# the compressed cache against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [10, 24, 65])
def test_cache_compression_matches_jax(d):
    """The arena after a warming pass: bf16 rows bit for bit (both round
    to nearest even), gids, validity and slot layout equal; the f32 norm
    and error sidecars to 2 ulp.  XLA's CPU row sums are a chain of fused
    multiply-adds up to 32 columns and another order past that; torch sums
    in its own order, so their last bit can differ."""
    rng = np.random.default_rng(d)
    g = (rng.standard_normal((300, d)) * 3.7).astype(np.float32)
    valid = rng.random(300) < 0.8
    tc = T.ChunkCache(1 << 20, d, device=CPU)
    jc = J.ChunkCache(1 << 20, d)
    T.streaming_target(T.array_chunks(g, 72, valid=valid), cache=tc,
                       device=CPU)
    J.streaming_target(J.array_chunks(g, 72, valid=valid), cache=jc)
    assert tc.entries == jc.entries and tc.complete == jc.complete == 5
    assert tc.stats() == jc.stats()
    np.testing.assert_array_equal(
        tc.rows.view(torch.int16).numpy(),
        np.asarray(jc.rows).view(np.int16))
    np.testing.assert_array_equal(tc.gids.numpy(), np.asarray(jc.gids))
    np.testing.assert_array_equal(tc.ok.numpy(), np.asarray(jc.ok))
    for got, want in ((tc.norms, jc.norms), (tc.errn, jc.errn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2 * 2.0 ** -23, atol=0)
    # and the arena as a solve leaves it, LRU-bounded to two of five slots
    cbytes = 2 * 128 * tc.bytes_per_row
    out = T.omp_select_streaming(
        T.array_chunks(g, 72, valid=valid), (g * valid[:, None]).sum(0), 16,
        buffer_size=16, cache=(tc := T.ChunkCache(cbytes, d, device=CPU)),
        device=CPU)
    want = J.omp_select_streaming(
        J.array_chunks(g, 72, valid=valid),
        jnp.asarray((g * valid[:, None]).sum(0)), 16, buffer_size=16,
        cache=(jc := J.ChunkCache(cbytes, d)))
    _assert_stats(out.stats, want.stats)
    assert tc.entries == jc.entries and tc.evictions == jc.evictions > 0
    np.testing.assert_array_equal(tc.rows.view(torch.int16).numpy(),
                                  np.asarray(jc.rows).view(np.int16))


def test_compress_chunk_matches_jax():
    """``_compress_chunk`` on its own: bf16 bits equal, sidecars to 2 ulp,
    zero sidecars on rows the mask drops."""
    rng = np.random.default_rng(1)
    ch = (rng.standard_normal((64, 33)) * 1e3).astype(np.float32)
    ok = rng.random(64) < 0.7
    rb, nj, ej = (np.asarray(a) for a in J._compress_chunk(
        jnp.asarray(ch), jnp.asarray(ok)))
    tb, nt, et = T._compress_chunk(torch.from_numpy(ch), torch.from_numpy(ok))
    np.testing.assert_array_equal(tb.view(torch.int16).numpy(),
                                  rb.view(np.int16))
    np.testing.assert_allclose(nt.numpy(), nj, rtol=2 * 2.0 ** -23, atol=0)
    np.testing.assert_allclose(et.numpy(), ej, rtol=2 * 2.0 ** -23, atol=0)
    assert not nt.numpy()[~ok].any() and not et.numpy()[~ok].any()


# ---------------------------------------------------------------------------
# faults and recovery (tests/test_resilience.py's cases the port has)
# ---------------------------------------------------------------------------

class _FlakyChunks:
    """Chunk factory that raises ``fault`` the first time chunk ``at`` is
    read, then reads clean."""

    def __init__(self, inner, at, fault):
        self.inner, self.at, self.fault = inner, at, fault
        self.raised = 0

    def __call__(self):
        for i, item in enumerate(self.inner()):
            if i == self.at and not self.raised:
                self.raised += 1
                raise self.fault(f"chunk {i} read failed")
            yield item


class _CorruptChunks:
    """Chunk factory whose chunk ``at`` reads scaled by 3 on every read
    after the first (the first read is the cache's ground truth)."""

    def __init__(self, inner, at):
        self.inner, self.at, self.reads = inner, at, 0

    def __call__(self):
        for i, (chunk, v) in enumerate(self.inner()):
            if i == self.at:
                self.reads += 1
                if self.reads > 1:
                    chunk = chunk * np.float32(3.0)
            yield chunk, v


def _flaky_fetch(fetch, fault):
    state = {"raised": 0}

    def f(ids):
        if not state["raised"]:
            state["raised"] += 1
            raise fault("fetch failed")
        return fetch(ids)

    return f


def test_transient_faults_bit_identical_selection():
    """A transient fault on one chunk read and on one row fetch: the same
    selection bit for bit, with both retries counted."""
    g = _pool(5, 256, 32)
    target = g.sum(axis=0)
    kw = dict(buffer_size=16, cache_bytes=1 << 20, retry=FAST, device=CPU)
    ref = T.omp_select_streaming(T.array_chunks(g, 64), target, 32,
                                 row_fetch=T.array_row_fetch(g), **kw)
    assert ref.stats.retries == 0 and ref.stats.fetched_rows > 0
    chunks = _FlakyChunks(T.array_chunks(g, 64), 2, tfaults.ChunkReadError)
    out = T.omp_select_streaming(
        chunks, target, 32,
        row_fetch=_flaky_fetch(T.array_row_fetch(g), tfaults.RowFetchError),
        **kw)
    assert torch.equal(out.indices, ref.indices)
    assert torch.equal(out.mask, ref.mask)
    assert torch.equal(out.weights, ref.weights)
    assert out.stats.retries == 2 and out.stats.quarantined == 0
    with pytest.raises(RetryExhausted):
        with_retries(lambda: (_ for _ in ()).throw(
            tfaults.ChunkReadError("x")), RetryPolicy(
                max_retries=2, backoff_s=0.0, sleep=lambda s: None))


def test_persistently_corrupt_chunk_quarantined_never_selected():
    """Chunk 1 reads corrupted on every re-read: the engine detects it
    against the exact-norm sidecars, retries, then quarantines its rows;
    none is selected.  The JAX engine does the same on the same reads."""
    g = _pool(40, 256, 16)
    target = g.sum(axis=0)
    kw = dict(buffer_size=8, chunk_topm=4, cache_bytes=1 << 20)
    tchunks = _CorruptChunks(T.array_chunks(g, 64), 1)
    out = T.omp_select_streaming(tchunks, target, 24, retry=FAST,
                                 device=CPU, **kw)
    jchunks = _CorruptChunks(J.array_chunks(g, 64), 1)
    want = J.omp_select_streaming(jchunks, jnp.asarray(target), 24,
                                  retry=JFAST, **kw)
    assert out.stats.passes > 1 and out.stats.quarantined > 0
    _assert_stats(out.stats, want.stats)
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(want.indices))
    # Every row of chunk 1 is quarantined; rows of it committed from the
    # first (clean) read stay, later rounds never pick one.
    assert out.stats.quarantined == 64
    sel = out.indices[out.mask].numpy()
    late = sel[out.stats.rounds - 4:]
    assert not ((late >= 64) & (late < 128)).any()


def test_persistent_row_corruption_quarantined_on_warm_cache():
    """Warm-cache bootstrap: every candidate row reaches the solver through
    the checked fetch.  Rows whose fetch keeps disagreeing with the
    sidecars are quarantined out of candidacy, fail closed."""
    n, d, k = 256, 32, 32
    g = _pool(0, n, d)
    pool = T.array_chunks(g, 64)

    def warm_solve(fetch):
        cache = T.ChunkCache(1 << 20, d, device=CPU)
        target, total = T.streaming_target(pool, cache=cache, device=CPU)
        assert total == n and cache.complete == 4
        return T.omp_select_streaming(pool, target, k, buffer_size=n,
                                      cache=cache, row_fetch=fetch,
                                      retry=FAST, device=CPU)

    ref = warm_solve(T.array_row_fetch(g))
    assert ref.stats.passes == 0
    picked = ref.indices[ref.mask].numpy()
    bad = {int(picked[0]), int(picked[-1]), 3}

    def corrupt(ids):
        rows = g[np.asarray(ids)].copy()
        hit = np.isin(np.asarray(ids), list(bad))
        rows[hit] *= np.float32(2.0)
        return rows

    out = warm_solve(corrupt)
    sel = set(out.indices[out.mask].tolist())
    assert not (bad & sel)
    assert out.stats.quarantined == len(bad)
    assert "quarantined=" in out.stats.summary()


def test_checkpoint_dir_not_ported(tmp_path):
    """``checkpoint_dir``: a solve killed when its stream dies resumes
    from its snapshot to the never-killed solve's bits, through both entry
    points."""
    g = _pool(1, 96, 4)
    chunks = T.array_chunks(g, 16)
    kw = dict(buffer_size=8, cache_bytes=0, retry=FAST, device=CPU)
    ref = T.omp_select_streaming(chunks, g.sum(0), 12, **kw)
    dying = tfaults.FaultyChunkIterator(
        chunks, tfaults.FaultPlan(die_after_chunks=20))
    with pytest.raises(tfaults.StreamDied):
        T.omp_select_streaming(dying, g.sum(0), 12, checkpoint_dir=str(
            tmp_path / "a"), checkpoint_every=1, **kw)
    out = T.omp_select_streaming(chunks, g.sum(0), 12, checkpoint_dir=str(
        tmp_path / "a"), checkpoint_every=1, **kw)
    assert out.stats.resumes == 1 and out.stats.passes == ref.stats.passes
    assert torch.equal(out.indices, ref.indices)
    assert torch.equal(out.weights, ref.weights)
    sel = T.gradmatch_streaming(chunks, 12, buffer_size=8, cache_bytes=0,
                                retry=FAST, checkpoint_dir=str(
                                    tmp_path / "b"), device=CPU)
    assert sel.stats.checkpoints == 1 and torch.equal(sel.indices,
                                                      ref.indices)


def test_streaming_equals_in_memory_solver_bit_for_bit(monkeypatch):
    """With scoring kernels whose row results do not depend on how many
    rows a call holds (the card's one-warp-a-row kernels), the streaming
    engine and the in-memory incremental solver make the same picks with
    the same ``err`` over many rounds: the engine takes ``g_e . target``
    from the scoring kernel, as the in-memory solver's ``c0`` does.  Rows
    here are scored in f64 and rounded, which is row-wise on the CPU."""
    from repro_torch.core import omp as tomp
    from repro_torch.kernels import ops

    def corr(g, r):
        return (g.double() @ r.double()).float()

    def corr_argmax(c, w, base, mask, absolute=False):
        s = (base.double() - c.double() @ w.double()).float()
        s = torch.where(mask, s.abs() if absolute else s, float("-inf"))
        i = torch.argmax(s)
        return i.to(torch.int32), s[i]

    monkeypatch.setattr(ops, "corr", corr)
    monkeypatch.setattr(ops, "corr_argmax", corr_argmax)
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.standard_normal((6000, 10))
                          * rng.random((6000, 1))).astype(np.float32))
    target = g.sum(0)
    idx, _, mask, err = tomp.omp_select(g, target, 500)
    out = T.omp_select_streaming(T.array_chunks(g, 1024), target, 500,
                                 row_fetch=T.array_row_fetch(g), device=CPU)
    assert torch.equal(out.indices, idx) and torch.equal(out.mask, mask)
    assert float(out.err) == float(err)
    assert out.stats.repairs > 0 or out.stats.refills > 0
