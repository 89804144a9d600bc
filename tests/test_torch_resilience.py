"""The port's fault injection, recovery, circuit breaker, degradation rung
and streaming kill-and-resume (``repro_torch/resilience``,
``repro_torch/core/streaming.py``) against the JAX package's, on the CPU.

The reference's differential guarantees, kept inside the port: under
seeded transient faults the selection is bit-identical to the fault-free
run; corruption is detected against the exact-norm sidecars (cleared when
transient, quarantined when persistent, never selected); a solve killed
mid-stream resumes from its checkpoint to the never-killed run's bits.
Across the packages: a ``FaultPlan``'s schedule is the reference's event
for event, the streaming snapshot tree at every committed round has the
reference's keys, shapes and dtypes and its values (indices and masks
equal, floats to rtol 1e-4 / atol 1e-5), and the stochastic rung draws
the reference's sample and makes its picks.  Sizes are
``tests/test_resilience.py``'s.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import streaming as J  # noqa: E402
from repro.resilience import FaultPlan as JPlan  # noqa: E402
from repro.resilience import FaultyChunkIterator as JFaulty  # noqa: E402
from repro.resilience import RetryPolicy as JRetry  # noqa: E402
from repro.resilience import RowFetchError as JRowFetchError  # noqa: E402
from repro.resilience import TransientFault as JTransient  # noqa: E402
from repro.resilience import faulty_row_fetch as j_faulty_fetch  # noqa: E402
from repro.resilience import stochastic_fallback as j_fallback  # noqa: E402
from repro.resilience.degrade import \
    stochastic_pool_select as j_pool_select  # noqa: E402
from repro_torch.core import streaming as S  # noqa: E402
from repro_torch.resilience import (ChunkReadError, CircuitBreaker,  # noqa
                                    CircuitOpen, FaultPlan,
                                    FaultyChunkIterator, RetryExhausted,
                                    RetryPolicy, RowFetchError,
                                    SimulatedCrash, StreamDied,
                                    TransientFault, crash_after,
                                    faulty_row_fetch, stochastic_fallback,
                                    with_retries)
from repro_torch.resilience.degrade import \
    stochastic_pool_select  # noqa: E402

SEED = int(os.environ.get("FAULT_SEED", "7"))
CPU = "cpu"
FAST = RetryPolicy(max_retries=8, backoff_s=0.0, sleep=lambda s: None)
JFAST = JRetry(max_retries=8, backoff_s=0.0, sleep=lambda s: None)

N, D, K, CHUNK, BUF = 256, 32, 32, 64, 16


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal((N, D)).astype(
        np.float32)


def _small_cache_bytes(x):
    # Room for ~2 of the 4 chunks: eviction churn, repairs and extra
    # loader passes, the busiest recovery surface.
    return 2 * CHUNK * (x.shape[1] * 2 + 8)


def _solve(pool_iter, x, row_fetch=None, cache_bytes=None, **kw):
    cb = _small_cache_bytes(x) if cache_bytes is None else cache_bytes
    return S.omp_select_streaming(
        pool_iter, x.sum(axis=0), K, buffer_size=BUF, cache_bytes=cb,
        row_fetch=row_fetch, retry=kw.pop("retry", FAST), device=CPU, **kw)


def _same(a, b):
    assert torch.equal(a.indices, b.indices)
    assert torch.equal(a.mask, b.mask)
    assert torch.equal(a.weights, b.weights)
    assert torch.equal(a.err, b.err)


# -- fault schedules ---------------------------------------------------------

def _drive(it, passes=3):
    """Every event of ``passes`` passes, re-opening a pass after each
    transient fault: (pass, chunk index, outcome) in order."""
    log = []
    for p in range(passes):
        gen = it()
        idx = 0
        while True:
            try:
                for chunk, _ in gen:
                    log.append((p, idx, float(np.asarray(chunk).sum())))
                    idx += 1
                break
            except (TransientFault, JTransient) as e:
                log.append((p, idx, type(e).__name__))
                gen, idx = it(), 0
    return log


def test_fault_schedule_equals_the_reference_event_for_event():
    x = _x()
    plan = dict(seed=SEED, transient_rate=0.2, corrupt_rate=0.3,
                slow_rate=0.2, slow_s=0.0)
    naps, jnaps = [], []
    it = FaultyChunkIterator(S.array_chunks(x, CHUNK), FaultPlan(**plan),
                             sleeper=naps.append)
    jit = JFaulty(J.array_chunks(x, CHUNK), JPlan(**plan),
                  sleeper=jnaps.append)
    log, jlog = _drive(it), _drive(jit)
    assert log == jlog and naps == jnaps
    assert dict(it.injected) == dict(jit.injected)
    assert it.encounters == jit.encounters and it.yielded == jit.yielded
    assert it.injected["corrupt"] > 0 and it.injected["transient"] > 0
    # a second run of the same plan sees the same schedule
    again = FaultyChunkIterator(S.array_chunks(x, CHUNK), FaultPlan(**plan),
                                sleeper=lambda s: None)
    assert _drive(again) == log


def test_faulty_row_fetch_equals_the_reference():
    x = _x(1)
    plan = dict(seed=SEED, row_transient_rate=0.3, row_corrupt_rate=0.2,
                corrupt_ids=(3, 17))
    fetch = faulty_row_fetch(S.array_row_fetch(torch.from_numpy(x)),
                             FaultPlan(**plan))
    jfetch = j_faulty_fetch(J.array_row_fetch(x), JPlan(**plan))
    rng = np.random.default_rng(0)
    for _ in range(12):
        ids = rng.choice(N, 9, replace=False)
        ids[0] = 3
        try:
            got = fetch(ids)
        except RowFetchError:
            with pytest.raises(JRowFetchError):
                jfetch(ids)
            continue
        want = jfetch(ids)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert dict(fetch.injected) == dict(jfetch.injected)
    assert fetch.injected["row_transient"] > 0
    assert fetch.injected["row_corrupt"] >= 12 - fetch.injected[
        "row_transient"]


# -- the differential guarantee ----------------------------------------------

def test_transient_faults_bit_identical_selection():
    x = _x()
    pool = S.array_chunks(x, CHUNK)
    ref = _solve(pool, x, row_fetch=S.array_row_fetch(x))
    assert ref.stats.retries == 0

    plan = FaultPlan(seed=SEED, transient_rate=0.12, row_transient_rate=0.1,
                     slow_rate=0.05, slow_s=0.0)
    runs = []
    for _ in range(2):                    # run-to-run determinism
        fpool = FaultyChunkIterator(pool, plan)
        ffetch = faulty_row_fetch(S.array_row_fetch(x), plan)
        out = _solve(fpool, x, row_fetch=ffetch)
        assert torch.equal(out.indices, ref.indices)
        assert torch.equal(out.mask, ref.mask)
        assert torch.equal(out.weights, ref.weights)
        ninj = sum(fpool.injected.values()) + sum(ffetch.injected.values())
        assert ninj > 0 and out.stats.retries > 0
        assert out.stats.quarantined == 0
        runs.append((ninj, out.stats.retries, dict(fpool.injected)))
    assert runs[0] == runs[1]


def test_transient_chunk_corruption_detected_and_cleared():
    x = _x()
    pool = S.array_chunks(x, CHUNK)
    pol = RetryPolicy(max_retries=16, backoff_s=0.0, sleep=lambda s: None)
    ref = _solve(pool, x, row_fetch=S.array_row_fetch(x),
                 cache_bytes=1 << 20, retry=pol)
    plan = FaultPlan(seed=SEED, transient_rate=0.15, corrupt_rate=0.15)
    fpool = FaultyChunkIterator(pool, plan)
    out = _solve(fpool, x, row_fetch=S.array_row_fetch(x),
                 cache_bytes=1 << 20, retry=pol)
    assert torch.equal(out.indices, ref.indices)
    assert torch.equal(out.mask, ref.mask)
    if fpool.injected["corrupt"]:
        assert out.stats.retries > 0
    assert out.stats.quarantined == 0


def test_persistent_corruption_quarantined_never_selected():
    x = _x()
    pool = S.array_chunks(x, CHUNK)

    def warm_solve(fetch):
        cache = S.ChunkCache(1 << 20, D, device=CPU)
        target, n = S.streaming_target(pool, cache=cache, device=CPU)
        assert n == N and cache.complete == N // CHUNK
        return S.omp_select_streaming(pool, target, K, buffer_size=N,
                                      cache=cache, row_fetch=fetch,
                                      retry=FAST, device=CPU)

    ref = warm_solve(S.array_row_fetch(x))
    assert ref.stats.passes == 0
    picked = ref.indices[ref.mask].numpy()
    bad_ids = (int(picked[0]), int(picked[-1]), 3)
    ffetch = faulty_row_fetch(S.array_row_fetch(x),
                              FaultPlan(seed=SEED, corrupt_ids=bad_ids))
    out = warm_solve(ffetch)
    sel = set(out.indices[out.mask].tolist())
    assert ffetch.injected["row_corrupt"] > 0
    assert not (set(bad_ids) & sel)
    assert out.stats.quarantined > 0
    assert "quarantined=" in out.stats.summary()


# -- checkpoint / resume -----------------------------------------------------

@pytest.mark.parametrize("arena,die", [(False, 10), (True, 12)])
def test_kill_and_resume_bit_identical(tmp_path, arena, die):
    """Killed mid-stream (the stream dies for good), then resumed: the
    never-killed run's selection, bit for bit; with and without the
    arena (the cache and the row fetch)."""
    x = _x()
    pool = S.array_chunks(x, CHUNK)
    kw = (dict(row_fetch=S.array_row_fetch(x)) if arena
          else dict(cache_bytes=0))
    ref = _solve(pool, x, **kw)

    td = str(tmp_path / "ckpt")
    dpool = FaultyChunkIterator(pool, FaultPlan(seed=SEED,
                                                die_after_chunks=die))
    with pytest.raises((StreamDied, RetryExhausted)):
        _solve(dpool, x, checkpoint_dir=td, checkpoint_every=1, **kw)
    assert os.listdir(td)                 # the kill left checkpoints

    res = _solve(pool, x, checkpoint_dir=td, checkpoint_every=1, **kw)
    assert res.stats.resumes == 1
    _same(res, ref)
    assert "resumes=1" in res.stats.summary()


def test_checkpointing_changes_nothing(tmp_path):
    """A never-killed run with snapshots equals one without, and counts
    them; ``gradmatch_streaming`` passes the arguments on."""
    x = _x(2)
    pool = S.array_chunks(x, CHUNK)
    fetch = S.array_row_fetch(x)
    ref = _solve(pool, x, row_fetch=fetch)
    out = _solve(pool, x, row_fetch=fetch,
                 checkpoint_dir=str(tmp_path / "a"), checkpoint_every=4)
    _same(out, ref)
    assert out.stats.checkpoints == K // 4 and out.stats.resumes == 0
    sel = S.gradmatch_streaming(pool, K, buffer_size=BUF,
                                cache_bytes=_small_cache_bytes(x),
                                row_fetch=fetch, retry=FAST,
                                checkpoint_dir=str(tmp_path / "b"),
                                checkpoint_every=8, device=CPU)
    assert sel.stats.checkpoints == K // 8
    assert len(os.listdir(tmp_path / "b")) == 2     # keep-2


def test_incompatible_checkpoint_refused(tmp_path):
    x = _x()
    pool = S.array_chunks(x, CHUNK)
    td = str(tmp_path / "ckpt")
    _solve(pool, x, cache_bytes=0, checkpoint_dir=td, checkpoint_every=1)
    with pytest.raises(ValueError, match="incompatible"):
        S.omp_select_streaming(pool, x.sum(0), K + 8, buffer_size=BUF,
                               cache_bytes=0, retry=FAST, checkpoint_dir=td,
                               device=CPU)
    # resume=False ignores the stale state and solves fresh.
    out = S.omp_select_streaming(pool, x.sum(0), K + 8, buffer_size=BUF,
                                 cache_bytes=0, retry=FAST,
                                 checkpoint_dir=td, resume=False, device=CPU)
    assert int(out.mask.sum()) == K + 8


def _snapshots(module, monkeypatch):
    """Record every snapshot tree ``module``'s engine saves, by step, as
    host numpy (bf16 as its bits, under the name ``bfloat16``)."""
    trees = {}
    save = module.save_solver_state

    def flat(tree, prefix=""):
        for key in sorted(tree):
            val = tree[key]
            if isinstance(val, dict):
                yield from flat(val, f"{prefix}{key}/")
            else:
                yield f"{prefix}{key}", val

    def host(v):
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                return v.view(torch.int16).numpy().view(np.uint16), "bf16"
            return v.numpy().copy(), str(v.numpy().dtype)
        a = np.array(v)
        if a.dtype.name == "bfloat16":
            return a.view(np.uint16), "bf16"
        return a, str(a.dtype)

    def recording(directory, step, tree, **kw):
        trees[int(step)] = dict((k, host(v)) for k, v in flat(tree))
        return save(directory, step, tree, **kw)

    monkeypatch.setattr(module, "save_solver_state", recording)
    return trees


def test_snapshot_tree_matches_the_reference(tmp_path, monkeypatch):
    x = _x(3)
    tgt = x.sum(axis=0)
    cb = _small_cache_bytes(x)
    got = _snapshots(S, monkeypatch)
    want = _snapshots(J, monkeypatch)
    S.omp_select_streaming(S.array_chunks(x, CHUNK), tgt, K,
                           buffer_size=BUF, cache_bytes=cb,
                           row_fetch=S.array_row_fetch(x), retry=FAST,
                           checkpoint_dir=str(tmp_path / "t"),
                           checkpoint_every=4, device=CPU)
    J.omp_select_streaming(J.array_chunks(x, CHUNK), jnp.asarray(tgt), K,
                           buffer_size=BUF, cache_bytes=cb,
                           row_fetch=J.array_row_fetch(x), retry=JFAST,
                           checkpoint_dir=str(tmp_path / "j"),
                           checkpoint_every=4)
    assert sorted(got) == sorted(want) and len(got) == K // 4
    for step in got:
        g, w = got[step], want[step]
        # the port's one extra counter: commit-loop device reads
        assert sorted(set(g) - {"stats/host_syncs"}) == sorted(w)
        for key, (wv, wdt) in w.items():
            gv, gdt = g[key]
            assert (gv.shape, gdt) == (wv.shape, wdt), (step, key)
            if wdt in ("float32", "float64"):
                np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{step} {key}")
            elif key == "arena/rows":
                # bf16 of rows the packages compress alike
                np.testing.assert_array_equal(gv, wv, err_msg=key)
            else:
                np.testing.assert_array_equal(gv, wv,
                                              err_msg=f"{step} {key}")


# -- satellite faults --------------------------------------------------------

def test_die_once_stream_revives():
    x = _x()
    it = FaultyChunkIterator(
        S.array_chunks(x, CHUNK),
        FaultPlan(seed=SEED, die_after_chunks=2, die_once=True))
    with pytest.raises(StreamDied):
        list(it())
    assert len(list(it())) == N // CHUNK  # healthy after the one death


def test_slow_chunks_call_sleeper():
    x = _x()
    naps = []
    it = FaultyChunkIterator(
        S.array_chunks(x, CHUNK),
        FaultPlan(seed=SEED, slow_rate=1.0, slow_s=0.01),
        sleeper=naps.append)
    list(it())
    assert naps == [0.01] * (N // CHUNK)


def test_corruption_keeps_tensor_chunks_on_their_device():
    x = torch.from_numpy(_x())
    it = FaultyChunkIterator(S.array_chunks(x, CHUNK),
                             FaultPlan(seed=SEED, corrupt_rate=1.0))
    first = [c for c, _ in it()]
    again = [c for c, _ in it()]
    assert all(torch.equal(a, b) for a, b in zip(first, x.split(CHUNK)))
    for a, b in zip(again, x.split(CHUNK)):
        assert isinstance(a, torch.Tensor)
        assert torch.equal(a, b * 1.5 + 0.125)
    assert it.injected["corrupt"] == N // CHUNK


def test_crash_after_raises_at_its_stage():
    hook = crash_after("blobs")
    hook("manifest-tmp")
    with pytest.raises(SimulatedCrash, match="blobs"):
        hook("blobs")


def test_circuit_breaker_lifecycle():
    t = [0.0]
    br = CircuitBreaker(failure_threshold=2, cooldown_s=5.0,
                        clock=lambda: t[0])
    br.allow()
    br.record_failure()
    br.allow()                            # 1 failure: still closed
    br.record_failure()                   # threshold: opens
    assert br.state == "open" and br.trips == 1
    with pytest.raises(CircuitOpen, match="circuit open"):
        br.allow()
    with pytest.raises(CircuitOpen):      # peek agrees, mutates nothing
        br.peek()
    t[0] = 6.0                            # past cooldown
    br.peek()                             # peek never consumes the trial
    br.allow()                            # half-open: one trial admitted
    assert br.state == "half-open"
    with pytest.raises(CircuitOpen, match="half-open"):
        br.allow()
    br.record_failure()                   # trial failed: re-open
    assert br.state == "open" and br.trips == 2
    t[0] = 12.0
    br.allow()
    br.record_success()                   # trial succeeded: closed again
    assert br.state == "closed" and br.failures == 0
    br.allow()


def test_retry_exhaustion_is_not_transient():
    calls = []

    def fails():
        calls.append(1)
        raise ChunkReadError("nope")

    with pytest.raises(RetryExhausted):
        with_retries(fails, RetryPolicy(max_retries=3, backoff_s=0.0,
                                        sleep=lambda s: None))
    assert len(calls) == 4


# -- degradation -------------------------------------------------------------

def test_stochastic_fallback_matches_the_reference():
    x = _x()
    cache = S.ChunkCache(1 << 20, D, device=CPU)
    target, n = S.streaming_target(S.array_chunks(x, CHUNK), cache=cache,
                                   device=CPU)
    jcache = J.ChunkCache(1 << 20, D)
    jtarget, _ = J.streaming_target(J.array_chunks(x, CHUNK), cache=jcache)
    assert n == N
    # quarantined rows are not live: drop a few on both sides
    cache.quarantine([5, 70, 200])
    jcache.quarantine([5, 70, 200])
    out = stochastic_fallback(cache, target, K, seed=SEED)
    want = j_fallback(jcache, jtarget, K, seed=SEED)
    sel = out.indices[out.mask].numpy()
    assert len(sel) == K and len(set(sel.tolist())) == K
    assert sel.min() >= 0 and sel.max() < N
    assert not set(sel.tolist()) & {5, 70, 200}
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-4, atol=1e-5)
    again = stochastic_fallback(cache, target, K, seed=SEED)
    assert torch.equal(out.indices, again.indices)
    # no arena -> no fallback (the ladder's next stop is failure)
    assert stochastic_fallback(S.ChunkCache(0, D, device=CPU), target,
                               K) is None


@pytest.mark.parametrize("with_valid", [False, True])
def test_stochastic_pool_select_matches_the_reference(with_valid):
    x = _x(4)
    valid = (np.arange(N) % 5 != 0) if with_valid else None
    out = stochastic_pool_select(torch.from_numpy(x), x.sum(0), 16,
                                 seed=SEED, valid=valid, min_sample=64)
    want = j_pool_select(jnp.asarray(x), jnp.asarray(x.sum(0)), 16,
                         seed=SEED, valid=valid, min_sample=64)
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-4, atol=1e-5)
    sel = out.indices[out.mask].numpy()
    if with_valid:
        assert valid[sel].all()
    assert stochastic_pool_select(torch.from_numpy(x), x.sum(0), 4,
                                  valid=np.zeros(N, bool)) is None
