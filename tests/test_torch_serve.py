"""The port's selection service (``repro_torch/serve``) against the JAX
package's, on the CPU.

The serving cases of ``tests/test_serve.py`` and the stream-session cases
of ``tests/test_continual.py``, each run on both services on the same
numpy pools and compared ticket by ticket: status, degradation rung,
micro-batch size, and the selection to the ROADMAP's standard (indices and
masks equal, weights and ``err`` to rtol 1e-4 / atol 1e-5); the
scheduler's ``counters`` and ``degraded_served`` and the tenants' budgets
equal after the same sequence.  Random and ``craig-stochastic`` picks
differ from the reference's by design (``core/random_sel.py``): those
hold invariants and same-seed determinism.  CRAIG pools lie on a 1/8
grid (ROADMAP §3: exact distances).  Where the reference promises bits
inside itself (a resumed solve, an extension), the port keeps them inside
the port.  Both launchers' ``--smoke`` pass with ``--device cpu``.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.continual import BufferMaintainer as JBuffer  # noqa: E402
from repro.core import omp as jomp  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro import resilience as jres  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.continual import BufferMaintainer  # noqa: E402
from repro_torch.core import omp as tomp  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.core.gradmatch import SelectionResult, _normalize  # noqa
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch import resilience as tres  # noqa: E402

SEED = int(os.environ.get("FAULT_SEED", "7"))
CPU = "cpu"


def _pkg(name, serve, res, stream, loader, omp, service):
    return SimpleNamespace(
        name=name, Service=service, serve=serve, res=res,
        chunked_pool_iter=stream.chunked_pool_iter,
        ChunkedPool=loader.ChunkedPool, omp=omp)


PORT = _pkg("port", tserve, tres, tstream, tloader, tomp,
            lambda **kw: tserve.SelectionService(device=CPU, **kw))
JAX = _pkg("jax", jserve, jres, jstream, jloader, jomp,
           jserve.SelectionService)
BOTH = (PORT, JAX)


def _pool(seed, n, d, grid=False):
    g = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    return np.round(g * 8) / 8 if grid else g


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _parity(got, want, what):
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]),
                                  err_msg=f"{what}: indices differ")
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]),
                                  err_msg=f"{what}: masks differ")
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: weights differ")
    np.testing.assert_allclose(float(_np(got[3])), float(_np(want[3])),
                               rtol=1e-4, atol=1e-5,
                               err_msg=f"{what}: err differs")


def _same_tickets(ts, js, picks=True):
    """Ticket pairs: the same outcome, rung and batch size, and (``picks``)
    the same selection to the standard."""
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        what = f"{t.ticket_id} ({t.request.strategy}, k {t.request.k})"
        assert (t.status, t.degradation, t.batched_with) == (
            j.status, j.degradation, j.batched_with), what
        assert (t.error is None) == (j.error is None), what
        if t.status == "done" and picks:
            _parity(t.result[:4], j.result[:4], what)


def _same_books(ts, js):
    """The scheduler's and the tenants' books after the same sequence."""
    assert ts.scheduler.counters == js.scheduler.counters
    assert ts.scheduler.degraded_served == js.scheduler.degraded_served
    assert ts.scheduler.batches_run == js.scheduler.batches_run
    assert ts.scheduler.singles_run == js.scheduler.singles_run
    a, b = ts.admission.stats(), js.admission.stats()
    assert a.keys() == b.keys()
    for tenant in a:
        for key in ("inflight", "admitted", "rejected"):
            assert a[tenant][key] == b[tenant][key], (tenant, key)
        assert a[tenant]["used_units"] == pytest.approx(
            b[tenant]["used_units"])


def _run(scenario):
    """``scenario(pkg) -> (service, tickets)`` on both packages, compared."""
    (ts, tt), (js, jt) = (scenario(p) for p in BOTH)
    _same_tickets(tt, jt)
    _same_books(ts, js)
    return ts, tt


def _oneshot(g, k, **kw):
    gt = torch.from_numpy(g)
    return tomp.omp_select(gt, gt.sum(dim=0), k, **kw)


# ---------------------------------------------------------------------------
# micro-batching
# ---------------------------------------------------------------------------

def test_micro_batches_same_pool():
    g1, g2 = _pool(0, 192, 24), _pool(1, 160, 24)

    def scenario(p):
        svc = p.Service(max_batch=8)
        p1, p2 = svc.register_pool(g1), svc.register_pool(g2)
        tickets = [svc.submit(p1 if i % 2 == 0 else p2, k=16,
                              tenant=f"t{i % 2}") for i in range(8)]
        svc.drain()
        return svc, tickets

    svc, tickets = _run(scenario)
    assert all(t.batched_with == 4 for t in tickets)
    assert svc.scheduler.batches_run == 2
    for t in tickets:
        g = g1 if t.request.pool_id == tickets[0].request.pool_id else g2
        one = _oneshot(g, 16)
        assert torch.equal(t.result.indices, one[0])
        s = float(t.result.weights[t.result.mask].sum())
        assert s == pytest.approx(1.0, rel=1e-5)


def test_batch_respects_distinct_keys():
    g = _pool(2, 128, 16)

    def scenario(p):
        svc = p.Service(max_batch=8)
        pid = svc.register_pool(g)
        tickets = [svc.submit(pid, k=12), svc.submit(pid, k=20)]
        svc.drain()
        return svc, tickets

    _, (a, b) = _run(scenario)
    assert a.batched_with == 1 and b.batched_with == 1
    assert int(a.result.mask.sum()) == 12 and int(b.result.mask.sum()) == 20


def test_padded_bucket_gives_jax_picks(monkeypatch):
    """Three requests pad to a batch of four, as the reference pads them.
    At d 48 and k 16 the batched regime rule ``hi * B <= d`` takes the
    wide regime at B 3 and the narrow one at B 4: the padded group runs
    the reference's rounds and gives its picks."""
    g = _pool(3, 120, 48)
    rng = np.random.default_rng(3)
    targets = [g[rng.random(120) < 0.5].sum(0) for _ in range(3)]
    seen = []
    real = tserve.scheduler.omp_select_batched

    def spy(grads, tg, **kw):
        seen.append(tuple(tg.shape))
        return real(grads, tg, **kw)

    monkeypatch.setattr(tserve.scheduler, "omp_select_batched", spy)

    def scenario(p):
        svc = p.Service(max_batch=8)
        pid = svc.register_pool(g)
        tickets = [svc.submit(pid, k=16, target=tg, tenant=f"t{i}")
                   for i, tg in enumerate(targets)]
        svc.drain()
        return svc, tickets

    _, tickets = _run(scenario)
    assert seen == [(4, 48)]
    assert all(t.batched_with == 3 for t in tickets)


def test_scheduler_craig_glister_random_single():
    g = _pool(3, 96, 16, grid=True)

    def scenario(p):
        svc = p.Service(max_batch=8)
        pid = svc.register_pool(g)
        tickets = [svc.submit(pid, k=8, strategy=s)
                   for s in ("craig-lazy", "craig", "glister")]
        svc.drain()
        return svc, tickets

    svc, _ = _run(scenario)
    pid = next(iter(svc.registry._pools))
    assert svc.registry.get(pid)._fl is not None   # the FL scan is cached
    # random and craig-stochastic: invariants, same-seed determinism
    for strategy in ("random", "craig-stochastic"):
        picks = []
        for _ in range(2):
            t = svc.submit(pid, k=8, strategy=strategy, seed=1)
            svc.drain()
            assert t.status == "done" and t.degradation == "certified"
            sel = t.result.indices[t.result.mask]
            assert len(set(sel.tolist())) == 8
            assert int(sel.min()) >= 0 and int(sel.max()) < 96
            assert float(t.result.weights.sum()) == pytest.approx(1.0)
            picks.append(sel)
        assert torch.equal(picks[0], picks[1]), strategy


def test_unknown_strategy_and_pool():
    for p in BOTH:
        svc = p.Service()
        pid = svc.register_pool(_pool(4, 64, 8))
        with pytest.raises(ValueError, match="unservable"):
            svc.submit(pid, k=4, strategy="gradmatch-pb")
        with pytest.raises(p.serve.UnknownPool):
            svc.submit("nope", k=4)


def test_chunked_pool_served_via_streaming():
    g = _pool(5, 200, 16)

    def scenario(p):
        svc = p.Service(max_batch=8)
        pid = svc.register_chunked_pool(p.ChunkedPool(g, chunk_size=48))
        t = svc.submit(pid, k=20)
        svc.drain()
        with pytest.raises(p.serve.UnknownPool, match="chunked"):
            svc.open_session(pid, k=8)
        return svc, [t]

    _, (t,) = _run(scenario)
    assert torch.equal(t.result.indices, _oneshot(g, 20)[0])


def test_partitioned_strategy_served_both_pool_kinds():
    from repro_torch.core import partition as part_lib
    g = _pool(55, 400, 16)

    def scenario(p):
        svc = p.Service(max_batch=8)
        pid = svc.register_pool(g, partitions=3)
        pid2 = svc.register_chunked_pool(p.ChunkedPool(g, chunk_size=96),
                                         partitions=4)
        assert svc.registry.get(pid2).partitions == 4
        tickets = [svc.submit(pid, k=20, strategy="gradmatch-partitioned"),
                   svc.submit(pid2, k=20, strategy="gradmatch-partitioned")]
        svc.drain()
        return svc, tickets

    _, (t, t2) = _run(scenario)
    assert t.degradation == "certified"
    lib = part_lib.gradmatch_partitioned(g, 20, partitions=3, device=CPU)
    assert torch.equal(t.result.indices, lib.indices)
    lib2 = part_lib.gradmatch_partitioned_stream(pool=g, k=20, partitions=4,
                                                 device=CPU)
    assert torch.equal(t2.result.indices, lib2.indices)
    assert t2.result.stats.num_parts == 4 and t2.result.stats.stream


# ---------------------------------------------------------------------------
# admission and backpressure
# ---------------------------------------------------------------------------

def test_queue_full_backpressure():
    g = _pool(6, 64, 8)

    def scenario(p):
        svc = p.Service(max_queue=3)
        pid = svc.register_pool(g)
        tickets = [svc.submit(pid, k=4) for _ in range(3)]
        with pytest.raises(p.serve.QueueFull):
            svc.submit(pid, k=4)
        svc.drain()
        tickets.append(svc.submit(pid, k=4))
        svc.drain()
        return svc, tickets

    _run(scenario)


def test_tenant_budget_exhaustion_and_inflight_cap():
    g = _pool(7, 64, 8)

    def scenario(p):
        svc = p.Service(default_budget_units=None)
        pid = svc.register_pool(g)
        svc.admission.set_budget("metered", budget_units=1500.0)
        t = svc.submit(pid, k=1, tenant="metered")
        with pytest.raises(p.serve.BudgetExhausted, match="budget"):
            svc.submit(pid, k=8, tenant="metered")
        svc.drain()
        svc.admission.set_budget("capped", budget_units=None,
                                 max_inflight=2)
        more = [svc.submit(pid, k=4, tenant="capped") for _ in range(2)]
        with pytest.raises(p.serve.BudgetExhausted, match="in flight"):
            svc.submit(pid, k=4, tenant="capped")
        svc.drain()
        assert svc.admission.account("capped").inflight == 0
        return svc, [t] + more

    _run(scenario)


def test_session_extension_charges_delta_only():
    g = _pool(8, 128, 16)
    for p in BOTH:
        svc = p.Service()
        pid = svc.register_pool(g)
        sid, _ = svc.open_session(pid, k=16, tenant="m")
        used = svc.admission.account("m").used_units
        svc.extend_session(sid, 24)
        delta = svc.admission.account("m").used_units - used
        assert delta == pytest.approx(p.serve.estimate_cost(128, 16, 8))


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def test_session_ttl_expiry_and_lru_eviction():
    g = _pool(9, 96, 12)
    stats = []
    for p in BOTH:
        clock = {"t": 0.0}
        svc = p.Service(max_sessions=2, session_ttl_s=100.0,
                        clock=lambda: clock["t"])
        pid = svc.register_pool(g)
        sid1, _ = svc.open_session(pid, k=8)
        clock["t"] = 50.0
        sid2, _ = svc.open_session(pid, k=8)
        clock["t"] = 120.0
        with pytest.raises(p.serve.SessionGone):
            svc.extend_session(sid1, 16)
        svc.extend_session(sid2, 16)
        svc.open_session(pid, k=8)
        sid4, _ = svc.open_session(pid, k=8)
        with pytest.raises(p.serve.SessionGone):
            svc.extend_session(sid2, 24)
        svc.extend_session(sid4, 16)
        stats.append(svc.sessions.stats())
    assert stats[0] == stats[1]
    assert stats[0]["expirations"] >= 1 and stats[0]["evictions"] >= 1


def test_extension_after_roundtrip_matches_oneshot():
    g = _pool(11, 160, 24)
    out = []
    for p in BOTH:
        svc = p.Service()
        pid = svc.register_pool(g)
        sid, first = svc.open_session(pid, k=10, lam=0.3)
        out.append((first, svc.extend_session(sid, 24)))
    (tf, te), (jf, je) = out
    _parity(te[:4], je[:4], "extension")
    _parity(tf[:4], jf[:4], "first session")
    one = _oneshot(g, 24, lam=0.3)
    assert torch.equal(te.indices, one[0])
    assert torch.equal(te.indices[:10], tf.indices)


def test_extension_idempotent_retry_charges_nothing():
    g = _pool(29, 96, 12)
    for p in BOTH:
        svc = p.Service()
        svc.admission.set_budget("m", budget_units=1e9)
        pid = svc.register_pool(g)
        sid, first = svc.open_session(pid, k=8, tenant="m")
        used = svc.admission.account("m").used_units
        again = svc.extend_session(sid, 8)
        assert svc.admission.account("m").used_units == used
        np.testing.assert_array_equal(_np(again.indices),
                                      _np(first.indices))
        with pytest.raises(ValueError, match="shrink"):
            svc.extend_session(sid, 4)


def test_stale_session_after_pool_replacement_raises():
    for p in BOTH:
        svc = p.Service()
        svc.register_pool(_pool(27, 96, 12), pool_id="p")
        sid, _ = svc.open_session("p", k=8)
        svc.register_pool(_pool(28, 96, 12), pool_id="p")
        with pytest.raises(p.serve.SessionGone, match="stale"):
            svc.extend_session(sid, 16)


# ---------------------------------------------------------------------------
# failure paths: the queue never wedges, budgets never leak
# ---------------------------------------------------------------------------

def test_pool_evicted_between_submit_and_drain_fails_ticket_not_queue():
    def scenario(p):
        svc = p.Service(max_pools=1)
        t1 = svc.submit(svc.register_pool(_pool(20, 64, 8)), k=4,
                        tenant="m")
        t2 = svc.submit(svc.register_pool(_pool(21, 64, 8)), k=4,
                        tenant="m")
        svc.drain()
        assert "unknown pool" in t1.error.lower()
        assert svc.scheduler.pending() == 0
        return svc, [t1, t2]

    _, (t1, t2) = _run(scenario)
    assert t1.status == "failed" and t2.status == "done"


def test_malformed_target_fails_group_and_refunds():
    def scenario(p):
        svc = p.Service(default_budget_units=1e9)
        pid = svc.register_pool(_pool(22, 64, 8))
        bad = svc.submit(pid, k=4, tenant="m",
                         target=np.zeros((3,), np.float32))
        good = svc.submit(pid, k=6, tenant="m")
        used = svc.admission.account("m").used_units
        svc.drain()
        acct = svc.admission.account("m")
        assert acct.inflight == 0
        assert acct.used_units == pytest.approx(used - bad.cost)
        return svc, [bad, good]

    _, (bad, good) = _run(scenario)
    assert bad.status == "failed" and good.status == "done"


def test_chunked_pool_rejects_per_request_valid():
    g = _pool(23, 96, 8)

    def scenario(p):
        svc = p.Service()
        pid = svc.register_chunked_pool(p.ChunkedPool(g, chunk_size=32))
        t = svc.submit(pid, k=8, valid=np.ones((96,), bool))
        svc.drain()
        assert "valid" in t.error
        with pytest.raises(ValueError, match="chunk factory"):
            svc.register_chunked_pool(lambda: iter([(g, None)]),
                                      valid=np.ones((96,), bool))
        return svc, [t]

    _, (t,) = _run(scenario)
    assert t.status == "failed"


def test_failed_session_open_refunds_budget():
    for p in BOTH:
        svc = p.Service()
        svc.admission.set_budget("m", budget_units=1e9)
        pid = svc.register_pool(_pool(24, 64, 8))
        with pytest.raises(Exception):
            svc.open_session(pid, k=8, tenant="m",
                             target=np.zeros((5,), np.float32))
        acct = svc.admission.account("m")
        assert acct.used_units == 0.0 and acct.inflight == 0


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_dedupe_respects_valid_mask():
    g = _pool(30, 80, 8)
    mask = np.arange(80) < 40

    def scenario(p):
        svc = p.Service()
        p_all = svc.register_pool(g)
        p_masked = svc.register_pool(g, valid=mask)
        assert p_all != p_masked
        t = svc.submit(p_masked, k=8)
        svc.drain()
        return svc, [t]

    _, (t,) = _run(scenario)
    assert mask[_np(t.result.indices)[_np(t.result.mask)]].all()


def test_random_and_glister_honor_pool_valid():
    g = _pool(31, 80, 8)
    mask = np.arange(80) < 10
    svc = PORT.Service()
    pid = svc.register_pool(g, valid=mask)
    for strategy in ("random", "glister"):
        sel = svc.select(pid, k=8, strategy=strategy, seed=3)
        assert mask[_np(sel.indices)[_np(sel.mask)]].all(), strategy
    # GLISTER's picks are the reference's
    jsvc = JAX.Service()
    jsel = jsvc.select(jsvc.register_pool(g, valid=mask), k=8,
                       strategy="glister")
    _parity(svc.select(pid, k=8, strategy="glister")[:4], jsel[:4],
            "glister on a masked pool")


def test_registry_overwrite_retires_old_fingerprint():
    a, b = _pool(25, 64, 8), _pool(26, 64, 8)
    for p in BOTH:
        svc = p.Service()
        svc.register_pool(a, pool_id="x")
        svc.register_pool(b, pool_id="x")
        pa = svc.register_pool(a)
        assert pa != "x"
        np.testing.assert_array_equal(_np(svc.registry.get(pa).grads), a)


def test_registry_fingerprint_dedupe_and_eviction():
    g1, g2, g3 = _pool(0, 64, 8), _pool(1, 64, 8), _pool(2, 64, 8)
    ids = []
    for p in BOTH:
        svc = p.Service(max_pools=2)
        p1 = svc.register_pool(g1)
        assert svc.register_pool(g1.copy()) == p1
        p2 = svc.register_pool(g2)
        p3 = svc.register_pool(g3)
        assert p1 not in svc.registry and p2 in svc.registry
        with pytest.raises(p.serve.UnknownPool):
            svc.submit(p1, k=4)
        assert svc.registry.stats()["evictions"] == 1
        ids.append((p1, p2, p3))
    assert ids[0] == ids[1]


def test_registry_takes_device_tensors_and_hashes_host_bytes():
    """A tensor pool: one host copy for both hashes, the device copy from
    the tensor; keys equal to the numpy pool's."""
    g = _pool(32, 96, 12)
    reg = tserve.PoolRegistry(device=CPU)
    e1 = reg.get(reg.register(torch.from_numpy(g)))
    reg2 = tserve.PoolRegistry(device=CPU)
    e2 = reg2.get(reg2.register(g))
    assert (e1.fingerprint, e1.content_digest) == (e2.fingerprint,
                                                   e2.content_digest)
    assert torch.equal(e1.grads, e2.grads)
    assert torch.equal(e1.target_sum, e2.target_sum)
    assert e1.device == torch.device(CPU)


# ---------------------------------------------------------------------------
# resilience: breakers, the degradation ladder, deadlines
# ---------------------------------------------------------------------------

def _fast_retry(p):
    return p.res.RetryPolicy(max_retries=2, backoff_s=0.0,
                             sleep=lambda s: None)


def _poisoned(p, g, chunk=32, die_after=5, die_once=False, seed=0):
    return p.res.FaultyChunkIterator(
        p.chunked_pool_iter(p.ChunkedPool(g, chunk_size=chunk)),
        p.res.FaultPlan(seed=seed, die_after_chunks=die_after,
                        die_once=die_once))


def test_breaker_opens_poisoned_pool_healthy_pools_unaffected():
    def scenario(p):
        clock = {"t": 0.0}
        svc = p.Service(default_budget_units=1e9, breaker_threshold=2,
                        breaker_cooldown_s=60.0, clock=lambda: clock["t"],
                        retry_policy=_fast_retry(p))
        p_arr = svc.register_pool(_pool(30, 64, 8))
        p_ok = svc.register_chunked_pool(
            p.ChunkedPool(_pool(31, 128, 8), chunk_size=32))
        p_bad = svc.register_chunked_pool(_poisoned(p, _pool(32, 128, 8)),
                                          cache_bytes=0)
        tickets = [svc.submit(p_bad, k=8, tenant="m") for _ in range(3)]
        tickets += [svc.submit(p_arr, k=8, tenant="m"),
                    svc.submit(p_ok, k=8, tenant="m")]
        svc.drain()
        assert "circuit" in tickets[2].error.lower()
        with pytest.raises(p.res.CircuitOpen):
            svc.submit(p_bad, k=8, tenant="m")
        clock["t"] = 61.0
        tickets.append(svc.submit(p_bad, k=8, tenant="m"))
        svc.drain()
        with pytest.raises(p.res.CircuitOpen):
            svc.submit(p_bad, k=8, tenant="m")
        assert svc.breakers.get(p_bad).state == "open"
        return svc, tickets

    svc, tickets = _run(scenario)
    assert [t.degradation for t in tickets] == (
        ["failed"] * 3 + ["certified"] * 2 + ["failed"])
    acct = svc.admission.account("m")
    assert acct.inflight == 0
    assert acct.used_units == pytest.approx(tickets[3].cost
                                            + tickets[4].cost)


def test_degradation_exhausted_refunds_exactly_once():
    def scenario(p):
        svc = p.Service(default_budget_units=1e9,
                        retry_policy=_fast_retry(p), breaker_threshold=100)
        tickets = [svc.submit(svc.register_pool(_pool(33, 64, 8)), k=4,
                              tenant="m")]
        svc.drain()
        base = svc.admission.account("m").used_units
        pid = svc.register_chunked_pool(_poisoned(p, _pool(34, 128, 8)),
                                        cache_bytes=0)
        for _ in range(2):
            t = svc.submit(pid, k=8, tenant="m")
            svc.drain()
            assert svc.admission.account("m").used_units == \
                pytest.approx(base)
            tickets.append(t)
        return svc, tickets

    _, tickets = _run(scenario)
    assert [t.degradation for t in tickets[1:]] == ["failed", "failed"]


def test_degradation_stochastic_rung_serves_from_cache():
    """Stream dead, no checkpoint, no session: the last rung serves a
    seeded subsample of the admission-warmed cache, labelled; the
    subsample is the reference's draw, so the picks are too."""
    g = _pool(35, 128, 8)

    def scenario(p):
        svc = p.Service(retry_policy=_fast_retry(p))
        pid = svc.register_chunked_pool(_poisoned(p, g))
        svc.scheduler.stream_buffer = 16
        tickets = []
        for _ in range(2):
            tickets.append(svc.submit(pid, k=12))
            svc.drain()
        return svc, tickets

    svc, (t, t2) = _run(scenario)
    assert t.degradation == "stochastic"
    sel = _np(t.result.indices)[_np(t.result.mask)]
    assert len(set(sel.tolist())) == 12
    assert svc.scheduler.stats()["degraded_served"] == {"stochastic": 2}
    assert torch.equal(t2.result.indices, t.result.indices)


def test_degradation_resumed_rung_bit_identical(tmp_path):
    """A solve killed once mid-stream is re-run by the first rung from its
    own mid-solve checkpoint (the port's checkpoint format): the never-
    faulted service's bits, labelled "resumed"."""
    g = _pool(36, 128, 8)
    ref_svc = PORT.Service(retry_policy=_fast_retry(PORT))
    ref_pid = ref_svc.register_chunked_pool(
        tstream.chunked_pool_iter(tloader.ChunkedPool(g, chunk_size=32)),
        cache_bytes=0)
    ref_svc.scheduler.stream_buffer = 16
    ref = ref_svc.select(ref_pid, k=12)

    def scenario(p):
        svc = p.Service(retry_policy=_fast_retry(p),
                        checkpoint_root=str(tmp_path / p.name))
        pid = svc.register_chunked_pool(
            _poisoned(p, g, die_after=12, die_once=True), cache_bytes=0)
        svc.scheduler.stream_buffer = 16
        svc.scheduler.checkpoint_every = 1
        t = svc.submit(pid, k=12)
        svc.drain()
        return svc, [t]

    svc, (t,) = _run(scenario)
    assert t.degradation == "resumed"
    for a, b in zip(t.result[:4], ref[:4]):
        assert torch.equal(a, b)
    assert os.listdir(tmp_path / "port")     # the per-solve directory


def test_degradation_anytime_prefix_rung():
    g = _pool(38, 128, 8)
    gt = torch.from_numpy(g)
    target = gt.sum(dim=0)
    sess = tomp.omp_session_start(gt, target, 24)
    jsess = jomp.omp_session_start(jnp.asarray(g), jnp.asarray(g).sum(0), 24)
    calls = []

    def lookup_of(p):
        def lookup(pool_id, fingerprint, k):
            calls.append((p.name, k))
            if p is PORT:
                idx, w, mask, err = tomp.session_prefix_result(sess, k)
                return SelectionResult(idx, _normalize(w, mask), mask, err)
            from repro.core.gradmatch import SelectionResult as JResult
            from repro.core.gradmatch import _normalize as jnorm
            idx, w, mask, err = jomp.session_prefix_result(jsess, k)
            return JResult(idx, jnorm(w, mask), mask, err)
        return lookup

    def scenario(p):
        svc = p.Service(retry_policy=_fast_retry(p))
        pid = svc.register_chunked_pool(_poisoned(p, g), cache_bytes=0)
        svc.scheduler.session_lookup = lookup_of(p)
        t = svc.submit(pid, k=10)
        svc.drain()
        return svc, [t]

    _, (t,) = _run(scenario)
    assert t.degradation == "anytime-prefix"
    assert calls == [("port", 10), ("jax", 10)]
    assert torch.equal(t.result.indices,
                       tomp.omp_select(gt, target, 24)[0][:10])


def test_deadline_expired_ticket_timeout_refund():
    g = _pool(37, 96, 8)

    def scenario(p):
        clock = {"t": 0.0}
        svc = p.Service(default_budget_units=1e9, clock=lambda: clock["t"])
        pid = svc.register_chunked_pool(p.ChunkedPool(g, chunk_size=32))
        late = svc.submit(pid, k=8, tenant="m", deadline_s=5.0)
        ok = svc.submit(pid, k=6, tenant="m")
        clock["t"] = 9.0
        svc.drain()
        assert "DeadlineExceeded" in late.error
        assert svc.admission.account("m").used_units == pytest.approx(
            ok.cost)
        after = svc.submit(pid, k=4, tenant="m")
        svc.drain()
        return svc, [late, ok, after]

    _, (late, ok, after) = _run(scenario)
    assert (late.status, late.degradation) == ("failed", "timeout")
    assert ok.degradation == "certified" and after.status == "done"


# ---------------------------------------------------------------------------
# stream sessions (tests/test_continual.py's serve cases)
# ---------------------------------------------------------------------------

def test_serve_stream_lifecycle():
    out = []
    for p in BOTH:
        rng = np.random.default_rng(SEED)
        svc = p.Service()
        tgt = rng.standard_normal(8).astype(np.float32)
        sid = svc.open_stream(d=8, k=6, target=tgt, capacity=24,
                              tenant="t1")
        res = None
        for _ in range(6):
            res = svc.push_stream(
                sid, rng.standard_normal((8, 8)).astype(np.float32))
        assert res.stats.admits == 48
        st = svc.stats()
        assert st["streams"]["sessions"] == 1 and st["streams"]["hits"] == 6
        assert st["tenants"]["t1"]["admitted"] == 7     # open + 6 pushes
        assert svc.stream_result(sid).stats.admits == 48
        assert svc.close_stream(sid)
        with pytest.raises(p.serve.SessionGone):
            svc.push_stream(sid, rng.standard_normal((4, 8)))
        out.append((res, st["tenants"]["t1"]["used_units"]))
    (tr, tu), (jr, ju) = out
    _parity(tr[:4], jr[:4], "stream result")
    assert tu == pytest.approx(ju)
    assert (tr.stats.evicts, tr.stats.downdates, tr.stats.resolves) == (
        jr.stats.evicts, jr.stats.downdates, jr.stats.resolves)


def test_serve_stream_refunds_failed_push():
    for p in BOTH:
        svc = p.Service(default_budget_units=1e6)
        sid = svc.open_stream(d=8, k=4, target=np.ones(8, np.float32),
                              capacity=16, tenant="t2")
        used = svc.stats()["tenants"]["t2"]["used_units"]
        with pytest.raises(ValueError, match="incompatible"):
            svc.push_stream(sid, np.ones((4, 5), np.float32))
        assert svc.stats()["tenants"]["t2"]["used_units"] == used
        assert svc.stats()["tenants"]["t2"]["inflight"] == 0


def test_serve_stream_checkpoint_resume(tmp_path):
    """Killed mid-stream and reopened on its checkpoint: bit-equal to the
    stream never killed, inside the port; the reference's coreset."""
    rng = np.random.default_rng(SEED)
    batches = [rng.standard_normal((6, 8)).astype(np.float32)
               for _ in range(8)]
    tgt = np.sum(np.concatenate(batches), axis=0)
    ref = BufferMaintainer(capacity=16, d=8, target=tgt, k=6, compress=True,
                           seed=0, device=CPU)
    jref = JBuffer(capacity=16, d=8, target=tgt, k=6, compress=True, seed=0)
    for i, b in enumerate(batches):
        gids = np.arange(6 * i, 6 * i + 6, dtype=np.int64)
        ref.admit(b, gids=gids)
        jref.admit(b, gids=gids)

    svc = PORT.Service()
    ckpt = str(tmp_path / "svc-stream")
    sid = svc.open_stream(d=8, k=6, target=tgt, capacity=16, seed=0,
                          checkpoint_dir=ckpt)
    for i, b in enumerate(batches[:4]):
        svc.push_stream(sid, b, gids=np.arange(6 * i, 6 * i + 6,
                                               dtype=np.int64))
    svc.close_stream(sid)                            # "killed"
    sid2 = svc.open_stream(d=8, k=6, target=tgt, capacity=16, seed=0,
                           checkpoint_dir=ckpt)      # resumes
    res = None
    for i, b in enumerate(batches[4:], start=4):
        res = svc.push_stream(sid2, torch.from_numpy(b),
                              gids=np.arange(6 * i, 6 * i + 6,
                                             dtype=np.int64))
    assert res.stats.resumes == 1
    assert torch.equal(res.indices, ref.result().indices)
    for a, b in zip(ref.slot_result(),
                    svc.streams.get(sid2).maintainer.slot_result()):
        assert torch.equal(a, b)
    _parity(res[:4], jref.result()[:4], "resumed stream vs reference")


def test_flaky_delivery_matches_fault_free():
    """Transient delivery faults retried away leave the stream's evictions
    and coreset bit-identical to the fault-free stream."""
    rng = np.random.default_rng(SEED)
    batches = [rng.standard_normal((8, 8)).astype(np.float32)
               for _ in range(10)]
    tgt = np.sum(np.concatenate(batches), axis=0)
    policy = tres.RetryPolicy(max_retries=3, backoff_s=0.0,
                              sleep=lambda s: None)
    fault_batches = set(np.random.default_rng((SEED, 1234)).choice(
        len(batches), size=3, replace=False))

    def run(faulty):
        svc = PORT.Service()
        sid = svc.open_stream(d=8, k=6, target=tgt, capacity=20, seed=SEED)
        injected = 0
        for i, b in enumerate(batches):
            state = {"tries": 0}

            def deliver():
                state["tries"] += 1
                if faulty and state["tries"] == 1 and i in fault_batches:
                    raise tres.TransientFault(f"flaky delivery, batch {i}")
                return b

            rows = tres.with_retries(deliver, policy)
            injected += state["tries"] - 1
            svc.push_stream(sid, rows, gids=np.arange(i * 8, i * 8 + 8,
                                                      dtype=np.int64))
        return svc.streams.get(sid).maintainer, injected

    clean, _ = run(False)
    dirty, injected = run(True)
    assert injected > 0
    for a, b in zip(clean.slot_result(), dirty.slot_result()):
        assert torch.equal(a, b)
    assert torch.equal(clean._pool, dirty._pool)
    assert (clean.stats.evicts, clean.stats.downdates) == (
        dirty.stats.evicts, dirty.stats.downdates)


# ---------------------------------------------------------------------------
# the launchers, on the CPU when asked
# ---------------------------------------------------------------------------

def test_serve_selection_smoke_on_the_cpu():
    from repro_torch.launch import serve_selection
    rep = serve_selection.main(["--smoke", "--device", "cpu"])
    assert rep["ok"] and rep["batched_ok"] and rep["extension_ok"]
    assert rep["device"] == "cpu" and rep["batch_sizes"] == [4]
    assert rep["partings"] == []


def test_build_artifacts_smoke_on_the_cpu(tmp_path):
    from repro_torch.launch import build_artifacts
    store = str(tmp_path / "store")
    assert build_artifacts.main(["--smoke", "--device", "cpu", "--store",
                                 store, "--gc"]) == 0
    st = build_artifacts.ArtifactStore(store)
    assert len(st.idents()) == 2
    # the launcher's artifacts serve in a service on the same store
    rng = np.random.default_rng(0)
    g = rng.standard_normal((512, 32)).astype(np.float32)
    svc = PORT.Service(artifact_store=store)
    t = svc.submit(svc.register_pool(g), 48)
    assert t.degradation == "artifact"


def test_build_artifacts_selfcheck_certifies_partings_only_by_hook(tmp_path):
    """A slice that parts from ``omp_select`` fails the self-check unless
    the hook certifies it; the session's bits are required either way."""
    from repro_torch.artifacts import ArtifactStore
    from repro_torch.launch import build_artifacts
    g = _pool(40, 128, 8)
    store = ArtifactStore(str(tmp_path / "s"))
    reports = build_artifacts.build_pools(store, [g], 16, device=CPU)
    ok, recs = build_artifacts._selfcheck(store, [g], reports, 0.5, 1e-10,
                                          True, device=CPU)
    assert ok and [r["k"] for r in recs] == [1, 8, 16]
    assert all(r["session_bits"] and r["oneshot_picks"] for r in recs)


@pytest.mark.parametrize("case", ["equal", "parted-no-hook", "parted-hook",
                                  "parted-hook-raises"])
def test_launchers_hold_picks_or_a_certified_tie(case):
    """The launchers' one rule: equal picks pass, a parting passes only
    where the hook certifies it, and a hook that cannot certify fails."""
    from repro_torch.launch import picks_or_tie
    g = torch.from_numpy(_pool(41, 64, 8))
    target = g.sum(dim=0)
    want = tomp.omp_select(g, target, 6)
    got = list(want)
    if case != "equal":
        got[0] = want[0].clone()
        got[0][3] = int(want[0][4])
    asked = []

    def hook(what, grads, tgt, a, b, solve_a, solve_b):
        asked.append(what)
        if case == "parted-hook-raises":
            raise AssertionError("not a tie")
        return {"parted_at": 3}

    kw = {} if case == "parted-no-hook" else {"on_parting": hook}
    args = ("x", tuple(got), want, g, target, None, None)
    if case == "parted-hook-raises":
        with pytest.raises(AssertionError, match="not a tie"):
            picks_or_tie(*args, **kw)
        return
    ok, parting = picks_or_tie(*args, **kw)
    assert ok == (case != "parted-no-hook")
    assert parting == ({"parted_at": 3} if case == "parted-hook" else None)
    assert asked == (["x"] if case.startswith("parted-hook") else [])
