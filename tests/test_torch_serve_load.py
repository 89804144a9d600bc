"""The port's overload machinery (``repro_torch/serve``: open-loop load,
priority and weighted fairness, the brownout ladder, deferred pool
admission) against the JAX package's, on the CPU.

The cases of ``tests/test_serve_load.py``, each on both services on an
injected ``SimClock`` with a deterministic ``step_cost``: arrival traces
equal the reference's, and a run gives the reference's ``LoadReport``
(completed, shed, failed, rejected, rungs, fairness ratio, latencies) and
tickets.  Certified rungs keep the one-shot solve's indices, compared to
the port's ``omp_select``; selections across packages meet the ROADMAP's
standard (indices and masks equal, weights and ``err`` to rtol 1e-4 /
atol 1e-5).
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import resilience as jres  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro_torch import resilience as tres  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import omp as tomp  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402

CPU = "cpu"


def _pkg(name, serve, res, stream, loader, service):
    return SimpleNamespace(name=name, serve=serve, res=res, stream=stream,
                           ChunkedPool=loader.ChunkedPool, Service=service)


PORT = _pkg("port", tserve, tres, tstream, tloader,
            lambda **kw: tserve.SelectionService(device=CPU, **kw))
JAX = _pkg("jax", jserve, jres, jstream, jloader, jserve.SelectionService)
BOTH = (PORT, JAX)


def _pool(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _svc(p, clock=None, **kw):
    kw.setdefault("max_batch", 8)
    clock_kw = {} if clock is None else {"clock": clock.now}
    return p.Service(**clock_kw, **kw)


def _fast_retry(p):
    return p.res.RetryPolicy(max_retries=6, backoff_s=0.0,
                             sleep=lambda s: None)


def _flat_cost(out):
    return 0.01


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


def _same_tickets(ts, js):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        what = f"{t.ticket_id} (k {t.request.k}, {t.request.priority})"
        assert (t.ticket_id, t.status, t.degradation, t.batched_with) == (
            j.ticket_id, j.status, j.degradation, j.batched_with), what
        if t.status == "done":
            _parity(t.result[:4], j.result[:4], what)


def _same_reports(rt, rj):
    for key in ("requests", "completed", "shed", "failed", "timeouts",
                "rejected", "rungs", "violations"):
        assert getattr(rt, key) == getattr(rj, key), key
    for key in ("duration_s", "sustained_rps", "p50_ms", "p99_ms",
                "fairness_ratio"):
        assert getattr(rt, key) == pytest.approx(getattr(rj, key)), key
    assert rt.class_p99_ms == pytest.approx(rj.class_p99_ms)
    assert rt.tenant_p99_ms == pytest.approx(rj.tenant_p99_ms)
    assert rt.tenant_served_units == pytest.approx(rj.tenant_served_units)
    _same_tickets([r["ticket"] for r in rt.records],
                  [r["ticket"] for r in rj.records])


def _oneshot(g, k):
    gt = torch.from_numpy(g)
    return tomp.omp_select(gt, gt.sum(dim=0), k)


# ---------------------------------------------------------------------------
# submit-time validation
# ---------------------------------------------------------------------------

def test_expired_deadline_rejected_at_submit():
    for p in BOTH:
        svc = _svc(p)
        pid = svc.register_pool(_pool(0, 64, 8))
        for bad in (0.0, -1.0, -0.001):
            with pytest.raises(ValueError, match="deadline_s must be > 0"):
                svc.submit(pid, k=4, deadline_s=bad)
        assert svc.scheduler.pending() == 0
        assert svc.scheduler.counters["admitted"] == 0
        t = svc.submit(pid, k=4, deadline_s=10.0)
        svc.drain()
        assert t.status == "done"
        with pytest.raises(ValueError, match="unknown priority"):
            svc.submit(pid, k=4, priority="platinum")


# ---------------------------------------------------------------------------
# overload controller, shedding
# ---------------------------------------------------------------------------

def test_overload_controller_hysteresis():
    levels = []
    for p in BOTH:
        oc = p.serve.OverloadController(max_queue=10, brownout_at=0.5,
                                        overload_at=0.8, recover_at=0.2)
        levels.append([oc.observe(q) for q in (0, 5, 4, 8, 6, 3, 2)])
        assert oc.transitions == 4
        assert oc.should_shed("interactive") is False
        oc.observe(9)
        assert oc.should_shed("best-effort") and oc.should_shed("batch")
        assert not oc.should_shed("interactive")
        with pytest.raises(ValueError):
            p.serve.OverloadController(brownout_at=0.9, overload_at=0.5)
    assert levels[0] == levels[1] == [0, 1, 1, 2, 2, 1, 0]


def test_shed_is_labelled_and_never_charged():
    out = []
    for p in BOTH:
        svc = _svc(p, max_queue=8, brownout_at=0.25, overload_at=0.9,
                   recover_at=0.0)
        pid = svc.register_pool(_pool(1, 64, 8))
        svc.admission.set_budget("bg", budget_units=1e9)
        tickets = [svc.submit(pid, k=4, tenant="fg") for _ in range(3)]
        shed = svc.submit(pid, k=4, tenant="bg", priority="best-effort")
        assert shed.status == "shed" and shed.degradation == "shed"
        assert "shed at submit" in shed.error
        assert svc.scheduler.pending() == 3
        assert svc.admission.stats()["bg"]["inflight"] == 0
        assert svc.admission.stats()["bg"]["used_units"] == 0.0
        svc.drain()
        c = svc.scheduler.counters
        assert c["admitted"] == c["completed"] + c["shed"] + c["failed"]
        out.append((svc, tickets + [shed]))
    _same_tickets(out[0][1], out[1][1])
    assert out[0][0].scheduler.counters == out[1][0].scheduler.counters


# ---------------------------------------------------------------------------
# strict priority, weighted fairness
# ---------------------------------------------------------------------------

def _served(p, fill, steps=None, **kw):
    svc = _svc(p, max_batch=1, overload=False, **kw)
    fill(svc)
    served = []
    n = 0
    while svc.scheduler.pending() and (steps is None or n < steps):
        served += [(t.request.tenant, t.request.priority)
                   for t in svc.drain_step()]
        n += 1
    return svc, served


def test_strict_priority_order():
    def fill(svc):
        pid = svc.register_pool(_pool(2, 64, 8))
        for prio in ("best-effort", "best-effort", "batch", "interactive",
                     "batch", "interactive"):
            svc.submit(pid, k=4, priority=prio)

    (_, a), (_, b) = (_served(p, fill) for p in BOTH)
    assert a == b
    assert [pr for _, pr in a] == ["interactive", "interactive", "batch",
                                   "batch", "best-effort", "best-effort"]


def test_weighted_fair_drain_across_tenants():
    def fill(svc):
        pa = svc.register_pool(_pool(3, 64, 8), pool_id="pa")
        pb = svc.register_pool(_pool(4, 64, 8), pool_id="pb")
        svc.admission.set_weight("heavy", 2.0)
        for _ in range(8):
            svc.submit(pa, k=4, tenant="light")
            svc.submit(pb, k=4, tenant="heavy")

    runs = [_served(p, fill, steps=9) for p in BOTH]
    (svc, a), (_, b) = runs
    assert a == b
    tenants = [tn for tn, _ in a]
    assert tenants.count("heavy") == 2 * tenants.count("light")
    svc.drain()
    assert all(s["inflight"] == 0 for s in svc.admission.stats().values())


def test_equal_weights_alternate():
    def fill(svc):
        pa = svc.register_pool(_pool(5, 64, 8), pool_id="pa")
        pb = svc.register_pool(_pool(6, 64, 8), pool_id="pb")
        for _ in range(4):
            svc.submit(pa, k=4, tenant="a")
            svc.submit(pb, k=4, tenant="b")

    (_, a), (_, b) = (_served(p, fill) for p in BOTH)
    assert a == b
    assert [tn for tn, _ in a] in (["a", "b"] * 4, ["b", "a"] * 4)


# ---------------------------------------------------------------------------
# brownout ladder
# ---------------------------------------------------------------------------

def test_cross_k_shared_session_bit_exact_prefixes():
    g = _pool(7, 192, 16)
    out = []
    for p in BOTH:
        svc = _svc(p, brownout_at=0.0, overload_at=0.9, recover_at=0.0)
        pid = svc.register_pool(g)
        ts = [svc.submit(pid, k=k) for k in (6, 12, 18)]
        svc.drain()
        assert svc.scheduler.shared_solves == 1
        assert svc.sessions.stats()["puts"] >= 1
        t2 = svc.submit(pid, k=12)
        svc.drain()
        assert svc.scheduler.shared_solves == 1      # no new solve
        out.append((svc, ts + [t2]))
    _same_tickets(out[0][1], out[1][1])
    ts = out[0][1]
    for t in ts:
        one = _oneshot(g, t.request.k)
        assert torch.equal(t.result.indices, one[0])
        assert torch.equal(t.result.mask, one[2])
    assert [t.degradation for t in ts] == [
        "prefix-shared", "prefix-shared", "certified", "prefix-shared"]
    assert all(t.batched_with == 3 for t in ts[:3])


def test_overload_stochastic_rung_for_non_interactive():
    g = _pool(8, 512, 16)
    out = []
    for p in BOTH:
        svc = _svc(p, max_queue=4, brownout_at=0.25, overload_at=0.5,
                   recover_at=0.0)
        pid = svc.register_pool(g)
        ts = [svc.submit(pid, k=8, priority="batch") for _ in range(3)]
        assert ts[2].status == "shed"
        svc.drain()
        svc2 = _svc(p, max_queue=4, brownout_at=0.25, overload_at=0.5,
                    recover_at=0.0)
        p2 = svc2.register_pool(g)
        us = [svc2.submit(p2, k=8) for _ in range(2)]
        svc2.drain()
        out.append(ts + us)
    _same_tickets(*out)
    ts = out[0]
    assert [t.degradation for t in ts[:2]] == ["stochastic"] * 2
    for t in ts[:2]:
        idx = _np(t.result.indices)
        assert ((idx >= 0) & (idx < 512))[_np(t.result.mask)].all()
    assert {t.degradation for t in ts[3:]} <= {"certified", "prefix-shared"}


# ---------------------------------------------------------------------------
# deferred (async) pool admission
# ---------------------------------------------------------------------------

def test_deferred_warm_matches_sync_admission():
    g = _pool(9, 256, 12)
    out = []
    for p in BOTH:
        svc = _svc(p)
        pid = svc.register_chunked_pool(p.ChunkedPool(g, chunk_size=64),
                                        warm="deferred")
        entry = svc.registry.get(pid)
        assert entry.warm_state == "warming" and entry.target_sum is None
        while not svc.registry.step_warm(pid, max_chunks=1):
            pass
        assert entry.warm_state == "warm" and entry.warmed_chunks == 4
        svc2 = _svc(p)
        pid2 = svc2.register_chunked_pool(p.ChunkedPool(g, chunk_size=64))
        assert svc2.registry.get(pid2).fingerprint == entry.fingerprint
        res, ref = svc.select(pid, k=10), svc2.select(pid2, k=10)
        np.testing.assert_array_equal(_np(res.indices), _np(ref.indices))
        out.append((entry, res))
    (te, tr), (je, jr) = out
    assert te.fingerprint == je.fingerprint and te.pool_id == je.pool_id
    np.testing.assert_allclose(_np(te.target_sum), _np(je.target_sum),
                               rtol=1e-5, atol=1e-4)
    want, n = tstream.streaming_target(
        tstream.chunked_pool_iter(tloader.ChunkedPool(g, chunk_size=64)),
        device=CPU)
    assert n == 256 and torch.equal(te.target_sum, want)
    _parity(tr[:4], jr[:4], "deferred-warm pool")


def test_deferred_warm_does_not_head_of_line_block():
    g_ch = _pool(11, 512, 8)
    out = []
    for p in BOTH:
        clock = p.serve.SimClock()
        svc = _svc(p, clock=clock)
        pa = svc.register_pool(_pool(10, 128, 8))
        pc = svc.register_chunked_pool(p.ChunkedPool(g_ch, chunk_size=64),
                                       warm="deferred")
        svc.scheduler.warm_chunks = 1
        t_ch = svc.submit(pc, k=6)
        t_arr = svc.submit(pa, k=6)
        first = svc.drain_step()
        assert [t.ticket_id for t in first] == [t_arr.ticket_id]
        assert t_ch.status == "queued"
        svc.drain()
        out.append([t_ch, t_arr])
    _same_tickets(*out)
    t_ch = out[0][0]
    assert t_ch.degradation == "certified"
    assert torch.equal(t_ch.result.indices, _oneshot(g_ch, 6)[0])


def test_deferred_warm_deadline_expires_while_warming():
    g = _pool(12, 512, 8)
    out = []
    for p in BOTH:
        clock = p.serve.SimClock()
        svc = _svc(p, clock=clock)
        pid = svc.register_chunked_pool(p.ChunkedPool(g, chunk_size=64),
                                        warm="deferred")
        svc.scheduler.warm_chunks = 1
        t_plain = svc.submit(pid, k=6, deadline_s=0.5)
        t_tgt = svc.submit(pid, k=6, deadline_s=0.5, target=g.sum(0))
        clock.advance(1.0)
        got = svc.drain_step()
        assert {t.ticket_id for t in got} == {t_plain.ticket_id,
                                              t_tgt.ticket_id}
        assert "warming" in t_plain.error
        assert all(s["inflight"] == 0
                   for s in svc.admission.stats().values())
        out.append([t_plain, t_tgt])
    _same_tickets(*out)
    t_plain, t_tgt = out[0]
    assert (t_plain.status, t_plain.degradation) == ("failed", "timeout")
    assert (t_tgt.status, t_tgt.degradation) == ("done", "stochastic")


def _factory(g):
    def chunks():
        yield g[:64], None
        yield g[64:], None
    return chunks


def test_deferred_warm_needs_n_for_factories():
    g = _pool(13, 128, 8)
    for p in BOTH:
        svc = _svc(p)
        with pytest.raises(ValueError, match="needs n="):
            svc.register_chunked_pool(_factory(g), warm="deferred")
        pid = svc.register_chunked_pool(_factory(g), warm="deferred", n=128)
        while not svc.registry.step_warm(pid):
            pass
        assert svc.registry.get(pid).warm_state == "warm"
        res = svc.select(pid, k=5)
        np.testing.assert_array_equal(_np(res.indices),
                                      _np(_oneshot(g, 5)[0]))


def test_deferred_warm_wrong_n_fails_requests_not_queue():
    g = _pool(14, 128, 8)
    out = []
    for p in BOTH:
        svc = _svc(p)
        pa = svc.register_pool(_pool(15, 64, 8))
        pid = svc.register_chunked_pool(_factory(g), warm="deferred", n=999)
        t_bad = svc.submit(pid, k=5)
        t_ok = svc.submit(pa, k=5)
        assert len(svc.drain()) == 2
        assert "warm failed" in t_bad.error
        assert svc.registry.get(pid).warm_state == "failed"
        out.append([t_bad, t_ok])
    _same_tickets(*out)
    assert [t.status for t in out[0]] == ["failed", "done"]


# ---------------------------------------------------------------------------
# breaker and fairness, session stats
# ---------------------------------------------------------------------------

def test_poisoned_tenant_does_not_starve_healthy_tenants():
    g_bad = _pool(16, 128, 8)
    out = []
    for p in BOTH:
        faulty = p.res.FaultyChunkIterator(
            p.stream.chunked_pool_iter(p.ChunkedPool(g_bad, chunk_size=32)),
            p.res.FaultPlan(die_after_chunks=5, seed=0))
        svc = _svc(p, max_batch=1, overload=False, degrade=False,
                   breaker_threshold=2)
        p_bad = svc.register_chunked_pool(faulty)
        p_ok = svc.register_pool(_pool(17, 64, 8))
        svc.admission.set_budget("victim", budget_units=1e9)
        tickets = []
        for _ in range(3):
            tickets.append(svc.submit(p_bad, k=5, tenant="victim"))
            tickets.append(svc.submit(p_ok, k=5, tenant="healthy"))
        assert len(svc.drain()) == 6
        assert svc.breakers.get(p_bad).state == "open"
        stats = svc.admission.stats()
        assert stats["victim"]["used_units"] == 0.0
        assert stats["victim"]["inflight"] == 0
        assert stats["healthy"]["inflight"] == 0
        out.append(tickets)
    _same_tickets(*out)
    assert [t.status for t in out[0]] == ["failed", "done"] * 3


def test_session_store_stats_counters_surfaced():
    stats = []
    for p in BOTH:
        svc = _svc(p)
        pid = svc.register_pool(_pool(18, 96, 8))
        sid, _ = svc.open_session(pid, k=6)
        svc.extend_session(sid, 10)
        svc.close_session(sid)
        with pytest.raises(p.serve.SessionGone):
            svc.extend_session(sid, 12)
        stats.append(svc.stats()["sessions"])
    assert stats[0] == stats[1]
    assert stats[0]["puts"] >= 1 and stats[0]["hits"] >= 1
    assert stats[0]["misses"] >= 1


# ---------------------------------------------------------------------------
# the open-loop load harness
# ---------------------------------------------------------------------------

SPECS = [
    dict(seed=3, requests=40, rate_rps=50.0, pools=("p1", "p2"),
         ks=(4, 8, 12), tenants=("a", "b"), tenant_weights=(3, 1),
         priorities=("interactive", "best-effort"), priority_weights=(1, 1)),
    dict(seed=4, requests=40, rate_rps=50.0, pools=("p1",)),
    dict(seed=9, requests=64, rate_rps=1e6, pools=("r", "c"),
         pool_weights=(3, 1), ks=(64, 128), tenants=("team-a", "team-b"),
         tenant_weights=(2, 1),
         priorities=("interactive", "batch", "best-effort"),
         priority_weights=(5, 3, 2), strategies=("gradmatch", "random"),
         deadline_s={"batch": 0.5}),
]


@pytest.mark.parametrize("spec", SPECS, ids=["mix", "plain", "launcher"])
def test_make_arrivals_is_the_reference_trace(spec):
    a = tserve.make_arrivals(tserve.LoadSpec(**spec))
    b = jserve.make_arrivals(jserve.LoadSpec(**spec))
    assert a == tserve.make_arrivals(tserve.LoadSpec(**spec))
    assert [x.t for x in a] == sorted(x.t for x in a)
    assert [(x.t, x.request.__dict__) for x in a] == [
        (x.t, x.request.__dict__) for x in b]


def test_run_load_invariants_and_determinism():
    def once(p):
        clock = p.serve.SimClock()
        svc = _svc(p, clock=clock, max_queue=16, brownout_at=0.4,
                   overload_at=0.8, recover_at=0.1)
        pid = svc.register_pool(_pool(19, 128, 8))
        spec = p.serve.LoadSpec(seed=5, requests=30, rate_rps=1000.0,
                                pools=(pid,), ks=(4, 8),
                                tenants=("a", "b"),
                                priorities=("interactive", "best-effort"),
                                priority_weights=(2, 1))
        return p.serve.run_load(svc, p.serve.make_arrivals(spec), clock,
                                step_cost=_flat_cost)

    r1, r2, rj = once(PORT), once(PORT), once(JAX)
    assert r1.violations == [] and r1.completed > 0
    assert r1.completed + r1.shed + r1.failed == len(r1.records)
    assert (r1.completed, r1.shed, r1.failed, r1.rejected, r1.rungs) == (
        r2.completed, r2.shed, r2.failed, r2.rejected, r2.rungs)
    assert all(r["ticket"].degradation != "none" for r in r1.records)
    assert r1.p99_ms >= r1.p50_ms >= 0.0
    _same_reports(r1, rj)


def test_run_load_rejections_do_not_break_accounting():
    reps = []
    for p in BOTH:
        clock = p.serve.SimClock()
        svc = _svc(p, clock=clock, max_queue=4, overload=False)
        pid = svc.register_pool(_pool(20, 64, 8))
        spec = p.serve.LoadSpec(seed=6, requests=20, rate_rps=1e6,
                                pools=(pid,), ks=(4,))
        rep = p.serve.run_load(svc, p.serve.make_arrivals(spec), clock,
                               step_cost=_flat_cost)
        assert rep.rejected > 0 and rep.violations == []
        assert rep.completed + rep.rejected + rep.shed + rep.failed == 20
        reps.append(rep)
    _same_reports(*reps)


def test_run_load_under_faults_no_wedge_no_leak():
    g = _pool(21, 256, 8)
    reps = []
    for p in BOTH:
        clock = p.serve.SimClock()
        svc = _svc(p, clock=clock, max_queue=32, retry_policy=_fast_retry(p),
                   brownout_at=0.4, overload_at=0.8, recover_at=0.1)
        faulty = p.res.FaultyChunkIterator(
            p.stream.chunked_pool_iter(p.ChunkedPool(g, chunk_size=64)),
            p.res.FaultPlan(transient_rate=0.2, seed=2))
        p_ch = svc.register_chunked_pool(faulty)
        p_arr = svc.register_pool(_pool(22, 128, 8))
        spec = p.serve.LoadSpec(seed=7, requests=24, rate_rps=1000.0,
                                pools=(p_arr, p_ch), pool_weights=(2, 1),
                                ks=(4, 6), tenants=("a", "b"),
                                priorities=("interactive", "batch"))
        rep = p.serve.run_load(svc, p.serve.make_arrivals(spec), clock,
                               step_cost=_flat_cost)
        assert rep.violations == [] and svc.scheduler.pending() == 0
        assert rep.completed > 0 and faulty.injected["transient"] > 0
        reps.append((rep, p_ch, dict(faulty.injected)))
    (rt, p_ch, ft), (rj, _, fj) = reps
    assert ft == fj                          # the same faults, the same places
    _same_reports(rt, rj)
    want = {k: _oneshot(g, k)[0] for k in (4, 6)}
    checked = 0
    for r in rt.records:
        t = r["ticket"]
        if (t.request.pool_id == p_ch and t.status == "done"
                and t.degradation == "certified"):
            assert torch.equal(t.result.indices, want[t.request.k])
            checked += 1
    assert checked > 0


def test_run_load_fairness_ratio_reported():
    reps = []
    for p in BOTH:
        clock = p.serve.SimClock()
        svc = _svc(p, clock=clock, max_queue=64, overload=False, max_batch=1,
                   max_inflight_per_tenant=64)
        svc.register_pool(_pool(23, 64, 8), pool_id="pa")
        svc.register_pool(_pool(24, 64, 8), pool_id="pb")
        spec = p.serve.LoadSpec(seed=8, requests=24, rate_rps=1e6,
                                pools=("pa", "pb"), ks=(4,),
                                tenants=("a", "b"))
        arr = [p.serve.Arrival(t=a.t, request=p.serve.SelectRequest(
            pool_id="pa" if a.request.tenant == "a" else "pb",
            k=a.request.k, tenant=a.request.tenant, seed=a.request.seed))
            for a in p.serve.make_arrivals(spec)]
        rep = p.serve.run_load(svc, arr, clock, step_cost=_flat_cost)
        assert rep.violations == []
        assert 0.0 < rep.fairness_ratio <= 1.0
        assert set(rep.tenant_served_units) == {"a", "b"}
        reps.append(rep)
    _same_reports(*reps)


def test_run_load_times_steps_on_the_pools_device(monkeypatch):
    """Without ``step_cost`` a step is timed by ``device_timer`` of the
    service's device: a no-op sync on the CPU, one sync a reading on a
    card."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    t = tserve.device_timer(torch.device("cpu"))
    t0 = t()
    assert isinstance(t0, float) and t() >= t0 and syncs == []
    tserve.device_timer(torch.device("cuda", 0))()
    assert syncs == [torch.device("cuda", 0)]
    clock = tserve.SimClock()
    svc = _svc(PORT, clock=clock)
    pid = svc.register_pool(_pool(25, 64, 8))
    readings = []
    real = tserve.loadgen.device_timer

    def spy(device):
        timer = real(device)

        def read():
            readings.append(device)
            return timer()
        return read

    monkeypatch.setattr(tserve.loadgen, "device_timer", spy)
    t0 = time.perf_counter()
    rep = tserve.run_load(svc, tserve.make_arrivals(tserve.LoadSpec(
        seed=1, requests=4, rate_rps=1e6, pools=(pid,), ks=(4,))), clock)
    assert rep.completed == 4 and rep.violations == []
    assert readings and set(readings) == {torch.device("cpu")}
    assert 0.0 < clock.now() <= time.perf_counter() - t0 + 1.0
