"""Selection-service launcher: queued multi-tenant selection over shared
pools, after ``repro/launch/serve_selection.py``.

A ``SelectionService`` is stood up on the card, synthetic proxy pools are
registered, a queue of ``SelectRequest``s from several tenants is admitted
and drained (same-pool requests micro-batch into one batched OMP solve),
and one client runs an anytime budget extension ``k -> k'``.

``--smoke`` self-checks the two correctness claims the service makes and
exits non-zero on violation:

* every batched result is index-identical to a direct per-request
  ``omp_select`` over the same pool and target;
* the ``k -> k'`` session continuation is index-identical to a one-shot
  ``k'`` solve.

``--load`` switches the launcher to the open-loop overload scenario
(DESIGN.md §10): seeded Poisson arrivals from two tenants with unequal
offered load and weights, a priority mix, and one fault-injected chunked
pool, driven on a virtual clock through the overload-aware scheduler.  It
prints per-tenant p99, the degradation-rung distribution, the weighted
fairness ratio and the shed/refund accounting, and exits non-zero if an
accounting invariant is violated.

Runs on the card unless ``--device cpu`` asks for the CPU; a missing card
raises.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_selection --smoke
      PYTHONPATH=src python -m repro_torch.launch.serve_selection --load
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.omp import (omp_select, omp_select_batched,
                                  omp_session_start, session_result)
from repro_torch.device import resolve_device
from repro_torch.launch import picks_or_tie
from repro_torch.serve import SelectionService
from repro_torch.serve.scheduler import _bucket_b


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small pools + differential self-checks")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--pools", type=int, default=2)
    ap.add_argument("--pool-size", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--k-extend", type=int, default=192,
                    help="anytime extension budget (> --k)")
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load", action="store_true",
                    help="open-loop overload scenario (DESIGN.md §10)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="arrival rate in req/s for --load "
                         "(0 = one saturating burst)")
    ap.add_argument("--fault-rate", type=float, default=0.15,
                    help="transient fault rate on the chunked pool "
                         "(--load)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' asks for "
                         "the CPU)")
    return ap


def main(argv=None, on_parting: Optional[Callable] = None) -> dict:
    """Run the launcher; returns its report (``report["ok"]``).

    Where a self-check's picks part from the one-shot solve,
    ``on_parting(what, grads, target, got, want, solve_got, solve_want)``
    (if given) may certify the parting as a tie and returns its record;
    it raises if it cannot.  Without it a parting fails the check.
    """
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        args.pool_size = min(args.pool_size, 1024)
        args.k = min(args.k, 64)
        args.k_extend = min(args.k_extend, 96)
    if args.load:
        return _run_load(args, device)

    svc = SelectionService(max_batch=args.max_batch,
                           max_queue=max(args.requests * 2, 16),
                           device=device)
    rng = np.random.default_rng(args.seed)
    pools = []
    for p in range(args.pools):
        g = rng.standard_normal(
            (args.pool_size, args.dim)).astype(np.float32)
        pools.append((svc.register_pool(g), g))

    # Queue: round-robin tenants over round-robin pools, then one drain:
    # requests sharing a pool land in the same micro-batch.
    t0 = time.perf_counter()
    tickets = []
    for i in range(args.requests):
        pid, _ = pools[i % len(pools)]
        tickets.append(svc.submit(pid, k=args.k,
                                  tenant=f"tenant-{i % args.tenants}"))
    done = svc.drain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    serve_wall = time.perf_counter() - t0

    failures = []
    partings = []
    if any(t.status != "done" for t in done):
        failures.append("request-failed")
    batch_sizes = sorted({t.batched_with for t in done})

    def certified(what, got, want, grads, target, solve_got, solve_want):
        ok, parting = picks_or_tie(what, got, want, grads, target,
                                   solve_got, solve_want, on_parting)
        if parting is not None:
            partings.append({"what": what, **parting})
        return ok

    batched_ok = True
    if args.smoke:
        for t in done:
            gd = torch.from_numpy(dict(pools)[t.request.pool_id]).to(device)
            target = gd.sum(dim=0)
            one = omp_select(gd, target, k=args.k)
            bb = min(_bucket_b(t.batched_with), args.max_batch)

            def batched(k, gd=gd, target=target, bb=bb):
                out = omp_select_batched(gd, target.expand(bb, -1), k=k)
                return tuple(x[0] for x in out)

            batched_ok &= certified(
                f"{t.ticket_id} batched vs omp_select", tuple(t.result[:4]),
                one, gd, target, batched,
                lambda k, gd=gd, target=target: omp_select(gd, target, k))
        if not batched_ok:
            failures.append("batched-vs-sequential")

    # Anytime budget extension on pool 0: k -> k'.
    pid0, g0 = pools[0]
    t0 = time.perf_counter()
    sid, _ = svc.open_session(pid0, k=args.k, tenant="tenant-0")
    ext = svc.extend_session(sid, args.k_extend)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    extend_wall = time.perf_counter() - t0
    g0d = torch.from_numpy(g0).to(device)
    t_sum = g0d.sum(dim=0)
    extension_ok = certified(
        "extension vs one-shot", tuple(ext[:4]),
        omp_select(g0d, t_sum, k=args.k_extend), g0d, t_sum,
        lambda k: session_result(omp_session_start(g0d, t_sum, k)),
        lambda k: omp_select(g0d, t_sum, k))
    if not extension_ok:
        failures.append("extension-vs-oneshot")

    stats = svc.stats()
    report = {
        "device": str(device),
        "requests": len(done),
        "pools": args.pools,
        "k": args.k,
        "k_extend": args.k_extend,
        "batch_sizes": batch_sizes,
        "batches_run": stats["scheduler"]["batches_run"],
        "serve_wall_s": round(serve_wall, 3),
        "extend_wall_s": round(extend_wall, 3),
        "batched_ok": batched_ok,
        "extension_ok": extension_ok,
        "partings": partings,
        "failures": failures,
        "ok": not failures,
    }
    print(report)
    return report


def _run_load(args, device: torch.device) -> dict:
    """Open-loop overload scenario: two tenants with unequal offered load
    and weights, a priority mix, one healthy resident pool and one
    fault-injected chunked pool."""
    from repro_torch.core import streaming as stream_lib
    from repro_torch.data.loader import ChunkedPool
    from repro_torch.resilience import (FaultPlan, FaultyChunkIterator,
                                        RetryPolicy)
    from repro_torch.serve import LoadSpec, SimClock, make_arrivals, run_load

    n = args.pool_size
    requests = max(args.requests, 24) if args.requests == 8 \
        else args.requests
    if args.smoke:
        n, requests = min(n, 1024), min(requests, 16)
    k_small = max(args.k // 2, 4)
    ks = (k_small, args.k)
    retry = RetryPolicy(max_retries=25, backoff_s=0.0,
                        sleep=lambda s: None)
    clock = SimClock()
    svc = SelectionService(
        max_batch=args.max_batch, max_queue=max(2 * requests, 16),
        max_inflight_per_tenant=2 * requests, clock=clock.now,
        retry_policy=retry, brownout_at=0.4, overload_at=0.85,
        recover_at=0.1, device=device)
    # team-a: 2/3 of the offered load at weight 2; team-b: 1/3 at weight
    # 1: the fairness ratio below is about weighted shares.
    svc.admission.set_weight("team-a", 2.0)
    svc.admission.set_weight("team-b", 1.0)
    rng = np.random.default_rng(args.seed)
    g = rng.standard_normal((n, args.dim)).astype(np.float32)
    g_ch = rng.standard_normal((n, args.dim)).astype(np.float32)
    pid = svc.register_pool(g, pool_id="load-resident")
    faulty = FaultyChunkIterator(
        stream_lib.chunked_pool_iter(ChunkedPool(g_ch,
                                                 chunk_size=max(n // 8,
                                                                64))),
        FaultPlan(transient_rate=args.fault_rate, seed=args.seed))
    pid_ch = svc.register_chunked_pool(faulty, pool_id="load-chunked")
    for k in ks:                                   # warm off-trace
        svc.select(pid, k=k)
        svc.select(pid_ch, k=k)
    sid, _ = svc.open_session(pid, k=max(ks))
    svc.close_session(sid)

    spec = LoadSpec(
        seed=args.seed, requests=requests,
        rate_rps=args.rate if args.rate > 0 else 1e6,
        pools=(pid, pid_ch), pool_weights=(3, 1), ks=ks,
        tenants=("team-a", "team-b"), tenant_weights=(2, 1),
        priorities=("interactive", "batch", "best-effort"),
        priority_weights=(5, 3, 2))
    rep = run_load(svc, make_arrivals(spec), clock)

    report = {
        "mode": "load",
        "device": str(device),
        "requests": rep.requests,
        "completed": rep.completed,
        "shed": rep.shed,
        "failed": rep.failed,
        "rejected": rep.rejected,
        "sustained_rps": round(rep.sustained_rps, 2),
        "p50_ms": round(rep.p50_ms, 2),
        "p99_ms": round(rep.p99_ms, 2),
        "tenant_p99_ms": {t: round(v, 2)
                          for t, v in sorted(rep.tenant_p99_ms.items())},
        "rungs": dict(sorted(rep.rungs.items())),
        "fairness_ratio": (None if rep.fairness_ratio is None
                           else round(rep.fairness_ratio, 3)),
        "faults_injected": dict(faulty.injected),
        "overload": svc.scheduler.stats()["overload"],
        "violations": rep.violations,
        "ok": rep.ok and rep.completed > 0,
    }
    print(report)
    return report


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
