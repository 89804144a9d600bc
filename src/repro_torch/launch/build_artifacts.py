"""Offline selection-artifact pipeline (DESIGN.md §12), after
``repro/launch/build_artifacts.py``.

Precomputes durable anytime-OMP trajectories for a set of pools on the
card and commits them to a content-addressed ``ArtifactStore``: the
"solve once, serve any k" fast path.  A serving deployment pointed at the
same store root (``SelectionService(artifact_store=...)``) then answers
gradmatch requests for these pools at any ``k <= k_max`` in O(1) at
submit, rung ``"artifact"``.

Key congruence: the artifact is keyed by the pool's full-content digest
and the byte-exact SHA of the default target the registry computes at
admission.  The pipeline registers each pool through a real
``PoolRegistry`` and builds from the registered entry's
``content_digest`` / ``target_sum``, so the serving path's lookup key
matches, including the device sum that produced the target.

``--smoke`` builds small pools, then self-checks every artifact at 3
budgets: each slice bit-equal to the anytime session engine (indices,
mask, weights, err) and index-identical to a live ``omp_select`` (weights
to rtol 1e-4 / atol 1e-5); it exits non-zero on a violation.  Runs on
the card unless ``--device cpu`` asks for the CPU; a missing card raises.

Run:  PYTHONPATH=src python -m repro_torch.launch.build_artifacts --smoke
      PYTHONPATH=src python -m repro_torch.launch.build_artifacts \\
          --pools 4 --pool-size 8192 --dim 64 --k-max 512
"""

from __future__ import annotations

import argparse
import pathlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.artifacts import (ArtifactStore, artifact_key_for,
                                   build_artifact)
from repro_torch.core.omp import (omp_select, omp_session_start,
                                  session_result)
from repro_torch.device import resolve_device
from repro_torch.launch import picks_or_tie
from repro_torch.serve.registry import PoolRegistry

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_STORE = REPO_ROOT / "ARTIFACTS_selection_torch"


def build_pools(store: ArtifactStore, pools, k_max: int, lam: float = 0.5,
                eps: float = 1e-10, positive: bool = True,
                device: str | torch.device | None = None) -> list[dict]:
    """Register each (n, d) pool (a tensor or a host array) on ``device``,
    solve to ``k_max`` there, commit; returns one report dict per pool
    (ident, build seconds, dims)."""
    registry = PoolRegistry(max_pools=max(len(pools), 1), artifacts=store,
                            device=device)
    reports = []
    for g in pools:
        pid = registry.register(g)
        entry = registry.get(pid)
        t0 = time.perf_counter()
        key, ident = build_artifact(
            store, entry.grads, entry.target_sum, k_max, lam=lam, eps=eps,
            positive=positive, fingerprint=entry.content_digest)
        dt = time.perf_counter() - t0
        reports.append({"pool_id": pid, "ident": ident, "n": entry.n,
                        "d": entry.d, "k_max": int(k_max),
                        "build_s": dt})
        print(f"build_artifacts,pool={pid},ident={ident},n={entry.n},"
              f"d={entry.d},k_max={k_max},build_s={dt:.2f}", flush=True)
    return reports


def _selfcheck(store: ArtifactStore, pools, reports, lam, eps, positive,
               device: str | torch.device | None = None,
               on_parting: Optional[Callable] = None
               ) -> tuple[bool, list[dict]]:
    """The differential guarantee on every built artifact at 3 k-slices:
    bit-equal to the session engine, index-identical to ``omp_select``.

    Where the slice parts from ``omp_select``'s picks, ``on_parting(what,
    grads, target, got, want, solve_got, solve_want)`` (if given) may
    certify the parting as a tie; it raises if it cannot.  Without it a
    parting fails the check.  Returns (ok, one record per slice).
    """
    dev = resolve_device(device)
    ok, records = True, []
    for g, rep in zip(pools, reports):
        gd = (g if isinstance(g, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(g, np.float32))
              ).to(dev, torch.float32)
        target = gd.sum(dim=0)
        key = artifact_key_for(gd, target, lam, eps, positive)
        art = store.get(key)
        if art is None:
            print(f"build_artifacts,selfcheck={rep['ident']},"
                  f"error=unloadable", flush=True)
            ok = False
            continue
        kw = dict(lam=lam, eps=eps, positive=positive)
        for k in sorted({1, rep["k_max"] // 2, rep["k_max"]}):
            idx, w, mask, err = art.slice(k)
            got = (torch.from_numpy(np.array(idx)).to(dev),
                   torch.from_numpy(np.array(w)).to(dev),
                   torch.from_numpy(np.array(mask)).to(dev),
                   torch.tensor(err, dtype=torch.float32, device=dev))
            sess = session_result(omp_session_start(gd, target, k, **kw))
            one = omp_select(gd, target, k, **kw)
            session_bits = all(torch.equal(a, b) for a, b in zip(got, sess))
            close = bool(torch.allclose(got[1], one[1], rtol=1e-4,
                                        atol=1e-5))
            # the hook is asked only about a slice that is the session's
            tied, parting = picks_or_tie(
                f"artifact {rep['ident']} at k {k} vs omp_select", got, one,
                gd, target,
                lambda t: session_result(
                    omp_session_start(gd, target, t, **kw)),
                lambda t: omp_select(gd, target, t, **kw),
                on_parting if session_bits else None)
            picks = tied and parting is None
            rec = {"ident": rep["ident"], "k": k,
                   "session_bits": session_bits, "oneshot_picks": picks,
                   "oneshot_weights": close, "parting": parting}
            same = session_bits and tied and (close or parting is not None)
            records.append(rec)
            print(f"build_artifacts,selfcheck={rep['ident']},k={k},"
                  f"ok={same}", flush=True)
            ok &= same
    return ok, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=str(DEFAULT_STORE),
                    help="artifact store root (default: "
                         "ARTIFACTS_selection_torch at the repo root)")
    ap.add_argument("--pools", type=int, default=2)
    ap.add_argument("--pool-size", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--k-max", type=int, default=512)
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gc", action="store_true",
                    help="mark-then-sweep the store after building")
    ap.add_argument("--smoke", action="store_true",
                    help="small pools + differential self-check")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' asks for "
                         "the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        args.pools = min(args.pools, 2)
        args.pool_size = min(args.pool_size, 512)
        args.dim = min(args.dim, 32)
        args.k_max = min(args.k_max, 48)

    rng = np.random.default_rng(args.seed)
    pools = [rng.standard_normal(
        (args.pool_size, args.dim)).astype(np.float32)
        for _ in range(args.pools)]
    store = ArtifactStore(args.store)
    reports = build_pools(store, pools, args.k_max, lam=args.lam,
                          device=device)
    ok = True
    if args.smoke:
        ok, _ = _selfcheck(store, pools, reports, args.lam, 1e-10, True,
                           device=device)
    if args.gc:
        swept = store.gc()
        print(f"build_artifacts,gc_objects={swept['objects_swept']},"
              f"gc_tmp={swept['tmp_swept']}", flush=True)
    print(f"build_artifacts,store={args.store},"
          f"artifacts={store.stats()['artifacts']},"
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
