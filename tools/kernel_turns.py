#!/usr/bin/env python3
"""``lastlayer_grad`` and ``bound_max`` at their paths' shapes, from one
checkout or another, for comparing two trees on one card in turns.

    python3 tools/kernel_turns.py [--src DIR] [--save FILE] [--compare FILE]
    python3 tools/kernel_turns.py --routes
    python3 tools/kernel_turns.py --picks [--src DIR] [--save F] [--compare F]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``) and
times each kernel's wrapper as its callers call it, on inputs made from a
seed with numpy, so two trees see the same bits: ``lastlayer_grad`` at the
main path's (45 000, 64, 10) and the stream path's (1 024, 64, 10), int64
labels; ``bound_max`` at the streaming arenas (88 064, 10) and (86 016,
65) bf16, their masks with the empty slots and a tenth of the cached rows
off, ``abs`` on, the threshold the median live bound.  ``--save`` keeps the
outputs, ``--compare`` says whether they equal a saved run's bit for bit.
To compare a parent commit with this one, unpack it under the git-ignored
``build/`` (``git archive``) and run it and this tree in turns (parent,
change, change, parent), each in its own process: each tree builds its own
library.  Device times as ``chip_smoke.py`` takes them (``device_ms``).

``--routes`` times both routes of both kernels of this checkout over n, on
either side of the plans' ``TILE_MIN_ROWS`` and ``BOUND_MIN_ROWS``, and
over d and C, beside the route each plan picks: the data behind the
plans' rules.

``--picks`` runs selections through the entry points instead, on the main
path's data (45 000 rows of ``make_classification``) and a seeded
``mlp()``'s proxies (``lastlayer_grad`` on all 45 000 rows): per-class
GRAD-MATCH, and streaming GRAD-MATCH over the bias proxies (the (n, 10)
arena) and over the per-gradient proxies (the (n, 65) arena), each with
its seconds and ``SelectStats``; ``--save`` / ``--compare`` then hold the
proxies, picks, weights and stats of two trees against each other.

One JSON line a shape, then one with the card's name and power limit.
Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

LLG_SHAPES = ((45_000, 64, 10), (1_024, 64, 10))
# The arenas a 256 MiB cache builds over 45 000 rows in chunks of 1 024 (86
# slots) and 2 048 (42 slots); chip_smoke.py fails if a path scans another.
ARENAS = ((88_064, 10, 1_024), (86_016, 65, 2_048))
ROWS = 45_000


def llg_inputs(torch, np, n, dh, nc, dev):
    rng = np.random.default_rng(n + dh + nc)
    h = np.maximum(rng.standard_normal((n, dh)), 0).astype(np.float32)
    z = (3 * rng.standard_normal((n, nc))).astype(np.float32)
    y = rng.integers(0, nc, n)
    return [torch.from_numpy(a).to(dev) for a in (h, z, y)]


def arena_inputs(torch, np, n, d, used, dev):
    """An arena of n rows whose first ``used`` rows are cached (a tenth of
    them taken) and whose other slots are empty; rows past 45 000 in the
    last chunk are padding."""
    rng = np.random.default_rng(n + d)
    rows = torch.from_numpy(np.round(rng.standard_normal((n, d)) * 8) / 8
                            ).to(dev).to(torch.bfloat16)
    r = torch.from_numpy((np.round(rng.standard_normal(d) * 8) / 8).astype(
        np.float32)).to(dev)
    norms = rows.float().norm(dim=1)
    errn = torch.from_numpy((np.abs(rng.standard_normal(n)) / 700).astype(
        np.float32)).to(dev)
    acc = d * 2.0 ** -23 * 1.25
    m = np.zeros(n, dtype=bool)
    m[:used] = rng.random(used) > 0.1
    m[ROWS:used] = False
    mask = torch.from_numpy(m).to(dev)
    u = (rows.float() @ r).abs() + (errn + acc * norms) * r.norm()
    th = u[mask].median().reshape(())
    return rows, norms, errn, r, acc, th, mask


def card_line() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}))


def turns(torch, np, device_ms, args) -> None:
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import lastlayer_grad as llg_k
    dev = torch.device("cuda")
    outs = {}
    for n, dh, nc in LLG_SHAPES:
        h, z, y = llg_inputs(torch, np, n, dh, nc, dev)
        outs[f"lastlayer_grad {n}"] = llg_k.lastlayer_grad(h, z, y)
        ms = [device_ms(torch, lambda: llg_k.lastlayer_grad(h, z, y))
              for _ in range(args.repeats)]
        print(json.dumps({"kernel": "lastlayer_grad", "shape": [n, dh, nc],
                          "src": str(args.src), "ms": ms}), flush=True)
    for n, d, chunk in ARENAS:
        a = arena_inputs(torch, np, n, d, (ROWS // chunk + 1) * chunk, dev)
        outs[f"bound_max {n}"] = corr_k.bound_max(*a, absolute=True)
        ms = [device_ms(torch, lambda: corr_k.bound_max(*a, absolute=True))
              for _ in range(args.repeats)]
        print(json.dumps({"kernel": "bound_max", "shape": [n, d],
                          "src": str(args.src), "ms": ms}), flush=True)
    outs = {k: [t.cpu() for t in v] for k, v in outs.items()}
    if args.save:
        torch.save(outs, args.save)
    if args.compare:
        other = torch.load(args.compare)
        print(json.dumps({"equal_to": str(args.compare), "bits": {
            k: all(torch.equal(a, b) for a, b in zip(v, other[k]))
            for k, v in outs.items()}}))


def picks(torch, args) -> None:
    import time

    from repro_torch.configs.paper import mlp
    from repro_torch.core import selection as sel_lib
    from repro_torch.data.synthetic import make_classification, split
    from repro_torch.train.steps import make_proxy_fn
    from repro_torch.train.trainer import AdaptiveTrainer, TrainerConfig
    train, val = split(make_classification(n=50_000, dim=64, num_classes=10,
                                           seed=0), seed=1)
    model = AdaptiveTrainer(mlp(), TrainerConfig(strategy="gradmatch"),
                            train, val).init_model()
    pcg, bias = make_proxy_fn(model)(train.x, train.y)
    k = 4500
    outs = {"proxies": [pcg.cpu(), bias.cpu()]}
    runs = {"gradmatch": lambda: sel_lib.select(
                "gradmatch", None, pcg, k, labels=train.y, num_classes=10),
            "gradmatch-stream bias": lambda: sel_lib.select(
                "gradmatch-stream", None, bias, k),
            "gradmatch-stream per-gradient": lambda: sel_lib.select(
                "gradmatch-stream", None, pcg, k)}
    stats = {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats[name] = vars(res.stats) if res.stats is not None else None
        outs[name] = [res.indices.cpu(), res.weights.cpu(), res.mask.cpu(),
                      torch.as_tensor(float(res.err))]
        print(json.dumps({"selection": name, "src": str(args.src),
                          "seconds": seconds, "stats": stats[name]}),
              flush=True)
    outs["stats"] = stats
    if args.save:
        torch.save(outs, args.save)
    if args.compare:
        other = torch.load(args.compare)
        print(json.dumps({"equal_to": str(args.compare), "bits": {
            k: (v == other[k] if k == "stats" else
                all(torch.equal(a, b) for a, b in zip(v, other[k])))
            for k, v in outs.items()}}))


def routes(torch, np, device_ms) -> None:
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import lastlayer_grad as llg_k
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (256, 1024, 2048, 4096, 8192, 12288, 16384, 24576, 45000,
              200000):
        h, z, y = llg_inputs(torch, np, n, 64, 10, dev)
        ms = {route: device_ms(torch, lambda: llg_k.lastlayer_grad(
            h, z, y, route=route)) for route in ("tiles", "warps")}
        plan = llg_k.lastlayer_plan(n, 64, 10, [0] * 5, sms)
        print(json.dumps({"kernel": "lastlayer_grad", "shape": [n, 64, 10],
                          "ms": ms, "plan": plan.route}), flush=True)
    for nc in (2, 4, 8, 16, 20, 31, 32):
        h, z, y = llg_inputs(torch, np, 45000, 64, nc, dev)
        ms = {route: device_ms(torch, lambda: llg_k.lastlayer_grad(
            h, z, y, route=route)) for route in ("tiles", "warps")}
        plan = llg_k.lastlayer_plan(45000, 64, nc, [0] * 5, sms)
        print(json.dumps({"kernel": "lastlayer_grad", "shape": [45000, 64, nc],
                          "ms": ms, "plan": plan.route}), flush=True)
    shapes = [(n, d) for n in (1024, 4096, 16384, 400000) for d in (10, 65)]
    shapes += [(88064, d) for d in (10, 16, 32, 48, 64, 65, 96, 100, 129,
                                    256)]
    for n, d in shapes:
        a = arena_inputs(torch, np, n, d, n // 2, dev)
        ms = {route: device_ms(torch, lambda: corr_k.bound_max(
            *a, absolute=True, route=route)) for route in ("tiles", "rows")}
        plan = corr_k.bound_max_plan(n, d, 2, 0, 0, sms)
        print(json.dumps({"kernel": "bound_max", "shape": [n, d],
                          "live": int(a[-1].sum()), "ms": ms,
                          "plan": plan.route}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--save", type=Path)
    ap.add_argument("--compare", type=Path)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--picks", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import device_ms
    import repro_torch  # noqa: F401  (turns TF32 off)
    if args.routes:
        routes(torch, np, device_ms)
    elif args.picks:
        picks(torch, args)
    else:
        turns(torch, np, device_ms, args)
    card_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
