#!/usr/bin/env python3
"""How the batched scoring kernels' time grows with B, n and d, on one card.

    PYTHONPATH=src python3 tools/corr_batched_sweep.py [n ...]

Times ``corr_batched`` and ``corr_argmax_batched`` (shared pool) at B = 1,
2, 4, 8, 10, 16 and 32 problems, on f32 pools of n rows (45 000 and
450 000 unless given) and d = 64 (16-byte lanes) and 65 (scalar lanes, the
main path's width), beside one launch of the single ``corr`` kernel and
``torch.mm(grads, vecs.T)`` on the same pool.  The argmax runs with every
row masked in and with per-class selection's masks (one-hot by class over
B classes, a tenth of the rows taken).  Device times as ``chip_smoke.py``
takes them (``device_ms``); each line carries the launch plans (route,
tile, groups, ring, grid).  One JSON line a shape, then one with the
card's name and power limit.  Needs a card and ``nvcc``.

    PYTHONPATH=src python3 tools/corr_batched_sweep.py --routes

times both kernels on each route (row tiles and warps, whatever the plan
would pick) over n and B, on either side of the plan's ``ROW_MIN_ROWS``
and ``ROW_MIN_PAIRS``, beside the route the plan picks.
"""

from __future__ import annotations

import json
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("corr_batched_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import numpy as np
    from repro_torch.kernels import corr as ck

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    if argv == ["--routes"]:
        routes(torch, np, chip_smoke, ck, dev, gen, rng)
        card()
        return 0
    sizes = [int(a) for a in argv] or [45_000, 450_000]
    for n in sizes:
        for d in (64, 65):
            g = torch.randn((n, d), generator=gen, device=dev)
            r = torch.randn((d,), generator=gen, device=dev)
            single = chip_smoke.device_ms(torch, lambda: ck.corr(g, r))
            vec = ck._vec_ok(g) == 1
            for b in (1, 2, 4, 8, 10, 16, 32):
                v = torch.randn((b, d), generator=gen, device=dev)
                base = torch.zeros((n, b), device=dev)
                every = torch.ones((n, b), dtype=torch.bool, device=dev)
                classes = class_masks(torch, np, rng, n, b, dev)
                print(json.dumps({
                    "n": n, "d": d, "B": b,
                    "corr_batched_ms": chip_smoke.device_ms(
                        torch, lambda: ck.corr_batched(g, v)),
                    "corr_argmax_batched_ms": chip_smoke.device_ms(
                        torch, lambda: ck.corr_argmax_batched(
                            g, v, base, every)),
                    "corr_argmax_batched_class_masks_ms":
                        chip_smoke.device_ms(
                            torch, lambda: ck.corr_argmax_batched(
                                g, v, base, classes)),
                    "single_corr_ms": single,
                    "torch_mm_ms": chip_smoke.device_ms(
                        torch, lambda: torch.mm(g, v.T)),
                    "plan_corr_batched": asdict(ck.batched_plan(
                        n, d, b, argmax=False, vec=vec)),
                    "plan_corr_argmax_batched": asdict(ck.batched_plan(
                        n, d, b, argmax=True, vec=vec))}), flush=True)
    card()
    return 0


def class_masks(torch, np, rng, n, b, dev):
    """One-hot by class over B classes, a tenth of the rows taken."""
    labels = rng.integers(0, b, n)
    return torch.from_numpy(np.eye(b, dtype=bool)[labels]
                            & (rng.random((n, 1)) >= 0.1)).to(dev)


# (n, d, B): the main path's width over n and B, the smoke run's ragged
# cases (d = 63), and the 16-byte order (d = 12).
ROUTE_SHAPES = ([(n, 65, b) for b in (1, 3, 10, 32)
                 for n in (1000, 2000, 3000, 4000, 6000, 8000, 12000, 16000,
                           24000, 45000)]
                + [(1001, 63, 1), (1001, 63, 3), (4097, 12, 8),
                   (4097, 12, 40)])


def routes(torch, np, chip_smoke, ck, dev, gen, rng) -> None:
    """Each shape's kernels timed on the row tiles (``ROW_MIN_ROWS`` and
    ``ROW_MIN_PAIRS`` lifted) and on the warps (``ROW_MAX_D`` lowered), and
    the plan's pick; the argmax with every row live and with class
    masks."""
    for n, d, b in ROUTE_SHAPES:
        g = torch.randn((n, d), generator=gen, device=dev)
        v = torch.randn((b, d), generator=gen, device=dev)
        base = torch.zeros((n, b), device=dev)
        every = torch.ones((n, b), dtype=torch.bool, device=dev)
        classes = class_masks(torch, np, rng, n, b, dev)
        vec = ck._vec_ok(g) == 1
        line = {"n": n, "d": d, "B": b, "pairs": n * b,
                "plan_route": ck.batched_plan(n, d, b, argmax=True,
                                              vec=vec).route}
        saved = ck.ROW_MIN_ROWS, ck.ROW_MIN_PAIRS, ck.ROW_MAX_D
        for route, knobs in (("rows", (0, 0, saved[2])),
                             ("warps", (*saved[:2], 0))):
            ck.ROW_MIN_ROWS, ck.ROW_MIN_PAIRS, ck.ROW_MAX_D = knobs
            try:
                assert ck.batched_plan(n, d, b, argmax=True,
                                       vec=vec).route == route
                line[f"{route}_corr_batched_ms"] = chip_smoke.device_ms(
                    torch, lambda: ck.corr_batched(g, v))
                line[f"{route}_argmax_all_live_ms"] = chip_smoke.device_ms(
                    torch, lambda: ck.corr_argmax_batched(g, v, base, every))
                line[f"{route}_argmax_class_masks_ms"] = (
                    chip_smoke.device_ms(torch, lambda: ck.corr_argmax_batched(
                        g, v, base, classes)))
            finally:
                ck.ROW_MIN_ROWS, ck.ROW_MIN_PAIRS, ck.ROW_MAX_D = saved
        print(json.dumps(line), flush=True)


def card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": smi}))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
