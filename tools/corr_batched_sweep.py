#!/usr/bin/env python3
"""How the batched scoring kernels' time grows with B, n and d, on one card.

    PYTHONPATH=src python3 tools/corr_batched_sweep.py [n ...]

Times ``corr_batched`` and ``corr_argmax_batched`` (shared pool, every row
masked in) at B = 1, 2, 4, 8, 10, 16 and 32 problems, on f32 pools of n
rows (45 000 and 450 000 unless given) and d = 64 (16-byte lanes) and 65
(scalar lanes, the main path's width), beside one launch of the single
``corr`` kernel and ``torch.mm(grads, vecs.T)`` on the same pool.  Device
times as ``chip_smoke.py`` takes them (``device_ms``).  One JSON line a
shape, then one with the card's name and power limit.  Needs a card and
``nvcc``.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
    from repro_torch.kernels import corr as ck

    sizes = [int(a) for a in argv] or [45_000, 450_000]
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in sizes:
        for d in (64, 65):
            g = torch.randn((n, d), generator=gen, device=dev)
            r = torch.randn((d,), generator=gen, device=dev)
            single = chip_smoke.device_ms(torch, lambda: ck.corr(g, r))
            for b in (1, 2, 4, 8, 10, 16, 32):
                v = torch.randn((b, d), generator=gen, device=dev)
                base = torch.zeros((n, b), device=dev)
                mask = torch.ones((n, b), dtype=torch.bool, device=dev)
                print(json.dumps({
                    "n": n, "d": d, "B": b,
                    "corr_batched_ms": chip_smoke.device_ms(
                        torch, lambda: ck.corr_batched(g, v)),
                    "corr_argmax_batched_ms": chip_smoke.device_ms(
                        torch, lambda: ck.corr_argmax_batched(
                            g, v, base, mask)),
                    "single_corr_ms": single,
                    "torch_mm_ms": chip_smoke.device_ms(
                        torch, lambda: torch.mm(g, v.T))}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
