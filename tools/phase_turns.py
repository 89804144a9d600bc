#!/usr/bin/env python3
"""Wall seconds of ``chip_smoke.py``'s phases, from one checkout or another,
for comparing two trees on one card in turns.

    python3 tools/phase_turns.py [--root DIR] [--phases stream,partition]

Imports ``chip_smoke.py`` and ``repro_torch`` from the checkout at ``DIR``
(default: this one), runs the device and build phases, the trainer phase
the others start from, then each named phase (``stream``, ``partition``,
``craig``, ``sessions``), and prints one JSON line with each phase's wall
seconds and the card's name and power limit.  To compare a parent commit
with this one, unpack it under the git-ignored ``build/`` (``git
archive``) and run parent, change, change, parent, each in its own
process: each tree builds its own library.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("stream", "partition", "craig", "sessions")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--phases", default="stream,partition")
    args = ap.parse_args()
    names = args.phases.split(",")
    unknown = set(names) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    import torch
    if not torch.cuda.is_available():
        print("phase_turns: needs a CUDA card", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(root))
    import numpy as np

    import chip_smoke as cs
    import repro_torch  # noqa: F401  (turns TF32 off)
    seconds = {}

    def timed(name, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    card = timed("device", cs.phase_device, torch)
    timed("build", cs.phase_build)
    tr = timed("trainer", cs.phase_trainer, torch, np)
    model, train, val = tr["model"], tr["train"], tr["val"]
    for name in names:
        if name in ("stream", "partition", "craig"):
            fn = getattr(cs, f"phase_{name}")
            timed(name, fn, torch, np, train, val)
        else:
            timed(name, cs.phase_sessions, torch, np, model, train)
    print(json.dumps({"root": str(root), "seconds": seconds,
                      "card": card["smi"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
