#!/usr/bin/env python3
"""Where ``lastlayer_grad``'s time goes, on one card.

    PYTHONPATH=src python3 tools/lastlayer_breakdown.py [--reps 30]

Builds variants of ``src/repro_torch/kernels/csrc/lastlayer_grad.cu``, each
with one part of the work taken out by a text substitution, into shared
libraries under ``build/lastlayer_variants`` (one ``nvcc`` per variant, all
at once), and times each in turns against the unchanged source at the main
path's shape: (45 000, 64, 10) f32 hidden and logits, int64 labels, on
both routes (the tile route and the warps, each launched as its plan
gives it).  Parts taken out: the hgrad stores (and, on the warps, the
hidden loads), the resid stores, the softmax; on the tiles all three
(what is left: the bulk copies and the barriers).  Beside them, the card's
floor for the same traffic: ``hgrad.copy_(hidden)`` and
``resid.copy_(logits)`` (two copies, 27.0 MB), and a one-element
``torch.sum`` (the one-operation floor of this timing).  A variant that
drops work leaves wrong outputs by design; whether its outputs equal the
kernel's is printed beside its time.  Device times as ``chip_smoke.py``
takes them (``device_ms``: calls queued behind a sleep, the L2 warm).  One
JSON line a variant, then one with the card's name and power limit.
Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import lastlayer_grad as llg  # noqa: E402

OUT = ROOT / "build" / "lastlayer_variants"
TILE_HGRAD = [("for (int q = t; q < hn / 4; q += kTileThreads) {",
               "for (int q = t; q < 0; q += kTileThreads) {"),
              ("for (int e = hn / 4 * 4 + t; e < hn; e += kTileThreads)",
               "for (int e = hn / 4 * 4 + t; e < 0; e += kTileThreads)")]
TILE_RESID = [("for (int q = t; q < zn / 4; q += kTileThreads)",
               "for (int q = t; q < 0; q += kTileThreads)"),
              ("for (int e = zn / 4 * 4 + t; e < zn; e += kTileThreads)",
               "for (int e = zn / 4 * 4 + t; e < 0; e += kTileThreads)")]
TILE_SOFTMAX = [("own[t] = softmax_row(z + t * nc, nc, "
                 "static_cast<int64_t>(y[t]));", "own[t] = 1.f;")]
WARP_HGRAD = [("for (int64_t j = lane; j < dh; j += 32) hg[j] = own * h[j];",
               "(void)hg;")]
WARP_RESID = [("out[c] = expf(z[c] - m) / sum - (c == y ? 1.f : 0.f);",
               "(void)out;")]
# name: (route, what it measures, substitutions)
VARIANTS = {
    "tiles": ("tiles", "the tile route as it is", []),
    "tiles_no_hgrad": ("tiles", "without the hgrad stores", TILE_HGRAD),
    "tiles_no_resid": ("tiles", "without the resid stores", TILE_RESID),
    "tiles_no_softmax": ("tiles", "without the softmax (own = 1)",
                         TILE_SOFTMAX),
    "tiles_loads_only": ("tiles", "the bulk copies and barriers only",
                         TILE_HGRAD + TILE_RESID + TILE_SOFTMAX),
    "warps": ("warps", "the warp route as it is", []),
    "warps_no_hgrad": ("warps", "without the hidden loads and hgrad stores",
                       WARP_HGRAD),
    "warps_no_resid": ("warps", "without the resid stores", WARP_RESID),
}


def build_variants() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC / "lastlayer_grad.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for name, (_, _, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the "
                                   "source any more")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True)
        (d / "lastlayer_grad.cu").write_text(text)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "lastlayer_grad.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rt_lastlayer_grad.argtypes = [i32, p, p, p, i32, p, p, i64, i64,
                                          i64, i32, i32, i32, i64, p]
        lib.rt_lastlayer_grad.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lastlayer_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, dh, nc = 45_000, 64, 10
    h = torch.randn((n, dh), generator=gen, device=dev).clamp_(min=0)
    z = 3 * torch.randn((n, nc), generator=gen, device=dev)
    y = torch.randint(0, nc, (n,), generator=gen, device=dev)
    resid = torch.empty((n, nc), device=dev)
    hgrad = torch.empty((n, dh), device=dev)
    want = llg.lastlayer_grad(h, z, y, route="warps")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    addrs = [t.data_ptr() for t in (h, z, y, resid, hgrad)]
    plans = {route: llg.lastlayer_plan(n, dh, nc, addrs, sms, 8, route)
             for route in ("tiles", "warps")}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(name):
        plan = plans[VARIANTS[name][0]]
        code = libs[name].rt_lastlayer_grad(
            dev.index or 0, h.data_ptr(), z.data_ptr(), y.data_ptr(), 1,
            resid.data_ptr(), hgrad.data_ptr(), n, dh, nc,
            int(plan.route == "tiles"), plan.rows, plan.stages, plan.grid,
            stream)
        if code != 0:
            raise RuntimeError(f"variant {name}: CUDA error {code}")

    equal = {}
    for name in libs:
        resid.fill_(float("nan"))
        hgrad.fill_(float("nan"))
        call(name)
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(resid, want[0])
                           and torch.equal(hgrad, want[1]))
    src = torch.empty_like(h)
    floors = {
        "copy_floor": ("hgrad.copy_(hidden); resid.copy_(logits): the same "
                       "27.0 MB moved by two copies",
                       lambda: (hgrad.copy_(h), resid.copy_(z))),
        "copy_hidden": ("hgrad.copy_(hidden) alone (23.0 MB)",
                        lambda: hgrad.copy_(h)),
        "one_op_floor": ("a one-element torch.sum: one device operation",
                         lambda: src[:1, :1].sum()),
    }
    times = {name: [] for name in list(libs) + list(floors)}
    order = list(libs) + list(floors)
    for turn in (order, order[::-1]):      # in turns: a, b, ..., b, a
        for name in turn:
            fn = floors[name][1] if name in floors else (
                lambda name=name: call(name))
            times[name].append(chip_smoke.device_ms(torch, fn,
                                                    reps=args.reps))
    for name, (route, what, _) in VARIANTS.items():
        plan = plans[route]
        print(json.dumps({"variant": name, "what": what, "route": route,
                          "plan": [plan.rows, plan.stages, plan.grid,
                                   plan.smem],
                          "shape": [n, dh, nc], "ms": times[name],
                          "equal_to_kernel": equal[name]}))
    for name, (what, _) in floors.items():
        print(json.dumps({"variant": name, "what": what,
                          "ms": times[name]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
