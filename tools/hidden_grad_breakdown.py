#!/usr/bin/env python3
"""Where the tensor-core ``hidden_grad`` kernel's time goes, on one card.

    PYTHONPATH=src python3 tools/hidden_grad_breakdown.py [--reps 20]

Builds variants of ``src/repro_torch/kernels/csrc/hidden_grad_tc.cu``, each
with one part of the work taken out by a text substitution (the residual's
exp, the tensor-core products, the flush of the accumulators, the product
loop altogether), into shared libraries under ``build/hidden_grad_variants``
(one ``nvcc`` per variant, all at once), and times each in turns against
the unchanged source at the LM path's shape: (512, 256 000, 2 048) bf16
logits and a tied bf16 head, V cut as the wrapper cuts it.  A variant that
drops work gives wrong numbers by design; its error against the plain
version is printed beside its time (null where it leaves the output
unwritten).  One JSON line a variant, then one
with the card's name and power limit.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import lastlayer_grad as llg  # noqa: E402

OUT = ROOT / "build" / "hidden_grad_variants"
EXP = [("ex2((zz.x - mrow[h]) * kLog2e) * ilrow[h]", "zz.x"),
       ("ex2((zz.y - mrow[h]) * kLog2e) * ilrow[h]", "zz.y")]
MMA = [("wgmma_256<kTied>(acc, hi[ks], desc + ks * kStepUnits);", ""),
       ("wgmma_256<kTied>(acc, lo[ks], desc + ks * kStepUnits);", "")]
NO_FLUSH = [("kTcFlush = 32", "kTcFlush = 1 << 30")]
# name: (what it measures, substitutions)
VARIANTS = {
    "kernel": ("the source as it is", []),
    "no_exp": ("without the exp (p = z)", EXP),
    "no_products": ("without the wgmma products", MMA),
    "loads_and_flush": ("TMA ring, Z reads, split and flushes only",
                        EXP + MMA),
    "loads": ("TMA ring, Z reads and split only (one flush at the end)",
              EXP + MMA + NO_FLUSH),
    "no_flush": ("one flush at the end: the f32 sums lose precision",
                 NO_FLUSH),
    "flush16": ("a flush every 16 stages", [("kTcFlush = 32",
                                             "kTcFlush = 16")]),
    "flush64": ("a flush every 64 stages", [("kTcFlush = 32",
                                             "kTcFlush = 64")]),
    "stats_and_fold": ("no product loop: the row statistics, the launch "
                       "and the slice fold", [(
                           "const int chunks = (v_stop - v_begin + kTcDepth"
                           " - 1) / kTcDepth;", "const int chunks = 0;")]),
}


def build_variants() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC / "hidden_grad_tc.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the "
                                   "source any more")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True)
        (d / "hidden_grad_tc.cu").write_text(text)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "hidden_grad_tc.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rt_hidden_grad_tc.argtypes = [i32, p, i32, p, i32, p, i32, p,
                                          i64, i64, i64, i64, i32, p, p, p]
        lib.rt_hidden_grad_tc.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hidden_grad_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, v, dh = 512, 256_000, 2048
    z = (2 * torch.randn((n, v), generator=gen, device=dev)).to(
        torch.bfloat16)
    y = torch.randint(0, v, (n,), generator=gen, device=dev)
    w = (0.02 * torch.randn((v, dh), generator=gen, device=dev)).to(
        torch.bfloat16).T
    want = ref.hidden_grad_ref(z, y, w)
    scale = float(want.abs().max())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, slice_ = llg.tc_vocab_split(n, v, dh, sms)
    stats = torch.empty((n, 2), device=dev)
    part = torch.empty((splits, n, dh), device=dev)
    out = torch.empty((n, dh), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib):
        code = lib.rt_hidden_grad_tc(
            dev.index or 0, z.data_ptr(), 1, y.data_ptr(), 1, w.data_ptr(),
            1, stats.data_ptr(), n, v, dh, slice_, splits, part.data_ptr(),
            out.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"launch failed: CUDA error {code}")

    def device_ms(lib):
        for _ in range(3):
            call(lib)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(args.reps + 1)]
        torch.cuda._sleep(50_000_000)
        ev[0].record()
        for i in range(args.reps):
            call(lib)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return statistics.median(ev[i].elapsed_time(ev[i + 1])
                                 for i in range(args.reps))

    times = {name: [] for name in libs}
    errs = {}
    for name, lib in libs.items():
        part.fill_(float("nan"))     # what a variant leaves unwritten
        out.fill_(float("nan"))      # shows as nan, not a stale result
        call(lib)
        torch.cuda.synchronize()
        err = float((out - want).abs().max()) / scale
        errs[name] = err if math.isfinite(err) else None
    order = list(libs)
    for turn in (order, order[::-1]):      # in turns: a, b, ..., b, a
        for name in turn:
            times[name].append(device_ms(libs[name]))
    for name, (what, _) in VARIANTS.items():
        print(json.dumps({"variant": name, "what": what,
                          "shape": [n, v, dh], "splits": splits,
                          "ms": times[name], "rel_err": errs[name]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
