#!/usr/bin/env python3
"""Where the tensor-core ``fl_gain_argmax_otf`` kernel's time goes, on one
card.

    PYTHONPATH=src python3 tools/fl_gain_breakdown.py [--reps 10]

Builds variants of ``src/repro_torch/kernels/csrc/fl_gain_tc.cu``, each
with one part of the work taken out or swapped by a text substitution (the
epilogue, the tensor-core products, both; the branch-free root swapped for
``sqrtf``, or its tiny-input scaling taken on every element), into shared
libraries under ``build/fl_gain_variants`` (one ``nvcc`` per variant, all
at once), and times each in turns against the unchanged source at the two
CRAIG paths' shapes, (45 000, 65) and (45 000, 10), on seeded numpy inputs
drawn as ``chip_smoke.py``'s ``kernels_fl`` phase draws them.  A variant that drops work gives wrong gains by design;
its largest gain error against the plain version, over the largest gain,
is printed beside its time.  One JSON line a variant and shape, then one
with the card's name and power limit.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import greedy  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import fl_gain as fl  # noqa: E402

OUT = ROOT / "build" / "fl_gain_variants"
EPILOGUE = [("""        const float d2 = rn[h] + (e ? c2.y : c2.x) -
                         2.f * acc[4 * j + 2 * h + e];
        const float x = fmaxf(d2, 0.f);
        const float root = kExact ? sqrt_rn(x) : sqrt_fast(x);
        const float sv = (lm - root) * ok[h];
        gacc[2 * j + e] += fmaxf(sv - cv[h], 0.f);""",
             "        gacc[2 * j + e] += acc[4 * j + 2 * h + e];")]
ROOT_BY = "kExact ? sqrt_rn(x) : sqrt_fast(x)"
PRODUCTS = [(f"      wgmma_tf32(acc, a_desc + {a} * kA, b_desc + {b} * kB, "
             f"{s});", "")
            for a, b, s in (("(K8 + c)", "c", "c > 0"), ("c", "(K8 + c)", "1"),
                            ("c", "c", "1"))]
# name: (what it measures, substitutions)
VARIANTS = {
    "kernel": ("the source as it is", []),
    "sqrtf": ("the epilogue's root by sqrtf (its slow-path branch)",
              [(ROOT_BY, "sqrtf(x)")]),
    "scaled": ("every root by sqrt_rn (the scaling for tiny inputs on "
               "every element)", [(ROOT_BY, "sqrt_rn(x)")]),
    "no_epilogue": ("the TMA ring and the products; each element only "
                    "added to its column's sum", EPILOGUE),
    "no_products": ("the TMA ring and the epilogue, without the wgmma "
                    "products", PRODUCTS),
    "ring": ("the TMA ring, the waits and the fold only",
             EPILOGUE + PRODUCTS),
}
SHAPES = ((45_000, 65), (45_000, 10))


def build_variants() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC / "fl_gain_tc.cu").read_text()
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
        (d / "fl_gain_tc.cu").write_text(text)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "fl_gain_tc.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rt_fl_gain_argmax_otf_tc.argtypes = [
            i32, p, p, p, p, p, p, i64, i64, i32, i32, p, p, p, p, p, p]
        lib.rt_fl_gain_argmax_otf_tc.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fl_gain_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build_variants()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n, d in SHAPES:
        rng = np.random.default_rng(n + d)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        g = t(rng.standard_normal((n, d)).astype(np.float32))
        lm = greedy.default_l_max(g)
        sqn = (g * g).sum(1)
        cover = t(np.abs(rng.standard_normal(n)).astype(np.float32) * 8)
        rok = t(rng.random(n) > 0.1)
        mask = t(rng.random(n) < 0.7)
        want = ref.fl_gain_argmax_otf_ref(g, cover, rok, mask, lm,
                                          sqnorms=sqn)[0]
        scale = float(want.abs().max())
        plan = fl.fl_gain_otf_plan(n, d, "tc")
        split = torch.empty((2 * n * plan.d_pad,), device=dev)
        ws = torch.empty((fl.OTF_WS_WORDS,), dtype=torch.int64, device=dev)
        gains = torch.empty((n,), device=dev)
        idx = torch.empty((), dtype=torch.int32, device=dev)
        val = torch.empty((), device=dev)

        def call(lib):
            code = lib.rt_fl_gain_argmax_otf_tc(
                dev.index or 0, g.data_ptr(), sqn.data_ptr(),
                cover.data_ptr(), rok.data_ptr(), mask.data_ptr(),
                lm.data_ptr(), n, d, plan.d_pad // 8, plan.stages,
                split.data_ptr(), ws.data_ptr(), gains.data_ptr(),
                idx.data_ptr(), val.data_ptr(), stream)
            if code != 0:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        def device_ms(lib):
            for _ in range(2):
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

        errs = {}
        for name, lib in libs.items():
            call(lib)
            torch.cuda.synchronize()
            errs[name] = float((gains - want).abs().max()) / scale
        times = {name: [] for name in libs}
        order = list(libs)
        for turn in (order, order[::-1]):      # in turns: a, b, ..., b, a
            for name in turn:
                times[name].append(device_ms(libs[name]))
        for name, (what, _) in VARIANTS.items():
            print(json.dumps({"variant": name, "what": what,
                              "shape": [n, d], "plan": vars(plan),
                              "ms": times[name], "rel_err": errs[name]}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
