#!/usr/bin/env python3
"""Where the tensor-core ``sqdist`` kernel's time goes, on one card.

    PYTHONPATH=src python3 tools/sqdist_breakdown.py [--reps 10]

Builds variants of ``src/repro_torch/kernels/csrc/sqdist_tc.cu``, each
with one part of the work taken out by a text substitution (the TMA
stores, the shared-memory staging, the tensor-core products, the
transposed half of the mirrored writes; the products and the staging
together), into shared libraries under ``build/sqdist_variants`` (one
``nvcc`` per variant, all at once), and times each in turns against the
unchanged source at the craig-resident path's (45 000, 45 000, 65) f32, on
"tc-sym" and on the full grid ("tc"), beside a write-only ``fill_`` of the
same 8.1 GB output (the card's memory written once, in order) and a cuBLAS
TF32 ``torch.mm(a, a.T)`` into it (tile-shaped writes of the same bytes),
and ``pairwise_sim``'s other passes over the result (``clamp_min_``,
``sqrt_``, ``neg_``, ``add_``; the ``max`` it takes without an l_max).  A
variant that drops work gives a wrong matrix by design; its largest error
against the plain version is printed beside its time.  One JSON line a
variant and route, then one with the card's name and power limit.  Needs
a card and ``nvcc``.
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

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import sqdist as sq  # noqa: E402

OUT = ROOT / "build" / "sqdist_variants"
# No-op stand-ins, defined ahead of the kernel.
NOOPS = ("struct TileWalk {", """\
__device__ __forceinline__ void skip_mma(float (&d)[64], uint64_t,
                                         uint64_t, int) {
#pragma unroll
  for (int q = 0; q < 64; ++q) hold(d[q]);
}
__device__ __forceinline__ void skip_st(uint32_t, float) {}
__device__ __forceinline__ void skip_st2(uint32_t, float, float) {}

struct TileWalk {""")
N_STORE = ("tma_store_2d(&out_map, buf + s * kSqBoxBytes, ccol, rs)",
           "(void)0")
T_STORE = ("tma_store_2d(&out_map, buf + (2 + s) * kSqBoxBytes, rs, ccol)",
           "(void)0")
STAGING = [("st_f32x2(nbox + n_off[jj]", "skip_st2(nbox + n_off[jj]"),
           ("st_f32(tbox + t_off[he]", "skip_st(tbox + t_off[he]")]
PRODUCTS = [("wgmma_tf32(acc,", "skip_mma(acc,"),
            ("wgmma_tf32(acc2,", "skip_mma(acc2,")]
# name: (what it measures, substitutions)
VARIANTS = {
    "kernel": ("the source as it is", []),
    "no_transpose": ("the transposed boxes' TMA stores taken out (half the "
                     "output written on tc-sym)", [T_STORE]),
    "no_stores": ("no TMA stores: loads, products, epilogue, staging",
                  [N_STORE, T_STORE]),
    "no_staging": ("no shared-memory staging writes: the TMA stores write "
                   "whatever the boxes hold", [NOOPS] + STAGING),
    "no_products": ("no wgmma products: loads, epilogue, staging, stores",
                    [NOOPS] + PRODUCTS),
    "stores_only": ("the TMA loads and stores and the epilogue's "
                    "arithmetic: no products, no staging writes",
                    [NOOPS] + PRODUCTS + STAGING),
}
SHAPE = (45_000, 65)


def build_variants() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC / "sqdist_tc.cu").read_text()
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
        (d / "sqdist_tc.cu").write_text(text)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "sqdist_tc.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rt_sqdist_tc.argtypes = [i32, p, p, i32, p, p, i64, i64, i64,
                                     i32, i32, i32, p, p, p]
        lib.rt_sqdist_tc.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sqdist_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build_variants()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, d = SHAPE
    rng = np.random.default_rng(n + d)
    a = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(
        dev)
    an = sq._norms(a)
    out = torch.empty((n, n), device=dev)

    def timed(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(args.reps + 1)]
        torch.cuda._sleep(50_000_000)
        ev[0].record()
        for i in range(args.reps):
            fn()
            ev[i + 1].record()
        torch.cuda.synchronize()
        return statistics.median(ev[i].elapsed_time(ev[i + 1])
                                 for i in range(args.reps))

    for route in ("tc-sym", "tc"):
        plan = sq.sqdist_plan(n, n, d, 4, True, sms, route)
        sym = route == "tc-sym"
        split = torch.empty((plan.planes * 8 * (n if sym else 2 * n),),
                            device=dev)

        def call(lib):
            code = lib.rt_sqdist_tc(
                dev.index or 0, a.data_ptr(), a.data_ptr(), 0,
                an.data_ptr(), an.data_ptr(), n, n, d, plan.k8, int(sym),
                plan.grid, split.data_ptr(), out.data_ptr(), stream)
            if code != 0:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        errs = {}
        for name, lib in libs.items():
            out.fill_(-1.0)
            call(lib)
            torch.cuda.synchronize()
            errs[name] = max(
                float((out[lo:lo + 4096] - ref.sqdist_ref(a[lo:lo + 4096], a))
                      .abs().max()) for lo in range(0, n, 4096))
        times = {name: [] for name in libs}
        order = list(libs)
        for turn in (order, order[::-1]):      # in turns: a, b, ..., b, a
            for name in turn:
                times[name].append(timed(lambda: call(libs[name])))
        for name, (what, _) in VARIANTS.items():
            print(json.dumps({"variant": name, "what": what, "route": route,
                              "shape": [n, n, d], "plan": vars(plan),
                              "ms": times[name], "max_abs_err": errs[name]}),
                  flush=True)
    # The resident build's other parts (core/greedy.py: pairwise_sim): its
    # four in-place passes over the (n, n) result, and the max it takes
    # when no l_max is given; each timed on the same 8.1 GB buffer.
    lm = float(2.0 * an[:n].max().sqrt())
    parts = {"clamp_min_": lambda: out.clamp_min_(0.0),
             "sqrt_": lambda: out.sqrt_(),
             "neg_": lambda: out.neg_(),
             "add_": lambda: out.add_(lm),
             "max": lambda: out.max()}
    for name, fn in parts.items():
        out.fill_(1.0)
        print(json.dumps({"variant": f"pairwise_sim {name}", "what": "one "
                          "of pairwise_sim's passes over the (45 000, 45 000)"
                          " f32 result", "ms": timed(fn)}))
    print(json.dumps({"variant": "fill_", "what": "torch fill_ of the "
                      "(45 000, 45 000) f32 output: the card writing 8.1 GB "
                      "once, in order", "ms": timed(lambda: out.fill_(1.0))}))
    # One cuBLAS product writing the same (n, n) f32 output in tiles, TF32
    # (one pass): what a library's tile-shaped writes of it take.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        mm = timed(lambda: torch.mm(a, a.T, out=out))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(json.dumps({"variant": "torch.mm", "what": "torch.mm(a, a.T) in "
                      "TF32 into the same output (cuBLAS; not sqdist)",
                      "ms": mm}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
