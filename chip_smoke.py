#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path — the paper's Algorithm 1: last-layer proxies,
per-class GRAD-MATCH and GRAD-MATCHPB selection, weighted SGD — and the
CRAIG and GLISTER baselines through their entry points on the card, and
holds every kernel of those paths against its plain PyTorch version.
Phases, one JSON line each:

  1. device   the card's name and power limit;
  2. build    nvcc builds the kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels  each kernel against its plain version at the shapes each path
              gives it and at ragged, tied, ``abs`` and all-masked inputs,
              with its time, its plain version's time, the time of the
              nearest single PyTorch call where there is one, and its bound;
  4. trainer  ``mlp()`` at full width on 45 000 rows: per-class GRAD-MATCH
              (budget 0.1, 2 epochs, R = 1), then one GRAD-MATCHPB
              selection.  The launch counts are set to 0 before each path
              and read after it: every kernel of a path must launch on it;
  5. solve    the per-class solve and the GRAD-MATCHPB solve, each with the
              kernels and with the plain versions, both on the card, on the
              same proxies: ``err`` must agree;
  6. trace    a ``torch.profiler`` trace of the first rounds of one class's
              OMP solve at the main path's shape: the card's busy share and
              the host time and launches inside the NNLS loop against the
              rest of the round;
  7. craig    the same data and widths through CRAIG and GLISTER, each path
              with its launch counts read on its own: ``craig-lazy`` trained
              end to end (per-gradient proxies (45 000, 65), so the
              similarity is rebuilt on the fly), one ``craig-lazy-otf``,
              ``craig-stochastic``, ``craig-pb`` and ``glister`` selection,
              and lazy CRAIG over a resident similarity built by
              ``sqdist`` (``craig-resident``).  Then, on the card: the resident and the
              on-the-fly lazy selections with the kernels and with the plain
              versions (same 4 500 picks, ``err`` to rtol 1e-5), and the
              dense oracle against the resident lazy greedy at k = 256.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power limit,
and the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero; without a card, or without the repo's
``src/`` beside it, it exits 2 and prints no result.

Times: ``ms`` is the median device time of one call, measured with CUDA
events between calls queued behind a sleep kernel, so the host's launch
cost is not in it (the L2 cache stays warm, as in the OMP round loop that
re-reads the same pool).  ``bound_ms`` is the larger of the bytes the call
must move (each input read once, each output written once) over the card's
published memory bandwidth and its f32 operations over the card's
published f32 rate outside the tensor cores.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published dense peaks (NVIDIA data sheets): memory bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}

# The main path's size: make_classification(n=50 000) split 90/10 gives the
# 45 000 training rows of CIFAR-10's train set; budget 0.1 selects 4 500.
POOL_ROWS = 50_000
ROWS = 45_000
BUDGET = 0.1
K = int(ROWS * BUDGET)
BATCH = 64
PB_ROWS = ROWS // BATCH   # GRAD-MATCHPB's mini-batch proxies: (703, 10)
WIDE = (8192, 512)        # a full-width column cache of the wide regime
TRACE_ROUNDS = 32         # OMP rounds in the profiler trace
PATHS = ("gradmatch", "gradmatch-pb")
CRAIG_PATHS = ("craig-lazy", "craig-lazy-otf", "craig-stochastic",
               "craig-pb", "glister", "craig-resident")
DENSE_K = 256             # rounds of the dense-oracle check

KERNEL_SOURCES = {
    "corr": ("src/repro_torch/kernels/csrc/corr.cu",
             "src/repro/kernels/corr.py:51"),
    "corr_argmax": ("src/repro_torch/kernels/csrc/corr.cu",
                    "src/repro/kernels/corr.py:234"),
    "lastlayer_grad": ("src/repro_torch/kernels/csrc/lastlayer_grad.cu",
                       "src/repro/kernels/lastlayer_grad.py:60"),
    "fl_gain_argmax": ("src/repro_torch/kernels/csrc/fl_gain.cu",
                       "src/repro/kernels/fl_gain.py:85"),
    "fl_gain_argmax_otf": ("src/repro_torch/kernels/csrc/fl_gain.cu",
                           "src/repro/kernels/fl_gain.py:174"),
    "sqdist": ("src/repro_torch/kernels/csrc/sqdist.cu",
               "src/repro/kernels/sqdist.py:51"),
}
# The path whose shape gives each kernel's top-level numbers.
MAIN_PATH = {"corr": "gradmatch", "corr_argmax": "gradmatch",
             "lastlayer_grad": "gradmatch",
             "fl_gain_argmax": "craig-resident",
             "fl_gain_argmax_otf": "craig-lazy", "sqdist": "craig-resident"}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def peaks(name: str) -> tuple[float, float]:
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name:
            return PEAKS[key]
    raise RuntimeError(f"no published peaks for {name!r}")


def device_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn()`` over ``reps`` calls queued behind a
    sleep kernel, one event pair per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(50_000_000)       # ~25 ms: the host queues every call
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return {"name": name, "smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build()
    build.lib()
    emit("build", library=str(path.relative_to(ROOT)),
         nvcc_seconds=build.build_seconds,
         load_seconds=time.perf_counter() - t0)


def phase_kernels(torch, np, card: dict) -> dict:
    """Each kernel against its plain version on the card; returns, per
    kernel and per path, the record at the shape that path gives it."""
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import lastlayer_grad as llg_k
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bw, flops = peaks(card["name"])
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def bound(nbytes, nflops):
        by_bytes, by_ops = nbytes / bw * 1e3, nflops / flops * 1e3
        return (max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations")

    records = {name: {} for name in KERNEL_SOURCES}

    # -- corr: per-class (45 000, 65) and PB (703, 10) f32, wide (8192, 512)
    #    f32 and bf16, ragged ------------------------------------------------
    for n, d, dt, paths in ((ROWS, 65, "float32", ("gradmatch",)),
                            (PB_ROWS, 10, "float32", ("gradmatch-pb",)),
                            (*WIDE, "float32", ()),
                            (*WIDE, "bfloat16", ()),
                            (1000, 700, "float32", ())):
        g = t(rng.standard_normal((n, d)).astype(np.float32)).to(
            getattr(torch, dt))
        r = t(rng.standard_normal(d).astype(np.float32))
        got, want = corr_k.corr(g, r), ref.corr_ref(g, r)
        err = float((got - want).abs().max())
        scale = float(torch.sqrt((g.float() ** 2).sum(1).max()
                                 * (r ** 2).sum()))
        check(torch.allclose(got, want, rtol=1e-5,
                             atol=1e-6 * max(scale, 1.0)),
              f"corr kernel disagrees at ({n}, {d}) {dt}: max err {err}")
        ms = device_ms(torch, lambda: corr_k.corr(g, r))
        plain = device_ms(torch, lambda: ref.corr_ref(g, r))
        lib_ms = device_ms(torch, lambda: torch.mv(g, r.to(g.dtype)))
        b, by = bound(n * d * g.element_size() + 4 * d + 4 * n, 2 * n * d)
        emit("kernels", kernel="corr", shape=[n, d], dtype=dt,
             max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
             bound_ms=b)
        for path in paths:
            records["corr"][path] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib_ms, shape=[n, d])

    # -- corr_argmax: narrow (G, -r, 0) and wide (C, w, c0), both abs ------
    def argmax_case(c, w, base, mask, absolute, what):
        gi, gv = corr_k.corr_argmax(c, w, base, mask, absolute=absolute)
        ri, rv = ref.corr_argmax_ref(c, w, base, mask, absolute=absolute)
        gi, ri, gv, rv = int(gi), int(ri), float(gv), float(rv)
        if gi != ri:
            # Only a true near-tie under another summation order may differ.
            s = base - c.float() @ w
            s = s.abs() if absolute else s
            a, b = float(s[gi]), float(s[ri])
            check(bool(mask[gi]) and abs(a - b) <= 1e-6 * abs(b),
                  f"corr_argmax {what}: index {gi} vs {ri}, scores {a} {b}")
        if np.isfinite(rv):
            check(abs(gv - rv) <= 1e-5 * abs(rv) + 1e-6,
                  f"corr_argmax {what}: value {gv} vs {rv}")
        else:
            check(gv == rv, f"corr_argmax {what}: value {gv} vs {rv}")
        return abs(gv - rv) if np.isfinite(rv) else 0.0

    labels = t(rng.integers(0, 10, ROWS))
    cases = []
    g = t(rng.standard_normal((ROWS, 65)).astype(np.float32))
    r = t(rng.standard_normal(65).astype(np.float32))
    zeros = torch.zeros((ROWS,), device=dev)
    for absolute in (False, True):
        cases.append(("narrow", g, -r, zeros, labels == 3, absolute,
                      ("gradmatch",) if not absolute else ()))
    gp = t(rng.standard_normal((PB_ROWS, 10)).astype(np.float32))
    rp = t(rng.standard_normal(10).astype(np.float32))
    cases.append(("pb-narrow", gp, -rp,
                  torch.zeros((PB_ROWS,), device=dev),
                  t(rng.random(PB_ROWS) < 0.9), False, ("gradmatch-pb",)))
    cc = t(rng.standard_normal(WIDE).astype(np.float32))
    w = t(rng.standard_normal(WIDE[1]).astype(np.float32) / 16)
    c0 = t(rng.standard_normal(WIDE[0]).astype(np.float32) * 3)
    wmask = t(rng.random(WIDE[0]) < 0.9)
    for absolute in (False, True):
        cases.append(("wide", cc, w, c0, wmask, absolute, ()))
    gr = t(rng.standard_normal((1000, 700)).astype(np.float32))
    cases.append(("ragged", gr, t(rng.standard_normal(700).astype(
        np.float32)), t(rng.standard_normal(1000).astype(np.float32)),
        t(rng.random(1000) < 0.5), True, ()))
    g10 = t(rng.standard_normal((ROWS, 10)).astype(np.float32))
    v10 = t(rng.standard_normal(10).astype(np.float32))
    cases.append(("glister", g10, -v10, zeros, t(rng.random(ROWS) < 0.9),
                  False, ("glister",)))
    dup = g.clone()
    dup[1::2] = dup[::2]
    every = torch.ones((ROWS,), dtype=torch.bool, device=dev)
    cases.append(("ties", dup, -r, zeros, every, True, ()))
    cases.append(("all-masked", g, -r, zeros,
                  torch.zeros((ROWS,), dtype=torch.bool, device=dev), False,
                  ()))
    for what, c, wv, base, mask, absolute, paths in cases:
        err = argmax_case(c, wv, base, mask, absolute, what)
        n, p = c.shape
        ms = device_ms(torch, lambda: corr_k.corr_argmax(
            c, wv, base, mask, absolute=absolute))
        plain = device_ms(torch, lambda: ref.corr_argmax_ref(
            c, wv, base, mask, absolute=absolute))
        b, by = bound(n * p * 4 + 4 * p + 4 * n + n + 8, 2 * n * p)
        emit("kernels", kernel="corr_argmax", case=what, shape=[n, p],
             absolute=absolute, max_abs_err=err, ms=ms, plain_ms=plain,
             bound_ms=b)
        for path in paths:
            records["corr_argmax"][path] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None, shape=[n, p])
    gi, _ = corr_k.corr_argmax(dup, -r, zeros, every, absolute=True)
    check(int(gi) % 2 == 0, "corr_argmax: a tie did not go to the lower row")

    # -- lastlayer_grad: both paths n = 45 000, d_h = 64, C = 10 -----------
    for n, dh, nc, ldt, paths in ((ROWS, 64, 10, "int64",
                                   PATHS + CRAIG_PATHS),
                                  (ROWS, 64, 10, "int32", ()),
                                  (1001, 84, 37, "int64", ())):
        h = t(np.maximum(rng.standard_normal((n, dh)), 0).astype(np.float32))
        z = t(3 * rng.standard_normal((n, nc)).astype(np.float32))
        y = t(rng.integers(0, nc, n)).to(getattr(torch, ldt))
        resid, hgrad = llg_k.lastlayer_grad(h, z, y)
        rr, rh = ref.lastlayer_grad_ref(h, z, y)
        err = max(float((resid - rr).abs().max()),
                  float((hgrad - rh).abs().max()))
        check(torch.allclose(resid, rr, rtol=1e-5, atol=1e-6)
              and torch.allclose(hgrad, rh, rtol=1e-5, atol=1e-6),
              f"lastlayer_grad disagrees at ({n}, {dh}, {nc}): {err}")
        ms = device_ms(torch, lambda: llg_k.lastlayer_grad(h, z, y))
        plain = device_ms(torch, lambda: ref.lastlayer_grad_ref(h, z, y))
        nbytes = 2 * 4 * n * (dh + nc) + y.element_size() * n
        b, by = bound(nbytes, n * (4 * nc + dh))
        emit("kernels", kernel="lastlayer_grad", shape=[n, dh, nc],
             labels=ldt, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b)
        for path in paths:
            records["lastlayer_grad"][path] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None, shape=[n, dh, nc])
    torch.cuda.synchronize()
    return records


def phase_kernels_fl(torch, np, card: dict, records: dict) -> None:
    """``fl_gain_argmax``, ``fl_gain_argmax_otf`` and ``sqdist`` against
    their plain versions on the card, at the shapes the CRAIG paths give
    them and at ragged, tied and all-masked inputs; adds their records."""
    from repro_torch.core import greedy
    from repro_torch.kernels import fl_gain as fl_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import sqdist as sq_k

    dev = torch.device("cuda")
    bw, flops = peaks(card["name"])
    rng = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def bound(nbytes, nflops):
        by_bytes, by_ops = nbytes / bw * 1e3, nflops / flops * 1e3
        return (max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations")

    def close(got, want, rtol=1e-4, atol=1e-4):
        """Max abs error and whether |got - want| <= atol + rtol |want|,
        in row blocks (the matrices here are up to 8.1 GB)."""
        err, ok = 0.0, True
        for lo in range(0, got.shape[0], 4096):
            a, b = got[lo:lo + 4096], want[lo:lo + 4096]
            diff = (a - b).abs_()
            err = max(err, float(diff.max()))
            ok = ok and bool((diff <= atol + rtol * b.abs()).all())
        return err, ok

    def check_scan(got, want, what):
        """Gains to rtol/atol 1e-4; the index equal unless the two gains
        are within that tolerance; an all-masked input (0, -inf)."""
        (gg, gi, gv), (wg, wi, wv) = got, want
        err, ok = close(gg[None], wg[None])
        check(ok, f"{what}: gains differ, max abs err {err}")
        gi, wi, gv, wv = int(gi), int(wi), float(gv), float(wv)
        if not np.isfinite(wv):
            check(gi == 0 and gv == wv, f"{what}: all-masked gave "
                  f"({gi}, {gv})")
            return err
        if gi != wi:
            a, b = float(wg[gi]), float(wg[wi])
            check(abs(a - b) <= 1e-4 + 1e-4 * abs(b),
                  f"{what}: index {gi} vs {wi}, gains {a} vs {b}")
        check(abs(gv - wv) <= 1e-4 + 1e-4 * abs(wv),
              f"{what}: value {gv} vs {wv}")
        return err

    def record(err, ms, plain, lib, b, by, shape):
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                    bound_by=by, library_ms=lib, shape=shape)

    # -- fl_gain_argmax: the resident (45 000, 45 000) similarity of 65-wide
    #    rows, then ragged n, all masked, a planted tie ---------------------
    for n in (ROWS, 1, 129, 4097):
        g = t(rng.standard_normal((n, 65)).astype(np.float32))
        # Built as the resident path builds it: sqdist is bitwise symmetric
        # (fmaf(a, b, c) == fmaf(b, a, c)), so row j is column j.
        sim = greedy.build_sim(g, dist_fn=sq_k.sqdist)
        cover = t(np.abs(rng.standard_normal(n)).astype(np.float32) * 4)
        mask = t(rng.random(n) < 0.7)
        for what, m in (("random", mask),
                        ("all-masked", torch.zeros_like(mask))):
            if what == "all-masked" and n != 4097:
                continue
            got = fl_k.fl_gain_argmax(sim, cover, m)
            want = ref.fl_gain_argmax_ref(sim, cover, m)
            err = check_scan(got, want, f"fl_gain_argmax n={n} {what}")
            emit("kernels", kernel="fl_gain_argmax", shape=[n, n],
                 case=what, max_abs_err=err)
        if n != ROWS:
            continue
        # The lazy engine's block refresh sums similarity rows with torch
        # where the scan kernel sums columns; their relative gap, over every
        # candidate, is what the resident certification margin (1e-6) has
        # to cover.
        gains = got[0]
        rows = torch.cat([(sim[lo:lo + 4096] - cover[None, :]).clamp_min_(
            0.0).sum(1) for lo in range(0, n, 4096)])
        block_gap = float(((rows - gains).abs() / gains.abs()).max())
        plain_gap = float(((want[0] - gains).abs() / gains.abs()).max())
        plain_block_gap = float(((want[0] - rows).abs() / rows.abs()).max())
        ms = device_ms(torch, lambda: fl_k.fl_gain_argmax(sim, cover, mask))
        plain = device_ms(torch, lambda: ref.fl_gain_argmax_ref(
            sim, cover, mask), reps=10, warmup=2)
        b, by = bound(4 * n * n + 13 * n + 8, 3 * n * n)
        records["fl_gain_argmax"]["craig-resident"] = record(
            err, ms, plain, None, b, by, [n, n])
        emit("kernels", kernel="fl_gain_argmax", shape=[n, n], ms=ms,
             plain_ms=plain, bound_ms=b, block_vs_kernel_rel_gap=block_gap,
             plain_vs_kernel_rel_gap=plain_gap,
             plain_vs_block_rel_gap=plain_block_gap)
        check(block_gap < 1e-6, f"fl_gain_argmax: the block refresh's row "
              f"sums and the kernel's column sums differ by {block_gap} "
              "relative, more than the 1e-6 certification margin")
        del sim, got, want, rows, gains
        torch.cuda.empty_cache()
    n = 4097
    sim = torch.ones((n, n), device=dev)
    cover = torch.zeros((n,), device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    mask[0] = False
    _, gi, gv = fl_k.fl_gain_argmax(sim, cover, mask)
    check(int(gi) == 1 and float(gv) == float(n),
          f"fl_gain_argmax all-tied: ({int(gi)}, {float(gv)}), not (1, {n})")
    sim[:, [3001, 4000]] = 2.0
    _, gi, _ = fl_k.fl_gain_argmax(sim, cover, mask)
    check(int(gi) == 3001, f"fl_gain_argmax planted tie: {int(gi)}, not "
          "3001")
    del sim

    # -- fl_gain_argmax_otf: the two proxies the trainer feeds it, a tenth
    #    of the rows invalid; then ragged n and all masked -----------------
    # (No n = 1 case: a lone column's gain is its own diagonal term
    # sqrt(2|g|^2 - 2 g.g), rounding noise of ~sqrt(eps)|g| that the
    # kernel's FFMA dot and cuBLAS round differently; the card tests hold
    # it at the reference's on-the-fly tolerance, 1e-3.)
    for n, d, path in ((ROWS, 65, "craig-lazy"), (ROWS, 10, "craig-lazy-otf"),
                       (129, 65, None), (4097, 10, None)):
        g = t(rng.standard_normal((n, d)).astype(np.float32))
        lm = greedy.default_l_max(g)
        sqn = (g * g).sum(1)
        cover = t(np.abs(rng.standard_normal(n)).astype(np.float32) * 8)
        rok = t(rng.random(n) > 0.1)
        mask = t(rng.random(n) < 0.7)
        for what, m in (("random", mask),
                        ("all-masked", torch.zeros_like(mask))):
            if what == "all-masked" and n != 4097:
                continue
            got = fl_k.fl_gain_argmax_otf(g, cover, rok, m, lm, sqnorms=sqn)
            want = ref.fl_gain_argmax_otf_ref(g, cover, rok, m, lm,
                                              sqnorms=sqn)
            err = check_scan(got, want, f"fl_gain_argmax_otf ({n}, {d}) "
                             f"{what}")
            emit("kernels", kernel="fl_gain_argmax_otf", shape=[n, d],
                 case=what, max_abs_err=err)
        if path is None:
            continue
        ms = device_ms(torch, lambda: fl_k.fl_gain_argmax_otf(
            g, cover, rok, mask, lm, sqnorms=sqn), reps=10, warmup=2)
        plain = device_ms(torch, lambda: ref.fl_gain_argmax_otf_ref(
            g, cover, rok, mask, lm, sqnorms=sqn), reps=5, warmup=1)
        # operations: the dot products (2 n^2 d) and 8 f32 operations of the
        # epilogue per similarity element; the sqrt is not counted.
        b, by = bound(4 * n * d + 14 * n + 12, 2 * n * n * d + 8 * n * n)
        records["fl_gain_argmax_otf"][path] = record(
            err, ms, plain, None, b, by, [n, d])
        emit("kernels", kernel="fl_gain_argmax_otf", shape=[n, d], ms=ms,
             plain_ms=plain, bound_ms=b, bound_by=by)

    # -- sqdist: the resident build of the main path's proxies (f32), and a
    #    ragged bf16 case --------------------------------------------------
    for n, m, d, dt in ((ROWS, ROWS, 65, "float32"),
                        (4097, 1000, 130, "bfloat16"),
                        (129, 65, 3, "float32")):
        a = t(rng.standard_normal((n, d)).astype(np.float32)).to(
            getattr(torch, dt))
        bb = a if n == m else t(rng.standard_normal((m, d)).astype(
            np.float32)).to(getattr(torch, dt))
        got = sq_k.sqdist(a, bb)
        want = ref.sqdist_ref(a, bb)
        err, ok = close(got, want)
        check(ok, f"sqdist ({n}, {m}, {d}) {dt}: max abs err {err}")
        check(float(got.min()) >= 0.0, "sqdist gave a negative distance")
        del got, want
        torch.cuda.empty_cache()
        ms = device_ms(torch, lambda: sq_k.sqdist(a, bb), reps=10, warmup=2)
        plain = device_ms(torch, lambda: ref.sqdist_ref(a, bb), reps=5,
                          warmup=1)
        lib = (device_ms(torch, lambda: torch.cdist(a, bb).square(), reps=5,
                         warmup=1) if dt == "float32" else None)
        b, by = bound(a.element_size() * (n + m) * d + 4 * n * m,
                      2 * n * m * d + 4 * n * m)
        emit("kernels", kernel="sqdist", shape=[n, m, d], dtype=dt,
             max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
             bound_ms=b, bound_by=by)
        if n == ROWS:
            records["sqdist"]["craig-resident"] = record(
                err, ms, plain, lib, b, by, [n, m, d])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_trainer(torch, np) -> dict:
    """The main path's two paths through their entry points, the launch
    counts set to 0 before each and read after it."""
    from repro_torch.configs.paper import PaperHParams, mlp
    from repro_torch.data.synthetic import make_classification, split
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import AdaptiveTrainer, TrainerConfig

    ds = make_classification(n=POOL_ROWS, dim=64, num_classes=10, seed=0)
    train, val = split(ds, seed=1)
    check(train.n == ROWS, f"train split has {train.n} rows")
    cfg = mlp()
    tcfg = TrainerConfig(strategy="gradmatch", budget=BUDGET, epochs=2,
                         batch_size=BATCH, hp=PaperHParams(select_every=1),
                         eval_every=1)
    trainer = AdaptiveTrainer(cfg, tcfg, train, val)
    model = trainer.init_model()
    pb = AdaptiveTrainer(cfg, replace(tcfg, strategy="gradmatch-pb"),
                         train, val)

    counts = {}
    ops.reset_launch_counts()
    rep = trainer.run(model)
    counts["gradmatch"] = ops.launch_counts()
    ops.reset_launch_counts()
    sel_pb, pb_seconds = pb._run_selection(model, None)
    counts["gradmatch-pb"] = ops.launch_counts()

    emit("trainer", strategy="gradmatch", rows=train.n, budget=BUDGET,
         epochs=2, select_every=1, selection_rounds=rep.selection_rounds,
         selection_seconds=rep.selection_seconds,
         wall_seconds=rep.wall_seconds, final_acc=rep.final_acc,
         subset_size=rep.subset_size, pb_selection_seconds=pb_seconds,
         pb_subset_size=int(sel_pb.mask.sum()), launches=counts)
    for path in PATHS:
        for name in ("corr", "corr_argmax", "lastlayer_grad"):
            check(counts[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")
    check(rep.selection_rounds == 2, "expected two selection rounds")
    check(rep.subset_size == K,
          f"per-class selection kept {rep.subset_size} rows, not {K}")
    # 140 SGD steps reach ~0.6 on this mixture; chance is 0.1.
    check(np.isfinite(rep.final_acc) and rep.final_acc > 0.3,
          f"final accuracy {rep.final_acc} is not above 0.3")
    w = sel_pb.weights[sel_pb.mask]
    check(int(sel_pb.mask.sum()) == (K // BATCH) * BATCH,
          f"PB selection kept {int(sel_pb.mask.sum())} rows")
    check(bool(torch.isfinite(w).all()) and abs(float(w.sum()) - 1) < 1e-4,
          "PB selection weights are not finite or do not sum to 1")
    return {"counts": counts, "model": model, "train": train, "val": val,
            "selection_seconds": {"gradmatch": rep.selection_seconds,
                                  "gradmatch-pb": pb_seconds}}


def phase_solve(torch, np, model, train) -> None:
    """Per-class GRAD-MATCH and GRAD-MATCHPB, each with the kernels and with
    the plain versions, both on the card, on the same proxies."""
    from repro_torch.core.gradmatch import gradmatch_per_class, gradmatch_pb
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_proxy_fn

    pcg, bias = make_proxy_fn(model)(train.x, train.y)
    solves = {  # path: (candidates, solve)
        "gradmatch": (train.n, lambda: gradmatch_per_class(
            pcg, train.y, 10, K)),
        "gradmatch-pb": (train.n // BATCH, lambda: gradmatch_pb(
            bias, BATCH, K // BATCH)),
    }
    for path, (candidates, solve) in solves.items():
        out = {}
        for mode in ("kernels", "ref"):
            ops.set_backend("ref" if mode == "ref" else None)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sel = solve()
                torch.cuda.synchronize()
                out[mode] = (sel, time.perf_counter() - t0)
            finally:
                ops.set_backend(None)
        (a, ta), (b, tb) = out["kernels"], out["ref"]
        ia = set(a.indices[a.mask].tolist())
        ib = set(b.indices[b.mask].tolist())
        overlap = len(ia & ib) / max(len(ib), 1)
        ea, eb = float(a.err), float(b.err)
        emit("solve", path=path, candidates=candidates, picked=len(ia),
             err_kernels=ea, err_plain=eb, index_overlap=overlap,
             seconds_kernels=ta, seconds_plain=tb)
        check(np.isfinite(ea) and abs(ea - eb) <= 1e-3 * abs(eb),
              f"{path} err with kernels {ea} vs plain {eb}")
        check(bool(torch.isfinite(a.weights).all()),
              f"{path} weights not finite")


def phase_trace(torch, model, train) -> dict:
    """A profiler trace of the first TRACE_ROUNDS rounds of class 0's OMP
    solve on the main path's (45 000, 65) proxies.  The NNLS loop is marked
    by wrapping ``omp._nnls_active_cached`` in a ``record_function`` for the
    trace only.  Reports the card's busy share (the union of device
    activity over the solve's span), the host time and the kernel launches
    inside the NNLS loop against the rest of the rounds, the device time of
    the port's own kernels, and the same solve's time untraced (the
    profiler's cost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import omp
    from repro_torch.train.steps import make_proxy_fn

    pcg, _ = make_proxy_fn(model)(train.x, train.y)
    valid = train.y == 0
    target = pcg[valid].sum(dim=0)

    def solve():
        omp.omp_select(pcg, target, k=TRACE_ROUNDS, valid=valid)
        torch.cuda.synchronize()

    solve()
    t0 = time.perf_counter()
    solve()
    untraced_s = time.perf_counter() - t0

    nnls = omp._nnls_active_cached

    def traced_nnls(*args, **kwargs):
        with record_function("nnls"):
            return nnls(*args, **kwargs)

    omp._nnls_active_cached = traced_nnls
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("solve"):
                solve()
    finally:
        omp._nnls_active_cached = nnls

    events = prof.events()

    def host_ranges(name):
        return sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.name == name and e.device_type == DeviceType.CPU)

    (lo, hi), = host_ranges("solve")
    nnls_ranges = host_ranges("nnls")
    check(len(nnls_ranges) == TRACE_ROUNDS,
          f"trace holds {len(nnls_ranges)} NNLS calls, not {TRACE_ROUNDS}")
    # Device activity: kernels, memsets and copies.  The two marked ranges
    # are mirrored on the device's timeline as annotations; they are not
    # activity.
    device = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.device_type == DeviceType.CUDA
                    and e.name not in ("solve", "nnls"))
    busy, end, by_name = 0.0, lo, {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b

    def inside(t):
        return any(a <= t <= b for a, b in nnls_ranges)

    launch_names = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemsetAsync")
    launches = [e.time_range.start for e in events
                if e.name in launch_names and lo <= e.time_range.start <= hi]
    in_nnls = sum(inside(t) for t in launches)
    span = hi - lo
    nnls_host = sum(b - a for a, b in nnls_ranges)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    rec = dict(rounds=TRACE_ROUNDS, span_ms=span / 1e3,
               untraced_ms=untraced_s * 1e3,
               device_busy_share=busy / span if device else None,
               nnls_host_share=nnls_host / span,
               launches_per_round=len(launches) / TRACE_ROUNDS,
               nnls_launches_per_round=in_nnls / TRACE_ROUNDS,
               device_events=len(device),
               device_us=sum(by_name.values()),
               port_kernels_us=sum(us for name, us in by_name.items()
                                   if "repro_torch::" in name),
               top_device_us={name[:100]: us for name, us in top})
    emit("trace", **rec)
    return rec


def phase_craig(torch, np, train, val) -> dict:
    """CRAIG and GLISTER through their entry points at the main path's
    data and widths, each path's launch counts read on its own, then the
    kernels against the plain versions on whole selections."""
    from repro_torch.configs.paper import PaperHParams, mlp
    from repro_torch.core import craig as craig_lib
    from repro_torch.core import greedy
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_proxy_fn
    from repro_torch.train.trainer import AdaptiveTrainer, TrainerConfig

    cfg = mlp()
    tcfg = TrainerConfig(strategy="craig-lazy", budget=BUDGET, epochs=2,
                         batch_size=BATCH, hp=PaperHParams(select_every=1),
                         eval_every=1)
    # The greedy statistics are read by wrapping fl_greedy for this phase.
    stats = []
    fl_greedy = greedy.fl_greedy

    def recording(*args, **kwargs):
        res = fl_greedy(*args, **kwargs)
        stats.append(vars(res.stats))
        return res

    def measure(fn):
        """fn() with the launch counts, greedy stats and peak memory of
        that call alone, and its seconds (host clock, synced)."""
        stats.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, dict(seconds=time.perf_counter() - t0,
                            launches=ops.launch_counts(),
                            greedy_stats=list(stats),
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    def check_sel(sel, what, size=K):
        w = sel.weights[sel.mask]
        check(int(sel.mask.sum()) == size,
              f"{what} kept {int(sel.mask.sum())} rows, not {size}")
        check(len(set(sel.indices[sel.mask].tolist())) == size,
              f"{what} picked a row twice")
        check(bool(torch.isfinite(w).all()) and abs(float(w.sum()) - 1)
              < 1e-4, f"{what} weights are not finite or do not sum to 1")

    greedy.fl_greedy = recording
    paths = {}
    try:
        # 1. craig-lazy trained end to end (per-gradient proxies: on the fly)
        trainer = AdaptiveTrainer(cfg, tcfg, train, val)
        model = trainer.init_model()
        sels = []
        run_selection = trainer._run_selection

        def capture(*args):
            sel, dt = run_selection(*args)
            sels.append(sel)
            return sel, dt

        trainer._run_selection = capture
        rep, paths["craig-lazy"] = measure(lambda: trainer.run(model))
        paths["craig-lazy"].update(
            selection_seconds=rep.selection_seconds,
            selection_rounds=rep.selection_rounds,
            wall_seconds=rep.wall_seconds, final_acc=rep.final_acc,
            subset_size=rep.subset_size)
        check(rep.selection_rounds == 2, "expected two selection rounds")
        check(rep.subset_size == K,
              f"craig-lazy kept {rep.subset_size} rows, not {K}")
        for sel in sels:
            check_sel(sel, "craig-lazy")
        check(np.isfinite(rep.final_acc) and rep.final_acc > 0.2,
              f"craig-lazy final accuracy {rep.final_acc} is not above 0.2")

        # 2.-3. one selection of each other strategy through the trainer:
        # craig-stochastic draws from a generator on the card; craig-pb is
        # the dense oracle over the 703 mini-batch proxies
        for strategy in ("craig-lazy-otf", "craig-stochastic", "craig-pb",
                         "glister"):
            tr = AdaptiveTrainer(cfg, replace(tcfg, strategy=strategy),
                                 train, val)
            gen = torch.Generator(device="cuda").manual_seed(7)
            (sel, _), paths[strategy] = measure(
                lambda: tr._run_selection(model, gen))
            paths[strategy]["selection_seconds"] = paths[strategy]["seconds"]
            check_sel(sel, strategy, (K // BATCH) * BATCH
                      if strategy == "craig-pb" else K)

        # 4. lazy CRAIG over a resident similarity built by sqdist
        pcg, _ = make_proxy_fn(model)(train.x, train.y)
        lm = greedy.default_l_max(pcg)
        resident, paths["craig-resident"] = measure(
            lambda: craig_lib.craig(pcg, K, method="lazy", on_the_fly=False,
                                    dist_fn=ops.sqdist, l_max=lm))
        paths["craig-resident"]["selection_seconds"] = (
            paths["craig-resident"]["seconds"])
        check_sel(resident, "craig-resident")
        for path in CRAIG_PATHS:
            emit("craig", path=path, **paths[path])
        needs = {"craig-lazy": ("fl_gain_argmax_otf", "lastlayer_grad"),
                 "craig-lazy-otf": ("fl_gain_argmax_otf", "lastlayer_grad"),
                 "craig-stochastic": ("lastlayer_grad",),
                 "craig-pb": ("lastlayer_grad",),
                 "glister": ("corr_argmax", "lastlayer_grad"),
                 "craig-resident": ("sqdist", "fl_gain_argmax")}
        for path, names in needs.items():
            for name in names:
                check(paths[path]["launches"][name] > 0,
                      f"kernel {name} was not launched on the {path} path")
        check(paths["craig-resident"]["launches"]["sqdist"] == 1,
              "the resident path built its similarity more than once")

        # Kernels against plain versions on whole selections, on the card.
        sim = greedy.build_sim(pcg, l_max=lm, dist_fn=ops.sqdist)

        def both(what, fn):
            out = {}
            for mode in ("kernels", "ref"):
                ops.set_backend("ref" if mode == "ref" else None)
                try:
                    out[mode] = measure(fn)
                finally:
                    ops.set_backend(None)
            (a, ra), (b, rb) = out["kernels"], out["ref"]
            differ = (a.indices != b.indices).nonzero()
            first = int(differ[0, 0]) if len(differ) else None
            emit("craig_compare", what=what, picks=int(a.mask.sum()),
                 first_differing_round=first, err_kernels=float(a.err),
                 err_plain=float(b.err), kernels=ra, plain=rb)
            check(first is None, f"{what}: kernels and plain versions part "
                  f"at round {first}")
            check(abs(float(a.err) - float(b.err))
                  <= 1e-5 * abs(float(b.err)),
                  f"{what}: err {float(a.err)} vs {float(b.err)}")
            return a

        a = both("resident lazy", lambda: craig_lib.craig(
            pcg, K, sim=sim, method="lazy", l_max=lm))
        check(torch.equal(a.indices, resident.indices),
              "the resident path's picks differ from the same selection "
              "on a rebuilt similarity")
        both("on-the-fly lazy", lambda: craig_lib.craig(
            pcg, K, method="lazy", on_the_fly=True, l_max=lm))

        # 5. the dense oracle against the resident lazy greedy
        dense, rd = measure(lambda: greedy.fl_greedy(
            None, DENSE_K, sim=sim, method="dense", l_max=lm))
        lazy, rl = measure(lambda: greedy.fl_greedy(
            None, DENSE_K, sim=sim, method="lazy", l_max=lm))
        differ = (dense.indices != lazy.indices).nonzero()
        first = int(differ[0, 0]) if len(differ) else None
        emit("craig_compare", what=f"dense vs resident lazy, k={DENSE_K}",
             first_differing_round=first, dense=rd, lazy=rl)
        check(first is None, f"dense and lazy part at round {first}")
        del sim
        torch.cuda.empty_cache()
    finally:
        greedy.fl_greedy = fl_greedy
    return {"counts": {p: paths[p]["launches"] for p in CRAIG_PATHS},
            "selection_seconds": {p: paths[p]["selection_seconds"]
                                  for p in CRAIG_PATHS}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs a card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import repro_torch  # noqa: F401  (turns TF32 off)

    t_start = time.perf_counter()
    card = phase_device(torch)
    phase_build()
    records = phase_kernels(torch, np, card)
    phase_kernels_fl(torch, np, card, records)
    tr = phase_trainer(torch, np)
    phase_solve(torch, np, tr["model"], tr["train"])
    phase_trace(torch, tr["model"], tr["train"])
    cr = phase_craig(torch, np, tr["train"], tr["val"])
    counts = {**tr["counts"], **cr["counts"]}
    selection_seconds = {**tr["selection_seconds"],
                         **cr["selection_seconds"]}
    kernels = []
    kernel_s = {path: 0.0 for path in counts}
    for name, (source, replaces) in KERNEL_SOURCES.items():
        # The top-level numbers are those at MAIN_PATH's shape; "paths"
        # holds each path that launched the kernel, with its launches and
        # the numbers at the shape that path gives it.
        paths = {}
        for path, c in counts.items():
            if c[name] == 0:
                continue
            rec = records[name].get(path)
            check(rec is not None, f"{name} launched on {path} at a shape "
                  "the kernels phase did not measure")
            paths[path] = {"launches": c[name], **rec}
            kernel_s[path] += c[name] * rec["ms"] / 1e3
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(p["launches"]
                                        for p in paths.values()),
                        **records[name][MAIN_PATH[name]], "paths": paths})
    # Share of each path's selection seconds spent in the kernels:
    # launches times each kernel's device time at that path's shape.
    for path in counts:
        emit("share", path=path, kernel_seconds=kernel_s[path],
             selection_seconds=selection_seconds[path],
             kernel_share=kernel_s[path] / selection_seconds[path])
    emit("done", seconds=time.perf_counter() - t_start)
    print(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
