#!/usr/bin/env python3
"""Kernels at their paths' shapes, from one checkout or another, for
comparing two trees on one card in turns.

    python3 tools/kernel_turns.py [--src DIR] [--save FILE] [--compare FILE]
                                  [--kernels fl_gain_argmax_otf,corr_argmax,
                                             corr_argmax_batched,sqdist,corr]
                                  [--stream tree|current] [--host-ab DIR]
    python3 tools/kernel_turns.py --routes [--kernels ...]
    python3 tools/kernel_turns.py --picks [--src DIR] [--save F] [--compare F]
                                  [--kernels ...]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``) and
times each kernel's wrapper as its callers call it, on inputs made from a
seed with numpy, so two trees see the same bits.  ``--kernels`` names them
(default ``fl_gain_argmax_otf,corr_argmax``):

- ``fl_gain_argmax_otf`` at the craig-lazy path's (45 000, 65) and the
  craig-lazy-otf path's (45 000, 10): cover, row_ok and mask as
  ``chip_smoke.py``'s ``kernels_fl`` phase makes them;
- ``corr_argmax`` at every case of ``chip_smoke.py``'s ``kernels`` phase
  (the (45 000, 65) pool with a class mask, plain and ``abs``; GRAD-MATCH-PB's
  (703, 10); the wide regime's (8 192, 512), plain and ``abs``; a ragged
  (1 000, 700); GLISTER's (45 000, 10), from an aligned pool and from one
  off a 16-byte boundary; planted ties; all masked) and the LM's (16, 4),
  each also by its wall time a call on the host (``wall_us``: calls queued
  back to back, the host's work a call where it exceeds the card's);
- ``corr`` at every shape ``chip_smoke.py``'s ``kernels`` phase holds it
  at (``CORR_CASES``: the main path's (45 000, 65), GRAD-MATCH-PB's
  (703, 10), the stream paths' buffers (768, 10 or 65), the merges'
  unions, the wide regime's (8 192, 512) in f32 and bf16, a ragged
  (1 000, 700), the bf16 arenas (88 064, 10) and (86 016, 65), the LM's
  candidates (16, 2 048) and (16, 3 584)) and at the stream paths' one
  row, each with ``wall_us``, ``torch.mv``'s time (``mv_ms``), the bound
  and the route the tree's plan gives it; first a line with the host
  cost of the stream handle a wrapper passes its kernel, through
  ``torch.cuda.current_stream`` and as the raw handle;
- ``corr_argmax_batched`` at ``chip_smoke.py``'s ``kernels_batched``
  cases: the main path's (45 000, 65) pool with B = 10 class masks, plain
  and ``abs``; B = 32 with random masks; the wide regime's per-problem
  (4, 8 192, 512);
- ``lastlayer_grad`` at the main path's (45 000, 64, 10) and the stream
  path's (1 024, 64, 10), int64 labels; ``bound_max`` at the streaming
  arenas (88 064, 10) and (86 016, 65) bf16, their masks with the empty
  slots and a tenth of the cached rows off, ``abs`` on, the threshold the
  median live bound;
- ``sqdist`` at the craig-resident path's ``sqdist(a, a)`` of (45 000, 65)
  f32 and at ``chip_smoke.py``'s other two cases, (4 097, 1 000, 130) bf16
  and (129, 65, 3) f32; the (45 000, 45 000) output is kept as a 64-bit
  digest of its bits with its diagonal and first and last rows.

``--save`` keeps the outputs, ``--compare`` says whether they equal a saved
run's bit for bit.  ``--stream current`` has every wrapper take its stream
handle through ``torch.cuda.current_stream``, as the wrappers did before
they passed the raw handle, so that a tree's ``wall_us`` can be split
between the handle and the rest of its host path.  With ``corr``,
``--host-ab DIR`` loads ``DIR``'s ``kernels/corr.py`` beside this tree's,
bound to this tree's library, stream handle and checks, and at each case
both wrappers launch the warp kernel times, interleaved in one process:
this tree's wrapper, ``DIR``'s, and this tree's with the handle through
``torch.cuda.current_stream`` (``wall_us``, ``other_wall_us``,
``current_wall_us``); each case also gives the plan lookup's own host
cost (``plan_us``: ``corr_plan`` and ``sm_count`` a call).  To compare a parent commit with this one, unpack it
under the git-ignored ``build/`` (``git archive``) and run it and this tree
in turns (parent, change, change, parent), each in its own process: each
tree builds its own library.  Device times as ``chip_smoke.py`` takes them
(``device_ms``).

``--routes`` times both routes of the named kernels of this checkout beside
the route each plan picks: ``corr``'s three over n at widths 10 and 65 in
f32 and bf16, aligned and 4 bytes off, and over n at widths past 96 (the
row tiles against the warps, the wide route against the warps, each with
``torch.mv``); ``corr_argmax`` over n at widths 10 and 65 and
over the width at 45 000 rows, from an aligned pool and from one off a
16-byte boundary; ``fl_gain_argmax_otf`` over d and n; ``lastlayer_grad``
and ``bound_max`` over n, d and C; ``sqdist`` over n, d, the dtype and
whether a is b (each route that takes the call: the mirrored tensor cores,
their full grid, the FFMA tiles).  The data behind the plans' rules.

``--picks`` runs selections through the entry points instead, on the main
path's data (45 000 rows of ``make_classification``) and a seeded
``mlp()``'s proxies (``lastlayer_grad`` on all 45 000 rows), each with its
seconds (each selection ``--repeats`` times; the outputs of every repeat
must equal the first's): for ``fl_gain_argmax_otf`` and ``corr_argmax`` lazy
CRAIG over the per-gradient proxies (``craig-lazy``) and over the bias
proxies (``craig-lazy-otf``), and GLISTER over the bias proxies; for the
other two per-class GRAD-MATCH, and streaming GRAD-MATCH over the bias
proxies (the (n, 10) arena) and over the per-gradient proxies (the (n, 65)
arena), with their ``SelectStats``; for ``sqdist`` lazy CRAIG over the
similarity it builds resident from the per-gradient proxies (``craig-
resident``). ``--save`` / ``--compare`` then hold the proxies, picks,
weights (and stats, or each CRAIG round's gain) of two trees against each
other; where two trees' picks part, the first round that differs and both
trees' picks and gains there.

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


FL_SHAPES = ((45_000, 65), (45_000, 10))
SQ_CASES = ((45_000, 45_000, 65, "float32"), (4_097, 1_000, 130, "bfloat16"),
            (129, 65, 3, "float32"))
DEFAULT_KERNELS = "fl_gain_argmax_otf,corr_argmax"
# corr's shapes: chip_smoke.py's kernels phase, then the stream paths' one
# row (rows, d, dtype).
CORR_CASES = ((45_000, 65, "float32"), (703, 10, "float32"),
              (768, 10, "float32"), (768, 65, "float32"),
              (900, 10, "float32"), (512, 65, "float32"),
              (8_192, 512, "float32"), (8_192, 512, "bfloat16"),
              (1_000, 700, "float32"), (88_064, 10, "bfloat16"),
              (86_016, 65, "bfloat16"), (16, 2_048, "float32"),
              (16, 3_584, "float32"), (1, 10, "float32"),
              (1, 65, "float32"))


def corr_inputs(torch, np, n, d, dt, dev, offset=0):
    """A pool of ``dt`` (its first element ``offset`` elements past an
    allocation's start) and an f32 residual, from a seed."""
    rng = np.random.default_rng(n + d)
    buf = torch.from_numpy(rng.standard_normal(n * d + offset).astype(
        np.float32)).to(dev).to(getattr(torch, dt))
    r = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(dev)
    return buf[offset:].view(n, d), r


def corr_bound_ms(torch, g) -> float:
    """The least time of ``corr`` on ``g`` on this card
    (``chip_smoke.bound_of``): its bytes (the pool, the residual, the
    scores) or its multiply-adds, whichever take longer."""
    from chip_smoke import bound_of
    n, d = g.shape
    card = {"name": torch.cuda.get_device_name(g.device)}
    return bound_of(card, n * d * g.element_size() + 4 * d + 4 * n,
                    2 * n * d)[0]


def fl_inputs(torch, np, n, d, dev):
    """grads, cover, row_ok, mask, l_max and squared norms as the
    ``kernels_fl`` phase of ``chip_smoke.py`` makes them."""
    rng = np.random.default_rng(n + d)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(
        dev)
    cover = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(
        np.float32) * 8).to(dev)
    rok = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    mask = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    sq = (g * g).sum(1)
    # l_max as greedy.default_l_max takes it (both trees have it)
    from repro_torch.core import greedy
    return g, cover, rok, mask, greedy.default_l_max(g), sq


def argmax_cases(torch, np, dev):
    """(name, colcache, w, base, mask, absolute) of ``corr_argmax`` at the
    ``kernels`` phase's cases and the LM's (16, 4)."""
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    zeros = torch.zeros((ROWS,), device=dev)
    labels = t(rng.integers(0, 10, ROWS))
    g = t(rng.standard_normal((ROWS, 65)).astype(np.float32))
    r = t(rng.standard_normal(65).astype(np.float32))
    cases = [("narrow", g, -r, zeros, labels == 3, False),
             ("narrow abs", g, -r, zeros, labels == 3, True)]
    gp = t(rng.standard_normal((703, 10)).astype(np.float32))
    cases.append(("pb-narrow", gp, -t(rng.standard_normal(10).astype(
        np.float32)), torch.zeros((703,), device=dev),
        t(rng.random(703) < 0.9), False))
    cc = t(rng.standard_normal((8192, 512)).astype(np.float32))
    w = t(rng.standard_normal(512).astype(np.float32) / 16)
    c0 = t(rng.standard_normal(8192).astype(np.float32) * 3)
    wmask = t(rng.random(8192) < 0.9)
    cases += [("wide", cc, w, c0, wmask, False),
              ("wide abs", cc, w, c0, wmask, True)]
    cases.append(("ragged", t(rng.standard_normal((1000, 700)).astype(
        np.float32)), t(rng.standard_normal(700).astype(np.float32)),
        t(rng.standard_normal(1000).astype(np.float32)),
        t(rng.random(1000) < 0.5), True))
    g10 = t(rng.standard_normal((ROWS, 10)).astype(np.float32))
    v10 = t(rng.standard_normal(10).astype(np.float32))
    cases.append(("glister", g10, -v10, zeros, t(rng.random(ROWS) < 0.9),
                  False))
    buf = t(rng.standard_normal(ROWS * 10 + 1).astype(np.float32))
    cases.append(("unaligned", buf[1:].view(ROWS, 10), -v10, zeros,
                  t(rng.random(ROWS) < 0.9), False))
    dup = g.clone()
    dup[1::2] = dup[::2]
    cases.append(("ties", dup, -r, zeros,
                  torch.ones((ROWS,), dtype=torch.bool, device=dev), True))
    cases.append(("all-masked", g, -r, zeros,
                  torch.zeros((ROWS,), dtype=torch.bool, device=dev), False))
    cases.append(("lm", t(rng.standard_normal((16, 4)).astype(np.float32)),
                  t(rng.standard_normal(4).astype(np.float32)),
                  t(rng.standard_normal(16).astype(np.float32)),
                  t(rng.random(16) < 0.8), True))
    return cases


def argmax_batched_cases(torch, np, dev):
    """(name, mat, w, base, mask, absolute) of ``corr_argmax_batched`` at
    the main path's, the batched phase's and the wide regime's shapes."""
    rng = np.random.default_rng(3)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    labels = rng.integers(0, 10, ROWS)
    g = t(rng.standard_normal((ROWS, 65)).astype(np.float32))
    onehot = t(np.eye(10, dtype=bool)[labels]
               & (rng.random((ROWS, 1)) > 0.1))
    w10 = t(-rng.standard_normal((10, 65)).astype(np.float32))
    zeros10 = torch.zeros((ROWS, 10), device=dev)
    cases = [("per-class", g, w10, zeros10, onehot, False),
             ("per-class abs", g, w10, zeros10, onehot, True),
             ("batched B=32", g, t(-rng.standard_normal((32, 65)).astype(
                 np.float32)), torch.zeros((ROWS, 32), device=dev),
              t(rng.random((ROWS, 32)) < 0.5), False)]
    cases.append(("wide per-problem",
                  t(rng.standard_normal((4, 8192, 512)).astype(np.float32)),
                  t(rng.standard_normal((4, 512)).astype(np.float32) / 16),
                  t(rng.standard_normal((8192, 4)).astype(np.float32) * 3),
                  t(rng.random((8192, 4)) < 0.9), True))
    return cases


def sq_inputs(torch, np, n, m, d, dt, dev):
    """a and b of a ``chip_smoke.py`` sqdist case; b is a when n == m."""
    rng = np.random.default_rng(n + m + d)
    a = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(
        dev).to(getattr(torch, dt))
    if n == m:
        return a, a
    return a, torch.from_numpy(rng.standard_normal((m, d)).astype(
        np.float32)).to(dev).to(getattr(torch, dt))


def digest(torch, s) -> list:
    """A 64-bit digest of a matrix's bits (a weighted sum of its elements'
    int32 patterns, wrapping), with its diagonal and its first and last
    rows: two trees' outputs compared without holding both."""
    gen = torch.Generator(device=s.device).manual_seed(0)
    cols = torch.randint(1, 2 ** 62, (s.shape[1],), generator=gen,
                         device=s.device) | 1
    acc = torch.zeros((), dtype=torch.int64, device=s.device)
    for lo in range(0, s.shape[0], 4096):
        blk = s[lo:lo + 4096].contiguous().view(torch.int32).long()
        rows = torch.arange(lo, lo + blk.shape[0], device=s.device
                            ) * 2654435761 + 1
        acc += (blk * cols * rows[:, None]).sum()
    return [acc, s.diagonal(), s[0], s[-1]]


def wall_us(torch, fn, calls: int = 2000) -> float:
    """Wall microseconds a call of ``fn`` queued back to back: the host's
    work a call where it exceeds the card's."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def host_us(fn, calls: int = 100_000) -> float:
    """Host microseconds a call of ``fn`` (nothing on the card)."""
    import time
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def current_stream_handles(torch) -> None:
    """Every kernel wrapper of the imported tree takes its stream handle
    through ``torch.cuda.current_stream`` (a Python Stream object a
    call)."""
    import importlib
    kargs = importlib.import_module("repro_torch.kernels.args")
    tree_stream = kargs.stream

    def stream(device):
        return torch.cuda.current_stream(device).cuda_stream

    for name in ("args", "corr", "fl_gain", "lastlayer_grad", "sqdist"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        if getattr(mod, "stream", None) is tree_stream:
            mod.stream = stream


def host_ab(torch, corr_k, other_src: Path, g, r, dt: str,
            rounds: int = 10) -> None:
    """``corr``'s wall time a call from this tree's wrapper, from
    ``other_src``'s (its ``kernels/corr.py`` bound to this tree's library,
    handle and checks) and from this tree's with a Stream object's handle,
    interleaved in one process, on the warp kernel both launch."""
    import importlib.util
    if not hasattr(host_ab, "other"):
        spec = importlib.util.spec_from_file_location(
            "host_ab_corr", other_src / "repro_torch/kernels/corr.py")
        host_ab.other = importlib.util.module_from_spec(spec)
        sys.modules["host_ab_corr"] = host_ab.other   # for its dataclasses
        spec.loader.exec_module(host_ab.other)
    other = host_ab.other
    dev = g.device
    tree_stream = corr_k.stream

    def current(device):
        return torch.cuda.current_stream(device).cuda_stream

    if not torch.equal(corr_k.corr(g, r), other.corr(g, r)):
        raise AssertionError(f"corr {tuple(g.shape)}: the wrappers' bits "
                             "differ")
    out = {"wall_us": [], "other_wall_us": [], "current_wall_us": []}
    for _ in range(rounds):
        out["wall_us"].append(wall_us(torch, lambda: corr_k.corr(g, r)))
        out["other_wall_us"].append(wall_us(torch, lambda: other.corr(g, r)))
        corr_k.stream = current
        try:
            out["current_wall_us"].append(
                wall_us(torch, lambda: corr_k.corr(g, r)))
        finally:
            corr_k.stream = tree_stream
    torch.cuda.current_stream(dev).synchronize()
    print(json.dumps({"kernel": "corr", "host_ab": str(other_src),
                      "shape": list(g.shape), "dtype": dt, **out}),
          flush=True)


def turns(torch, np, device_ms, args) -> None:
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import fl_gain as fl_k
    from repro_torch.kernels import lastlayer_grad as llg_k
    dev = torch.device("cuda")
    outs = {}

    def timed(kernel, key, shape, fn, reps=30, wall=False, keep=None,
              **extra):
        outs[key] = fn() if keep is None else keep(fn())
        ms = [device_ms(torch, fn, reps=reps, warmup=2)
              for _ in range(args.repeats)]
        if wall:
            extra["wall_us"] = [wall_us(torch, fn)
                                for _ in range(args.repeats)]
        print(json.dumps({"kernel": kernel, "shape": shape, **extra,
                          "src": str(args.src), "stream": args.stream,
                          "ms": ms}), flush=True)

    if "fl_gain_argmax_otf" in args.kernels:
        for n, d in FL_SHAPES:
            g, cover, rok, mask, lm, sq = fl_inputs(torch, np, n, d, dev)
            timed("fl_gain_argmax_otf", f"fl_gain_argmax_otf {n} {d}",
                  [n, d], lambda: fl_k.fl_gain_argmax_otf(
                      g, cover, rok, mask, lm, sqnorms=sq), reps=10)
    if "corr" in args.kernels:
        # The stream handle every wrapper passes its kernel: through a
        # Stream object, or as the raw handle (microseconds a call).
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        print(json.dumps({"stream_handle_us": {
            "current_stream": host_us(lambda: torch.cuda.current_stream(
                dev).cuda_stream),
            "raw": host_us(lambda: raw(dev.index or 0)) if raw else None}}),
            flush=True)
        plan_of = getattr(corr_k, "corr_plan", None)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for n, d, dt in CORR_CASES:
            g, r = corr_inputs(torch, np, n, d, dt, dev)
            route = (plan_of(n, d, g.element_size(), g.data_ptr(), sms).route
                     if plan_of else "warps")
            plan_us = (host_us(lambda: plan_of(
                n, d, g.element_size(), g.data_ptr(), corr_k.sm_count(dev)))
                if plan_of else None)
            mv = device_ms(torch, lambda: torch.mv(g, r.to(g.dtype)))
            timed("corr", f"corr {n} {d} {dt}", [n, d],
                  lambda: corr_k.corr(g, r), wall=True, dtype=dt,
                  route=route, plan_us=plan_us, mv_ms=mv,
                  bound_ms=corr_bound_ms(torch, g))
            if args.host_ab and route == "warps":
                host_ab(torch, corr_k, args.host_ab, g, r, dt)
    if "corr_argmax" in args.kernels:
        for name, c, w, base, mask, ab in argmax_cases(torch, np, dev):
            timed("corr_argmax", f"corr_argmax {name}", list(c.shape),
                  lambda: corr_k.corr_argmax(c, w, base, mask, absolute=ab),
                  wall=True, case=name)
    if "corr_argmax_batched" in args.kernels:
        for name, c, w, base, mask, ab in argmax_batched_cases(torch, np,
                                                               dev):
            timed("corr_argmax_batched", f"corr_argmax_batched {name}",
                  list(c.shape) + [w.shape[0]],
                  lambda: corr_k.corr_argmax_batched(c, w, base, mask,
                                                     absolute=ab),
                  case=name)
    if "lastlayer_grad" in args.kernels:
        for n, dh, nc in LLG_SHAPES:
            h, z, y = llg_inputs(torch, np, n, dh, nc, dev)
            timed("lastlayer_grad", f"lastlayer_grad {n}", [n, dh, nc],
                  lambda: llg_k.lastlayer_grad(h, z, y))
    if "bound_max" in args.kernels:
        for n, d, chunk in ARENAS:
            a = arena_inputs(torch, np, n, d, (ROWS // chunk + 1) * chunk,
                             dev)
            timed("bound_max", f"bound_max {n}", [n, d],
                  lambda: corr_k.bound_max(*a, absolute=True))
    if "sqdist" in args.kernels:
        from repro_torch.kernels import sqdist as sq_k
        for n, m, d, dt in SQ_CASES:
            a, b = sq_inputs(torch, np, n, m, d, dt, dev)
            timed("sqdist", f"sqdist {n} {m} {d}", [n, m, d],
                  lambda: sq_k.sqdist(a, b), reps=10, dtype=dt,
                  keep=(lambda s: digest(torch, s)) if n == ROWS else
                  (lambda s: [s]))
            del a, b
            torch.cuda.empty_cache()
    outs = {k: [t.cpu() for t in v] for k, v in outs.items()}
    if args.save:
        torch.save(outs, args.save)
    if args.compare:
        other = torch.load(args.compare)
        print(json.dumps({"equal_to": str(args.compare), "bits": {
            k: all(torch.equal(a, b) for a, b in zip(v, other[k]))
            for k, v in outs.items() if k in other}}))


def first_parting(a, b):
    """The first position where two pick lists differ, or None."""
    differ = (a != b).nonzero()
    return int(differ[0, 0]) if len(differ) else None


def picks(torch, args) -> None:
    import time

    from repro_torch.configs.paper import mlp
    from repro_torch.core import greedy
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
    runs = {}
    if "fl_gain_argmax_otf" in args.kernels or "corr_argmax" in args.kernels:
        runs.update({
            "craig-lazy": lambda: sel_lib.select("craig-lazy", None, pcg, k),
            "craig-lazy-otf": lambda: sel_lib.select("craig-lazy-otf", None,
                                                     bias, k),
            "glister": lambda: sel_lib.select("glister", None, bias, k)})
    if "sqdist" in args.kernels:
        from repro_torch.core import craig as craig_lib
        from repro_torch.kernels import ops
        lm = greedy.default_l_max(pcg)
        runs["craig-resident"] = lambda: craig_lib.craig(
            pcg, k, method="lazy", on_the_fly=False, dist_fn=ops.sqdist,
            l_max=lm)
    if "lastlayer_grad" in args.kernels or "bound_max" in args.kernels:
        runs.update({
            "gradmatch": lambda: sel_lib.select(
                "gradmatch", None, pcg, k, labels=train.y, num_classes=10),
            "gradmatch-stream bias": lambda: sel_lib.select(
                "gradmatch-stream", None, bias, k),
            "gradmatch-stream per-gradient": lambda: sel_lib.select(
                "gradmatch-stream", None, pcg, k)})
    # Each CRAIG round's accepted gain, read by wrapping fl_greedy.
    gains = []
    fl_greedy = greedy.fl_greedy

    def recording(*a, **kw):
        res = fl_greedy(*a, **kw)
        gains.append(res.gains)
        return res

    greedy.fl_greedy = recording
    stats = {}
    try:
        for name, run in runs.items():
            seconds, same = [], True
            for rep in range(args.repeats):
                gains.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                got = [res.indices.cpu(), res.weights.cpu(), res.mask.cpu(),
                       torch.as_tensor(float(res.err))]
                if rep == 0:
                    outs[name] = got
                    st = getattr(res, "stats", None)
                    stats[name] = vars(st) if st is not None else None
                    if gains:
                        outs[name + " gains"] = [gains[0].cpu()]
                else:
                    same = same and all(torch.equal(a, b)
                                        for a, b in zip(got, outs[name]))
            print(json.dumps({"selection": name, "src": str(args.src),
                              "seconds": seconds,
                              "same_bits_each_repeat": same,
                              "stats": stats[name]}), flush=True)
    finally:
        greedy.fl_greedy = fl_greedy
    outs["stats"] = stats
    if args.save:
        torch.save(outs, args.save)
    if args.compare:
        other = torch.load(args.compare)
        bits, parted = {}, {}
        for key, v in outs.items():
            if key not in other:
                continue
            bits[key] = (v == other[key] if key == "stats" else
                         all(torch.equal(a, b) for a, b in zip(v, other[key])))
            if key in runs and not bits[key]:
                t = first_parting(v[0], other[key][0])
                g = outs.get(key + " gains"), other.get(key + " gains")
                parted[key] = {
                    "round": t,
                    "picks": None if t is None else [int(v[0][t]),
                                                     int(other[key][0][t])],
                    "gains": None if t is None or g[0] is None else [
                        float(g[0][0][t]), float(g[1][0][t])],
                    "err": [float(v[3]), float(other[key][3])]}
        print(json.dumps({"equal_to": str(args.compare), "bits": bits,
                          "parted": parted}))


def routes(torch, np, device_ms, args) -> None:
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import fl_gain as fl_k
    from repro_torch.kernels import lastlayer_grad as llg_k
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if "corr" in args.kernels:
        narrow = [(n, d, dt, off) for d in (10, 65)
                  for dt in ("float32", "bfloat16")
                  for n in (512, 1024, 2048, 4096, 6144, 8192, 10240, 12288,
                            14336, 16384, 20480, 24576, 32768, 45000, 88064)
                  for off in (0, 1)]
        wide = [(n, d, dt, 0)
                for d in (128, 256, 384, 512, 700, 1024, 2048, 3584, 4096)
                for dt in ("float32", "bfloat16")
                for n in (1, 16, 64, 128, 192, 256, 384, 512, 768, 1000,
                          8192, 32768, 131072)
                if n * d <= 2 ** 26]
        for n, d, dt, off in narrow + wide:
            g, r = corr_inputs(torch, np, n, d, dt, dev, off)
            ms = {}
            for route in ("rows", "wide", "warps"):
                try:
                    corr_k.corr_plan(n, d, g.element_size(), g.data_ptr(),
                                     sms, route)
                except ValueError:
                    continue
                ms[route] = device_ms(torch, lambda: corr_k.corr(
                    g, r, route=route))
            plan = corr_k.corr_plan(n, d, g.element_size(), g.data_ptr(),
                                    sms)
            print(json.dumps({"kernel": "corr", "shape": [n, d], "dtype": dt,
                              "aligned": off == 0, "ms": ms,
                              "mv_ms": device_ms(torch, lambda: torch.mv(
                                  g, r.to(g.dtype))),
                              "bound_ms": corr_bound_ms(torch, g),
                              "plan": plan.route}), flush=True)
            del g
    if "corr_argmax" in args.kernels:
        shapes = [(n, p) for p in (10, 65)
                  for n in (256, 703, 1024, 2048, 4096, 8192, 12288, 16384,
                            24576, 45000, 200000)]
        shapes += [(45000, p) for p in (1, 4, 16, 32, 64, 96)]
        for (n, p), offset in [(sh, 0) for sh in shapes] + [
                ((n, 10), 1) for n in (4096, 16384, 45000)] + [
                ((n, 65), 1) for n in (16384, 45000)]:
            rng = np.random.default_rng(n + p)
            buf = torch.from_numpy(rng.standard_normal(n * p + offset).astype(
                np.float32)).to(dev)
            c = buf[offset:].view(n, p)
            w = torch.from_numpy(rng.standard_normal(p).astype(
                np.float32)).to(dev)
            base = torch.zeros((n,), device=dev)
            mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
            ms = {}
            for route in ("rows", "warps"):
                try:
                    corr_k.corr_argmax_plan(n, p, c.data_ptr(), sms, route)
                except ValueError:
                    continue
                ms[route] = device_ms(torch, lambda: corr_k.corr_argmax(
                    c, w, base, mask, route=route))
            plan = corr_k.corr_argmax_plan(n, p, c.data_ptr(), sms)
            print(json.dumps({"kernel": "corr_argmax", "shape": [n, p],
                              "aligned": offset == 0, "ms": ms,
                              "plan": plan.route}), flush=True)
    if "fl_gain_argmax_otf" in args.kernels:
        for n, d in [(45000, d) for d in (1, 8, 10, 16, 32, 65, 72, 96,
                                          104)] + [(n, 65) for n in
                                                   (1024, 4096, 16384)]:
            g, cover, rok, mask, lm, sq = fl_inputs(torch, np, n, d, dev)
            ms = {route: device_ms(torch, lambda: fl_k.fl_gain_argmax_otf(
                g, cover, rok, mask, lm, sqnorms=sq, route=route), reps=5,
                warmup=1) for route in ("tc", "ffma")}
            print(json.dumps({"kernel": "fl_gain_argmax_otf", "shape": [n, d],
                              "ms": ms,
                              "plan": vars(fl_k.fl_gain_otf_plan(n, d))}),
                  flush=True)
    if "sqdist" in args.kernels:
        from repro_torch.kernels import sqdist as sq_k
        cases = [(n, n, d, "float32", True) for d in (10, 65)
                 for n in (64, 128, 192, 256, 384, 512, 1024, 2048, 4096,
                           8192, 16384, 45000)]
        cases += [(n, n // 2, 65, "float32", False)
                  for n in (128, 256, 512, 1024, 4096, 16384)]
        cases += [(4097, 1000, 130, "bfloat16", False), (129, 65, 3,
                                                         "float32", False),
                  (4096, 4096, 130, "bfloat16", True)]
        for n, m, d, dt, same in cases:
            a, b = sq_inputs(torch, np, n, m if not same else n, d, dt, dev)
            if not same and b is a:
                b = a.clone()
            itemsize = a.element_size()
            ms = {}
            for route in ("tc-sym", "tc", "ffma"):
                try:
                    sq_k.sqdist_plan(n, m, d, itemsize, same, sms, route)
                except ValueError:
                    continue
                ms[route] = device_ms(torch, lambda: sq_k.sqdist(
                    a, b, route=route), reps=10 if n > 8192 else 30,
                    warmup=2)
            plan = sq_k.sqdist_plan(n, m, d, itemsize, same, sms)
            print(json.dumps({"kernel": "sqdist", "shape": [n, m, d],
                              "dtype": dt, "same": same, "ms": ms,
                              "plan": plan.route}), flush=True)
            del a, b
            torch.cuda.empty_cache()
    if "lastlayer_grad" in args.kernels:
        for n in (256, 1024, 2048, 4096, 8192, 12288, 16384, 24576, 45000,
                  200000):
            h, z, y = llg_inputs(torch, np, n, 64, 10, dev)
            ms = {route: device_ms(torch, lambda: llg_k.lastlayer_grad(
                h, z, y, route=route)) for route in ("tiles", "warps")}
            plan = llg_k.lastlayer_plan(n, 64, 10, [0] * 5, sms)
            print(json.dumps({"kernel": "lastlayer_grad",
                              "shape": [n, 64, 10], "ms": ms,
                              "plan": plan.route}), flush=True)
        for nc in (2, 4, 8, 16, 20, 31, 32):
            h, z, y = llg_inputs(torch, np, 45000, 64, nc, dev)
            ms = {route: device_ms(torch, lambda: llg_k.lastlayer_grad(
                h, z, y, route=route)) for route in ("tiles", "warps")}
            plan = llg_k.lastlayer_plan(45000, 64, nc, [0] * 5, sms)
            print(json.dumps({"kernel": "lastlayer_grad",
                              "shape": [45000, 64, nc], "ms": ms,
                              "plan": plan.route}), flush=True)
    if "bound_max" in args.kernels:
        shapes = [(n, d) for n in (1024, 4096, 16384, 400000)
                  for d in (10, 65)]
        shapes += [(88064, d) for d in (10, 16, 32, 48, 64, 65, 96, 100,
                                        129, 256)]
        for n, d in shapes:
            a = arena_inputs(torch, np, n, d, n // 2, dev)
            ms = {route: device_ms(torch, lambda: corr_k.bound_max(
                *a, absolute=True, route=route))
                  for route in ("tiles", "rows")}
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
    ap.add_argument("--kernels", default=DEFAULT_KERNELS,
                    help="comma-separated: fl_gain_argmax_otf, corr_argmax, "
                    "corr_argmax_batched, lastlayer_grad, bound_max, sqdist, "
                    "corr")
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--stream", choices=("tree", "current"), default="tree")
    ap.add_argument("--host-ab", type=Path)
    ap.add_argument("--picks", action="store_true")
    args = ap.parse_args()
    args.kernels = set(args.kernels.split(","))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import device_ms
    import repro_torch  # noqa: F401  (turns TF32 off)
    if args.stream == "current":
        current_stream_handles(torch)
    if args.routes:
        routes(torch, np, device_ms, args)
    elif args.picks:
        picks(torch, args)
    else:
        turns(torch, np, device_ms, args)
    card_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
