#!/usr/bin/env python3
"""The MoE, Mamba2-hybrid and xLSTM LM paths on one card, outside the whole
smoke run.

    python3 tools/lm_decode_probe.py [--phases] [--profile] [--depth]

``--phases`` builds the kernels and runs ``chip_smoke.py``'s ``lm_moe``,
``lm_hybrid`` and ``lm_xlstm`` phases alone (their lines, then a ``done``
line with each phase's seconds).  ``--profile`` times decode steps of
qwen3-moe-30b-a3b (48 layers) and zamba2-7b (81 layers) at full width,
batch 4 after a 32-token prompt, eight steps between syncs, and traces one
with ``torch.profiler``: the card's busy share of the step, its device
operations and its busiest kernels.  ``--depth`` holds zamba2's
teacher-forced decode against its forward (batch 2, 32 -> 48) at f32 and
bf16 for 1 / 4 / 7 / 13 super-blocks (9 / 27 / 45 / 81 layers), and
xlstm-1.3b's for 1 / 3 / 6 (8 / 24 / 48 layers): how the difference grows
with depth, and whether it meets the reference decode test's elementwise
``allclose(rtol=5e-2, atol=5e-2)``; then it times and traces xlstm-1.3b's
weighted step at full depth (``chip_smoke.py``'s ``xlstm_step_trace``: the
step's device operations and busy share, the six sLSTM layers' launches
and share).  With no flag, all three.  One JSON line a measurement, then
the card's name and power limit.  Needs a card (and ``nvcc`` for
``--phases``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import _seat  # noqa: E402
from repro_torch.models import lm  # noqa: E402

DEV = torch.device("cuda")


PHASES = {"lm_moe": cs.phase_lm_moe, "lm_hybrid": cs.phase_lm_hybrid,
          "lm_xlstm": cs.phase_lm_xlstm}


def phases(card: dict) -> None:
    cs.phase_build()
    records = {k: {} for k in cs.KERNEL_SOURCES}
    seconds = {}
    for name, fn in PHASES.items():
        t0 = time.perf_counter()
        fn(torch, np, card, records)
        seconds[name] = time.perf_counter() - t0
    cs.emit("done", phases=seconds)


def profile() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    for arch in ("qwen3-moe-30b-a3b", "zamba2-7b"):
        cfg = get_config(arch)
        model = lm.init_lm(cfg, torch.Generator(device=DEV).manual_seed(0),
                           DEV)
        tok = torch.randint(0, cfg.vocab_size, (4, 48), device=DEV,
                            dtype=torch.int32)
        _, pstate = lm.prefill_step(cfg, model, tok[:, :32])
        state = _seat(lm.init_decode_state(cfg, 4, 48, DEV), pstate)
        steps = []
        for t in range(32, 40):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state = lm.decode_step(cfg, model, state, tok[:, t:t + 1], t)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            lm.decode_step(cfg, model, state, tok[:, 40:41], 40)
            torch.cuda.synchronize()
        events = prof.events()
        lo = min(e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU)
        hi = max(e.time_range.end for e in events)
        device = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in events if e.device_type == DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False))
        busy, end, by_name = 0.0, lo, {}
        for a, b, name in device:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            a, b = max(a, end), min(b, hi)
            if b > a:
                busy += b - a
                end = b
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        cs.emit("probe", what="decode step", arch=arch, layers=cfg.n_layers,
                step_s=steps, traced_ms=(hi - lo) / 1e3,
                device_ops=len(device), device_busy_share=busy / (hi - lo),
                device_us=sum(by_name.values()),
                top_device_us={name[:80]: us for name, us in top})
        del model, state, pstate
        gc.collect()
        torch.cuda.empty_cache()


# the super-blocks each arch's decode-vs-forward error is measured at, by
# dtype
DEPTHS = {"zamba2-7b": {"float32": (1, 13), "bfloat16": (1, 4, 7, 13)},
          "xlstm-1.3b": {"float32": (1, 3, 6), "bfloat16": (1, 3, 6)}}


def depth() -> None:
    for arch, dtypes in DEPTHS.items():
        full = get_config(arch)
        for dt, blocks in dtypes.items():
            for sb in blocks:
                cfg = full.replace(param_dtype=dt, n_superblocks=sb,
                                   n_layers=len(full.prologue)
                                   + len(full.layer_pattern) * sb)
                model = lm.init_lm(cfg, torch.Generator(
                    device=DEV).manual_seed(0), DEV)
                gen = torch.Generator(device=DEV).manual_seed(0)
                tok = torch.randint(0, cfg.vocab_size, (2, 48),
                                    generator=gen, device=DEV,
                                    dtype=torch.int32)
                dec, fwd = cs.teacher_forced(torch, cfg, model, tok, 32)
                diff = (dec - fwd).abs()
                cs.emit("probe", what="decode vs forward", arch=cfg.name,
                        dtype=dt, layers=cfg.n_layers,
                        rel_err=float(diff.max()) / float(fwd.abs().max()),
                        reference_allclose=bool(
                            (diff <= 0.05 + 0.05 * fwd.abs()).all()),
                        argmax_equal=float((dec.argmax(-1)
                                            == fwd.argmax(-1))
                                           .float().mean()))
                del model, dec, fwd
                gc.collect()
                torch.cuda.empty_cache()
    xlstm_step()


def xlstm_step() -> None:
    """xlstm-1.3b's weighted step at full width and depth (48 layers) on
    the driver's first micro-batch: ``chip_smoke.xlstm_step_trace``."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train

    args = train.build_argparser().parse_args(cs.XLSTM_ARGV)
    cfg = get_config(cs.XLSTM_ARCH)
    model = lm.init_lm(cfg, torch.Generator(device=DEV).manual_seed(
        args.seed), DEV)
    stream = TokenStream(seed=args.seed, batch_per_shard=args.micro_batch,
                         seq_len=args.seq_len, vocab=cfg.vocab_size,
                         n_shards=args.window, device=DEV)
    batch = dict(stream.batch(0, 0))
    batch["weights"] = torch.full((args.micro_batch,),
                                  1.0 / args.micro_batch, device=DEV)
    cs.emit("probe", what="xlstm step", arch=cfg.name, layers=cfg.n_layers,
            **cs.xlstm_step_trace(torch, cfg, model, batch, args.lr))
    del model
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--depth", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_decode_probe: needs a CUDA card", file=sys.stderr)
        return 2
    every = not (args.phases or args.profile or args.depth)
    card = cs.phase_device(torch)
    if args.phases or every:
        phases(card)
    if args.profile or every:
        profile()
    if args.depth or every:
        depth()
    print(card["smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
