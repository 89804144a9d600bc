"""Serving driver, after ``repro/launch/serve.py``: batched prefill, then
greedy decode a token at a time against the KV caches.

A queue of synthetic prompts (drawn from ``--seed`` as the reference draws
them) is admitted in batches of ``--batch``: each batch is prefilled, its
caches are seated into buffers of ``prompt_len + gen_len`` slots
(``_seat``), and ``--gen-len`` tokens are decoded.  A last batch shorter
than ``--batch`` is padded with copies of its last prompt, as the
reference's comment intends (its comprehension raises there instead); the
report counts only the real requests and their tokens.

An encoder-only config (hubert-xlarge) has no decode step, and a config
with ``xattn`` layers (llama-3.2-vision-90b) needs ``vision`` states for
its prefill, which this driver's queue of token prompts does not carry:
``main`` refuses both with ``SystemExit``, as the reference refuses the
first (its prefill fails on the second); ``generate`` takes ``vision``.

It runs on the card unless ``--device cpu`` asks for the CPU; a missing
card raises.  Example::

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import XATTN, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm as lm_lib


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' asks for "
                         "the CPU)")
    return ap


def _seat(full_state, prefill_state):
    """Copy the prefill caches into the (larger) decode buffers, leaf by
    leaf, along the first dim where their shapes differ (the sequence
    dim); the buffers are written in place.  A leaf of the buffer's shape
    (a recurrent state, an ``xattn`` layer's vision K / V of ``(B, n_img,
    kv, hd)``) is the prefill's own.  A window layer's prefill ring
    is ``window`` slots, which may be more than a decode buffer of
    ``s_max < window`` slots: it is cut to the buffer, since slots past
    the prompt are empty."""
    if isinstance(full_state, Mapping):
        return {k: _seat(full_state[k], prefill_state[k])
                for k in full_state}
    if isinstance(full_state, (list, tuple)):
        return [_seat(f, p) for f, p in zip(full_state, prefill_state)]
    f, p = full_state, prefill_state
    if p.shape == f.shape:
        return p.to(f.dtype)
    dim = next(i for i, (a, b) in enumerate(zip(f.shape, p.shape))
               if a != b)
    if p.shape[dim] > f.shape[dim]:
        return p.narrow(dim, 0, f.shape[dim]).to(f.dtype)
    f.narrow(dim, 0, p.shape[dim]).copy_(p)
    return f


@torch.no_grad()
def generate(cfg: ModelConfig, model: lm_lib.LM, prompts: torch.Tensor,
             gen_len: int, vision: torch.Tensor | None = None
             ) -> torch.Tensor:
    """Greedy continuation of ``prompts`` (B, P) int on the model's device
    (with their ``vision`` states (B, N, d_embed) for an ``xattn`` model):
    the prefill's argmax, then one argmax per decode step at positions
    P .. P + gen_len - 1.  Returns the (B, gen_len + 1) tokens, on the
    device, as the reference's loop computes them."""
    b, plen = prompts.shape
    device = prompts.device
    logits, pstate = lm_lib.prefill_step(cfg, model, prompts, vision=vision)
    state = _seat(lm_lib.init_decode_state(cfg, b, plen + gen_len, device),
                  pstate)
    cur = logits.argmax(-1)[:, None].to(torch.int32)
    out = [cur]
    for i in range(gen_len):
        logits, state = lm_lib.decode_step(cfg, model, state, cur, plen + i)
        cur = logits.argmax(-1)[:, None].to(torch.int32)
        out.append(cur)
    return torch.cat(out, dim=1)


def main(argv=None, *, model: lm_lib.LM | None = None) -> dict:
    """Serve the queue; returns the reference's report (``arch``,
    ``requests``, ``tokens``, ``wall_s``, ``tok_per_s``).

    ``model`` is a seam for a caller that brings its own parameters (its
    ``cfg`` is then used); by default the driver builds ``lm.init_lm``
    from ``--seed`` on the device.
    """
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if model is not None:
        cfg = model.cfg
    else:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    if XATTN in cfg.prologue + cfg.layer_pattern:
        raise SystemExit(f"{args.arch} cross-attends to vision states: its "
                         f"prefill needs a `vision` input, which this "
                         f"driver's token prompts do not carry")
    if model is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = lm_lib.init_lm(cfg, gen, device)

    # Request queue: synthetic prompts, admitted in fixed-size batches.
    rng = np.random.default_rng(args.seed)
    queue = [rng.integers(0, cfg.vocab_size, (args.prompt_len,))
             for _ in range(args.requests)]

    done = tokens_out = 0
    t0 = time.perf_counter()
    for start in range(0, len(queue), args.batch):
        real = queue[start:start + args.batch]
        batch = real + [real[-1]] * (args.batch - len(real))
        toks = torch.as_tensor(np.stack(batch), dtype=torch.int32,
                               device=device)
        generate(cfg, model, toks, args.gen_len)
        done += len(real)
        tokens_out += len(real) * args.gen_len
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    report = {"arch": args.arch, "requests": done,
              "tokens": tokens_out, "wall_s": round(wall, 2),
              "tok_per_s": round(tokens_out / wall, 1)}
    print(report)
    return report


if __name__ == "__main__":
    main()
