"""LM training driver with GRAD-MATCH subset selection, after
``repro/launch/train.py``.

``--arch <id>`` selects an architecture (``--smoke`` for the reduced config;
the port runs the dense attention archs).  The loop is the reference's:

  - a stateless-indexed token stream (``data/tokens.py``);
  - GRAD-MATCHPB candidate selection every R *steps* over a window of W
    upcoming micro-batches: one proxy per micro-batch from
    ``lm.selection_proxy`` (the closed-form head gradient through the fused
    ``hidden_grad`` kernel, no trunk backprop), then OMP picks a weighted
    subset of the micro-batches (``core.gradmatch``, kernels ``corr`` and
    ``corr_argmax``);
  - one weighted SGD step (momentum 0.9, warmup + cosine) on one selected
    micro-batch a step;
  - with ``--checkpoint-dir``, an async snapshot every ``--checkpoint-every``
    steps (parameters, SGD state, the current selection, the token
    stream's state) in the reference's format, and auto-resume from the
    latest one (``[resume] from step N``): a killed run, resumed, takes
    the steps of a run never killed, bit for bit.

It runs on the card unless ``--device cpu`` asks for the CPU; a missing card
raises.  One device only: ``--mesh-data``/``--mesh-model`` above 1 and
``--fsdp`` raise (ROADMAP queue 1, "The rest of the LM side", (g)).
Example::

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \\
      --device cpu --steps 100 --select-every 20 --budget 0.25
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, restore_to
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import gradmatch as gm_lib
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import lm as lm_lib
from repro_torch.models.common import count_params
from repro_torch.optim import cosine_with_warmup, sgd
from repro_torch.train.steps import lm_train_step_fn, make_lm_proxy_step


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="candidate micro-batches per selection window")
    ap.add_argument("--micro-batch", type=int, default=4,
                    help="sequences per micro-batch")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--budget", type=float, default=0.25,
                    help="fraction of candidate micro-batches to train on")
    ap.add_argument("--select-every", type=int, default=20, help="R (steps)")
    ap.add_argument("--window", type=int, default=16,
                    help="candidate window: micro-batches per selection")
    ap.add_argument("--strategy", default="gradmatch-pb",
                    choices=["gradmatch-pb", "random", "full"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--checkpoint-dir")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' asks for "
                         "the CPU)")
    return ap


def main(argv=None, *, stream=None, model: lm_lib.LM | None = None) -> dict:
    """Run the driver; returns its report.

    ``stream`` and ``model`` are seams for a caller that brings its own
    batches (anything with ``batch(step, shard) -> {'tokens', 'targets'}``
    on the device) or its own parameters (``lm.params_from_jax``); by
    default the driver builds a ``TokenStream`` and ``lm.init_lm`` from
    ``--seed``.
    """
    args = build_argparser().parse_args(argv)
    if args.mesh_data > 1 or args.mesh_model > 1 or args.fsdp:
        raise NotImplementedError(
            "the port's driver runs on one device: --mesh-data/--mesh-model "
            "> 1 and --fsdp are not ported yet (ROADMAP queue 1, \"The "
            "rest of the LM side\", (g))")
    device = resolve_device(args.device)
    if model is not None:
        cfg = model.cfg
    else:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))

    if model is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        model = lm_lib.init_lm(cfg, gen, device)
    opt = sgd(model.parameters(), cosine_with_warmup(args.lr, 10, args.steps),
              momentum=0.9)
    step_fn = lm_train_step_fn(cfg, model, opt)
    proxy_fn = make_lm_proxy_step(cfg, model)
    if stream is None:
        stream = TokenStream(seed=args.seed,
                             batch_per_shard=args.micro_batch,
                             seq_len=args.seq_len, vocab=cfg.vocab_size,
                             n_shards=args.window, device=device)

    ckpt = (CheckpointManager(args.checkpoint_dir)
            if args.checkpoint_dir else None)
    params = dict(model.named_parameters())

    # Current selection over the candidate window (micro-batch granularity).
    k_batches = max(int(args.window * args.budget), 1)
    sel_batches = np.arange(k_batches)
    sel_weights = np.full((k_batches,), 1.0 / k_batches, np.float32)

    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        snap = ckpt.restore()
        with torch.no_grad():
            for name, val in restore_to(snap["params"], device).items():
                params[name].copy_(val)
        opt.load_state_tree(restore_to(snap["opt_state"], device), params)
        start_step = TokenStream.resume(snap["meta"])
        # The selection in force (the reference's snapshot lacks it, so a
        # resume between selection steps would train on another one).
        sel_batches = np.asarray(snap["selection"]["batches"], np.int64)
        sel_weights = np.asarray(snap["selection"]["weights"], np.float32)
        print(f"[resume] from step {start_step}")

    losses, selections = [], []
    t0 = time.perf_counter()
    sel_seconds = 0.0
    window_round = start_step // args.select_every

    for step in range(start_step, args.steps):
        # --- selection round: pick micro-batches from the upcoming window --
        if args.strategy != "full" and step % args.select_every == 0:
            window_round = step // args.select_every
            ts = time.perf_counter()
            if args.strategy == "gradmatch-pb":
                proxies = torch.stack([
                    proxy_fn(stream.batch(window_round, s)).mean(dim=0)
                    for s in range(args.window)])
                sel = gm_lib.gradmatch(proxies, k_batches, lam=args.lam)
                m = sel.mask.cpu().numpy()
                sel_batches = sel.indices.cpu().numpy()[m]
                sel_weights = sel.weights.cpu().numpy()[m]
            else:  # random
                rng = np.random.default_rng(args.seed + step)
                sel_batches = rng.choice(args.window, k_batches,
                                         replace=False)
                sel_weights = np.full((k_batches,), 1.0 / k_batches,
                                      np.float32)
            sel_seconds += time.perf_counter() - ts
            selections.append({"round": window_round,
                               "indices": sel_batches.tolist(),
                               "weights": sel_weights.tolist()})

        # --- one weighted step on one selected micro-batch -----------------
        pick = step % len(sel_batches)
        batch = dict(stream.batch(window_round, int(sel_batches[pick])))
        scale = np.float32(sel_weights[pick]) * np.float32(len(sel_batches))
        batch["weights"] = torch.full(
            (args.micro_batch,), 1.0 / args.micro_batch,
            dtype=torch.float32, device=device) * float(scale)
        metrics = step_fn(batch)
        losses.append(float(metrics["loss"]))

        if ckpt is not None and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, {
                "params": params,
                "opt_state": opt.state_tree(params),
                "meta": {"step": step + 1, "seed": args.seed},
                "selection": {"batches": np.asarray(sel_batches, np.int64),
                              "weights": sel_weights},
            })

    if ckpt is not None:
        ckpt.wait()
    wall = time.perf_counter() - t0
    report = {
        "arch": args.arch, "strategy": args.strategy,
        "loss_first": float(np.mean(losses[:5])),
        "loss_last": float(np.mean(losses[-5:])),
        "steps": args.steps, "start_step": start_step, "wall_s": wall,
        "selection_s": sel_seconds,
        "params": count_params(model), "device": str(device),
    }
    print(report)
    report.update(losses=losses, selections=selections)
    return report


if __name__ == "__main__":
    main()
