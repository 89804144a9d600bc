"""LM training driver with GRAD-MATCH subset selection, after
``repro/launch/train.py``.

``--arch <id>`` selects an architecture (``--smoke`` for the reduced config;
the port runs all ten).  Its own token stream has tokens only, as the
reference's has: the ``vlm`` and ``audio`` families (llama-3.2-vision-90b,
hubert-xlarge) need a caller's ``stream=`` whose batches carry ``vision``
or ``embeds``, and without one the driver raises.  The loop is the
reference's:

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
raises.

``--mesh-data D --mesh-model M`` (either above 1) or ``--fsdp`` runs it on a
('data', 'model') mesh of the ranks there are (``launch/mesh.py:
make_host_mesh``, each axis clamped to them): the parameters are DTensors
placed by ``distributed.sharding.param_shardings``, each batch is sharded
over 'data', and the step runs inside the hint rules of ``logical_rules``.
The selection goes through ``core/distributed.sharded_omp_select`` over
the 'data' ranks when that axis is above 1 and divides the window, and a
snapshot restores through ``elastic.reshard_like`` onto any rank count.
Under ``torchrun`` the driver takes its process group from the environment
(NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``); a caller may
install one first; with neither it makes a one-rank group of its own.  A
group the driver made is destroyed when it returns.  Only rank 0 writes
snapshots.  Without the three flags the parameters stay plain tensors.
Examples::

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \\
      --device cpu --steps 100 --select-every 20 --budget 0.25
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch gemma-2b --mesh-data 2 --mesh-model 2 --fsdp
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, restore_to
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import distributed as dist_lib
from repro_torch.core import gradmatch as gm_lib
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed import dtensor as dt
from repro_torch.distributed.sharding import (distribute_model,
                                              logical_rules, param_shardings)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.elastic import reshard_like
from repro_torch.models import lm as lm_lib
from repro_torch.models.common import count_params
from repro_torch.optim import cosine_with_warmup, sgd
from repro_torch.train.steps import lm_train_step_fn, make_lm_proxy_step


# the stub inputs a family's batches carry beside the targets
_STUB_INPUTS = {"vlm": "vision states (batch['vision'])",
                "audio": "frame embeddings (batch['embeds'])"}


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
    on the device, and ``vision`` (B, N, d_embed) for a ``vlm`` model or
    ``embeds`` (B, S, d_model) in place of ``tokens`` for an ``audio``
    one: every key goes to the step and the proxy as it is) or its own
    parameters (``lm.params_from_jax``); by default the driver builds a
    ``TokenStream`` and ``lm.init_lm`` from ``--seed``.
    """
    args = build_argparser().parse_args(argv)
    if not (args.mesh_data > 1 or args.mesh_model > 1 or args.fsdp):
        return _run(args, resolve_device(args.device), None, stream, model)
    device = resolve_device(args.device)
    own = False
    if not dist.is_initialized() and "LOCAL_RANK" in os.environ:
        # torchrun: the group from the environment
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        own = True
    try:
        mesh = mesh_lib.make_host_mesh(args.mesh_data, args.mesh_model,
                                       device.type)
        return _run(args, device, mesh, stream, model)
    finally:
        mesh_lib.close_host_group()
        if own:
            dist.destroy_process_group()


def _gathered(tree):
    """A snapshot tree with each DTensor gathered whole (a collective:
    every rank takes part; rank 0 writes)."""
    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    return dt.gather_full(tree) if isinstance(tree, torch.Tensor) else tree


def _run(args, device, mesh, stream, model) -> dict:
    """The loop, on ``device`` alone (``mesh`` None) or on ``mesh``."""
    if model is not None:
        cfg = model.cfg
    else:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    if stream is None and cfg.family in _STUB_INPUTS:
        raise SystemExit(
            f"{cfg.name} reads {_STUB_INPUTS[cfg.family]}, which the "
            f"driver's TokenStream does not draw: pass main(stream=...) a "
            f"stream whose batches carry them")

    if model is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        model = lm_lib.init_lm(cfg, gen, device)
    shardings = None
    if mesh is not None:
        shardings = param_shardings(cfg, model, mesh, fsdp=args.fsdp)
        model = distribute_model(model, shardings)
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
    rank = dist.get_rank() if mesh is not None else 0
    data_ranks = mesh.shape[0] if mesh is not None else 1

    def placed(batch: dict) -> dict:
        """A batch as DTensors sharded over 'data' (each rank holds the
        whole batch: the stream is stateless-indexed)."""
        if mesh is None:
            return batch
        from torch.distributed.tensor import distribute_tensor
        sh = specs_lib.batch_shardings(mesh, batch)
        return {k: distribute_tensor(v, mesh, sh[k].placements,
                                     src_data_rank=None)
                for k, v in batch.items()}

    def restored(tree: dict) -> dict:
        """Snapshot leaves by parameter name on the device, placed as
        their parameters."""
        if mesh is None:
            return restore_to(tree, device)
        return reshard_like(tree, {k: shardings[k] for k in tree})

    # Current selection over the candidate window (micro-batch granularity).
    k_batches = max(int(args.window * args.budget), 1)
    sel_batches = np.arange(k_batches)
    sel_weights = np.full((k_batches,), 1.0 / k_batches, np.float32)

    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        snap = ckpt.restore()
        with torch.no_grad():
            for name, val in restored(snap["params"]).items():
                params[name].copy_(val)
        opt_state = dict(snap["opt_state"])
        opt_state["slots"] = restored(opt_state.get("slots", {}))
        opt.load_state_tree(opt_state, params)
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
                with _rules(mesh):
                    proxies = dt.gather_full(torch.stack([
                        proxy_fn(placed(stream.batch(window_round, s))
                                 ).mean(dim=0)
                        for s in range(args.window)]))
                if data_ranks > 1 and args.window % data_ranks == 0:
                    sel = dist_lib.sharded_omp_select(
                        proxies, proxies.sum(dim=0), k_batches,
                        group=mesh.get_group("data"), lam=args.lam)
                else:
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
        with _rules(mesh):
            metrics = step_fn(placed(batch))
        losses.append(float(dt.gather_full(metrics["loss"])))

        if ckpt is not None and (step + 1) % args.checkpoint_every == 0:
            tree = {
                "params": params,
                "opt_state": opt.state_tree(params),
                "meta": {"step": step + 1, "seed": args.seed},
                "selection": {"batches": np.asarray(sel_batches, np.int64),
                              "weights": sel_weights},
            }
            if mesh is not None:
                tree = _gathered(tree)
            if rank == 0:
                ckpt.save(step + 1, tree)

    if ckpt is not None:
        ckpt.wait()
    wall = time.perf_counter() - t0
    report = {
        "arch": args.arch, "strategy": args.strategy,
        "mesh": None if mesh is None else dict(zip(mesh.mesh_dim_names,
                                                   mesh.shape)),
        "loss_first": float(np.mean(losses[:5])),
        "loss_last": float(np.mean(losses[-5:])),
        "steps": args.steps, "start_step": start_step, "wall_s": wall,
        "selection_s": sel_seconds,
        "params": count_params(model), "device": str(device),
    }
    if rank == 0:
        print(report)
    report.update(losses=losses, selections=selections)
    return report


def _rules(mesh):
    """The mesh's hint rules (and implicit replication), or nothing."""
    import contextlib
    return (contextlib.nullcontext() if mesh is None
            else dt.mesh_mode(mesh, logical_rules(mesh)))


if __name__ == "__main__":
    main()
