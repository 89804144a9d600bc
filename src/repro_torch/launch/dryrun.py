"""Dry run of every (arch x shape x mesh) cell on the production meshes,
after ``repro/launch/dryrun.py``: the proof that the distribution config is
coherent without the hardware.

Each cell runs in a process that installs a fake process group
(``torch.testing._internal.distributed.fake_pg``) of 256 ranks for the
(16, 16) ('data', 'model') mesh or 512 for (2, 16, 16) ('pod', 'data',
'model'), as rank 0.  The parameters (and, for train, SGD's momentum and
the gradients) are meta tensors placed as DTensors by
``distributed.sharding.param_shardings``; the cell's step runs eagerly on
them inside the hint rules of ``logical_rules``:

  - train:   ``lm_loss``, the backward with remat, the SGD update, with
    the microbatches the reference adapts (~2 sequences a data rank): one
    microbatch is run and counted as many times as there are, since they
    are alike, and the update once;
  - prefill: ``prefill_step`` (the encoder head for an encoder-only
    arch);
  - decode:  ``decode_step`` of one token at the last position of a full
    cache (every cache chunk attended), on the placed decode state.

Nothing is allocated and nothing is computed: the meta device carries
shapes only, and the fake group's collectives return at once.  What a
cell records, under the reference's keys where they mean the same:

  - memory: the exact per-rank resident bytes (parameters, momentum and
    gradients, or the decode state) from the local shards' shapes, the
    reference's ``analytic_memory_gib`` beside them, and a fit verdict
    against the H100's 80 GB with the activations analytic;
  - ``hlo_flops_per_chip``: the matrix-product FLOPs rank 0's shards
    execute, from ``comm_analysis.CostMode``;
  - collectives a step (counts and input bytes by kind), the roofline
    terms on the H100, ``model_flops_global``, ``useful_flops_ratio``,
    ``params_total`` and ``params_active``.

The cost pass runs the cell at one and at two super-blocks (large flash
tiles, as the reference's cost modules take) and extrapolates linearly,
``cost(L) = cost(1) + (L - 1) * max(cost(2) - cost(1), 0)``: super-blocks
are alike, and a cell's time does not grow with its depth.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k [--multi-pod] [--microbatches 4] [--out out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--skip-existing]

``--all`` runs every cell of ``configs.all_cells()`` in a subprocess of its
own and writes one JSON a cell under ``build/dryrun_torch/<mesh>/``.  The
JSON is a record of the cell, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import dtensor as dt
from repro_torch.distributed.sharding import (axis_size, axis_sizes,
                                              distribute_model,
                                              logical_rules, param_shardings)
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.comm_analysis import (CollectiveStats, CostMode,
                                              analytic_hbm_bytes,
                                              roofline_terms)
from repro_torch.models import lm as lm_lib
from repro_torch.optim import sgd

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACT_DIR = os.path.join(os.path.dirname(_SRC), "build", "dryrun_torch")

# NVIDIA H100 80GB HBM3: the card's memory, and the per-shard weight size
# past which decode gathers its weights over data x model (half the card),
# where the reference takes half of a 16 GB TPU v5e.
H100_HBM_BYTES = 80e9
GATHER_DECODE_BYTES = H100_HBM_BYTES / 2


def install_fake_group(world_size: int) -> None:
    """A fake default process group of ``world_size`` ranks, this process
    rank 0: collectives return at once and move nothing."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            "(FakeStore), which this torch lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _ranks(mesh) -> int:
    return axis_size(mesh, tuple(axis_sizes(mesh)))


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def gathered_decode(cfg: ModelConfig, mesh) -> bool:
    """Weight-gathered decode: the weights shard over data x model when
    their TP shard alone would take half the card."""
    return cfg.param_count() * 2 / axis_size(mesh, "model") > \
        GATHER_DECODE_BYTES


def _local_bytes(t) -> int:
    local = t.to_local() if dt.is_dtensor(t) else t
    return local.numel() * local.element_size()


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return _local_bytes(tree)


def _placed_model(cfg: ModelConfig, mesh, fsdp: bool) -> lm_lib.LM:
    model = specs_lib.param_specs_shapes(cfg)
    return distribute_model(model, param_shardings(cfg, model, mesh,
                                                   fsdp=fsdp))


def _placed_batch(cfg, shape, mesh, seq_shard=False) -> dict:
    batch = specs_lib.input_specs(cfg, shape)
    return specs_lib.distribute(batch, specs_lib.batch_shardings(
        mesh, batch, seq_shard=seq_shard))


def _micro(shape: ShapeConfig, microbatches: int) -> ShapeConfig:
    """One microbatch of a train cell: its share of the sequences."""
    return ShapeConfig(shape.name, shape.seq_len,
                       shape.global_batch // microbatches, shape.kind)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               microbatches: int):
    """(the step as thunks, its resident bytes a rank by part).

    The thunks are ``[(thunk, times)]``: the step is each thunk run
    ``times`` times in turn.  A train step is one microbatch's ``lm_loss``
    and backward with remat, its gradients added into the f32 sums, run
    ``microbatches`` times (the microbatches are alike: same shapes, same
    operations, same collectives), then SGD's update once."""
    if shape.kind == "train":
        model = _placed_model(cfg, mesh, fsdp=True)
        opt = sgd(model.parameters(), 0.01, momentum=0.9,
                  weight_decay=5e-4)
        batch = _placed_batch(cfg, _micro(shape, microbatches), mesh)
        sums = {p: torch.zeros_like(p, dtype=torch.float32)
                for p in model.parameters()}

        def micro():
            loss, _ = lm_lib.lm_loss(cfg, model, batch)
            loss.backward()
            for p, acc in sums.items():
                acc.add_(p.grad.float())
                p.grad = None

        p_bytes = _tree_bytes(list(model.parameters()))
        n_local = sum(_local_bytes(p) // p.element_size()
                      for p in model.parameters())
        resident = {"params": p_bytes, "momentum": n_local * 4,
                    # the step's gradients in the parameter dtype, and
                    # the f32 sums across microbatches
                    "grads": p_bytes + (n_local * 4 if microbatches > 1
                                        else 0)}
        return [(micro, microbatches),
                (lambda: opt.step(grads=sums), 1)], resident
    if shape.kind == "prefill":
        model = _placed_model(cfg, mesh, fsdp=False)
        batch = _placed_batch(cfg, shape, mesh)
        resident = {"params": _tree_bytes(list(model.parameters()))}
        if cfg.encoder_only:
            def run():
                with torch.no_grad():
                    h, _, _ = lm_lib.forward(cfg, model, batch.get("tokens"),
                                             embeds=batch.get("embeds"))
                    return lm_lib._head_out(cfg, model, h)
            return [(run, 1)], resident
        states = specs_lib.decode_state_specs(cfg, shape)
        resident["decode_state"] = _tree_bytes(specs_lib.distribute(
            states, specs_lib.state_shardings(cfg, mesh, states)))
        return [(lambda: lm_lib.prefill_step(
            cfg, model, batch.get("tokens"), embeds=batch.get("embeds"),
            vision=batch.get("vision")), 1)], resident
    # decode
    seq_shard = shape.global_batch == 1
    model = _placed_model(cfg, mesh, fsdp=gathered_decode(cfg, mesh))
    batch = _placed_batch(cfg, shape, mesh, seq_shard=seq_shard)
    states = specs_lib.decode_state_specs(cfg, shape)
    states = specs_lib.distribute(states, specs_lib.state_shardings(
        cfg, mesh, states, seq_shard=seq_shard))
    resident = {"params": _tree_bytes(list(model.parameters())),
                "decode_state": _tree_bytes(states)}
    if batch.get("tokens") is None:
        raise ValueError("decode requires tokens")
    return [(lambda: lm_lib.decode_step(cfg, model, states, batch["tokens"],
                                        shape.seq_len - 1), 1)], resident


def analytic_memory_gib(cfg: ModelConfig, shape: ShapeConfig, mesh,
                        microbatches: int, fsdp_decode: bool | None = None
                        ) -> dict:
    """Coarse per-card memory accounting, the reference's arithmetic term
    for term: the activations a fused step holds, which the meta run
    cannot see.  ``fsdp_decode`` (default ``gathered_decode``) says
    whether decode weights shard over every rank."""
    sizes = axis_sizes(mesh)
    n_chips = _ranks(mesh)
    tp = sizes["model"]
    dp = n_chips // tp
    n_params = cfg.param_count()
    d = {"params_gib": n_params * 2 / 2**30, "per_chip": {}}
    pc = d["per_chip"]
    if shape.kind == "train":
        shard = n_chips  # fsdp: model x data
        pc["params"] = n_params * 2 / shard
        pc["momentum"] = n_params * 4 / shard
        pc["grads_f32"] = n_params * 4 / shard
        tokens_chip = shape.tokens // (dp * microbatches)
        # remat superblock carries + one layer's working set + f32 logits
        pc["act_carries"] = cfg.n_superblocks * tokens_chip * cfg.d_model * 2
        pc["logits_f32"] = tokens_chip * cfg.padded_vocab // tp * 4
    else:
        if fsdp_decode is None:
            fsdp_decode = gathered_decode(cfg, mesh)
        w_shard = n_chips if fsdp_decode else tp
        pc["params"] = n_params * 2 / w_shard
        # KV caches / recurrent states: states shard over data x model
        # (heads or head_dim fallback), i.e. ~n_chips-way.
        state_bytes = 0
        for kind in cfg.layer_types_in_order():
            if kind in ("attn", "global", "shared_attn"):
                s_eff = shape.seq_len
            elif kind == "local":
                s_eff = min(cfg.sliding_window or shape.seq_len,
                            shape.seq_len)
            else:   # recurrent: O(1) state per head — negligible
                s_eff = 0
            state_bytes += (2 * shape.global_batch * s_eff
                            * cfg.kv_dim * 2)
        pc["kv_states"] = state_bytes / n_chips
        tokens_chip = max(shape.tokens // dp, shape.seq_len // dp) \
            if shape.kind == "prefill" else shape.global_batch
        pc["activations"] = tokens_chip * cfg.d_model * 2 * 4  # ~4 live
    pc = {k: round(v / 2**30, 3) for k, v in pc.items()}
    d["per_chip"] = pc
    d["per_chip_total_gib"] = round(sum(pc.values()), 2)
    return d


def _cost(cfg, shape, mesh, microbatches) -> dict:
    """One eager step of the cell inside ``CostMode`` and the rules: each
    of ``build_cell``'s thunks run once and counted ``times`` times."""
    thunks, _ = build_cell(cfg, shape, mesh, microbatches)
    t0 = time.perf_counter()
    flops = op_bytes = 0
    coll = CollectiveStats()
    for thunk, times in thunks:
        with dt.mesh_mode(mesh, logical_rules(mesh)), CostMode() as cm:
            thunk()
        flops += cm.flops * times
        op_bytes += cm.op_bytes * times
        for op, n in cm.collectives.counts.items():
            coll.counts[op] = coll.counts.get(op, 0) + n * times
            coll.operand_bytes[op] = coll.operand_bytes.get(op, 0) + (
                cm.collectives.operand_bytes[op] * times)
    return {"seconds": time.perf_counter() - t0, "flops": flops,
            "bytes": op_bytes, "coll": coll}


def default_microbatches(shape: ShapeConfig, mesh) -> int:
    """~2 sequences a data rank a microbatch, as the reference adapts."""
    dp = _ranks(mesh) // axis_size(mesh, "model")
    return max(shape.global_batch // (2 * dp), 1)


def run_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
             microbatches: int = 0) -> dict:
    """Place, run and account one cell on ``mesh``; the record."""
    sizes = axis_sizes(mesh)
    n_chips = _ranks(mesh)
    if shape.kind != "train":
        microbatches = 1
    elif not microbatches:
        microbatches = default_microbatches(shape, mesh)
    t0 = time.perf_counter()
    _, resident = build_cell(cfg, shape, mesh, microbatches)

    L = cfg.n_superblocks
    cost_cfg = cfg.replace(n_layers=0, flash_block_q=8192,
                           flash_block_kv=8192)
    c1 = _cost(cost_cfg.replace(n_superblocks=1), shape, mesh, microbatches)
    c2 = _cost(cost_cfg.replace(n_superblocks=2), shape, mesh, microbatches)

    def extrap(a, b):
        return a + (L - 1) * max(b - a, 0)

    flops = extrap(c1["flops"], c2["flops"])
    op_bytes = extrap(c1["bytes"], c2["bytes"])
    coll = CollectiveStats()
    for op in sorted(set(c1["coll"].counts) | set(c2["coll"].counts)):
        coll.counts[op] = extrap(c1["coll"].counts.get(op, 0),
                                 c2["coll"].counts.get(op, 0))
        coll.operand_bytes[op] = extrap(c1["coll"].operand_bytes.get(op, 0),
                                        c2["coll"].operand_bytes.get(op, 0))
    fsdp_decode = shape.kind == "decode" and gathered_decode(cfg, mesh)
    hbm = analytic_hbm_bytes(cfg, shape, n_chips, sizes["model"],
                             microbatches, fsdp_decode=fsdp_decode)
    terms = roofline_terms(flops, hbm, coll.total_bytes, n_chips)

    analytic = analytic_memory_gib(cfg, shape, mesh, microbatches)
    resident_total = sum(resident.values())
    act_gib = sum(v for k, v in analytic["per_chip"].items()
                  if k in ("act_carries", "logits_f32", "activations"))
    peak = resident_total + act_gib * 2**30
    # MODEL_FLOPS: 6 N_active D for train (fwd + bwd), 2 N_active D else
    tokens = (shape.tokens if shape.kind != "decode"
              else shape.global_batch)
    model_flops = cfg.flops_per_token() * tokens * (
        1.0 if shape.kind == "train" else 1.0 / 3.0)
    flops_global = flops * n_chips
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name(mesh),
        "kind": shape.kind, "microbatches": microbatches, "ok": True,
        "run_s": round(time.perf_counter() - t0, 2),
        "cost_pass_s": [round(c1["seconds"], 2), round(c2["seconds"], 2)],
        "memory": {
            "resident_bytes": resident,
            "resident_total_bytes": resident_total,
            "activations_gib_analytic": act_gib,
            "peak_device_bytes": peak,
            "fits_80gb": bool(peak <= H100_HBM_BYTES),
            "analytic": analytic,
        },
        "hlo_flops_per_chip": flops,
        "op_bytes_per_chip": op_bytes,
        "hbm_bytes_per_chip_analytic": hbm,
        "collectives": coll.as_dict(),
        "roofline": terms,
        "model_flops_global": model_flops,
        "useful_flops_ratio": (model_flops / flops_global
                               if flops_global else None),
        "params_total": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
        "weight_gathered_decode": fsdp_decode,
    }


def production_cell(arch: str, shape_name: str, multi_pod: bool,
                    microbatches: int = 0) -> dict:
    """One cell on the production mesh, in this process (the fake group
    installed here and destroyed after)."""
    install_fake_group(512 if multi_pod else 256)
    try:
        return run_cell(get_config(arch), SHAPES[shape_name],
                        make_production_mesh(multi_pod=multi_pod),
                        microbatches)
    finally:
        dist.destroy_process_group()


def summary(result: dict) -> str:
    m = result["memory"]
    return (f"{result['arch']} x {result['shape']} ({result['mesh']}): OK  "
            f"resident/device={m['resident_total_bytes'] / 2**30:.2f} GiB  "
            f"peak/device={m['peak_device_bytes'] / 2**30:.2f} GiB  "
            f"flops/chip={result['hlo_flops_per_chip']:.3g}  "
            f"coll={result['collectives']['total_bytes'] / 2**30:.3f} GiB  "
            f"dominant={result['roofline']['dominant']}")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cell_out_path(arch: str, shape: str, multi_pod: bool) -> str:
    d = os.path.join(ARTIFACT_DIR, "2x16x16" if multi_pod else "16x16")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs import ARCH_IDS
        failures = []
        for arch in ARCH_IDS:
            for shape in applicable_shapes(get_config(arch)):
                out = _cell_out_path(arch, shape.name, args.multi_pod)
                if args.skip_existing and os.path.exists(out):
                    with open(out) as f:
                        if json.load(f).get("ok"):
                            print(f"[skip] {arch} x {shape.name}")
                            continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape.name,
                       "--microbatches", str(args.microbatches),
                       "--out", out]
                if args.multi_pod:
                    cmd.append("--multi-pod")
                print(f"[run ] {arch} x {shape.name} "
                      f"({'2x16x16' if args.multi_pod else '16x16'})",
                      flush=True)
                path = os.environ.get("PYTHONPATH")
                r = subprocess.run(cmd, env={
                    **os.environ,
                    "PYTHONPATH": _SRC + (os.pathsep + path if path else "")})
                if r.returncode != 0:
                    failures.append((arch, shape.name))
        print(f"\n{'FAILURES: ' + str(failures) if failures else 'all ok'}")
        sys.exit(1 if failures else 0)

    try:
        result = production_cell(args.arch, args.shape, args.multi_pod,
                                 args.microbatches)
    except Exception:
        result = {"arch": args.arch, "shape": args.shape,
                  "mesh": "2x16x16" if args.multi_pod else "16x16",
                  "ok": False, "error": traceback.format_exc()}
    out = args.out or _cell_out_path(args.arch, args.shape, args.multi_pod)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    if result["ok"]:
        print(summary(result))
    else:
        print(result["error"], file=sys.stderr)
        print(f"{args.arch} x {args.shape}: FAILED", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
