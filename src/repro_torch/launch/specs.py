"""Meta-tensor stand-ins and placements for every dry-run cell, after
``repro/launch/specs.py``.

``input_specs(cfg, shape)`` gives the batch a step consumes as tensors on
the meta device (shapes and dtypes, **no allocation**);
``batch_shardings`` / ``state_shardings`` assign placements with the
divisibility fallback of ``distributed.sharding.fit_spec``:

  - batch dim  -> ('pod', 'data')          [dropped if it does not divide]
  - KV-cache heads -> 'model', falling back to head_dim when the arch has
    fewer KV heads than the model axis (gemma-2b MQA, gemma2-9b kv=8)
  - global_batch=1 long-context cells -> sequence dim over ('pod', 'data')
    (sequence parallelism for the 500k KV residency)

The port's decode state keeps each super-block as an entry of the list
``blocks``, where the reference stacks them, so no state leaf is stacked.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (P, Sharding, _dp_entry,
                                              axis_size, batch_spec, dp_axes,
                                              fit_spec)
from repro_torch.models import lm as lm_lib

BF16 = torch.bfloat16
META = "meta"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Input stand-ins
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of (arch x shape) as meta tensors.

    train / prefill: the full (B, S) token batch (audio: frame embeddings,
    vlm: tokens + vision states).  decode: one new token (B, 1) and the
    0-d position; the cache comes from ``decode_state_specs``.
    """
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind
    batch: dict[str, Any] = {}
    tok_shape = (b, 1) if kind == "decode" else (b, s)
    if cfg.family == "audio":
        # the modality frontend is a stub: precomputed frame embeddings
        batch["embeds"] = _meta((*tok_shape, cfg.d_model), BF16)
    else:
        batch["tokens"] = _meta(tok_shape, torch.int32)
    if cfg.family == "vlm" and kind != "decode":
        batch["vision"] = _meta((b, cfg.vision.n_tokens, cfg.vision.d_embed),
                                BF16)
    if kind == "train":
        batch["targets"] = _meta(tok_shape, torch.int32)
        batch["weights"] = _meta((b,), torch.float32)
    if kind == "decode":
        batch["pos"] = _meta((), torch.int32)
    return batch


# ---------------------------------------------------------------------------
# Placement assignment
# ---------------------------------------------------------------------------

def batch_shardings(mesh, batch: dict, *, seq_shard: bool = False) -> dict:
    """Name -> ``Sharding`` of each batch entry: the batch dim over the DP
    axes, or for a long-context entry of batch 1 its sequence dim."""

    def spec_for(name: str, t) -> P:
        if t.dim() == 0:
            return P()
        return batch_spec(mesh, t.dim(), seq_shard=(
            seq_shard and name != "weights" and t.shape[0] == 1))

    return {k: Sharding(mesh, fit_spec(tuple(v.shape), spec_for(k, v), mesh))
            for k, v in batch.items()}


def _state_leaf_spec(path: str, shape: tuple, mesh, *, stacked: bool,
                     seq_shard: bool) -> P:
    """Greedy divisible assignment for one decode-state leaf.

    Layout conventions (models/*):
      KV cache   (B, S, H_kv, hd)      slot_pos (B, S)
      SSM state  (B, H, P, N)          conv state (B, W, d_in)
      mLSTM C    (B, H, qk, v)         mlstm/slstm vectors (B, H*x) / (B, d)
    """
    dims = list(shape[1:]) if stacked else list(shape)
    ndim = len(dims)
    dpe = _dp_entry(mesh)
    model = "model"
    msize = axis_size(mesh, model)
    dsize = axis_size(mesh, dp_axes(mesh))

    entries: list = [None] * ndim
    # 1) data axes on the batch dim when divisible; else (long_500k) on the
    #    sequence dim of KV caches.
    if ndim >= 1 and dims[0] % dsize == 0 and dims[0] > 1:
        entries[0] = dpe
    elif seq_shard and ndim >= 2 and dims[1] % dsize == 0:
        entries[1] = dpe
    # 2) model axis on the first remaining dim it divides (heads, then
    #    head_dim / state dims).  Skip the sequence dim of KV caches
    #    (dim 1 for 4-d caches) so decode writes stay local in the common
    #    case; fall back to it if nothing else divides.
    candidates = [i for i in range(ndim - 1, 0, -1)
                  if entries[i] is None]
    candidates = sorted(candidates, key=lambda i: (i == 1, -i))
    for i in candidates:
        if dims[i] % msize == 0 and dims[i] > 1:
            entries[i] = model
            break
    if stacked:
        entries = [None] + entries
    return P(*entries)


def _map(tree, fn):
    """``tree`` (dicts and lists of tensors) with ``fn`` at each leaf."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def state_shardings(cfg: ModelConfig, mesh, state_shapes: Any, *,
                    seq_shard: bool = False) -> Any:
    """A ``Sharding`` for every leaf of a decode-state tree."""

    def one(leaf):
        spec = _state_leaf_spec("", tuple(leaf.shape), mesh, stacked=False,
                                seq_shard=seq_shard)
        return Sharding(mesh, fit_spec(tuple(leaf.shape), spec, mesh))

    return _map(state_shapes, one)


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig) -> Any:
    """The decode state as meta tensors (no allocation)."""
    return lm_lib.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                    device=META)


def param_specs_shapes(cfg: ModelConfig) -> lm_lib.LM:
    """The parameters as meta tensors (no allocation)."""
    return lm_lib.init_lm(cfg, None, META)


def distribute(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` as a DTensor placed by the matching
    ``Sharding`` of ``shardings`` (same structure)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [distribute(v, s) for v, s in zip(tree, shardings)]
    return distribute_tensor(tree, shardings.mesh, shardings.placements)
