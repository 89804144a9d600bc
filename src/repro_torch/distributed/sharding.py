"""Partition rules for parameters, activations, caches and optimizer state,
after ``repro/distributed/sharding.py``, on ``torch.distributed``'s
``DeviceMesh`` and DTensor placements.

Policy (the reference's DESIGN.md §6):
  - batch dims shard over ('pod', 'data')   [DP; 'pod' is absent single-pod]
  - Megatron TP over 'model': column-parallel up/gate/QKV, row-parallel
    down/O, vocab-parallel embedding + head, experts over 'model' (EP)
  - optional FSDP: parameters additionally sharded over 'data' on the
    non-model dim (ZeRO-3: DTensor gathers them where an op needs them)
  - KV caches: batch over 'data', head or head_dim over 'model', falling
    back to sequence over 'data' for global_batch=1 (long-context cells)

A rule is a ``P``: one entry per tensor dim, each ``None``, a mesh axis
name, or a tuple of names (one tensor dim over several mesh dims, in the
mesh's order).  Every rule passes through ``fit_spec``, which drops a mesh
axis from a dim that it does not divide: the one mechanism that lets all
ten archs run on the same mesh.  ``placements`` turns a fitted ``P`` into
the ``Shard`` / ``Replicate`` list of a DTensor, mesh dim by mesh dim; a
composite entry ``('pod', 'data')`` gives ``Shard(d)`` on both mesh dims,
which DTensor splits row-major (pod outer, data inner), the reference's
block order.

The port keeps each super-block in ``blocks`` as a list entry where the
reference stacks them on a leading axis, so a block parameter's rule is
the reference's without its leading ``None``.  Functions take a
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` mapping
(the tests' duck-typed mesh).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch

from repro_torch.configs.base import ModelConfig

# Mesh axis names (multi-pod meshes add 'pod' in front).
POD, DATA, MODEL = "pod", "data", "model"


class P(tuple):
    """A per-tensor-dim partition spec (the port's ``PartitionSpec``):
    ``P("data", None, "model")``, ``P(("pod", "data"))``; missing trailing
    entries mean ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name -> size."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def dp_axes(mesh) -> tuple:
    names = axis_names(mesh)
    return tuple(a for a in (POD, DATA) if a in names)


def _dp_entry(mesh):
    """The batch dims' entry: ('pod', 'data'), 'data', or None."""
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def axis_size(mesh, name) -> int:
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= axis_size(mesh, n)
        return out
    return axis_sizes(mesh).get(name, 1)


def fit_spec(shape: tuple, spec: P, mesh) -> P:
    """Drop mesh axes that do not evenly divide their dim (per entry).

    Composite entries like ('pod', 'data') are truncated left to right
    until the product divides."""
    names_on_mesh = axis_names(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        names = tuple(n for n in names if n in names_on_mesh)
        while names and dim % axis_size(mesh, names) != 0:
            names = names[:-1]
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(names)
    return P(*out)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of a (fitted) spec on ``mesh``: ``Shard(d)``
    on every mesh dim that tensor dim ``d``'s entry names, ``Replicate()``
    on the others.  A composite entry must name its axes in the mesh's
    order (DTensor splits a dim over mesh dims row-major)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry!r} of {spec!r} is not in the "
                             f"mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class Sharding:
    """A spec placed on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


# ---------------------------------------------------------------------------
# Parameter rules, keyed by parameter-name substrings.
# ---------------------------------------------------------------------------

def _param_rule(path: str, ndim: int, fsdp: bool) -> P:
    """The spec of one parameter, identified by its name."""
    f = DATA if fsdp else None
    # --- MoE experts: E over model (EP); FSDP on the expert-internal dims.
    if "w_gate" in path and ndim == 3:
        return P(MODEL, f, None)
    if "w_up" in path and ndim == 3:
        return P(MODEL, f, None)
    if "w_down" in path and ndim == 3:
        return P(MODEL, None, f)
    if "router" in path:
        return P(None, MODEL)
    # --- embeddings / head: vocab-parallel.
    if "embed" in path or "lm_head" in path or "unit_head" in path:
        return P(MODEL, f) if "embed" in path else P(f, MODEL)
    # --- attention.
    if any(k in path for k in ("wq", "wk", "wv")):
        return P(f, MODEL)
    if "wo" in path:
        return P(MODEL, f)
    if any(k in path for k in ("bq", "bk", "bv")):
        return P(MODEL)
    # --- dense FFN (also xlstm up/z projections, mamba in_proj).
    if any(k in path for k in ("w_up", "w_gate", "in_proj", "up_proj",
                               "z_proj", "wi_")):
        return P(f, MODEL)
    if any(k in path for k in ("w_down", "out_proj", "down_proj", "wo_")):
        return P(MODEL, f)
    # --- everything else (norms, convs, gates, scalars): replicate.
    return P()


def _named_tensors(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(cfg: ModelConfig, params, fsdp: bool = False) -> dict:
    """Parameter name -> spec, for an ``LM`` (or a name -> tensor
    mapping).  A block parameter (``blocks.3.sub0.attn.wq``) takes the
    reference's rule for its stacked leaf without the leading ``None``."""
    return {name: _param_rule(name, t.dim(), fsdp)
            for name, t in _named_tensors(params).items()}


def param_shardings(cfg: ModelConfig, params, mesh,
                    fsdp: bool = False) -> dict:
    """Parameter name -> ``Sharding``, each spec fitted to its shape."""
    named_t = _named_tensors(params)
    specs = param_specs(cfg, named_t, fsdp=fsdp)
    return {name: Sharding(mesh, fit_spec(tuple(t.shape), specs[name], mesh))
            for name, t in named_t.items()}


# ---------------------------------------------------------------------------
# Activation and batch rules.
# ---------------------------------------------------------------------------

def batch_spec(mesh, ndim: int, *, seq_shard: bool = False) -> P:
    """Tokens / labels / weights: leading batch dim over the DP axes.  For
    global_batch=1 long-context cells, shard the sequence dim instead."""
    dpe = _dp_entry(mesh)
    if seq_shard and ndim >= 2:
        return P(None, dpe)
    return P(dpe)


def logical_rules(mesh) -> dict:
    """Hint name -> spec table read by ``distributed/hints.py``: the
    reference's table, entry for entry."""
    dpe = _dp_entry(mesh)
    return {
        "moe_dispatch": P(dpe, MODEL, None, None),   # (G, E, C, d)
        "moe_combine": P(dpe, MODEL, None, None),
        "ffn_inner": P(dpe, None, MODEL),            # (B, S, d_ff)
        "attn_out": P(dpe, None, MODEL),             # (B, S, q_dim)
        "residual": P(dpe, None, None),              # (B, S, d_model)
        "logits": P(dpe, None, MODEL),               # (B, S, vocab)
    }


def distribute_model(model: torch.nn.Module, shardings: Mapping[str, Sharding],
                     values: Mapping[str, torch.Tensor] | None = None
                     ) -> torch.nn.Module:
    """Replace each parameter of ``model`` by a DTensor placed by its
    ``Sharding``, from ``values[name]`` (any device; moved to the mesh's)
    or from the parameter's own value.  Returns ``model``."""
    from torch.distributed.tensor import distribute_tensor

    for name, p in list(model.named_parameters()):
        sh = shardings[name]
        src = (values[name] if values is not None else p.detach())
        if src.device.type != "meta":
            src = src.to(sh.mesh.device_type)
        *path, leaf = name.split(".")
        owner = model
        for part in path:
            owner = owner[int(part)] if part.isdigit() else owner[part]
        owner.register_parameter(leaf, torch.nn.Parameter(
            distribute_tensor(src, sh.mesh, sh.placements),
            requires_grad=p.requires_grad))
    return model
