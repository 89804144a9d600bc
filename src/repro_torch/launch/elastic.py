"""Elastic scaling: restore a checkpoint onto a different rank count, after
``repro/launch/elastic.py``.

The checkpoint format (``checkpoint/checkpoint.py``) is layout-free: whole
host arrays keyed by path (a DTensor is written whole).  Re-meshing is
therefore ``distribute_tensor`` of each host array with the *new* mesh's
placements: no resharding pass, and any (old ranks) -> (new ranks)
transition works, shrink (node loss) and grow (node recovery) alike.

``reshard_like(tree, shardings)`` is the restore half; the save half is
whatever ``CheckpointManager`` wrote.  ``rendezvous`` is the control-plane
decision a real cluster makes after a membership change: rebuild the mesh
from the ranks there are and recompute the placements.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import dtensor as dt
from repro_torch.distributed.sharding import (distribute_model,
                                              param_shardings)
from repro_torch.launch.mesh import make_host_mesh


def _host_tensor(x) -> torch.Tensor:
    """A leaf as a tensor on the host: numpy (bf16 arrays through their
    bits), a tensor, or a DTensor of another mesh (gathered whole)."""
    if isinstance(x, torch.Tensor):
        return dt.gather_full(x.detach()).cpu()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def reshard_like(tree: Any, shardings: Any) -> Any:
    """Every leaf of ``tree`` as a DTensor with its target ``Sharding``
    (the two trees match: dicts by key, lists by position).

    Leaves may be numpy (fresh from a checkpoint), tensors, or DTensors
    of a *different* mesh: all go through the host, which is what a
    post-failure restore does."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(shardings, Mapping):
        return {k: reshard_like(tree[k], s) for k, s in shardings.items()}
    if isinstance(shardings, (list, tuple)):
        return [reshard_like(t, s) for t, s in zip(tree, shardings)]
    t = _host_tensor(tree).to(shardings.mesh.device_type)
    return distribute_tensor(t, shardings.mesh, shardings.placements)


def _flat_params(cfg: ModelConfig, params: Mapping) -> dict:
    """Parameter name -> host tensor, from a snapshot's ``params``: the
    port driver's flat names (``blocks.0.sub0.attn.wq``) or the
    reference's tree (blocks stacked on a leading axis)."""
    from repro_torch.models import lm as lm_lib
    if any("." in k for k in params):
        return {k: _host_tensor(v) for k, v in params.items()}
    model = lm_lib.params_from_jax(cfg, params, "cpu")
    return {n: p.detach() for n, p in model.named_parameters()}


def rendezvous(cfg: ModelConfig, params_np: Mapping, *, data: int,
               model: int, fsdp: bool = False, device_type: str | None = None):
    """Re-mesh onto the current rank population and place the parameters.

    Returns (the new mesh, an ``LM`` whose parameters are DTensors).  Call
    after a membership change with the surviving (data, model) split;
    every other piece of state (optimizer slots, selection state)
    reshards with the same mechanism (``reshard_like``).  With no process
    group installed the mesh is one rank (``make_host_mesh``)."""
    from repro_torch.models import lm as lm_lib
    mesh = make_host_mesh(data, model, device_type)
    values = _flat_params(cfg, params_np)
    lm = lm_lib.init_lm(cfg, None, "meta")
    shardings = param_shardings(cfg, lm, mesh, fsdp=fsdp)
    return mesh, distribute_model(lm, shardings, values)
