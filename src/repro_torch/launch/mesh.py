"""Mesh builders on ``torch.distributed``, after ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group.  A mesh is a ``DeviceMesh`` over the default process group,
whatever installed it: ``torchrun`` (``init_process_group`` from the
environment), the dry-run's fake group of 256 or 512 ranks, or
``make_host_mesh``'s own one-rank group.

Axes:
  - ``pod``   (multi-pod only): outermost; composes with ``data`` for
    gradient reduction.
  - ``data``  : data parallel / FSDP axis.
  - ``model`` : tensor / expert parallel axis (Megatron TP, MoE EP, and the
    sequence-parallel KV fallback for the 500k cells).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

_OWN_GROUP = False   # the default group is make_host_mesh's own


def _device_type() -> str:
    """The default group's device type: ``cuda`` for NCCL, else ``cpu``
    (gloo, and the dry-run's fake backend)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, axes: tuple, device_type: str | None = None):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    device_type = device_type or _device_type()
    n = 1
    for s in shape:
        n *= s
    if n == dist.get_world_size():
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    # fewer ranks than the group holds: the first n, as jax.make_mesh
    # takes the first devices
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data',
    'model'), over the default group (which must have the 256 / 512
    ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str | None = None):
    """A ('data', 'model') mesh over the ranks there are, each axis clamped
    as the reference clamps to the local devices.  With no default group
    installed it installs a one-rank group of its own (gloo on the CPU,
    NCCL on the card; ``device_type`` says which, default the card), which
    ``close_host_group`` destroys."""
    global _OWN_GROUP
    if not dist.is_initialized():
        device_type = resolve_device(device_type).type   # None: the card
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
        _OWN_GROUP = True
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return _mesh((data, model), ("data", "model"), device_type)


def close_host_group() -> None:
    """Destroy the default group if ``make_host_mesh`` installed it."""
    global _OWN_GROUP
    if _OWN_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_GROUP = False
