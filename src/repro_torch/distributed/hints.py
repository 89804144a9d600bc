"""Layout hints: named annotation points inside the model code, after
``repro/distributed/hints.py``.

The model code stays mesh-agnostic: it calls ``hints.constrain(x,
"residual")`` at layout-critical points.  Outside any rules this is the
identity.  A driver (``launch/train.py``, ``launch/dryrun.py``) installs a
table mapping hint names to specs with ``use_rules``; the constraint then
redistributes a DTensor to the table's placements (fitted to its shape),
as the reference's ``with_sharding_constraint`` pins a layout for GSPMD.
A plain tensor passes unchanged: rules only move DTensors.  The gradient
of a constrained DTensor is held to the same placements.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from repro_torch.distributed.sharding import P, fit_spec, placements

_state = threading.local()


def _rules() -> Optional[tuple]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(mesh, table: dict[str, P]):
    """Install hint name -> spec rules on ``mesh`` for the enclosed code
    (this thread only)."""
    prev = _rules()
    _state.rules = (mesh, table)
    try:
        yield
    finally:
        _state.rules = prev


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` redistributed to the rule ``name``'s placements; ``x`` itself
    when no rules are installed, the name has no rule, or ``x`` is not a
    DTensor."""
    ctx = _rules()
    if ctx is None:
        return x
    mesh, table = ctx
    spec = table.get(name)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, mesh, placements(
        fit_spec(tuple(x.shape), spec, mesh), mesh))


class _Constrain(torch.autograd.Function):
    """A redistribution whose gradient is held to the same placements, as
    the transpose of JAX's ``with_sharding_constraint`` is the same
    constraint on the cotangent: a partial sum arriving in the backward is
    reduced here (Megatron's all-reduce of a tensor-parallel block's input
    gradient), not carried on to make the next product gather its
    weights."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.pl), None, None
