"""Shared model primitives: the parts of ``repro/models/common.py`` that
the classifier uses."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(weight: torch.Tensor, fan_in: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Truncated-normal fan-in init in place: std 1/sqrt(fan_in), cut at
    +-2 std.  ``fan_in`` defaults to ``weight.shape[1]``, the input width
    of an ``nn.Linear`` weight ``(out, in)``."""
    fan = fan_in if fan_in is not None else weight.shape[1]
    std = 1.0 / math.sqrt(max(fan, 1))
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=generator)


def activation(name: str):
    return {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        # gate nonlinearity of the gated variants:
        "geglu": lambda x: F.gelu(x, approximate="tanh"),
        "swiglu": F.silu,
    }[name]
