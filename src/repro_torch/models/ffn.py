"""Dense FFN, after ``repro/models/ffn.py``: the plain 2-matrix MLP
(gelu/silu) or the gated 3-matrix one (geglu/swiglu).

Weights keep the reference's ``(in, out)`` layout: up/gate ``(d_model,
d_ff)``, down ``(d_ff, d_model)``, so ``x @ w`` reads as it does there.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import common
from repro_torch.models.common import dtype_of


def init_ffn(cfg, device: torch.device,
             generator: Optional[torch.Generator] = None,
             d_ff: Optional[int] = None) -> dict:
    dt = dtype_of(cfg)
    d_ff = d_ff or cfg.d_ff
    p = {
        "w_up": common.dense_param((cfg.d_model, d_ff), dt, device,
                                   generator),
        "w_down": common.dense_param((d_ff, cfg.d_model), dt, device,
                                     generator, fan_in=d_ff),
    }
    if common.is_gated(cfg.act):
        p["w_gate"] = common.dense_param((cfg.d_model, d_ff), dt, device,
                                         generator)
    return p


def ffn_apply(cfg, p, x: torch.Tensor) -> torch.Tensor:
    act = common.activation(cfg.act)
    if common.is_gated(cfg.act):
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"])
    return h @ p["w_down"]
