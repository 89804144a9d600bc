"""Shared model primitives, after ``repro/models/common.py``: init, norms,
activations, softcap, RoPE, masks and the dtype policy.

Mixed-precision policy, as in the reference: parameters are stored in
``cfg.param_dtype`` (bf16 for the big archs), matmuls run in the param
dtype, and numerically sensitive reductions (norm statistics, softmax, the
loss) run in f32.  Norm scales are always f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(weight: torch.Tensor, fan_in: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Truncated-normal fan-in init in place: std 1/sqrt(fan_in), cut at
    +-2 std.  ``fan_in`` defaults to ``weight.shape[1]``, the input width
    of an ``nn.Linear`` weight ``(out, in)``; the LM keeps the reference's
    ``(in, out)`` layout and passes ``shape[0]``."""
    fan = fan_in if fan_in is not None else weight.shape[1]
    std = 1.0 / math.sqrt(max(fan, 1))
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=generator)


def dense_param(shape, dtype: torch.dtype, device: torch.device,
                generator: Optional[torch.Generator],
                fan_in: Optional[int] = None) -> torch.Tensor:
    """An ``(in, out)`` weight drawn in f32 with fan-in ``shape[0]`` (the
    reference's ``dense_init``), stored in ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    dense_init(w, fan_in=fan_in if fan_in is not None else shape[0],
               generator=generator)
    return w.to(dtype)


def embed_init(shape, dtype: torch.dtype, device: torch.device,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """normal * 0.02 in f32 (not truncated), stored in ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms (params always f32: tiny, and scale precision matters)
# ---------------------------------------------------------------------------

def init_norm(cfg, device: torch.device, d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm (eps 1e-5) or RMSNorm (eps 1e-6) in f32, back in x's
    dtype.  The RMSNorm multiplies by ``scale`` as the reference's code does
    (its comment's "(1 + s)" is not what it computes)."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head qk-norm (qwen3): normalize over the head_dim axis."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def activation(name: str):
    return {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        # gate nonlinearity of the gated variants:
        "geglu": lambda x: F.gelu(x, approximate="tanh"),
        "swiglu": F.silu,
    }[name]


def is_gated(name: str) -> bool:
    return name in ("geglu", "swiglu")


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap), in f32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device)
                  ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) int -> rotated x (same dtype).

    Pairs (x[..., :D/2], x[..., D/2:]): the 'split-half' convention."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    ang = positions[..., None].float() * freqs                # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def causal_mask(q_len: int, kv_len: int, q_offset: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """(q_len, kv_len) bool mask, True = attend; ``q_offset`` is the
    absolute position of query row 0."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def window_mask(q_len: int, kv_len: int, q_offset: int, window: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos) & (kv_pos > q_pos - window)


def count_params(params) -> int:
    """Elements of a module's parameters, or of an iterable of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return sum(int(p.numel()) for p in params)


class ParamTree(torch.nn.Module):
    """A nested dict of tensors as a module: dicts become child trees,
    lists ``nn.ModuleList``s of trees, tensors ``nn.Parameter``s, so the
    parameter names follow the reference's pytree paths
    (``blocks.3.sub0.attn.wq``).  ``p["wq"]`` and ``"bq" in p`` read it as
    the reference's functions read their dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, torch.nn.ModuleList(
                    ParamTree(v) for v in val))
            else:
                self.register_parameter(key, torch.nn.Parameter(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules
