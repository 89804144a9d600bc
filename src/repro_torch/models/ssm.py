"""Mamba2 (SSD, state-space duality) block, chunkwise-parallel, after
``repro/models/ssm.py``.

Training and prefill run the SSD chunked algorithm (Dao & Gu 2024):
within a chunk of Q tokens the output is a masked attention-like
contraction; across chunks a (H, P, N) state is carried by a short loop
over the chunks, in order.  Decode is the O(1) recurrence
``h' = exp(dt*A) h + dt * B (x) outer``, ``y = C . h' + D x``.

All decay math runs in f32; ``dA = dt * A <= 0`` (``A = -exp(A_log)``,
``dt = softplus >= 0``), so every kept ``exp()`` of the chunked form is at
most 1.  A sequence longer than the chunk must be a multiple of it, as the
reference asserts; the port raises a ``ValueError`` naming both numbers.

The projections are stored separately (x / z / B / C / dt), as in the
reference's tree.  The depthwise causal convolutions carry a (B, W-1, C)
tail across prefill and decode, in the activation dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed import dtensor as dt
from repro_torch.models import common
from repro_torch.models.common import dtype_of


def dims(cfg) -> tuple[int, int, int, int]:
    """(d_inner, heads, head dim P, state N)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.head_dim, s.d_state


def init_mamba(cfg, device: torch.device,
               generator: Optional[torch.Generator] = None) -> dict:
    s = cfg.ssm
    dt = dtype_of(cfg)
    d_in, nh, _, n = dims(cfg)
    d = cfg.d_model

    def dense(shape, fan_in=None):
        return common.dense_param(shape, dt, device, generator,
                                  fan_in=fan_in)

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "out_proj": dense((d_in, d), fan_in=d_in),
        "x_proj": dense((d, d_in)),
        "z_proj": dense((d, d_in)),
        "b_proj": dense((d, n)),
        "c_proj": dense((d, n)),
        "dt_proj": dense((d, nh)),
        "conv_x": dense((s.d_conv, d_in), fan_in=s.d_conv),
        "conv_b": dense((s.d_conv, n), fan_in=s.d_conv),
        "conv_c": dense((s.d_conv, n), fan_in=s.d_conv),
        "a_log": const((nh,), 0.0),          # A = -exp(a_log) = -1
        "d_skip": const((nh,), 1.0),
        "dt_bias": const((nh,), -2.0),       # softplus(-2) ~ 0.13
        "gate_norm": const((d_in,), 1.0),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x (B,T,C), w (W,C); tail (B,W-1,C) carries
    the previous tokens.  Returns (y, new tail), both in x's dtype; the
    taps are added in the reference's order."""
    width = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xe = torch.cat([tail, x], dim=1)                   # (B, T+W-1, C)
    t = x.shape[1]
    y = sum(xe[:, i:i + t] * w[i] for i in range(width))
    return y, xe[:, xe.shape[1] - (width - 1):]


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Mamba2's norm-then-gate: rmsnorm(y * silu(z)) * scale, in f32."""
    g = y.float() * F.silu(z.float())
    ms = g.square().mean(-1, keepdim=True)
    return (g * torch.rsqrt(ms + 1e-6) * scale).to(y.dtype)


def _ssd_chunked(xh, dtv, bmat, cmat, a, chunk: int, state0):
    """SSD scan.  xh (B,T,H,P); dtv (B,T,H) f32; bmat / cmat (B,T,N); a
    (H,) f32 negative; state0 (B,H,P,N) f32.  Returns (y (B,T,H,P) f32,
    the state after the last token (B,H,P,N))."""
    b, t, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, t)
    if t % q:
        raise ValueError(f"a sequence of {t} tokens is not a multiple of "
                         f"the SSD chunk {q}")
    nc = t // q

    xc = dt.reshape(xh, b, nc, q, h, p).float()
    dtc = dt.reshape(dtv, b, nc, q, h)
    bc = dt.reshape(bmat, b, nc, q, n).float()
    cc = dt.reshape(cmat, b, nc, q, n).float()

    da = dtc * a                                          # (B,nc,Q,H) <= 0
    cum = da.cumsum(2)                                    # within a chunk
    total = cum[:, :, -1]                                 # (B,nc,H)

    # intra-chunk: L[b,c,i,j,h] = exp(cum_i - cum_j) for i >= j, else 0.
    # The reference takes exp() of every difference, then masks; above the
    # diagonal cum_i - cum_j >= 0 may overflow to inf, and the masked
    # backward would be 0 * inf.  Masking to -inf first gives the same
    # forward and a zero gradient there.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    ar = torch.arange(q, device=xh.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    decay = torch.where(mask, diff, float("-inf")).exp()
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)      # (B,nc,Qi,Qj)
    w_intra = scores[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_intra, xc)

    # each chunk's own contribution to the state at its end
    dec_out = torch.exp(total[:, :, None, :] - cum)       # (B,nc,Q,H)
    s_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchpn", dec_out * dtc, bc, xc)

    # inter-chunk recurrence: the state before each chunk, in order
    s = state0
    before = []
    for c in range(nc):
        before.append(s)
        s = torch.exp(total[:, c])[:, :, None, None] * s + s_chunk[:, c]
    s_prevs = torch.stack(before, dim=1)                  # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cc, s_prevs,
                           torch.exp(cum))
    return dt.reshape(y_intra + y_inter, b, t, h, p), s


def init_state(cfg, batch: int, device: str | torch.device | None = None
               ) -> dict:
    """Zero decode state on ``device`` (``None``: the card): ``ssd`` f32
    (B, H, P, N) and the three conv tails (B, W-1, C) in the activation
    dtype."""
    device = resolve_device(device)
    s = cfg.ssm
    d_in, nh, p, n = dims(cfg)
    dt = dtype_of(cfg)
    return {
        "ssd": torch.zeros((batch, nh, p, n), dtype=torch.float32,
                           device=device),
        "conv_x": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dt,
                              device=device),
        "conv_b": torch.zeros((batch, s.d_conv - 1, n), dtype=dt,
                              device=device),
        "conv_c": torch.zeros((batch, s.d_conv - 1, n), dtype=dt,
                              device=device),
    }


def _project(p, x: torch.Tensor, state: dict):
    """The five projections, the convolved and activated x / B / C, dt
    (f32, softplus) and the new conv tails."""
    xs, z = x @ p["x_proj"], x @ p["z_proj"]
    bm, cm, dtv = x @ p["b_proj"], x @ p["c_proj"], x @ p["dt_proj"]
    xs, tx = _causal_conv(xs, p["conv_x"], state["conv_x"])
    bm, tb = _causal_conv(bm, p["conv_b"], state["conv_b"])
    cm, tc = _causal_conv(cm, p["conv_c"], state["conv_c"])
    xs, bm, cm = F.silu(xs), F.silu(bm), F.silu(cm)
    dtv = F.softplus(dtv.float() + p["dt_bias"])
    return xs, z, bm, cm, dtv, {"conv_x": tx, "conv_b": tb, "conv_c": tc}


def mamba_apply(cfg, p, x: torch.Tensor, state: Optional[dict] = None,
                return_state: bool = False):
    """Full-sequence Mamba2.  x (B,T,d) -> (y (B,T,d), the state after the
    last token if ``return_state``, else None)."""
    b, t, _ = x.shape
    d_in, nh, hp, _ = dims(cfg)
    st = state or init_state(cfg, b, x.device)
    xs, z, bm, cm, dtv, tails = _project(p, x, st)
    a = -torch.exp(p["a_log"])
    xh = dt.reshape(xs, b, t, nh, hp)
    # on a mesh, each rank scans its batch rows and heads
    y, s_new = dt.local_heads(
        _ssd_chunked, (xh, dtv, bm, cm, a, cfg.ssm.chunk, st["ssd"]),
        (0, 0, 0, 0, None, None, 0), (2, 2, None, None, 0, None, 1),
        (0, 0), (2, 1))
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = _gated_rmsnorm(dt.reshape(y, b, t, d_in).to(x.dtype), z,
                        p["gate_norm"])
    out = y @ p["out_proj"]
    if not return_state:
        return out, None
    return out, {"ssd": s_new, **tails}


def mamba_decode(cfg, p, x: torch.Tensor, state: dict):
    """One token x (B,1,d) against ``state``: (y (B,1,d), the new state)."""
    b = x.shape[0]
    d_in, nh, hp, _ = dims(cfg)
    xs, z, bm, cm, dtv, tails = _project(p, x, state)
    dtv = dtv[:, 0]                                           # (B,H)
    a = -torch.exp(p["a_log"])
    xh = dt.reshape(xs, b, nh, hp).float()
    bmf, cmf = bm[:, 0].float(), cm[:, 0].float()
    decay = torch.exp(dtv * a)
    upd = torch.einsum("bh,bhp,bn->bhpn", dtv, xh, bmf)
    s_new = decay[:, :, None, None] * state["ssd"] + upd
    y = torch.einsum("bhpn,bn->bhp", s_new, cmf)
    y = y + p["d_skip"][None, :, None] * xh
    y = _gated_rmsnorm(dt.reshape(y, b, 1, d_in).to(x.dtype), z,
                        p["gate_norm"])
    return y @ p["out_proj"], {"ssd": s_new, **tails}
