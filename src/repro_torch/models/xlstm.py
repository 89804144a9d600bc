"""xLSTM blocks, after ``repro/models/xlstm.py``: the mLSTM (matrix memory,
chunkwise-parallel) and the sLSTM (scalar memory, strictly recurrent).
[arXiv:2405.04517]

mLSTM per head, in stabilized log space (the exponential input gate needs
a running-max stabilizer ``m``, where SSD's decays are all <= 1):

    m_t = max(logsig(f_t) + m_{t-1}, i_t)
    C_t = exp(logsig(f_t) + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) k_t v_t^T
    n_t = (same decay) n_{t-1} + exp(i_t - m_t) k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, exp(-m_t))

The chunkwise form writes every within-chunk coefficient as
``exp((i_s - b_s) - g_t)`` with b = cumsum(logsig(f)), a = cummax(i - b)
and g_t = max(m_prev, a_t), so every kept exponent is <= 0.  Training and
prefill run ``_mlstm_chunkwise_parallel`` (the chunk summaries and the
intra-chunk weights for all chunks at once, a short loop over the chunks
for the (C, n, m) state, then the combine); ``_mlstm_chunk_scan``, the
serial form, is the tests' oracle.  The reference takes ``exp()`` of the
whole (Q, Q) exponent matrix and masks ``s > t`` afterwards, so an input
gate that rises by more than ~88.7 inside a chunk gives an ``inf`` there
and a ``0 * inf`` NaN gradient; the port sets the masked exponents to
``-inf`` first: the same forward, a zero gradient there.  A sequence
longer than the chunk must be a multiple of it, as the reference asserts;
the port raises a ``ValueError`` naming both numbers.

The sLSTM is the paper's scalar-memory cell with block-diagonal per-head
recurrence, one step a token, followed by the gated up-projection FFN.
Its input projections run for all T at once, then a Python loop issues the
T steps from the host.  Decode for both blocks is the O(1) single-step
recurrence.  Gate math and states are f32 in a bf16 model too; the conv
tail is in the activation dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed import dtensor as dt
from repro_torch.distributed import hints
from repro_torch.models import common
from repro_torch.models.common import dtype_of
from repro_torch.models.ssm import _causal_conv

_M_CLAMP = 60.0  # exp(60) ~ 1e26: safe in f32


def mlstm_dims(cfg) -> tuple[int, int, int, int]:
    """(d_inner, heads, qk head dim dk, v head dim dv)."""
    x = cfg.xlstm
    d_in = int(x.proj_factor * cfg.d_model)
    h = cfg.n_heads
    dv = d_in // h
    dk = int(d_in * x.qk_dim_factor) // h
    return d_in, h, dk, dv


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(cfg, device: torch.device,
               generator: Optional[torch.Generator] = None) -> dict:
    x = cfg.xlstm
    dt = dtype_of(cfg)
    d_in, h, dk, _ = mlstm_dims(cfg)
    qk = h * dk

    def dense(shape, fan_in=None):
        return common.dense_param(shape, dt, device, generator,
                                  fan_in=fan_in)

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "up_proj": dense((cfg.d_model, d_in)),
        "z_proj": dense((cfg.d_model, d_in)),
        "conv": dense((x.conv_dim, d_in), fan_in=x.conv_dim),
        "wq": dense((d_in, qk), fan_in=d_in),
        "wk": dense((d_in, qk), fan_in=d_in),
        "wi_gate": dense((d_in, h), fan_in=d_in),
        "wf_gate": dense((d_in, h), fan_in=d_in),
        "b_i": const((h,), 0.0),
        "b_f": const((h,), 3.0),             # start remembering
        "head_norm": const((d_in,), 1.0),
        "down_proj": dense((d_in, cfg.d_model), fan_in=d_in),
    }


def _chunking(t: int, chunk: int) -> tuple[int, int]:
    """(chunk length, chunk count) of a sequence of ``t`` tokens."""
    qc = min(chunk, t)
    if t % qc:
        raise ValueError(f"a sequence of {t} tokens is not a multiple of "
                         f"the mLSTM chunk {qc}")
    return qc, t // qc


def _masked_exp(expo: torch.Tensor, qc: int) -> torch.Tensor:
    """exp of a (..., Qt, Qs) exponent matrix where s <= t, 0 above the
    diagonal (masked to -inf before the exp)."""
    ar = torch.arange(qc, device=expo.device)
    keep = ar[:, None] >= ar[None, :]
    return torch.where(keep, expo, float("-inf")).exp()


def _mlstm_chunk_scan(q, k, v, ig, fg, chunk: int, state):
    """The serial form.  q / k (B,T,H,dk), v (B,T,H,dv), ig / fg (B,T,H)
    f32; state = (C (B,H,dk,dv), n (B,H,dk), m (B,H)) f32.  Returns
    (h (B,T,H,dv) f32, the state after the last token)."""
    b, t, h, _ = q.shape
    dv = v.shape[-1]
    qc, nc = _chunking(t, chunk)

    def rc(x):  # (B,T,...) -> (B,NC,Q,...)
        return dt.reshape(x, b, nc, qc, *x.shape[2:])

    qs, ks, vs, igs, fgs = rc(q), rc(k), rc(v), rc(ig), rc(fg)
    c_prev, n_prev, m_prev = state
    hs = []
    for ci in range(nc):
        qi, ki, vi = qs[:, ci], ks[:, ci], vs[:, ci]   # (B,Q,H,*)
        ii, fi = igs[:, ci], fgs[:, ci]                # (B,Q,H)
        bcum = F.logsigmoid(fi).cumsum(1)
        ib = ii - bcum
        a = torch.cummax(ib, dim=1).values
        g = torch.maximum(m_prev[:, None, :], a)       # (B,Q,H)
        m_t = bcum + g

        carry_coef = torch.exp(m_prev[:, None, :] - g)  # <= 1
        # D[t,s] = exp(ib_s - g_t), s <= t   -> (B,H,Qt,Qs)
        dmat = _masked_exp(ib.transpose(1, 2)[:, :, None, :]
                           - g.transpose(1, 2)[:, :, :, None], qc)
        wmat = torch.einsum("bthk,bshk->bhts", qi, ki) * dmat

        num = torch.einsum("bhts,bshd->bthd", wmat, vi)
        num = num + carry_coef[..., None] * torch.einsum(
            "bthk,bhkd->bthd", qi, c_prev)
        den = wmat.sum(-1).transpose(1, 2)             # (B,Q,H)
        den = den + carry_coef * torch.einsum("bthk,bhk->bth", qi, n_prev)
        floor = torch.exp(torch.clamp(-m_t, max=_M_CLAMP))
        hs.append(num / torch.maximum(den.abs(), floor)[..., None])

        g_end = g[:, -1]                               # (B,H)
        u_end = torch.exp(ib - g_end[:, None, :])      # (B,Q,H) <= 1
        coef = torch.exp(m_prev - g_end)
        c_prev = coef[..., None, None] * c_prev + torch.einsum(
            "bqhk,bqhd->bhkd", u_end[..., None] * ki, vi)
        n_prev = coef[..., None] * n_prev + torch.einsum(
            "bqh,bqhk->bhk", u_end, ki)
        m_prev = bcum[:, -1] + g_end
    return (dt.reshape(torch.stack(hs, 1), b, t, h, dv),
            (c_prev, n_prev, m_prev))


def _mlstm_chunkwise_parallel(q, k, v, ig, fg, chunk: int, state):
    """The chunkwise-parallel form ``mlstm_apply`` runs: the same values as
    ``_mlstm_chunk_scan`` with every heavy einsum outside the loop over
    the chunks.  Phase A computes the chunk summaries and the intra-chunk
    weights for all chunks at once, phase B carries the O(H dk dv) state
    across the chunks in order, phase C combines the intra- and
    inter-chunk parts.  Every exponent is taken relative to the running
    max ``a`` within a chunk or its refinement ``g``, so each kept exp()
    is <= 1, as in the serial form.  Arguments and result as there."""
    b, t, h, _ = q.shape
    dv = v.shape[-1]
    qc, nc = _chunking(t, chunk)

    def rc(x):  # (B,T,...) -> (B,NC,Q,...)
        return dt.reshape(x, b, nc, qc, *x.shape[2:])

    qs, ks, vs, igs, fgs = rc(q), rc(k), rc(v), rc(ig), rc(fg)

    # ---- phase A: per-chunk quantities, all chunks at once ---------------
    bcum = dt.pointwise(F.logsigmoid, fgs).cumsum(2)   # (B,NC,Q,H)
    ib = igs - bcum
    a = torch.cummax(ib, dim=2).values             # running max in a chunk
    a_end = a[:, :, -1]                            # (B,NC,H)
    bcum_end = bcum[:, :, -1]

    # chunk summaries relative to a_end (ib <= a_end within the chunk)
    u_p = torch.exp(ib - a_end[:, :, None])        # (B,NC,Q,H) <= 1
    u_c = hints.constrain(
        torch.einsum("bcqhk,bcqhd->bchkd", u_p[..., None] * ks, vs),
        "mlstm_chunk_state")
    nu_c = torch.einsum("bcqh,bcqhk->bchk", u_p, ks)

    # intra-chunk attention-like part relative to a_t (the row max)
    dmat_p = _masked_exp(ib.transpose(2, 3)[:, :, :, None, :]      # ib_s
                         - a.transpose(2, 3)[:, :, :, :, None], qc)  # a_t
    wmat = torch.einsum("bcthk,bcshk->bchts", qs, ks) * dmat_p
    intra_num = torch.einsum("bchts,bcshd->bcthd", wmat, vs)
    intra_den = wmat.sum(-1).transpose(2, 3)       # (B,NC,Q,H)

    # ---- phase B: the cross-chunk state recurrence, in order --------------
    c_prev, n_prev, m_prev = state
    c_prevs, n_prevs, m_prevs = [], [], []
    for ci in range(nc):
        c_prevs.append(c_prev)
        n_prevs.append(n_prev)
        m_prevs.append(m_prev)
        g_end = torch.maximum(m_prev, a_end[:, ci])    # (B,H)
        coef = torch.exp(m_prev - g_end)
        su = torch.exp(a_end[:, ci] - g_end)
        c_prev = (coef[..., None, None] * c_prev
                  + su[..., None, None] * u_c[:, ci])
        n_prev = coef[..., None] * n_prev + su[..., None] * nu_c[:, ci]
        m_prev = bcum_end[:, ci] + g_end
    c_prevs = hints.constrain(torch.stack(c_prevs, 1),
                              "mlstm_chunk_state")  # (B,NC,H,dk,dv)
    n_prevs = torch.stack(n_prevs, 1)              # (B,NC,H,dk)
    m_prevs = torch.stack(m_prevs, 1)              # (B,NC,H)

    # ---- phase C: the combine, all chunks at once -------------------------
    g = torch.maximum(m_prevs[:, :, None], a)      # (B,NC,Q,H)
    m_t = bcum + g
    r = torch.exp(a - g)                           # row rescale <= 1
    carry_coef = torch.exp(m_prevs[:, :, None] - g)
    inter_num = torch.einsum("bcqhk,bchkd->bcqhd", qs, c_prevs)
    num = r[..., None] * intra_num + carry_coef[..., None] * inter_num
    inter_den = torch.einsum("bcqhk,bchk->bcqh", qs, n_prevs)
    den = r * intra_den + carry_coef * inter_den
    floor = torch.exp(torch.clamp(-m_t, max=_M_CLAMP))
    hout = num / torch.maximum(den.abs(), floor)[..., None]
    return dt.reshape(hout, b, t, h, dv), (c_prev, n_prev, m_prev)


def init_mlstm_state(cfg, batch: int,
                     device: str | torch.device | None = None) -> dict:
    """Zero decode state on ``device`` (``None``: the card): C, n f32, m
    f32 at ``-_M_CLAMP``, and the conv tail (B, W-1, d_in) in the
    activation dtype."""
    device = resolve_device(device)
    d_in, h, dk, dv = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, h, dk, dv), **f32),
        "n": torch.zeros((batch, h, dk), **f32),
        "m": torch.full((batch, h), -_M_CLAMP, **f32),
        "conv": torch.zeros((batch, cfg.xlstm.conv_dim - 1, d_in),
                            dtype=dtype_of(cfg), device=device),
    }


def _mlstm_project(cfg, p, x: torch.Tensor, conv_tail):
    """The z projection, q / k (f32, q scaled by 1/sqrt(dk)) from the
    convolved and activated up projection, v (the up projection before
    the conv, f32), the f32 gate pre-activations and the new conv tail."""
    _, h, dk, dv = mlstm_dims(cfg)
    b, t, _ = x.shape
    up = x @ p["up_proj"]
    z = x @ p["z_proj"]
    c, tail = _causal_conv(up, p["conv"], conv_tail)
    c = F.silu(c)
    q = hints.constrain(dt.reshape(c @ p["wq"], b, t, h, dk),
                        "mlstm_qk").float() / math.sqrt(dk)
    k = hints.constrain(dt.reshape(c @ p["wk"], b, t, h, dk),
                        "mlstm_qk").float()
    v = dt.reshape(up, b, t, h, dv).float()
    ig = (c @ p["wi_gate"]).float() + p["b_i"]
    fg = (c @ p["wf_gate"]).float() + p["b_f"]
    return z, q, k, v, ig, fg, tail


def _head_norm_gate(p, hmat: torch.Tensor, z: torch.Tensor,
                    x_dtype: torch.dtype) -> torch.Tensor:
    """Per-head RMS norm over dv, the ``head_norm`` scale, the silu(z)
    gate, in f32; back in ``x_dtype``."""
    ms = hmat.square().mean(-1, keepdim=True)
    hn = hmat * torch.rsqrt(ms + 1e-6)
    b, t = hmat.shape[:2]
    hn = dt.reshape(hn, b, t, -1) * p["head_norm"]
    return (hn * F.silu(z.float())).to(x_dtype)


def mlstm_apply(cfg, p, x: torch.Tensor, state: Optional[dict] = None,
                return_state: bool = False):
    """Full-sequence mLSTM block.  x (B,T,d) -> (y (B,T,d), the state
    after the last token if ``return_state``, else None)."""
    st = state or init_mlstm_state(cfg, x.shape[0], x.device)
    z, q, k, v, ig, fg, tail = _mlstm_project(cfg, p, x, st["conv"])
    def scan(q, k, v, ig, fg, c, n, m):
        h, state = _mlstm_chunkwise_parallel(q, k, v, ig, fg,
                                             cfg.xlstm.chunk, (c, n, m))
        return (h, *state)

    # on a mesh, each rank scans its batch rows and heads
    h, c_new, n_new, m_new = dt.local_heads(
        scan, (q, k, v, ig, fg, st["C"], st["n"], st["m"]),
        (0,) * 8, (2, 2, 2, 2, 2, 1, 1, 1), (0,) * 4, (2, 1, 1, 1))
    y = _head_norm_gate(p, h, z, x.dtype) @ p["down_proj"]
    if not return_state:
        return y, None
    return y, {"C": c_new, "n": n_new, "m": m_new, "conv": tail}


def mlstm_decode(cfg, p, x: torch.Tensor, state: dict):
    """One token x (B,1,d) against ``state``: (y (B,1,d), the new
    state)."""
    z, q, k, v, ig, fg, tail = _mlstm_project(cfg, p, x, state["conv"])
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]             # (B,H,dk/dv)
    i1, f1 = ig[:, 0], fg[:, 0]                        # (B,H)
    logf_m = dt.pointwise(F.logsigmoid, f1) + state["m"]
    m_new = torch.maximum(logf_m, i1)
    coef_f = torch.exp(logf_m - m_new)
    coef_i = torch.exp(i1 - m_new)
    c_new = coef_f[..., None, None] * state["C"] + coef_i[..., None, None] \
        * (k1[..., :, None] * v1[..., None, :])
    n_new = coef_f[..., None] * state["n"] + coef_i[..., None] * k1
    num = torch.einsum("bhk,bhkd->bhd", q1, c_new)
    den = torch.einsum("bhk,bhk->bh", q1, n_new)
    floor = torch.exp(torch.clamp(-m_new, max=_M_CLAMP))
    h = (num / torch.maximum(den.abs(), floor)[..., None])[:, None]
    y = _head_norm_gate(p, h, z, x.dtype) @ p["down_proj"]
    return y, {"C": c_new, "n": n_new, "m": m_new, "conv": tail}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_GATES = ("z", "i", "f", "o")


def init_slstm(cfg, device: torch.device,
               generator: Optional[torch.Generator] = None) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ff = int(d * cfg.xlstm.slstm_ff_factor)

    def dense(shape, fan_in=None):
        return common.dense_param(shape, dt, device, generator,
                                  fan_in=fan_in)

    def const(value):
        return torch.full((d,), value, dtype=torch.float32, device=device)

    p = {f"w_{n}": dense((d, d)) for n in _GATES}
    p.update({f"r_{n}": dense((h, dh, dh), fan_in=dh) for n in _GATES})
    p.update({"b_z": const(0.0), "b_i": const(0.0), "b_f": const(3.0),
              "b_o": const(0.0), "head_norm": const(1.0)})
    p["ff_gate"] = dense((d, ff))
    p["ff_up"] = dense((d, ff))
    p["ff_down"] = dense((ff, d), fan_in=ff)
    return p


def init_slstm_state(cfg, batch: int,
                     device: str | torch.device | None = None) -> dict:
    """Zero decode state on ``device`` (``None``: the card): h, c, m f32
    zeros and n f32 at 1e-6, each (B, d)."""
    device = resolve_device(device)
    shape, f32 = (batch, cfg.d_model), dict(dtype=torch.float32,
                                            device=device)
    return {"h": torch.zeros(shape, **f32), "c": torch.zeros(shape, **f32),
            "n": torch.full(shape, 1e-6, **f32),
            "m": torch.zeros(shape, **f32)}


def _recurrent(p) -> tuple[torch.Tensor, torch.Tensor]:
    """The four gates' block-diagonal recurrent matrices as one f32 (H, dh,
    4, dh) and their biases as one (4, 1, d), gates in ``_GATES`` order:
    cast and stacked once a call, where the reference casts each matrix on
    every step."""
    r_all = torch.stack([p[f"r_{n}"].float() for n in _GATES], dim=2)
    b_all = torch.stack([p[f"b_{n}"] for n in _GATES])[:, None, :]
    return r_all, b_all


def _slstm_cell(cfg, r_all, b_all, x4, state):
    """One recurrent step.  x4 (4,B,d) f32: the z / i / f / o
    pre-activations from the input side; ``r_all`` and ``b_all`` from
    ``_recurrent``; state a dict of (B,d) f32.  Each gate's
    pre-activation is the reference's ``x + rec + b``, the four gates in
    one operation.  Returns (h, the new state)."""
    h_heads = dt.reshape(state["h"], -1, cfg.n_heads,
                         cfg.d_model // cfg.n_heads)
    rec = dt.reshape(torch.einsum("bhd,hdge->gbhe", h_heads, r_all),
                     x4.shape)
    z_pre, i_pre, f_pre, o_pre = (x4 + rec + b_all).unbind(0)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    logf_m = dt.pointwise(F.logsigmoid, f_pre) + state["m"]
    m_new = torch.maximum(logf_m, i_pre)
    coef_f = torch.exp(logf_m - m_new)
    coef_i = torch.exp(i_pre - m_new)
    c_new = coef_f * state["c"] + coef_i * z
    n_new = coef_f * state["n"] + coef_i
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def _slstm_ff(cfg, p, h: torch.Tensor, x_dtype: torch.dtype
              ) -> torch.Tensor:
    """RMS norm over all of d (not per head), ``head_norm``, then the
    tanh-GELU gated FFN."""
    ms = h.square().mean(-1, keepdim=True)
    hn = (h * torch.rsqrt(ms + 1e-6) * p["head_norm"]).to(x_dtype)
    f = F.gelu(hn @ p["ff_gate"], approximate="tanh") * (hn @ p["ff_up"])
    return f @ p["ff_down"]


def _slstm_inputs(p, x: torch.Tensor) -> torch.Tensor:
    """The four input-side pre-activations, f32, stacked: (4, ..., d)."""
    return torch.stack([(x @ p[f"w_{n}"]).float() for n in _GATES])


def slstm_apply(cfg, p, x: torch.Tensor, state: Optional[dict] = None,
                return_state: bool = False):
    """Strictly sequential over T: the input projections for all T at
    once, then one host-issued step a token.  x (B,T,d) -> (y (B,T,d),
    the state after the last token if ``return_state``, else None)."""
    st = state or init_slstm_state(cfg, x.shape[0], x.device)
    r_all, b_all = _recurrent(p)

    def scan(x4s, r_all, b_all, h, c, n, m):
        st = {"h": h, "c": c, "n": n, "m": m}
        hs = []
        # unbind: one view a step, whose backward is one stack for all T
        for x4 in x4s.unbind(2):                       # (4,B,d) a step
            h, st = _slstm_cell(cfg, r_all, b_all, x4, st)
            hs.append(h)
        return torch.stack(hs, 1), st["h"], st["c"], st["n"], st["m"]

    # on a mesh, each rank runs the recurrence on its batch rows
    hs, *last = dt.local_heads(
        scan, (_slstm_inputs(p, x), r_all, b_all,
               *(st[k] for k in ("h", "c", "n", "m"))),
        (1, None, None, 0, 0, 0, 0), (None,) * 7, (0,) * 5, (None,) * 5)
    y = _slstm_ff(cfg, p, hs, x.dtype)                 # (B,T,d) f32 in
    return y, (dict(zip(("h", "c", "n", "m"), last)) if return_state
               else None)


def slstm_decode(cfg, p, x: torch.Tensor, state: dict):
    """One token x (B,1,d) against ``state``: (y (B,1,d), the new
    state)."""
    h, st_new = _slstm_cell(cfg, *_recurrent(p), _slstm_inputs(p, x[:, 0]),
                            state)
    return _slstm_ff(cfg, p, h[:, None], x.dtype), st_new
