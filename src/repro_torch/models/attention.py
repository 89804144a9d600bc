"""Self-attention, after ``repro/models/attention.py``: GQA/MQA by head
grouping, RoPE, sliding window, softcap, q/k head norms, the blockwise
(flash-style) path for long sequences, and the decode caches.

The math follows the reference step by step: scores in f32 (bf16 operands
widened, as ``preferred_element_type`` does), masked to ``MASK_VALUE``,
softmax in f32, probabilities cast to ``v``'s dtype before the PV product.

Decode state: ``full`` layers carry a (B, S_max, n_kv, hd) cache written
in place at the position of the new token; ``window`` layers carry a ring
of ``window`` slots plus a slot -> absolute position map (``slot_pos``,
-1 for an unfilled slot).  Position ``p`` always lives in slot
``p mod window``, in the prefill cache as in decode.  The reference's
prefill instead puts the prompt's trailing positions ``s - w + i`` in slot
``i`` while its decode writes slot ``pos mod window``; the two agree only
when the prompt is shorter than the window or a multiple of it, and
elsewhere its decode overwrites a position still inside the window.  Where
the reference is consistent the port's caches equal its caches; where it
is not, the port's decode still equals its teacher-forced forward.
Cross-attention is not ported (ROADMAP queue 1, "The rest of the LM
side").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models.common import apply_rope, dtype_of, softcap

MASK_VALUE = -2.0e38
_M_INIT = -1.0e30


def init_attention(cfg, device: torch.device,
                   generator: Optional[torch.Generator] = None) -> dict:
    dt = dtype_of(cfg)
    p = {
        "wq": common.dense_param((cfg.d_model, cfg.q_dim), dt, device,
                                 generator),
        "wk": common.dense_param((cfg.d_model, cfg.kv_dim), dt, device,
                                 generator),
        "wv": common.dense_param((cfg.d_model, cfg.kv_dim), dt, device,
                                 generator),
        "wo": common.dense_param((cfg.q_dim, cfg.d_model), dt, device,
                                 generator),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
        p["bo"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=torch.float32,
                                 device=device)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=torch.float32,
                                 device=device)
    return p


def _project_q(cfg, p, x: torch.Tensor) -> torch.Tensor:
    q = x @ p["wq"]
    if cfg.attn_bias:
        q = q + p["bq"]
    return q.reshape(*x.shape[:-1], cfg.n_heads, cfg.head_dim)


def _project_kv(cfg, p, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        k, v = k + p["bk"], v + p["bv"]
    shape = (*x.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
    return k.reshape(shape), v.reshape(shape)


def _qk_norm(cfg, p, q: torch.Tensor, k: torch.Tensor):
    if cfg.qk_norm:
        q = common.rms_head_norm(q, p["q_norm"])
        k = common.rms_head_norm(k, p["k_norm"])
    return q, k


def _scale(d: int) -> float:
    """1 / sqrt(d) rounded to f32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _attend(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,Kv,D) -> (B,Sq,H*D).  GQA via head grouping;
    softmax in f32; optional gemma2 attention-logit softcap."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    qg = q.reshape(b, sq, kvh, group, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    logits = logits * _scale(d)
    if cfg.attn_softcap is not None:
        logits = softcap(logits, cfg.attn_softcap)
    if mask is not None:
        # (Sq, Sk) or (B, Sq, Sk) -> (B?, 1, 1, Sq, Sk)
        mask = mask[None, None, None] if mask.dim() == 2 else mask[:, None,
                                                                    None]
        logits = torch.where(mask, logits, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h * d)


def _tile_mask(qoff, koff, tq, tk, causal, window, device):
    if not causal and window is None:
        return None
    qpos = qoff + torch.arange(tq, device=device)[:, None]
    kpos = koff + torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _attend_blockwise(cfg, q, k, v, *, causal: bool,
                      window: Optional[int]) -> torch.Tensor:
    """Tiled attention that never materializes (Sq, Sk): q/kv tiles of the
    config's sizes, an online softmax carrying (m, l, acc) in f32.

    Tiles wholly above the diagonal or wholly outside the window are
    skipped.  That gives the reference's numbers bit for bit: such a tile,
    after a tile with a live score, adds exp(-1e30 - m) = 0 with a
    rescale of exp(0) = 1; before one (the window's leading tiles), what it
    adds is rescaled by exp(-1e30 - m) = 0 when the first live tile comes.
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    tq = min(cfg.flash_block_q, sq)
    tk = min(cfg.flash_block_kv, sk)
    nq, nk = sq // tq, sk // tk
    assert nq * tq == sq and nk * tk == sk, (sq, sk, tq, tk)
    scale = _scale(d)
    dev = q.device
    qr = q.reshape(b, nq, tq, kvh, g, d)
    kr = k.reshape(b, nk, tk, kvh, d)
    vr = v.reshape(b, nk, tk, kvh, d)
    tiles = []
    for qi in range(nq):
        qoff = qi * tq
        qt = qr[:, qi].float()
        m = torch.full((b, kvh, g, tq), _M_INIT, device=dev)
        l = torch.zeros((b, kvh, g, tq), device=dev)
        acc = torch.zeros((b, kvh, g, tq, d), device=dev)
        for ki in range(nk):
            koff = ki * tk
            if causal and koff > qoff + tq - 1:
                continue            # tile strictly above the diagonal
            if window is not None and koff + tk - 1 <= qoff - window:
                continue            # tile strictly outside the window
            s = torch.einsum("bqkgd,bskd->bkgqs", qt,
                             kr[:, ki].float()) * scale
            if cfg.attn_softcap is not None:
                s = softcap(s, cfg.attn_softcap)
            mask = _tile_mask(qoff, koff, tq, tk, causal, window, dev)
            if mask is not None:
                s = torch.where(mask, s, _M_INIT)
            m_new = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", pr.to(v.dtype).float(),
                vr[:, ki].float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]     # (b,kvh,g,tq,d)
        tiles.append(out.permute(0, 3, 1, 2, 4).reshape(b, tq, h * d))
    return torch.cat(tiles, dim=1).to(v.dtype)


# ---------------------------------------------------------------------------
# Train / prefill paths
# ---------------------------------------------------------------------------

def self_attention(cfg, p, x: torch.Tensor, positions: torch.Tensor, *,
                   window: Optional[int] = None, return_cache: bool = False):
    """Full-sequence self-attention.  x (B,S,d), positions (B,S).  Returns
    (y, cache): with ``return_cache``, the prefill's ``{"k", "v"}`` cache
    (for a ``window`` layer the ring, with ``slot_pos``), else None."""
    s = x.shape[1]
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    q, k = _qk_norm(cfg, p, q, k)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if s >= cfg.flash_threshold:
        out = _attend_blockwise(cfg, q, k, v, causal=cfg.causal,
                                window=window)
    else:
        if not cfg.causal:
            mask = None
        elif window is not None:
            mask = common.window_mask(s, s, 0, window, x.device)
        else:
            mask = common.causal_mask(s, s, 0, x.device)
        out = _attend(cfg, q, k, v, mask)
    y = _out_proj(cfg, p, out)
    if not return_cache:
        return y, None
    if window is None:
        return y, {"k": k, "v": v}
    return y, _ring_cache(k, v, window)


def _out_proj(cfg, p, out: torch.Tensor) -> torch.Tensor:
    y = out @ p["wo"]
    if cfg.attn_bias:
        y = y + p["bo"]
    return y


def _ring_cache(k: torch.Tensor, v: torch.Tensor, window: int) -> dict:
    """The prompt's trailing ``min(window, S)`` positions as a ring of
    ``window`` slots: position ``p`` in slot ``p mod window``, unfilled
    slots zero with position -1."""
    b, s = k.shape[:2]
    w = min(window, s)
    pos = torch.arange(s - w, s, device=k.device)
    slots = pos % window
    ck = k.new_zeros((b, window, *k.shape[2:]))
    cv = v.new_zeros((b, window, *v.shape[2:]))
    cpos = torch.full((b, window), -1, dtype=torch.int32, device=k.device)
    ck.index_copy_(1, slots, k[:, s - w:])
    cv.index_copy_(1, slots, v[:, s - w:])
    cpos.index_copy_(1, slots, pos.to(torch.int32).expand(b, w))
    return {"k": ck, "v": cv, "slot_pos": cpos}


# ---------------------------------------------------------------------------
# Decode paths (one new token against a cache)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg, batch: int, s_max: int,
                      window: Optional[int] = None,
                      device: str | torch.device | None = None) -> dict:
    """Zero caches on ``device`` (``None``: the card): ``s_max`` slots, or
    ``min(window, s_max)`` with ``slot_pos`` all -1 for a ``window``
    layer."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    s = min(window, s_max) if window is not None else s_max
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if window is not None:
        cache["slot_pos"] = torch.full((batch, s), -1, dtype=torch.int32,
                                       device=device)
    return cache


def _decode_attend_blockwise(cfg, q, k, v, pos: int) -> torch.Tensor:
    """Flash-decoding: one query against a long cache, split over KV chunks
    of ``flash_block_kv`` with an online softmax carrying (m, l, acc) in
    f32, so no f32 copy of the whole cache is made.

    q (B,1,H,D); k/v (B,S,KvH,D).  S must be a multiple of the chunk (the
    reference asserts it; here a ``ValueError``).  Chunks wholly past
    ``pos`` are skipped: the reference's masked chunk adds
    exp(-1e30 - m) = 0 under a rescale of exp(0) = 1, so the numbers are
    the same.
    """
    b, _, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    tk = min(cfg.flash_block_kv, s)
    if s % tk:
        raise ValueError(f"flash-decoding needs the cache length {s} to be "
                         f"a multiple of flash_block_kv ({tk})")
    scale = _scale(d)
    dev = q.device
    qg = q.reshape(b, 1, kvh, g, d).float()
    m = torch.full((b, kvh, g, 1), _M_INIT, device=dev)
    l = torch.zeros((b, kvh, g, 1), device=dev)
    acc = torch.zeros((b, kvh, g, 1, d), device=dev)
    for koff in range(0, min(s, pos + 1), tk):
        kt, vt = k[:, koff:koff + tk], v[:, koff:koff + tk]
        sres = torch.einsum("bqkgd,bskd->bkgqs", qg, kt.float()) * scale
        if cfg.attn_softcap is not None:
            sres = softcap(sres, cfg.attn_softcap)
        kv_pos = koff + torch.arange(tk, device=dev)
        sres = torch.where(kv_pos <= pos, sres, _M_INIT)
        m_new = torch.maximum(m, sres.amax(-1))
        pm = torch.exp(sres - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pm.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", pm.to(v.dtype).float(), vt.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]       # (b,kvh,g,1,d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h * d).to(v.dtype)


def decode_self_attention(cfg, p, x: torch.Tensor, cache: dict, pos,
                          window: Optional[int] = None):
    """One-token decode.  x (B,1,d); ``pos`` the new token's absolute
    position (an int); ``cache`` from ``init_decode_cache`` or
    ``self_attention(return_cache=True)``, written in place (the new row
    cast to the cache's dtype first, so a bf16 cache stays bf16).  Returns
    (y, cache)."""
    pos = int(pos)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _project_q(cfg, p, x)
    k_new, v_new = _project_kv(cfg, p, x)
    q, k_new = _qk_norm(cfg, p, q, k_new)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    if window is not None:
        slot = pos % k.shape[1]
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        slot_pos = cache["slot_pos"]
        slot_pos[:, slot] = pos
        keep = (slot_pos > pos - window) & (slot_pos >= 0) & (
            slot_pos <= pos)
        mask = keep[:, None, :]                              # (B, 1, W)
    else:
        k[:, pos] = k_new[:, 0].to(k.dtype)
        v[:, pos] = v_new[:, 0].to(v.dtype)
        if k.shape[1] >= cfg.flash_threshold:
            out = _decode_attend_blockwise(cfg, q, k, v, pos)
            return _out_proj(cfg, p, out), cache
        kv_pos = torch.arange(k.shape[1], device=x.device)
        mask = (kv_pos <= pos)[None, None, :]                # (1, 1, S)
    out = _attend(cfg, q, k, v, mask)
    return _out_proj(cfg, p, out), cache
