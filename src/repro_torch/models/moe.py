"""Mixture-of-Experts FFN with capacity-bounded sparse-index dispatch, after
``repro/models/moe.py``.

Routing: top-k over the f32 router's softmax, renormalized (floor 1e-9)
and cast to the activation dtype, with the Switch-style load-balance loss
``E * mean_g sum_e f_e * pbar_e`` (``f`` from the top-1 choice only).
Dispatch: per token group an (E, C) table of token ids, built by a
stable sort of the (T*k,) expert ids; an assignment's rank within its
expert at or past the capacity C is dropped (arrival order).  The routed
tokens are gathered to (G, E, C, d), the experts run as three batched
products against the (E, d, ff) weights (always gated SiLU), and each
token's weighted outputs are added back.  Shared experts (moonshot) are
an ordinary SwiGLU FFN of width ``d_ff * n_shared_experts``.

Groups: ``group="seq"`` (train, prefill) routes each sequence on its own;
``group="batch"`` (decode) routes the B tokens as one group.  Capacity
``C = max(4, min(ceil(cf * T_g * k / E), T_g))``.

Where the port parts from the reference's code, not its numbers:

- ``lax.top_k`` breaks ties toward the lower expert id; ``torch.topk``
  promises no order, so the top k come from a stable descending sort.
- The reference drops ranks >= C with ``.at[...].set(mode="drop")``.  An
  out-of-range ``scatter`` raises in torch (a device-side assert on the
  card), so a dropped assignment is sent explicitly to a spare slot past
  the table, which is then cut off.
- The combine: the reference scatter-adds into (T, d) in the activation
  dtype.  On the card ``index_add_`` / ``scatter_add_`` add with atomics
  in an order that changes from run to run, and so would the bf16 bits of
  a step.  Here each token gathers its k contributions in the order the
  reference's scatter applies them (ascending expert; one slot an expert)
  and adds them one after another, each sum rounded to the activation
  dtype as there.  The dispatch gather's backward, a scatter-add of the
  same kind, is replaced by the same per-token sum (``_Dispatch``), so a
  weighted step, and remat's recomputed forward, give the same bits on
  every run.

On a mesh (DTensor parameters and activations) each rank routes and
dispatches its own token groups (``dtensor.rows_local``: a group's sort
and scatters need the group whole), the reference's ``hints.constrain``
calls pin the routed activations ``moe_dispatch`` / ``moe_combine``
(experts over the model axis), and the combine gathers each group's
expert outputs back before its per-token sums.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import dtensor as dt
from repro_torch.distributed import hints
from repro_torch.models import common, ffn
from repro_torch.models.common import dtype_of


def _shared_cfg(cfg):
    return cfg.replace(act="swiglu")


def init_moe(cfg, device: torch.device,
             generator: Optional[torch.Generator] = None) -> dict:
    """The router (f32, (d, E)), the experts' ``w_gate`` / ``w_up`` (E, d,
    ff) and ``w_down`` (E, ff, d) in the parameter dtype, and ``shared``
    when the config has shared experts: the reference's tree."""
    m = cfg.moe
    dt = dtype_of(cfg)
    d, ff, e = cfg.d_model, m.d_ff, m.n_experts
    p = {
        "router": common.dense_param((d, e), torch.float32, device,
                                     generator),
        "w_gate": common.dense_param((e, d, ff), dt, device, generator,
                                     fan_in=d),
        "w_up": common.dense_param((e, d, ff), dt, device, generator,
                                   fan_in=d),
        "w_down": common.dense_param((e, ff, d), dt, device, generator,
                                     fan_in=ff),
    }
    if m.n_shared_experts:
        p["shared"] = ffn.init_ffn(_shared_cfg(cfg), device, generator,
                                   d_ff=m.d_ff * m.n_shared_experts)
    return p


def capacity_of(cfg, group_tokens: int) -> int:
    m = cfg.moe
    c = math.ceil(m.capacity_factor * group_tokens * m.top_k / m.n_experts)
    return max(4, min(c, group_tokens))


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on the last axis: descending, ties toward the lower
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg, router_w: torch.Tensor, x: torch.Tensor):
    """x (G, T, d) -> top-k (ids (G, T, k) int64, weights (G, T, k) in x's
    dtype) per token and the load-balance aux loss (f32 scalar)."""
    m = cfg.moe
    logits = x.float() @ router_w                              # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, m.top_k)                      # (G, T, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    # f: the share of the group's tokens whose top-1 is e.  Counted by a
    # scatter of ones (exact integers: any order of the adds gives the same
    # bits); one_hot would check its indices with a sync on the card.
    g, t = top_i.shape[:2]
    f = top_w.new_zeros((g, m.n_experts), dtype=torch.float32).scatter_add_(
        1, top_i[..., 0], top_w.new_ones((g, t), dtype=torch.float32)) / t
    pbar = probs.mean(1)                                       # (G, E)
    aux = m.n_experts * (f * pbar).sum(-1).mean()
    return top_i, top_w.to(x.dtype), aux


def _dispatch(eid: torch.Tensor, w: torch.Tensor, n_experts: int,
              capacity: int):
    """eid / w (G, T, k) -> idx (G, E, C) token ids (sentinel T), cw (G, E,
    C) weights, and ``slots`` (G, T, k): each token's flat (E*C) table
    slots in ascending expert order, ``E*C`` where the assignment was
    dropped."""
    g, t, k = eid.shape
    ec = n_experts * capacity
    dev = eid.device
    flat_e = eid.reshape(g, t * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    e_s = flat_e.gather(1, order)
    t_s = torch.div(order, k, rounding_mode="floor")           # flat_t[order]
    w_s = w.reshape(g, t * k).gather(1, order)
    counts = torch.zeros((g, n_experts), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    start = counts.cumsum(1) - counts
    rank = torch.arange(t * k, device=dev) - start.gather(1, e_s)
    # ranks >= C are dropped: they go to the spare slot ec, cut off below
    slot = torch.where(rank < capacity, e_s * capacity + rank,
                       torch.full_like(rank, ec))
    idx = torch.full((g, ec + 1), t, dtype=torch.int64, device=dev).scatter(
        1, slot, t_s)[:, :ec].reshape(g, n_experts, capacity)
    cw = w.new_zeros((g, ec + 1)).scatter(1, slot, w_s)[:, :ec].reshape(
        g, n_experts, capacity)
    by_token = torch.empty_like(slot).scatter_(1, order, slot).reshape(
        g, t, k)
    slots = by_token.gather(-1, eid.argsort(-1))
    return idx, cw, slots


def _dispatch_indices(eid: torch.Tensor, w: torch.Tensor, n_experts: int,
                      capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_dispatch_indices`` on one group: eid / w (T, k)
    -> idx (E, C) token ids (sentinel T), cw (E, C) weights."""
    idx, cw, _ = _dispatch(eid[None], w[None], n_experts, capacity)
    return idx[0], cw[0]


def _token_sum(rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """rows (G, E*C, d), slots (G, T, k) -> (G, T, d): each token's rows
    at its slots added one after another, in ``slots``' order, in
    ``rows``' dtype; a dropped slot (``E*C``) adds nothing."""
    g, n, d = rows.shape
    t, k = slots.shape[1:]
    padded = torch.cat([rows, rows.new_zeros((g, 1, d))], dim=1)
    vals = padded.gather(1, slots.reshape(g, t * k, 1).expand(-1, -1, d))
    vals = vals.reshape(g, t, k, d)
    out = vals[:, :, 0]
    for j in range(1, k):
        out = out + vals[:, :, j]
    return out


class _Dispatch(torch.autograd.Function):
    """Gather the routed tokens (sentinel -> a zero row); the backward adds
    each token's k gradient rows in a fixed order (``_token_sum``) in
    place of the gather's scatter-add."""

    @staticmethod
    def forward(ctx, xg, idx, slots):
        g, t, d = xg.shape
        e, c = idx.shape[1:]
        ctx.save_for_backward(slots)
        xpad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
        return xpad.gather(1, idx.reshape(g, e * c, 1).expand(-1, -1, d)
                           ).reshape(g, e, c, d)

    @staticmethod
    def backward(ctx, grad):
        slots, = ctx.saved_tensors
        g, e, c, d = grad.shape
        return _token_sum(grad.reshape(g, e * c, d), slots), None, None


def _experts(xe, w_gate, w_up, w_down):
    """The experts' gated SiLU FFN on the routed tokens (G, E, C, d)."""
    h = torch.einsum("gecd,edf->gecf", xe, w_gate)
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", xe, w_up)
    return torch.einsum("gecf,efd->gecd", h, w_down)


def moe_apply(cfg, p, x: torch.Tensor, group: str = "seq"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss (), f32).

    group='seq': one routing group a sequence (train, prefill);
    group='batch': one group of all tokens (decode, S == 1)."""
    m = cfg.moe
    b, s, d = x.shape
    xg = dt.reshape(x, 1, b * s, d) if group == "batch" else x
    t = xg.shape[1]
    cap = capacity_of(cfg, t)

    def route(xg, router):
        top_i, top_w, aux = _route(cfg, router, xg)
        idx, cw, slots = _dispatch(top_i, top_w, m.n_experts, cap)
        xe = _Dispatch.apply(xg, idx, slots)                  # (G, E, C, d)
        return xe, cw, slots, aux

    if dt.is_dtensor(xg):
        # each rank's groups: its aux loss as a value a group, whose mean
        # over all the groups is the mean of the ranks' (as many groups
        # each)
        def local(xg, router):
            xe, cw, slots, aux = route(xg, router)
            return xe, cw, slots, aux.repeat(xg.shape[0])

        xe, cw, slots, aux = dt.rows_local(local, (xg,), (p["router"],))
        aux = aux.mean()
    else:
        xe, cw, slots, aux = route(xg, p["router"])
    xe = hints.constrain(xe, "moe_dispatch")

    weights = (xe, p["w_gate"], p["w_up"], p["w_down"])
    if dt.is_dtensor(xe):
        # expert-parallel: each rank runs its experts on its token groups
        # (the weights gathered over any FSDP axis)
        w_pl = dt.follow(xe, {1: 0})
        ye = dt.local_map(_experts, weights,
                          (xe.placements, w_pl, w_pl, w_pl), xe.placements)
    else:
        ye = _experts(*weights)
    ye = hints.constrain(ye, "moe_combine")

    def combine(prod, slots):
        return _token_sum(prod.reshape(prod.shape[0], m.n_experts * cap, d),
                          slots)

    y = dt.rows_local(combine, (ye * cw[..., None], slots))
    y = dt.reshape(y, b, s, d)

    if m.n_shared_experts:
        y = y + ffn.ffn_apply(_shared_cfg(cfg), p["shared"], x)
    return y, aux * m.router_aux_weight
