"""LM assembly, after ``repro/models/lm.py``: config -> init / forward /
loss / prefill / decode / selection proxy.

The port covers every layer kind of the reference: the attention kinds
(``attn``, ``local``, ``global``) with a dense FFN or a Mixture-of-Experts
(``models/moe.py``), the Mamba2 hybrid (``mamba2`` sub-layers,
``models/ssm.py``, and zamba2's ``shared_attn`` block), xLSTM (``mlstm``
and ``slstm`` sub-layers, ``models/xlstm.py``) and cross-attention to
vision states (``xattn``), with the LM head or hubert's encoder-only
``unit_head``: all ten archs of ``configs/``, in the reference's three
modes:

  - ``train``:   stateless forward, recomputed per super-block with remat;
  - ``prefill``: forward that also returns the decode state;
  - ``decode``:  one token against the state, whose attention caches it
    writes in place (``prefill_step`` / ``decode_step``, under
    ``no_grad``).

A recurrent sub-layer (``mamba2``, ``mlstm``, ``slstm``) is ``norm1``, the
mixer and the residual; its decode state has the same shapes in prefill
and decode.  An ``xattn`` sub-layer (llama-3.2-vision) is cross-attention
to the ``vision`` states and a plain FFN (even in an MoE config), each
added through ``tanh`` of an f32 0-d gate that starts at 0; its decode
state is the vision K / V of the prefill, ``(B, n_img, kv, hd)``, which
decode reads and passes on unchanged.  An encoder-only model (hubert)
reads frame ``embeds`` in place of tokens (the audio family has no
``embed``) and has no decode step.  The decode state is a dict like the
reference's, with ``blocks`` a list of super-blocks where the reference
stacks them.

Parameters live in a ``ParamTree`` (``LM``) whose names follow the
reference's pytree paths, with ``blocks`` a list of super-blocks where the
reference stacks them on a leading axis; ``params_from_jax`` turns a
``repro.models.lm.init_lm`` tree of numpy arrays into one
(``train.steps.reference_tree`` gives it back).  Weights keep the
reference's ``(in, out)`` layout.  Zamba2's shared block is one set of weights,
``params["shared"]``, outside ``blocks``: each super-block's ``shared_attn``
sub-layer runs it (its gradient is the sum over the invocations), while
each invocation keeps its own KV cache in its super-block's state.  The
MoE load-balance loss is summed over the prologue and the blocks, through
remat, as the reference's scan carries it.

On a mesh (parameters and batch as DTensors, ``launch/train.py``,
``launch/dryrun.py``) the residual stream is pinned to the ``residual``
rule after each attention or FFN add, one point more than the reference's
(after the attention add): DTensor would otherwise carry the row-parallel
output's partial sum into the next norm and gather the FFN's weights.

The weighted loss is the GRAD-MATCH integration point: ``lm_loss`` takes
per-sequence weights ``w`` (the OMP output, summing to 1) and computes
``sum_i w_i * meanCE_i + aux``.  ``selection_proxy`` gives each sequence's
exact head-input gradient through the fused ``hidden_grad`` kernel.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (LOCAL, MAMBA, MLSTM, SHARED_ATTN,
                                      SLSTM, XATTN, ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.core import proxies as proxy_lib
from repro_torch.distributed import dtensor as dt
from repro_torch.distributed import hints
from repro_torch.models import attention, common, ffn, moe, ssm, xlstm
from repro_torch.models.common import ParamTree, dtype_of

class LM(ParamTree):
    """The parameters of one LM (``embed`` unless audio, ``lm_head`` when
    untied or ``unit_head`` when encoder-only, ``prologue``, ``shared``,
    ``blocks``, ``final_norm``) with its config."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

# the recurrent mixers: (init, full-sequence apply, one-token decode, decode
# state)
_MIXERS = {
    MAMBA: (ssm.init_mamba, ssm.mamba_apply, ssm.mamba_decode,
            ssm.init_state),
    MLSTM: (xlstm.init_mlstm, xlstm.mlstm_apply, xlstm.mlstm_decode,
            xlstm.init_mlstm_state),
    SLSTM: (xlstm.init_slstm, xlstm.slstm_apply, xlstm.slstm_decode,
            xlstm.init_slstm_state),
}


def _init_sublayer(cfg: ModelConfig, kind: str, device, generator) -> dict:
    if kind in _MIXERS:
        return {"norm1": common.init_norm(cfg, device),
                "mixer": _MIXERS[kind][0](cfg, device, generator)}
    if kind == XATTN:
        return {
            "norm1": common.init_norm(cfg, device),
            "attn": attention.init_attention(cfg, device, generator,
                                             cross=True),
            "norm2": common.init_norm(cfg, device),
            "mlp": ffn.init_ffn(cfg, device, generator),
            "gate_attn": torch.zeros((), dtype=torch.float32, device=device),
            "gate_mlp": torch.zeros((), dtype=torch.float32, device=device),
        }
    p = {
        "norm1": common.init_norm(cfg, device),
        "attn": attention.init_attention(cfg, device, generator),
        "norm2": common.init_norm(cfg, device),
        "mlp": (moe.init_moe(cfg, device, generator) if cfg.uses_moe
                else ffn.init_ffn(cfg, device, generator)),
    }
    if cfg.post_norm:
        p["post_norm1"] = common.init_norm(cfg, device)
        p["post_norm2"] = common.init_norm(cfg, device)
    return p


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device: str | torch.device | None = None) -> LM:
    """Fresh parameters on ``device`` (``None``: the card), drawn from
    ``generator`` (a ``torch.Generator`` on that device).  The reference's
    initializers and dtypes; its values come from ``jax.random``, so they
    differ (``params_from_jax`` carries them over)."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    params: dict = {}
    if not cfg.encoder_only or cfg.family != "audio":
        params["embed"] = common.embed_init(
            (cfg.padded_vocab, cfg.d_model), dt, device, generator)
    if cfg.encoder_only:
        # hubert's head: frame hidden -> unit logits
        params["unit_head"] = common.dense_param(
            (cfg.d_model, cfg.padded_vocab), dt, device, generator)
    elif not cfg.tie_embeddings:
        params["lm_head"] = common.dense_param(
            (cfg.d_model, cfg.padded_vocab), dt, device, generator)
    if cfg.prologue:
        params["prologue"] = {f"pro{i}": _init_sublayer(cfg, kind, device,
                                                        generator)
                              for i, kind in enumerate(cfg.prologue)}
    if SHARED_ATTN in cfg.layer_pattern:
        # one set of weights, run by every super-block's shared_attn
        params["shared"] = _init_sublayer(cfg, SHARED_ATTN, device,
                                          generator)
    if cfg.n_superblocks:
        params["blocks"] = [
            {f"sub{si}": _init_sublayer(cfg, kind, device, generator)
             for si, kind in enumerate(cfg.layer_pattern)
             if kind != SHARED_ATTN}
            for _ in range(cfg.n_superblocks)]
    params["final_norm"] = common.init_norm(cfg, device)
    return LM(cfg, params)


def params_from_jax(cfg: ModelConfig, params: Mapping[str, object],
                    device: str | torch.device | None = None) -> LM:
    """An ``LM`` holding a JAX ``init_lm`` tree's values, on ``device``
    (``None``: the card).

    ``params`` has numpy (or array-like) leaves, or tensors (a snapshot
    read by ``checkpoint.load_checkpoint``); ``blocks`` is stacked on a
    leading super-block axis, which is split into the port's list (an
    ``xattn`` gate, stacked to ``(n_superblocks,)``, becomes a 0-d tensor
    again).  Leaves keep their dtype (bf16 arrays come through their bits)
    and layout.
    """
    device = resolve_device(device)

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device, copy=True)
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).astype(np.int16))
            return t.view(torch.bfloat16).to(device)
        return torch.from_numpy(np.array(a)).to(device)

    def tree(node):
        if isinstance(node, Mapping):
            return {k: tree(v) for k, v in node.items()}
        return leaf(node)

    def split(node, i):
        if isinstance(node, Mapping):
            return {k: split(v, i) for k, v in node.items()}
        return node[i] if isinstance(node, torch.Tensor) else (
            np.asarray(node)[i])

    out = {k: tree(v) for k, v in params.items() if k != "blocks"}
    if "blocks" in params:
        out["blocks"] = [tree(split(params["blocks"], i))
                         for i in range(cfg.n_superblocks)]
    return LM(cfg, out)


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------

def _init_substate(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                   device: torch.device) -> dict:
    """Decode state of one sub-layer (zeros; prefill overwrites): a
    recurrent mixer's state, the vision K / V of an ``xattn`` sub-layer
    (``(B, n_img, kv, hd)`` in the parameter dtype), or the attention
    caches (each shared_attn invocation its own)."""
    if kind in _MIXERS:
        return _MIXERS[kind][3](cfg, batch, device)
    if kind == XATTN:
        shape = (batch, cfg.vision.n_tokens, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
                "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}
    window = cfg.sliding_window if kind == LOCAL else None
    return attention.init_decode_cache(cfg, batch, s_max, window=window,
                                       device=device)


def init_decode_state(cfg: ModelConfig, batch: int, s_max: int,
                      device: str | torch.device | None = None) -> dict:
    """The whole decode state on ``device`` (``None``: the card):
    ``prologue`` sub-layers by name and ``blocks`` a list of super-blocks,
    each a dict of its sub-layers' caches."""
    device = resolve_device(device)
    state: dict = {}
    if cfg.prologue:
        state["prologue"] = {
            f"pro{i}": _init_substate(cfg, kind, batch, s_max, device)
            for i, kind in enumerate(cfg.prologue)}
    if cfg.n_superblocks:
        state["blocks"] = [
            {f"sub{si}": _init_substate(cfg, kind, batch, s_max, device)
             for si, kind in enumerate(cfg.layer_pattern)}
            for _ in range(cfg.n_superblocks)]
    return state


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_sublayer(cfg: ModelConfig, kind: str, p, x: torch.Tensor, *,
                    mode: str, positions: Optional[torch.Tensor] = None,
                    pos: Optional[int] = None, state: Optional[dict] = None,
                    vision: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, Optional[dict],
                               Optional[torch.Tensor]]:
    """Returns (x_out, the sub-layer's new state or None, its MoE aux loss
    or None)."""
    h = common.norm_apply(cfg, p["norm1"], x)
    if kind == XATTN:
        if mode == "decode":
            # the vision K / V are fixed during decode: the state passes on
            a, _ = attention.cross_attention(cfg, p["attn"], h,
                                             kv_cache=state)
            new_state = state
        else:
            a, new_state = attention.cross_attention(
                cfg, p["attn"], h, kv_states=vision,
                return_cache=mode == "prefill")
        x = hints.constrain(x + torch.tanh(p["gate_attn"]).to(x.dtype) * a,
                            "residual")
        h = common.norm_apply(cfg, p["norm2"], x)
        f = ffn.ffn_apply(cfg, p["mlp"], h)
        x = x + torch.tanh(p["gate_mlp"]).to(x.dtype) * f
        return hints.constrain(x, "residual"), new_state, None
    if kind in _MIXERS:
        _, apply, decode, _ = _MIXERS[kind]
        if mode == "decode":
            y, new_state = decode(cfg, p["mixer"], h, state)
        else:
            y, new_state = apply(cfg, p["mixer"], h, state=state,
                                 return_state=mode == "prefill")
        return hints.constrain(x + y, "residual"), new_state, None
    window = cfg.sliding_window if kind == LOCAL else None
    if mode == "decode":
        a, new_state = attention.decode_self_attention(
            cfg, p["attn"], h, state, pos, window=window)
    else:
        a, new_state = attention.self_attention(
            cfg, p["attn"], h, positions, window=window,
            return_cache=mode == "prefill")
    if cfg.post_norm:
        a = common.norm_apply(cfg, p["post_norm1"], a)
    x = hints.constrain(x + a, "residual")
    h = common.norm_apply(cfg, p["norm2"], x)
    aux = None
    if cfg.uses_moe:
        f, aux = moe.moe_apply(cfg, p["mlp"], h,
                               group="batch" if mode == "decode" else "seq")
    else:
        f = ffn.ffn_apply(cfg, p["mlp"], h)
    if cfg.post_norm:
        f = common.norm_apply(cfg, p["post_norm2"], f)
    return hints.constrain(x + f, "residual"), new_state, aux


def _embed_in(cfg: ModelConfig, params: LM, tokens: Optional[torch.Tensor],
              embeds: Optional[torch.Tensor]) -> torch.Tensor:
    if embeds is not None:
        return embeds.to(dtype_of(cfg))
    x = dt.vocab_lookup(params["embed"], tokens)
    if cfg.embed_scale:
        # sqrt(d_model) rounded to the parameter dtype first, as in the
        # reference.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


_MODES = ("train", "prefill", "decode")


def forward(cfg: ModelConfig, params: LM,
            tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            vision: Optional[torch.Tensor] = None, mode: str = "train",
            states: Optional[dict] = None, pos: Optional[int] = None
            ) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """Trunk forward.  Returns (hidden (B,S,d), new_states, aux_loss), as
    the reference does.  ``embeds`` (B,S,d), cast to the parameter dtype,
    stand in for ``tokens`` (hubert's frames); ``vision`` (B,N,d_embed),
    cast likewise, are the states the ``xattn`` sub-layers attend to in
    train and prefill (decode reads their K / V from ``states``).
    ``prefill`` returns the decode state of the prompt; ``decode`` takes
    tokens (B,1) at absolute position ``pos`` against ``states``, which it
    writes in place and returns.  The serving modes run without
    autograd."""
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} is not one of {_MODES}")
    with torch.set_grad_enabled(torch.is_grad_enabled() and mode == "train"):
        return _forward(cfg, params, tokens, embeds, vision, mode, states,
                        pos)


def _forward(cfg, params, tokens, embeds, vision, mode, states, pos):
    x = _embed_in(cfg, params, tokens, embeds)
    if vision is not None:
        vision = vision.to(dtype_of(cfg))
    b, s, _ = x.shape
    positions = None if mode == "decode" else torch.arange(
        s, dtype=torch.int32, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states: dict = {}

    def sub(kind, p, xx, aa, st):
        xx, nst, a = _apply_sublayer(cfg, kind, p, xx, mode=mode,
                                     positions=positions, pos=pos, state=st,
                                     vision=vision)
        # the aux loss is added a sub-layer at a time, as the reference's
        # scan carries it
        return xx, nst, aa if a is None else aa + a

    if cfg.prologue:
        pro = {}
        for i, kind in enumerate(cfg.prologue):
            st = states["prologue"][f"pro{i}"] if states else None
            x, pro[f"pro{i}"], aux = sub(
                kind, params["prologue"][f"pro{i}"], x, aux, st)
        if mode != "train":
            new_states["prologue"] = pro
    shared = params["shared"] if "shared" in params else None

    def superblock(xx, aa, bp, bst=None):
        out = {}
        for si, kind in enumerate(cfg.layer_pattern):
            p = shared if kind == SHARED_ATTN else bp[f"sub{si}"]
            st = bst[f"sub{si}"] if bst is not None else None
            xx, out[f"sub{si}"], aa = sub(kind, p, xx, aa, st)
        return xx, aa, out

    def train_superblock(xx, aa, bp):
        return superblock(xx, aa, bp)[:2]

    blocks = params["blocks"] if cfg.n_superblocks else ()
    block_states = []
    for bi, bp in enumerate(blocks):
        if mode != "train":
            bst = states["blocks"][bi] if states else None
            x, aux, out = superblock(x, aux, bp, bst)
            block_states.append(out)
        elif cfg.remat and torch.is_grad_enabled():
            # Recompute the super-block in the backward pass, as the
            # reference's jax.checkpoint(nothing_saveable) does: the same
            # numbers, activation memory of one super-block.  The aux loss
            # goes through it beside the residual stream.
            x, aux = checkpoint(train_superblock, x, aux, bp,
                                use_reentrant=False)
        else:
            x, aux = train_superblock(x, aux, bp)
    if mode != "train" and cfg.n_superblocks:
        new_states["blocks"] = block_states
    return x, new_states, aux


def head_weight(cfg: ModelConfig, params: LM) -> torch.Tensor:
    """The head as ``(d_model, Vpad)``: ``unit_head`` for an encoder-only
    model, ``embed.T`` (a view) when tied, else ``lm_head``."""
    if cfg.encoder_only:
        return params["unit_head"]
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _head_out(cfg: ModelConfig, params: LM, h: torch.Tensor
              ) -> torch.Tensor:
    h = common.norm_apply(cfg, params["final_norm"], h)
    logits = h @ head_weight(cfg, params)
    logits = common.softcap(logits, cfg.logit_softcap)
    return hints.constrain(logits, "logits")


def mask_padded_logits(cfg: ModelConfig, logits: torch.Tensor
                       ) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    v = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    return torch.where(v, logits, torch.tensor(-1e9, dtype=logits.dtype,
                                               device=logits.device))


# ---------------------------------------------------------------------------
# Loss (weighted-subset CE: the paper's Alg. 1 line 9 objective)
# ---------------------------------------------------------------------------

def token_ce(cfg: ModelConfig, logits: torch.Tensor, targets: torch.Tensor
             ) -> torch.Tensor:
    """Stable per-token CE in f32.  logits (..., Vpad), targets (...)."""
    # on a mesh, the vocabulary whole on every rank (one gather; DTensor
    # would gather it for the log-sum-exp anyway)
    lg = dt.unshard(logits.float(), -1)
    if cfg.padded_vocab != cfg.vocab_size:
        v = torch.arange(cfg.padded_vocab, device=lg.device) < cfg.vocab_size
        lg = torch.where(v, lg, -1e9)
    lse = torch.logsumexp(lg, dim=-1)
    own = lg.gather(-1, targets.long()[..., None])[..., 0]
    return lse - own


def lm_loss(cfg: ModelConfig, params: LM, batch: Mapping[str, torch.Tensor]
            ) -> tuple[torch.Tensor, dict]:
    """Weighted-subset LM / encoder loss.

    batch: tokens (B,S) [or embeds (B,S,d) for audio], targets (B,S),
    optional weights (B,) summing to 1 (uniform by default), optional
    loss_mask (B,S), optional vision (B,N,d_embed).  Returns (loss,
    metrics)."""
    h, _, aux = forward(cfg, params, batch.get("tokens"),
                        embeds=batch.get("embeds"),
                        vision=batch.get("vision"))
    logits = _head_out(cfg, params, h)
    ce = token_ce(cfg, logits, batch["targets"])               # (B,S) f32
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.float()
        per_seq = (ce * mask).sum(-1) / torch.clamp_min(mask.sum(-1), 1)
    else:
        per_seq = ce.mean(-1)                                  # (B,)
    w = batch.get("weights")
    if w is None:
        w = torch.full(per_seq.shape, 1.0 / per_seq.shape[0],
                       dtype=torch.float32, device=per_seq.device)
    loss = (w.float() * per_seq).sum() + aux
    metrics = {"ce": per_seq.mean(), "aux": aux, "loss": loss}
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_step(cfg: ModelConfig, params: LM,
                 tokens: Optional[torch.Tensor], *,
                 embeds: Optional[torch.Tensor] = None,
                 vision: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, dict]:
    """Process the whole prompt (B,S) (with its ``vision`` states for an
    ``xattn`` model); return (the last position's logits (B, Vpad), padded
    columns at -1e9, and the decode states)."""
    h, states, _ = forward(cfg, params, tokens, embeds=embeds,
                           vision=vision, mode="prefill")
    logits = _head_out(cfg, params, h[:, -1:])[:, 0]
    return mask_padded_logits(cfg, logits), states


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: LM, states: dict,
                tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict]:
    """One new token (B,1) at absolute position ``pos`` against the decode
    state (written in place).  Returns (logits (B, Vpad), the states)."""
    h, new_states, _ = forward(cfg, params, tokens, mode="decode",
                               states=states, pos=pos)
    logits = _head_out(cfg, params, h)[:, 0]
    return mask_padded_logits(cfg, logits), new_states


# ---------------------------------------------------------------------------
# Selection proxies (GRAD-MATCH hook): last-layer gradients for LM heads
# ---------------------------------------------------------------------------

@torch.no_grad()
def selection_proxy(cfg: ModelConfig, params: LM,
                    batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Per-sequence gradient proxy (B, d_model): the exact head-input
    gradient dL/dh, mean-pooled over tokens.  No trunk backprop.

    The residual ``softmax(logits) - onehot(targets)`` @ ``W^T`` is one
    ``proxies.hidden_grad_proxy`` call over the batch's B*S tokens (the
    fused ``hidden_grad`` kernel on the card), where the reference takes an
    unfused einsum.  As there, the softmax runs over the padded vocabulary
    with no mask.  The head is ``head_weight``'s (``unit_head`` for an
    encoder-only model).
    """
    h, _, _ = forward(cfg, params, batch.get("tokens"),
                      embeds=batch.get("embeds"),
                      vision=batch.get("vision"))
    logits = _head_out(cfg, params, h)
    g = proxy_lib.hidden_grad_proxy(h, logits, batch["targets"],
                                    head_weight(cfg, params))
    return g.mean(dim=1)
