"""LM assembly, after ``repro/models/lm.py``: config -> init / forward /
loss / prefill / decode / selection proxy.

The port covers the attention layer kinds (``attn``, ``local``,
``global``): the dense archs (gemma-2b, gemma2-9b, starcoder2-3b,
codeqwen1.5-7b), in the reference's three modes:

  - ``train``:   stateless forward, recomputed per super-block with remat;
  - ``prefill``: forward that also returns the decode state;
  - ``decode``:  one token against the state, whose caches it writes in
    place (``prefill_step`` / ``decode_step``, under ``no_grad``).

MoE, ``mamba2``, ``mlstm``, ``slstm``, ``xattn``, ``shared_attn`` and
encoder-only heads raise ``NotImplementedError`` (ROADMAP queue 1, "The
rest of the LM side").  The decode state is a dict like the reference's,
with ``blocks`` a list of super-blocks where the reference stacks them.

Parameters live in a ``ParamTree`` (``LM``) whose names follow the
reference's pytree paths, with ``blocks`` a list of super-blocks where the
reference stacks them on a leading axis; ``params_from_jax`` turns a
``repro.models.lm.init_lm`` tree of numpy arrays into one.  Weights keep the
reference's ``(in, out)`` layout.

The weighted loss is the GRAD-MATCH integration point: ``lm_loss`` takes
per-sequence weights ``w`` (the OMP output, summing to 1) and computes
``sum_i w_i * meanCE_i``.  ``selection_proxy`` gives each sequence's exact
head-input gradient through the fused ``hidden_grad`` kernel.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, GLOBAL, LOCAL, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.core import proxies as proxy_lib
from repro_torch.models import attention, common, ffn
from repro_torch.models.common import ParamTree, dtype_of

_ATTN_KINDS = (ATTN, LOCAL, GLOBAL)
_LATER = 'ROADMAP queue 1, "The rest of the LM side"'


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.prologue + cfg.layer_pattern)
    if cfg.uses_moe:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported "
                                  f"yet ({_LATER})")
    if cfg.encoder_only:
        raise NotImplementedError(f"{cfg.name}: encoder-only heads are not "
                                  f"ported yet ({_LATER})")
    other = sorted(kinds - set(_ATTN_KINDS))
    if other:
        raise NotImplementedError(f"{cfg.name}: layer kinds {other} are not "
                                  f"ported yet ({_LATER})")


class LM(ParamTree):
    """The parameters of one LM (``embed``, ``lm_head`` when untied,
    ``prologue``, ``blocks``, ``final_norm``) with its config."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        _check_supported(cfg)
        super().__init__(tree)
        self.cfg = cfg


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_sublayer(cfg: ModelConfig, device, generator) -> dict:
    p = {
        "norm1": common.init_norm(cfg, device),
        "attn": attention.init_attention(cfg, device, generator),
        "norm2": common.init_norm(cfg, device),
        "mlp": ffn.init_ffn(cfg, device, generator),
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
    _check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg)
    params: dict = {"embed": common.embed_init(
        (cfg.padded_vocab, cfg.d_model), dt, device, generator)}
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_param(
            (cfg.d_model, cfg.padded_vocab), dt, device, generator)
    if cfg.prologue:
        params["prologue"] = {f"pro{i}": _init_sublayer(cfg, device,
                                                        generator)
                              for i in range(len(cfg.prologue))}
    if cfg.n_superblocks:
        params["blocks"] = [
            {f"sub{si}": _init_sublayer(cfg, device, generator)
             for si in range(len(cfg.layer_pattern))}
            for _ in range(cfg.n_superblocks)]
    params["final_norm"] = common.init_norm(cfg, device)
    return LM(cfg, params)


def params_from_jax(cfg: ModelConfig, params: Mapping[str, object],
                    device: str | torch.device | None = None) -> LM:
    """An ``LM`` holding a JAX ``init_lm`` tree's values, on ``device``
    (``None``: the card).

    ``params`` has numpy (or array-like) leaves; ``blocks`` is stacked on a
    leading super-block axis, which is split into the port's list.  Leaves
    keep their dtype (bf16 arrays come through their bits) and layout.
    """
    device = resolve_device(device)

    def leaf(a):
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
        return np.asarray(node)[i]

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
    """Decode state of one sub-layer (zeros; prefill overwrites)."""
    window = cfg.sliding_window if kind == LOCAL else None
    return attention.init_decode_cache(cfg, batch, s_max, window=window,
                                       device=device)


def init_decode_state(cfg: ModelConfig, batch: int, s_max: int,
                      device: str | torch.device | None = None) -> dict:
    """The whole decode state on ``device`` (``None``: the card):
    ``prologue`` sub-layers by name and ``blocks`` a list of super-blocks,
    each a dict of its sub-layers' caches."""
    _check_supported(cfg)
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
                    pos: Optional[int] = None, state: Optional[dict] = None
                    ) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (x_out, the sub-layer's new state or None)."""
    window = cfg.sliding_window if kind == LOCAL else None
    h = common.norm_apply(cfg, p["norm1"], x)
    if mode == "decode":
        a, new_state = attention.decode_self_attention(
            cfg, p["attn"], h, state, pos, window=window)
    else:
        a, new_state = attention.self_attention(
            cfg, p["attn"], h, positions, window=window,
            return_cache=mode == "prefill")
    if cfg.post_norm:
        a = common.norm_apply(cfg, p["post_norm1"], a)
    x = x + a
    h = common.norm_apply(cfg, p["norm2"], x)
    f = ffn.ffn_apply(cfg, p["mlp"], h)
    if cfg.post_norm:
        f = common.norm_apply(cfg, p["post_norm2"], f)
    return x + f, new_state


def _embed_in(cfg: ModelConfig, params: LM, tokens: torch.Tensor
              ) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        # sqrt(d_model) rounded to the parameter dtype first, as in the
        # reference.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


_MODES = ("train", "prefill", "decode")


def forward(cfg: ModelConfig, params: LM, tokens: torch.Tensor, *,
            mode: str = "train", states: Optional[dict] = None,
            pos: Optional[int] = None
            ) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """Trunk forward.  Returns (hidden (B,S,d), new_states, aux_loss), as
    the reference does.  ``prefill`` returns the decode state of the
    prompt; ``decode`` takes tokens (B,1) at absolute position ``pos``
    against ``states``, which it writes in place and returns.  The
    serving modes run without autograd."""
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} is not one of {_MODES}")
    with torch.set_grad_enabled(torch.is_grad_enabled() and mode == "train"):
        return _forward(cfg, params, tokens, mode, states, pos)


def _forward(cfg, params, tokens, mode, states, pos):
    x = _embed_in(cfg, params, tokens)
    b, s, _ = x.shape
    positions = None if mode == "decode" else torch.arange(
        s, dtype=torch.int32, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states: dict = {}

    def sub(kind, p, xx, st):
        return _apply_sublayer(cfg, kind, p, xx, mode=mode,
                               positions=positions, pos=pos, state=st)

    if cfg.prologue:
        pro = {}
        for i, kind in enumerate(cfg.prologue):
            st = states["prologue"][f"pro{i}"] if states else None
            x, pro[f"pro{i}"] = sub(kind, params["prologue"][f"pro{i}"], x,
                                    st)
        if mode != "train":
            new_states["prologue"] = pro

    def superblock(xx, bp, bst=None):
        out = {}
        for si, kind in enumerate(cfg.layer_pattern):
            st = bst[f"sub{si}"] if bst is not None else None
            xx, out[f"sub{si}"] = sub(kind, bp[f"sub{si}"], xx, st)
        return xx, out

    def train_superblock(xx, bp):
        return superblock(xx, bp)[0]

    blocks = params["blocks"] if cfg.n_superblocks else ()
    block_states = []
    for bi, bp in enumerate(blocks):
        if mode != "train":
            bst = states["blocks"][bi] if states else None
            x, out = superblock(x, bp, bst)
            block_states.append(out)
        elif cfg.remat and torch.is_grad_enabled():
            # Recompute the super-block in the backward pass, as the
            # reference's jax.checkpoint(nothing_saveable) does: the same
            # numbers, activation memory of one super-block.
            x = checkpoint(train_superblock, x, bp, use_reentrant=False)
        else:
            x = train_superblock(x, bp)
    if mode != "train" and cfg.n_superblocks:
        new_states["blocks"] = block_states
    return x, new_states, aux


def head_weight(cfg: ModelConfig, params: LM) -> torch.Tensor:
    """The head as ``(d_model, Vpad)``: ``embed.T`` (a view) when tied."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _head_out(cfg: ModelConfig, params: LM, h: torch.Tensor
              ) -> torch.Tensor:
    h = common.norm_apply(cfg, params["final_norm"], h)
    logits = h @ head_weight(cfg, params)
    return common.softcap(logits, cfg.logit_softcap)


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
    lg = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        v = torch.arange(cfg.padded_vocab, device=lg.device) < cfg.vocab_size
        lg = torch.where(v, lg, -1e9)
    lse = torch.logsumexp(lg, dim=-1)
    own = lg.gather(-1, targets.long()[..., None])[..., 0]
    return lse - own


def lm_loss(cfg: ModelConfig, params: LM, batch: Mapping[str, torch.Tensor]
            ) -> tuple[torch.Tensor, dict]:
    """Weighted-subset LM loss.

    batch: tokens (B,S), targets (B,S), optional weights (B,) summing to 1
    (uniform by default), optional loss_mask (B,S).  Returns (loss,
    metrics)."""
    h, _, aux = forward(cfg, params, batch["tokens"])
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
def prefill_step(cfg: ModelConfig, params: LM, tokens: torch.Tensor
                 ) -> tuple[torch.Tensor, dict]:
    """Process the whole prompt (B,S); return (the last position's logits
    (B, Vpad), padded columns at -1e9, and the decode states)."""
    h, states, _ = forward(cfg, params, tokens, mode="prefill")
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
    with no mask.
    """
    h, _, _ = forward(cfg, params, batch["tokens"])
    logits = _head_out(cfg, params, h)
    g = proxy_lib.hidden_grad_proxy(h, logits, batch["targets"],
                                    head_weight(cfg, params))
    return g.mean(dim=1)
