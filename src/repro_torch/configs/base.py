"""Config dataclasses for the model zoo and the shape registry, a copy of
``repro/configs/base.py`` (plain data, no JAX in it).

Every assigned architecture is expressed as a ``ModelConfig`` built from the
published dims (see the per-arch modules in this package); the port's LM
(``models/lm.py``) and its training driver (``launch/train.py``) read it.

Layer heterogeneity (gemma2 local/global alternation, zamba2 mamba+shared-attn
super-blocks, xlstm 7:1 mLSTM:sLSTM, vision cross-attn every 5th layer) is
encoded as ``layer_pattern``: the sub-layer sequence of ONE scanned
super-block.  ``n_layers == len(prologue) + len(layer_pattern) * n_superblocks``
always holds and is checked at construction.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

# Sub-layer type tags usable in layer_pattern / prologue.
ATTN = "attn"          # self-attention + FFN/MoE
LOCAL = "local"        # sliding-window self-attention + FFN
GLOBAL = "global"      # full self-attention + FFN (alias of attn, kept
                       # distinct so gemma2's pairing reads literally)
XATTN = "xattn"        # cross-attention to vision states + FFN
SHARED_ATTN = "shared_attn"  # zamba2: attention+FFN block with weights shared
                             # across all invocations (lives outside the scan)
MAMBA = "mamba2"       # Mamba2 / SSD block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block

LAYER_TYPES = (ATTN, LOCAL, GLOBAL, XATTN, SHARED_ATTN, MAMBA, MLSTM, SLSTM)

ATTN_LIKE = (ATTN, LOCAL, GLOBAL, SHARED_ATTN)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert FFN hidden dim
    n_shared_experts: int = 0      # always-on experts (DeepSeek/Moonlight style)
    capacity_factor: float = 1.25  # tokens-per-expert cap = cf * T*topk/E
    router_aux_weight: float = 1e-2  # load-balance auxiliary loss weight


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64        # N: SSM state size per head
    d_conv: int = 4          # depthwise conv width
    expand: int = 2          # d_inner = expand * d_model
    head_dim: int = 64       # P: channels per SSD head
    chunk: int = 256         # SSD chunk length for the train-time scan


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0   # mLSTM up-projection factor
    qk_dim_factor: float = 0.5  # qk head dim = qk_dim_factor * v head dim
    conv_dim: int = 4          # causal conv width in the mLSTM block
    slstm_ff_factor: float = 1.3333  # sLSTM post-FFN expansion
    chunk: int = 256           # chunkwise-parallel segment length


@dataclass(frozen=True)
class VisionStubConfig:
    """Modality frontend is a STUB per the assignment: ``input_specs()``
    provides precomputed patch/frame embeddings of shape (B, n_tokens, d)."""

    n_tokens: int = 1600       # e.g. 1 image tile of 40x40 patches
    d_embed: int = 8192        # projected vision hidden size fed to cross-attn


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shape cells.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""             # citation tag from the assignment

    # -- trunk dims --------------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0                # dense FFN hidden (0 for pure-xLSTM archs)
    vocab_size: int = 0

    # -- structure ---------------------------------------------------------
    layer_pattern: Tuple[str, ...] = (ATTN,)
    n_superblocks: int = 0
    prologue: Tuple[str, ...] = ()
    encoder_only: bool = False   # bidirectional attention, no decode step
    causal: bool = True

    # -- attention knobs ----------------------------------------------------
    rope: bool = True
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # window for LOCAL layers
    attn_softcap: Optional[float] = None   # gemma2: 50.0 on attn logits
    qk_norm: bool = False                  # qwen3: RMSNorm on q,k heads
    attn_bias: bool = False                # qwen1.5: qkv projection bias

    # -- ffn / embedding knobs ----------------------------------------------
    act: str = "silu"            # silu | gelu | geglu | swiglu ('geglu' and
                                 # 'swiglu' are gated; 'gelu'/'silu' plain MLP)
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    post_norm: bool = False      # gemma2: extra norm after attn/ffn outputs
    logit_softcap: Optional[float] = None  # gemma2: 30.0 on final logits
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma: multiply embeddings by sqrt(d_model)

    # -- optional sub-configs -----------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    vision: Optional[VisionStubConfig] = None

    # -- distribution ---------------------------------------------------------
    pipeline_stages: int = 1     # carried so a pipeline schedule can be
                                 # added without config churn (DESIGN.md §6;
                                 # PP unused at this scale point)

    # -- numerics ------------------------------------------------------------
    param_dtype: str = "bfloat16"
    remat: bool = True           # checkpoint each scanned super-block
    unroll_scan: bool = False    # unroll the super-block scan (dry-run cost
                                 # analysis: XLA counts while bodies ONCE, so
                                 # the roofline pass unrolls to get true FLOPs)

    # -- blockwise (flash-style) attention ------------------------------------
    # Sequences >= flash_threshold never materialize the (Sq, Sk) score
    # matrix: q/kv tiles + online softmax (models/attention.py).  In
    # unroll_scan mode the tile loops are python loops with causal/window
    # tile SKIPPING — the exact FLOP schedule a Pallas flash kernel runs.
    flash_threshold: int = 2048
    flash_block_q: int = 1024
    flash_block_kv: int = 1024

    def __post_init__(self):
        expected = len(self.prologue) + len(self.layer_pattern) * self.n_superblocks
        if self.n_layers and expected != self.n_layers:
            raise ValueError(
                f"{self.name}: layer bookkeeping mismatch: "
                f"{len(self.prologue)} prologue + {len(self.layer_pattern)} x "
                f"{self.n_superblocks} superblocks = {expected} != n_layers="
                f"{self.n_layers}"
            )
        for t in self.layer_pattern + self.prologue:
            if t not in LAYER_TYPES:
                raise ValueError(f"{self.name}: unknown layer type {t!r}")

    # -- derived -------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the vocab-parallel head shards over the
        16-way model axis (hubert's 504 -> 512)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def uses_moe(self) -> bool:
        return self.moe is not None and any(
            t in ATTN_LIKE for t in self.layer_pattern
        )

    @property
    def subquadratic(self) -> bool:
        """True when decode at 500k context is admissible (SSM / linear-attn /
        hybrid / windowed): pure full-attention archs skip ``long_500k``."""
        kinds = set(self.layer_pattern + self.prologue)
        if kinds & {MAMBA, MLSTM, SLSTM}:
            return True
        # gemma2-style local/global alternation: half the layers are windowed;
        # decode cost per token is O(window) for those, O(1)-state for none.
        # We admit it (documented in DESIGN.md SS5) because its KV residency is
        # dominated by the windowed half and it exercises the 500k SP path.
        if LOCAL in kinds and self.sliding_window is not None:
            return True
        return False

    def layer_types_in_order(self) -> Tuple[str, ...]:
        return self.prologue + self.layer_pattern * self.n_superblocks

    # -- parameter accounting (for roofline MODEL_FLOPS = 6*N*D) -------------
    def _attn_params(self) -> int:
        qkv = self.d_model * (self.q_dim + 2 * self.kv_dim)
        out = self.q_dim * self.d_model
        return qkv + out

    def _dense_ffn_params(self, d_ff: int) -> int:
        mats = 3 if self.act in ("geglu", "swiglu") else 2
        return mats * self.d_model * d_ff

    def _moe_ffn_params(self, active_only: bool) -> int:
        assert self.moe is not None
        m = self.moe
        router = self.d_model * m.n_experts
        n_used = (m.top_k if active_only else m.n_experts) + m.n_shared_experts
        return router + n_used * self._dense_ffn_params_expert(m.d_ff)

    def _dense_ffn_params_expert(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # experts are always gated (swiglu)

    def _mamba_params(self) -> int:
        assert self.ssm is not None
        s = self.ssm
        d_in = s.expand * self.d_model
        n_heads = d_in // s.head_dim
        in_proj = self.d_model * (2 * d_in + 2 * s.d_state + n_heads)
        conv = s.d_conv * (d_in + 2 * s.d_state)
        out = d_in * self.d_model
        return in_proj + conv + out + 2 * n_heads  # + A_log, D

    def _mlstm_params(self) -> int:
        # Matches models/xlstm.py: up (d->di) + z-gate (d->di) + q,k
        # (di->qk_dim) + i,f gates (di->n_heads) + down (di->d); conv is
        # depthwise (negligible).
        assert self.xlstm is not None
        x = self.xlstm
        d_in = int(x.proj_factor * self.d_model)
        qk = int(d_in * x.qk_dim_factor)
        up = 2 * self.d_model * d_in
        qkproj = 2 * d_in * qk
        gates = 2 * d_in * self.n_heads
        down = d_in * self.d_model
        return up + qkproj + gates + down

    def _slstm_params(self) -> int:
        # Matches models/xlstm.py: 4 input mats (d->d) + 4 recurrent
        # (block-diagonal per head: d*head_dim_s) + gated FF at ff_factor.
        assert self.xlstm is not None
        x = self.xlstm
        d = self.d_model
        inp = 4 * d * d
        rec = 4 * d * (d // max(self.n_heads, 1))
        ff_h = int(d * x.slstm_ff_factor)
        ff = 3 * d * ff_h
        return inp + rec + ff

    def _layer_params(self, kind: str, active_only: bool) -> int:
        if kind in (ATTN, LOCAL, GLOBAL, SHARED_ATTN):
            ffn = (
                self._moe_ffn_params(active_only)
                if self.uses_moe
                else self._dense_ffn_params(self.d_ff)
            )
            return self._attn_params() + ffn
        if kind == XATTN:
            return self._attn_params() + self._dense_ffn_params(self.d_ff)
        if kind == MAMBA:
            return self._mamba_params()
        if kind == MLSTM:
            return self._mlstm_params()
        if kind == SLSTM:
            return self._slstm_params()
        raise ValueError(kind)

    def param_count(self, active_only: bool = False) -> int:
        """Approximate trunk+embedding parameter count.

        ``active_only=True`` counts only routed-in experts (MoE): the N in the
        6*N_active*D MODEL_FLOPS convention.  Zamba2's shared block is counted
        ONCE here (weights are shared) but its FLOPs recur per invocation —
        ``flops_per_token`` handles that distinction.
        """
        total = 0
        seen_shared = False
        for kind in self.layer_types_in_order():
            if kind == SHARED_ATTN:
                if seen_shared:
                    continue
                seen_shared = True
            total += self._layer_params(kind, active_only)
        embed = self.padded_vocab * self.d_model
        total += embed if self.tie_embeddings else 2 * embed
        return total

    def flops_per_token(self) -> int:
        """6 * N_active * 1 (per token), counting shared-block re-invocations
        and excluding embedding gather (matching the 6ND convention: the
        unembedding matmul IS counted via the head params)."""
        per_layer = 0
        for kind in self.layer_types_in_order():
            per_layer += self._layer_params(kind, active_only=True)
        head = self.padded_vocab * self.d_model
        return 6 * (per_layer + head)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def human(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000:
            return f"{n:.2f}{unit}"
        n /= 1000
    return f"{n:.2f}P"


def sqrt_d(cfg: ModelConfig) -> float:
    return math.sqrt(cfg.d_model)
