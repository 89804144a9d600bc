"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64.  Mamba2 backbone + ONE shared attention+MLP block invoked
periodically (weight sharing across invocations).  [arXiv:2411.15242;
unverified]

Layer layout (DESIGN.md SS5): 3 leading Mamba2 blocks (prologue), then 13
scanned super-blocks of (5x Mamba2 + 1 shared-attn invocation) = 3 + 78 = 81.
The shared block's weights live OUTSIDE the scan and are reused at every
invocation — Zamba's parameter-sharing trick.  (The published model also
concatenates the original embeddings into the shared block input and applies
per-invocation LoRA deltas; both are dropped here, noted in DESIGN.md SS5.)

SSM-dominated => runs ``long_500k`` (shared-attn decodes against a
sequence-sharded KV cache).
"""

from repro_torch.configs.base import MAMBA, SHARED_ATTN, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        source="arXiv:2411.15242",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        layer_pattern=(MAMBA,) * 5 + (SHARED_ATTN,),
        n_superblocks=13,
        prologue=(MAMBA,) * 3,
        act="geglu",
        norm="rmsnorm",
        rope=True,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=9, n_superblocks=1, prologue=(MAMBA,) * 3, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=96,
        remat=False,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    )
