"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

Local(4096-window)/global alternating attention, attention-logit softcap 50,
final-logit softcap 30, pre+post RMSNorm, GeGLU, head_dim=256, tied
embeddings.  [arXiv:2408.00118; hf]

Super-block = (local, global) pair, x21 = 42 layers.  ``long_500k`` IS run:
half the layers are sliding-window (KV residency O(window)), and the global
half decodes against a sequence-sharded 500k KV cache — documented choice in
DESIGN.md SS5.
"""

from repro_torch.configs.base import GLOBAL, LOCAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        source="arXiv:2408.00118",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        layer_pattern=(LOCAL, GLOBAL),
        n_superblocks=21,
        act="geglu",
        norm="rmsnorm",
        post_norm=True,
        rope=True,
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        tie_embeddings=True,
        embed_scale=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=4, n_superblocks=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=96, sliding_window=32, remat=False,
    )
