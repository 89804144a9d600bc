"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

GQA + RoPE, LayerNorm, plain-GELU MLP (4x), tied embeddings.
[arXiv:2402.19173; hf]   Pure full attention => ``long_500k`` skipped.
(The HF config uses a 4096 sliding window during training; the released
model serves full attention — we model full attention.)
"""

from repro_torch.configs.base import ATTN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        source="arXiv:2402.19173",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        layer_pattern=(ATTN,),
        n_superblocks=30,
        act="gelu",
        norm="layernorm",
        rope=True,
        rope_theta=999999.4420358813,
        attn_bias=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_superblocks=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=96, remat=False,
    )
