"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU activations, head_dim=256, multi-query attention, tied embeddings,
embeddings scaled by sqrt(d_model).  [arXiv:2403.08295; hf]

Pure full attention => ``long_500k`` skipped.
"""

from repro_torch.configs.base import ATTN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        source="arXiv:2403.08295",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        layer_pattern=(ATTN,),
        n_superblocks=18,
        act="geglu",
        norm="rmsnorm",
        rope=True,
        tie_embeddings=True,
        embed_scale=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_superblocks=2, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=96, remat=False,
    )
