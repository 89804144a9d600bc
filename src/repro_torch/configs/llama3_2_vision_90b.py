"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.  80 self-attention layers + 20 cross-attention (image) layers:
every 5th layer cross-attends to vision states.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Super-block = (4x self-attn + 1x cross-attn), x20 = 100 layers.  The vision
encoder is a STUB per the assignment: ``input_specs()`` provides precomputed
patch embeddings (B, 1600, 8192); the cross-attn layers hold their own
KV projections over those states.  Pure full attention => ``long_500k``
skipped.
"""

from repro_torch.configs.base import ATTN, XATTN, ModelConfig, VisionStubConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        source="hf:meta-llama/Llama-3.2-90B-Vision",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        layer_pattern=(ATTN,) * 4 + (XATTN,),
        n_superblocks=20,
        act="swiglu",
        norm="rmsnorm",
        rope=True,
        rope_theta=500_000.0,
        vision=VisionStubConfig(n_tokens=1600, d_embed=8192),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=5, n_superblocks=1, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=96, remat=False,
        vision=VisionStubConfig(n_tokens=16, d_embed=64),
    )
