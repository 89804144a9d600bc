"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, MoE 128 experts top-8, q/k RMSNorm, RoPE theta=1e6.
[hf:Qwen/Qwen3-30B-A3B; hf]

Pure full attention => ``long_500k`` skipped.
"""

from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        layer_pattern=(ATTN,),
        n_superblocks=48,
        act="swiglu",
        norm="rmsnorm",
        rope=True,
        rope_theta=1_000_000.0,
        qk_norm=True,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_superblocks=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=96, remat=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32),
    )
