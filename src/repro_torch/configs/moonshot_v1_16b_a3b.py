"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=163840, MoE 64 experts top-6 (+2 always-on shared experts,
DeepSeek/Moonlight style).  [hf:moonshotai/Moonlight-16B-A3B; hf]

Adaptation notes (DESIGN.md SS5): Moonlight's leading dense layer is modelled
as MoE like the rest (keeps the scanned super-block homogeneous; the FLOP
difference is <1%).  Pure full attention => ``long_500k`` skipped.
"""

from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        source="hf:moonshotai/Moonlight-16B-A3B",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163840,
        layer_pattern=(ATTN,),
        n_superblocks=48,
        act="swiglu",
        norm="rmsnorm",
        rope=True,
        rope_theta=50_000.0,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared_experts=2),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_superblocks=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=96, remat=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared_experts=1),
    )
