"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32, full MHA) d_ff=13440
vocab=92416.  Qwen1.5 architecture: SwiGLU, RMSNorm, RoPE theta=1e6, QKV
projection bias.  [hf:Qwen/CodeQwen1.5-7B; hf]

Pure full attention => ``long_500k`` skipped.
"""

from repro_torch.configs.base import ATTN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        source="hf:Qwen/CodeQwen1.5-7B",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab_size=92416,
        layer_pattern=(ATTN,),
        n_superblocks=32,
        act="swiglu",
        norm="rmsnorm",
        rope=True,
        rope_theta=1_000_000.0,
        attn_bias=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_superblocks=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=96, remat=False,
    )
