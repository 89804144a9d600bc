"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only transformer (same trunk as wav2vec2-XL) trained with masked-unit
cross-entropy over 504 cluster units.  [arXiv:2106.07447; unverified]

Modality frontend (conv feature extractor) is a STUB per the assignment:
``input_specs()`` feeds precomputed frame embeddings (B, T, 1280).  The
original uses a convolutional relative positional embedding; we substitute
RoPE inside attention (TPU-friendly, documented in DESIGN.md SS5).
Encoder-only => no decode step: ``decode_32k`` / ``long_500k`` are skipped.
"""

from repro_torch.configs.base import ATTN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        source="arXiv:2106.07447",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,          # padded_vocab -> 512 for the sharded head
        layer_pattern=(ATTN,),
        n_superblocks=48,
        encoder_only=True,
        causal=False,
        act="gelu",
        norm="layernorm",
        rope=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_superblocks=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=96, remat=False,
    )
