"""xlstm-1.3b [ssm]: 48 blocks d_model=2048 4H vocab=50304, d_ff=0.

sLSTM + mLSTM blocks at the paper's 7:1 ratio for the 1.3B model: each
scanned super-block is 7 mLSTM blocks followed by 1 sLSTM block, x6 = 48.
[arXiv:2405.04517; unverified]

mLSTM: matrix-memory linear-recurrent block (chunkwise-parallel in training,
O(1)-state recurrent in decode) -- runs ``long_500k``.  d_ff=0 per the
assignment: blocks carry their own up/down projections instead of a separate
FFN.
"""

from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        source="arXiv:2405.04517",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        head_dim=512,            # inner 4096 / 4 heads (v head dim)
        d_ff=0,
        vocab_size=50304,
        layer_pattern=(MLSTM,) * 7 + (SLSTM,),
        n_superblocks=6,
        act="gelu",
        norm="layernorm",
        rope=False,              # recurrence encodes position
        tie_embeddings=True,
        xlstm=XLSTMConfig(proj_factor=2.0, qk_dim_factor=0.25, conv_dim=4),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=8, n_superblocks=1, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=32, vocab_size=96, remat=False,
        xlstm=XLSTMConfig(proj_factor=2.0, qk_dim_factor=0.5, conv_dim=4,
                          chunk=16),
    )
