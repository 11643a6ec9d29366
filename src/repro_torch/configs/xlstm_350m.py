"""xlstm-350m — sLSTM + mLSTM blocks.

[arXiv:2405.04517; unverified] 24L d_model=1024 4H (GQA kv=4) d_ff=0
vocab=50304. d_ff=0: xLSTM blocks carry their own up/down projections
(pre-up-projection mLSTM, post-up-projection sLSTM per the paper).
Sub-quadratic (runs long_500k).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_kind="xlstm",
    mlp_kind="none",
    # xLSTM[7:1]-style: sLSTM at one position per 8-block group
    xlstm_pattern=("mlstm", "mlstm", "mlstm", "slstm",
                   "mlstm", "mlstm", "mlstm", "mlstm"),
    subquadratic=True,
    max_seq_len=524288,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    block_kind="xlstm",
    mlp_kind="none",
    xlstm_pattern=("mlstm", "slstm"),
    subquadratic=True,
    max_seq_len=128,
    dtype="float32",
)
