"""command-r-plus-104b — dense GQA kv=8, no-bias.

[hf:CohereForAI/c4ai-command-r-v01; unverified] 64L d_model=12288 96H
(GQA kv=8) d_ff=33792 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    attn_kind="gqa",
    mlp_kind="swiglu",
)

SMOKE_CONFIG = ModelConfig(
    name="command-r-plus-104b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    attn_kind="gqa",
    mlp_kind="swiglu",
    max_seq_len=128,
    dtype="float32",
)
