"""qwen1.5-32b — dense, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf] 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    attn_kind="gqa",
    mlp_kind="swiglu",
    qkv_bias=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen1.5-32b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    attn_kind="gqa",
    mlp_kind="swiglu",
    qkv_bias=True,
    max_seq_len=128,
    dtype="float32",
)
