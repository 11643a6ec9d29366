"""gemma-7b — dense GeGLU, head_dim=256.

[arXiv:2403.08295; hf] 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    attn_kind="gqa",
    mlp_kind="geglu",
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=32,
    attn_kind="gqa",
    mlp_kind="geglu",
    tie_embeddings=True,
    max_seq_len=128,
    dtype="float32",
)
