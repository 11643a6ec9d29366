"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio frontend stub).

[arXiv:2308.11596; hf] 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206. The speech frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    block_kind="encdec",
    attn_kind="gqa",
    mlp_kind="swiglu",
    encoder_layers=12,
    frontend="audio",
    frontend_tokens=0,  # encoder input length = shape.seq_len frames
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-large-v2-smoke",
    family="audio",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    block_kind="encdec",
    attn_kind="gqa",
    mlp_kind="swiglu",
    encoder_layers=2,
    frontend="audio",
    max_seq_len=128,
    dtype="float32",
)
