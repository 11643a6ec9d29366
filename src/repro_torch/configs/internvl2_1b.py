"""internvl2-1b — InternViT vision frontend (stub) + InternLM2/Qwen2 LM.

[arXiv:2404.16821; hf] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
Vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    attn_kind="gqa",
    mlp_kind="swiglu",
    qkv_bias=True,
    frontend="vision",
    frontend_tokens=256,  # ViT patch embeddings per image (stubbed)
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-1b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    attn_kind="gqa",
    mlp_kind="swiglu",
    qkv_bias=True,
    frontend="vision",
    frontend_tokens=16,
    max_seq_len=128,
    dtype="float32",
)
