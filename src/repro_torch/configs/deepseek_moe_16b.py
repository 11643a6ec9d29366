"""deepseek-moe-16b — 2 shared + 64 routed top-6, fine-grained experts.

[arXiv:2401.06066; hf] 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    attn_kind="gqa",
    mlp_kind="moe",
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6, expert_ffn=1408),
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-moe-16b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=48,
    vocab_size=512,
    attn_kind="gqa",
    mlp_kind="moe",
    moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=2, capacity_factor=4.0, expert_ffn=48),
    max_seq_len=128,
    dtype="float32",
)
