"""jamba-1.5-large-398b — hybrid Mamba + attention 1:7, MoE 16e top-2.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2. One attention layer per 8 (1:7 interleave);
MoE every other layer. Sub-quadratic (runs long_500k).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_kind="mamba_attn",
    attn_kind="gqa",
    mlp_kind="moe",
    moe=MoEConfig(num_experts=16, num_shared_experts=0, top_k=2, expert_ffn=24576),
    moe_every=2,  # MoE FFN every other layer (jamba e:2)
    attn_every=8,  # 1 attention : 7 mamba
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    subquadratic=True,
    max_seq_len=524288,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    block_kind="mamba_attn",
    attn_kind="gqa",
    mlp_kind="moe",
    moe=MoEConfig(num_experts=4, num_shared_experts=0, top_k=2, capacity_factor=4.0, expert_ffn=128),
    moe_every=2,
    attn_every=2,
    mamba_d_state=8,
    mamba_d_conv=4,
    mamba_expand=2,
    subquadratic=True,
    max_seq_len=128,
    dtype="float32",
)
