"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 experts, MTP.

[arXiv:2412.19437; hf] 61L d_model=7168 128H (GQA kv=128) d_ff=2048
vocab=129280, MoE 256e top-8.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    head_dim=128,
    attn_kind="mla",
    mlp_kind="moe",
    moe=MoEConfig(num_experts=256, num_shared_experts=1, top_k=8, expert_ffn=2048),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    mtp_depth=1,
    rope_theta=10000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v3-671b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    head_dim=16,
    attn_kind="mla",
    mlp_kind="moe",
    moe=MoEConfig(num_experts=8, num_shared_experts=1, top_k=2, capacity_factor=4.0, expert_ffn=96),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    mtp_depth=1,
    max_seq_len=128,
    dtype="float32",
)
