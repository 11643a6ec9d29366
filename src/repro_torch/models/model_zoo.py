"""Architecture dispatch: init / prefill / decode per family, analytic
parameter counts and MODEL_FLOPS (the JAX package's
``models/model_zoo.py``).

The port serves attention blocks (the dense GQA family and the DeepSeek
family: MLA, MoE, MTP); the mamba/attention hybrid, xLSTM and
encoder-decoder families raise ``NotImplementedError`` naming ROADMAP
Queue A item 12, and the training entry (``loss_fn``) waits for item 13.
``input_specs`` and ``param_specs`` build ``jax.ShapeDtypeStruct``
stand-ins for the TPU dry run and have no counterpart here (item 14).
"""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.models import transformer


def is_encdec(cfg) -> bool:
    return cfg.block_kind == "encdec"


def init_params(cfg, seed: int = 0, device="cuda"):
    return transformer.init_lm_params(cfg, seed, device)


def prefill_fn(cfg, params, batch):
    """batch: {"tokens": (B,S) int, ["frontend"]: (B,F,d)}."""
    return transformer.prefill(params, cfg, batch["tokens"],
                               batch.get("frontend"))


def decode_fn(cfg, params, token, caches, cur_len: int, seq_axis=None):
    return transformer.decode_step(params, cfg, token, caches, cur_len,
                                   seq_axis)


def init_decode_caches(cfg, batch: int, max_len: int, device="cuda"):
    dtype = transformer.DTYPES[cfg.dtype]
    return transformer.init_decode_caches(cfg, batch, max_len, dtype,
                                          resolve_device(device))


# ---------------------------------------------------------------------------
# analytic parameter counts (roofline MODEL_FLOPS = 6·N·D uses these)
# ---------------------------------------------------------------------------


def _attn_params(cfg) -> int:
    hd = cfg.resolved_head_dim
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return (cfg.d_model * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk
                + cfg.d_model * m.kv_lora_rank + cfg.d_model * m.qk_rope_head_dim
                + m.kv_lora_rank * cfg.num_heads * m.qk_nope_head_dim
                + m.kv_lora_rank * cfg.num_heads * m.v_head_dim
                + cfg.num_heads * m.v_head_dim * cfg.d_model)
    return (cfg.d_model * cfg.num_heads * hd
            + 2 * cfg.d_model * cfg.num_kv_heads * hd
            + cfg.num_heads * hd * cfg.d_model)


def _moe_params(cfg, active_only: bool) -> int:
    m = cfg.moe
    e = m.top_k if active_only else m.num_experts
    p = cfg.d_model * m.num_experts  # router (always evaluated)
    p += e * 3 * cfg.d_model * m.expert_ffn
    if m.num_shared_experts:
        p += 3 * cfg.d_model * m.shared_ffn_dim * m.num_shared_experts
    return p


def _ffn_params(cfg, use_moe: bool, active_only: bool) -> int:
    if use_moe:
        return _moe_params(cfg, active_only)
    return 0 if cfg.mlp_kind == "none" else 3 * cfg.d_model * cfg.d_ff


def analytic_param_count(cfg, active_only: bool = False) -> int:
    """The JAX package's count (embedding, untied head, attention and the
    MLP or MoE of each layer, the MTP block; biases and norms are not
    counted). ``active_only`` counts the top-k routed experts of each MoE
    (the router and shared experts always). The mamba and xLSTM terms come
    with their families (ROADMAP Queue A item 12)."""
    kinds = transformer.group_layer_kinds(cfg)  # raises naming item 12
    vp = transformer.lm_head_vocab(cfg)
    total = vp * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.d_model * vp  # head
    per_group = sum(
        _attn_params(cfg) + _ffn_params(cfg, transformer._uses_moe(cfg, i),
                                        active_only)
        for i, _ in enumerate(kinds))
    total += per_group * transformer.num_groups(cfg)
    if cfg.mtp_depth > 0:
        total += 2 * cfg.d_model * cfg.d_model + _attn_params(cfg)
        total += _moe_params(cfg, active_only) if cfg.mlp_kind == "moe" \
            else 3 * cfg.d_model * cfg.d_ff
    return total


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D (train) or 2·N·D (fwd-only), N = active params
    excluding the embedding table, D = processed tokens."""
    vp = transformer.lm_head_vocab(cfg)
    n = analytic_param_count(cfg, active_only=True) - vp * cfg.d_model
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d_tokens
