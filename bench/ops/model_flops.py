"""The model FLOPs a served request needs, whatever implements them: its
S prompt tokens and its ``max_new`` decode tokens through every layer,
the routed top-k experts (not every expert a batched matmul computes),
attention over the positions before each token, the Mamba mixer's scan
and convolution, and the vocab head once for the prefill's last position
and once a decode step. Neither a re-prefill nor a dropped pair is work
a request needs, so neither is counted: a change that removes wasted
work raises the share of the peak, one that adds some lowers it."""
from __future__ import annotations


def _mamba(cfg) -> float:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    dtr = -(-d // 16)
    mm = d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d
    # conv taps, then a = exp(dt A), b = dt x B, h = a h + b, y = C h
    return 2.0 * mm + 2.0 * dc * di + 7.0 * di * ds


def _attn_proj(cfg) -> float:
    hd = cfg.resolved_head_dim
    return 2.0 * (2 * cfg.d_model * cfg.num_heads * hd
                  + 2 * cfg.d_model * cfg.num_kv_heads * hd)


def _attn_core(cfg, context: int) -> float:
    """QK^T and PV of one token over ``context`` positions."""
    return 4.0 * cfg.num_heads * cfg.resolved_head_dim * context


def _ffn(cfg, moe: bool) -> float:
    if moe:
        m = cfg.moe
        return 2.0 * (cfg.d_model * m.num_experts
                      + m.top_k * 3 * cfg.d_model * m.expert_ffn)
    return 2.0 * 3 * cfg.d_model * cfg.d_ff


def layer_kinds(cfg):
    """(mixer, moe) of each layer, in the port's order for the hybrid
    stack: attention at ``attn_every // 2`` of a group, the MoE where
    ``index % moe_every == 0``."""
    g = cfg.attn_every
    out = []
    for i in range(cfg.num_layers):
        j = i % g
        out.append(("attn" if j == g // 2 else "mamba",
                    cfg.mlp_kind == "moe" and j % cfg.moe_every == 0))
    return out


def request_flops(cfg, prompt: int, max_new: int) -> float:
    """FLOPs of one request of ``prompt`` tokens and ``max_new`` new ones
    (the hybrid mamba/attention stack)."""
    tokens = prompt + max_new
    total = 0.0
    for mixer, moe in layer_kinds(cfg):
        total += tokens * _ffn(cfg, moe)
        if mixer == "mamba":
            total += tokens * _mamba(cfg)
        else:
            total += tokens * _attn_proj(cfg)
            # token at position p attends over p + 1 positions
            total += _attn_core(cfg, tokens * (tokens + 1) // 2)
    head = 2.0 * cfg.d_model * cfg.vocab_size
    return total + (1 + max_new) * head
