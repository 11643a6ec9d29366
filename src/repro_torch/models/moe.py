"""Fine-grained MoE (shared + routed top-k) with sort-based capacity
dispatch (the JAX package's ``models/moe.py``).

Dispatch keeps the reference's order exactly: (token, choice) pairs are
flattened token-major, stably sorted by expert id, and the first
``capacity`` pairs of each expert fill its (C,) row of a dense (E, C)
buffer; the rest are dropped. All experts then run batched over a leading
expert axis (``torch.bmm``), and each token sums its kept slots in
ascending slot order (= ascending expert id), in float32 — the order of the
reference's scatter-add, made deterministic: no atomics, so a run repeats
bit for bit on the card.

The router's weights and logits stay float32 in a bfloat16 model, as in the
reference (``init_moe``'s ``dense_init(..., jnp.float32)``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers
from repro_torch.vector.cagra import smallest_k

ROUTER_DTYPE = torch.float32


def _expert_stack(gen: torch.Generator, E: int, d_in: int, d_out: int,
                  scale: float, dtype):
    """(E, d_in, d_out) N(0, scale²) weights, drawn one expert at a time in
    float32 and cast (a whole f32 stack of deepseek-v3's experts is 15 GB).
    On ``meta`` (``model_zoo.param_specs``) nothing is drawn."""
    w = torch.empty((E, d_in, d_out), dtype=dtype, device=gen.device)
    for e in range(E if gen.device.type != "meta" else 0):
        w[e] = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                           device=gen.device).mul_(scale)
    return w


def init_moe(gen: torch.Generator, cfg, dtype):
    m = cfg.moe
    E, d, f = m.num_experts, cfg.d_model, m.expert_ffn
    p = {
        "router": layers.dense_init(gen, d, E, ROUTER_DTYPE),
        "w_gate": _expert_stack(gen, E, d, f, 1.0 / math.sqrt(d), dtype),
        "w_up": _expert_stack(gen, E, d, f, 1.0 / math.sqrt(d), dtype),
        "w_down": _expert_stack(gen, E, f, d, 1.0 / math.sqrt(f), dtype),
    }
    if m.num_shared_experts > 0:
        p["shared"] = layers.init_gated_mlp(
            gen, d, m.shared_ffn_dim * m.num_shared_experts, dtype)
    return p


def capacity_for(num_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(math.ceil(num_tokens * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)  # padded to 8, as the reference


def _total_order(x):
    """int64 keys that order float32 values as ``jax.lax.top_k`` does,
    -0.0 below +0.0."""
    bits = x.contiguous().view(torch.int32).long()
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def route_topk(router_logits, top_k: int):
    """Top-k routing with softmax-normalised gates over the selected
    experts; ties go to the lower expert id (``jax.lax.top_k``'s rule)."""
    _, idx = smallest_k(-_total_order(router_logits), top_k)  # (T, k)
    return torch.softmax(router_logits.gather(1, idx), dim=-1), idx


def moe_forward(params, x, cfg, capacity: int = 0):
    """x: (T, d) flat tokens. Returns (out (T, d) in x's dtype, aux_loss)."""
    m = cfg.moe
    T, d = x.shape
    E, k = m.num_experts, m.top_k
    C = capacity or capacity_for(T, cfg)
    dev = x.device

    logits = x.float() @ params["router"]  # (T, E)
    gates, expert_idx = route_topk(logits, k)  # (T, k)

    # load-balancing aux loss (Switch-style): E * sum_e f_e * P_e
    # counts by scatter_add (bincount has no meta kernel: the dry run)
    flat_idx = expert_idx.reshape(-1)
    occupancy = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_idx, torch.ones_like(flat_idx)).float()
    f_e = occupancy / (T * k)
    p_e = torch.softmax(logits, dim=-1).mean(dim=0)
    aux_loss = E * torch.sum(f_e * p_e)

    # sort-based capacity dispatch: pairs token-major, stable sort by expert
    flat_e = expert_idx.reshape(-1)  # (T*k,)
    flat_gate = gates.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)
    se, order = torch.sort(flat_e, stable=True)
    stok, sgate = flat_tok[order], flat_gate[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))  # left side
    pos_in_e = torch.arange(T * k, device=dev) - starts[se]
    keep = pos_in_e < C
    dest = torch.where(keep, se * C + pos_in_e, E * C)  # row E*C: dropped

    # slot -> source token (T marks an empty slot) and its gate
    slot_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    slot_tok.scatter_(0, dest, stok)
    slot_gate = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    slot_gate.scatter_(0, dest, sgate)
    slot_tok, slot_gate = slot_tok[:E * C], slot_gate[:E * C]
    xe = torch.where((slot_tok < T)[:, None], x[slot_tok.clamp(max=T - 1)],
                     torch.zeros((), dtype=x.dtype, device=dev))
    xe = constrain(xe.reshape(E, C, d), "model", None, None)

    # batched expert FFN over the leading expert axis
    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_up"])
    y = constrain(torch.bmm(h, params["w_down"]), "model", None, None)
    y = y.reshape(E * C, d).float()
    y = torch.cat([y * slot_gate[:, None], y.new_zeros((1, d))])  # row E*C: 0

    # combine: each token sums its kept slots in ascending slot order
    pair_slot = torch.empty_like(dest)
    pair_slot[order] = dest  # back to token-major (T*k,)
    pair_slot = torch.sort(pair_slot.reshape(T, k), dim=1).values
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + y[pair_slot[:, j]]
    out = constrain(out, "batch", None)

    if m.num_shared_experts > 0:
        out = out + layers.gated_mlp(params["shared"], x, "swiglu").float()
    return out.to(x.dtype), aux_loss

