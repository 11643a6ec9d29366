"""DeepSeek-style Multi-head Latent Attention (the JAX package's
``models/mla.py``).

Prefill uses the *naive* expansion (k_nope/v decompressed from the latent)
through ``attention.attend_blocked``. Decode uses the *absorbed* form: W_uk
is folded into the query and W_uv into the output, so the per-token cache is
just (kv_lora_rank + rope_dim) values. Both are torch ops: the reference
computes them with XLA ops, never in a Pallas kernel.

Cache (per layer): {"ckv": (B, S, r), "kr": (B, S, rope_dim)}, updated in
place by ``mla_decode_step`` (the JAX package returns a new one).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.attention import NEG_INF, attend_blocked


def init_mla(gen: torch.Generator, cfg, dtype):
    m = cfg.mla
    H = cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {
        "w_dq": layers.dense_init(gen, cfg.d_model, m.q_lora_rank, dtype),
        "q_norm": layers.init_rms_norm(m.q_lora_rank, dtype, dev),
        "w_uq": layers.dense_init(gen, m.q_lora_rank, H * qk_dim, dtype),
        "w_dkv": layers.dense_init(gen, cfg.d_model, m.kv_lora_rank, dtype),
        "kv_norm": layers.init_rms_norm(m.kv_lora_rank, dtype, dev),
        "w_kr": layers.dense_init(gen, cfg.d_model, m.qk_rope_head_dim, dtype),
        "w_uk": layers.dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                                  dtype),
        "w_uv": layers.dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype),
        "wo": layers.dense_init(gen, H * m.v_head_dim, cfg.d_model, dtype),
    }


def _queries(params, x, cfg, positions):
    m = cfg.mla
    B, S, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = layers.rms_norm(x @ params["w_dq"], params["q_norm"], cfg.norm_eps)
    q = (cq @ params["w_uq"]).reshape(B, S, cfg.num_heads, qk)
    cos, sin = layers.rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = layers.apply_rope(q[..., m.qk_nope_head_dim:], cos, sin)
    return q[..., :m.qk_nope_head_dim], q_rope


def _rope_key(params, x, cfg, positions):
    """The shared rotary key (B, S, 1, rope_dim)."""
    m = cfg.mla
    B, S, _ = x.shape
    kr = (x @ params["w_kr"]).reshape(B, S, 1, m.qk_rope_head_dim)
    cos, sin = layers.rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return layers.apply_rope(kr, cos, sin)


def mla_forward(params, x, cfg, positions=None):
    """Naive (decompressed) MLA for prefill. Returns (out (B, S, d), cache
    {"ckv": (B, S, r), "kr": (B, S, rope_dim)})."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(params, x, cfg, positions)
    ckv = layers.rms_norm(x @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    kr = _rope_key(params, x, cfg, positions)
    k_nope = (ckv @ params["w_uk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (ckv @ params["w_uv"]).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr.expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    out = attend_blocked(q, k, v, positions, positions, causal=True)
    out = out.reshape(B, S, H * m.v_head_dim) @ params["wo"]
    return out, {"ckv": ckv, "kr": kr[:, :, 0, :]}


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device):
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                          device=device),
    }


def mla_decode_step(params, x_step, cache, cur_len: int, cfg,
                    seq_axis: Optional[str] = None):
    """Absorbed-matrix MLA decode over the latent cache.

    x_step: (B, 1, d); cur_len: host int, the new token's position. The
    cache is written at ``cur_len`` in place (nothing past the cache is
    written). Returns (out (B, 1, d), cache).

    seq_axis inside ``activation_sharding(device_mesh)``: the cache is this
    rank's shard of the positions, combined over the axis's process group
    as ``attention.decode_step_attention`` does."""
    m = cfg.mla
    B = x_step.shape[0]
    H = cfg.num_heads
    pos = torch.full((1,), cur_len, dtype=torch.int32, device=x_step.device)
    q_nope, q_rope = _queries(params, x_step, cfg, pos)  # (B,1,H,·)
    # absorb W_uk into q: q_abs[b,h,r] = sum_n q_nope[b,h,n] * w_uk[r,h,n]
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_abs = torch.einsum("bthn,rhn->bthr", q_nope, w_uk)  # (B,1,H,r)
    ckv_new = layers.rms_norm(x_step @ params["w_dkv"], params["kv_norm"],
                              cfg.norm_eps)
    kr_new = _rope_key(params, x_step, cfg, pos)[:, :, 0, :]
    out_c = _cached_mla_core(q_abs, q_rope, ckv_new, kr_new, cache, cur_len,
                             cfg, sharding.seq_shards(seq_axis))
    return _mla_output(params, out_c, x_step, cfg), cache


def _mla_output(params, out_c, x_step, cfg):
    m = cfg.mla
    B = x_step.shape[0]
    H = cfg.num_heads
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bthr,rhv->bthv", out_c, w_uv.float()).to(x_step.dtype)
    return out.reshape(B, 1, H * m.v_head_dim) @ params["wo"]


def _cached_mla_core(q_abs, q_rope, ckv_new, kr_new, cache, cur_len: int, cfg,
                     shards=None):
    """Cache write at ``cur_len`` (none past the cache), then absorbed
    attention over positions <= cur_len. The cache stays in its dtype and
    the products accumulate in float32 (the reference's
    ``preferred_element_type``). Returns the attention-weighted latent
    (B, 1, H, r) in float32. With ``shards`` (``sharding.SeqShards``) the
    cache holds positions [shard0, shard0 + S): only the owner writes, and
    the shards' partials combine (``sharding.combine_partials``)."""
    if shards is not None:  # DTensors (the dry run) to their local shards
        return sharding.on_local_shards(
            lambda qa, qr, cn, kn, c: _cached_local_core(
                qa, qr, cn, kn, c, cur_len, cfg, shards),
            (q_abs, q_rope, ckv_new, kr_new), cache, shards)
    return _cached_local_core(q_abs, q_rope, ckv_new, kr_new, cache, cur_len,
                              cfg, None)


def _cached_local_core(q_abs, q_rope, ckv_new, kr_new, cache, cur_len: int,
                       cfg, shards):
    """``_cached_mla_core`` on plain tensors: the whole cache, or this
    rank's shard of it."""
    m = cfg.mla
    S = cache["ckv"].shape[1]
    shard0 = 0 if shards is None else shards.coord * S
    local = cur_len - shard0
    if 0 <= local < S:
        cache["ckv"][:, local] = ckv_new[:, 0].to(cache["ckv"].dtype)
        cache["kr"][:, local] = kr_new[:, 0].to(cache["kr"].dtype)
    ckv = cache["ckv"].float()
    valid = torch.arange(S, device=ckv.device) <= local
    scale = 1.0 / torch.tensor(float(m.qk_nope_head_dim + m.qk_rope_head_dim),
                               dtype=torch.float32).sqrt()
    scores = (torch.einsum("bthr,bsr->bths", q_abs.float(), ckv)
              + torch.einsum("bthp,bsp->bths", q_rope.float(),
                             cache["kr"].float())) * scale.to(ckv.device)
    scores = torch.where(valid, scores, NEG_INF)
    m_loc = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m_loc)
    p = torch.where(valid, p, 0.0)
    l_sum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bths,bsr->bthr", p.to(cache["ckv"].dtype).float(), ckv)
    if shards is None:
        return o / l_sum.clamp(min=1e-30)
    return sharding.combine_partials(m_loc[..., 0], l_sum[..., 0], o, shards)
