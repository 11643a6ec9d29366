"""GQA/MQA/MHA attention: causal prefill through the flash-attention kernel
and one-token decode over a KV cache through the decode-attention kernel
(the JAX package's ``models/attention.py``; its XLA paths
``attend_blocked`` and ``_cached_attention_core`` compute the functions
that ``kernels/ops.py`` dispatches here). ``attend_blocked``, ``gqa_scores``
and ``gqa_values`` are also here as torch ops: MLA attends through
``attend_blocked`` (its q/k head dim differs from its v head dim, which the
flash kernel does not take), and so does training (``attention_forward(...,
blocked=True)``): the kernels are bound without a backward, and the
reference trains through this XLA path under ``jax.value_and_grad``.

Shapes:
  x:      (B, S, d_model)
  q:      (B, S, H, hd)        k/v: (B, S, Hkv, hd)
  cache:  {"k": (B, S_max, Hkv, hd), "v": ...}   (per layer)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype):
    hd = cfg.resolved_head_dim
    p = {
        "wq": layers.dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype),
        "wk": layers.dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype),
        "wv": layers.dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype),
        "wo": layers.dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                        ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(params, x, cfg):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (constrain(q.reshape(B, S, cfg.num_heads, hd),
                      "batch", None, "model", None),
            constrain(k.reshape(B, S, cfg.num_kv_heads, hd),
                      "batch", None, "model", None),
            constrain(v.reshape(B, S, cfg.num_kv_heads, hd),
                      "batch", None, "model", None))


def _sqrt_hd(hd: int, dtype):
    """``jnp.sqrt(hd).astype(dtype)``: the float32 square root, cast. A 0-d
    CPU tensor: a CUDA op takes it as a scalar, with no copy to the card
    (a copy from pageable memory would wait for the stream)."""
    return torch.tensor(float(hd), dtype=torch.float32).sqrt().to(dtype)


def gqa_scores(q, k):
    """q: (B, Sq, H, hd), k: (B, Sk, Hkv, hd) -> (B, Hkv, g, Sq, Sk)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k)
    return scores / _sqrt_hd(hd, q.dtype)


def gqa_values(probs, v):
    """probs: (B, Hkv, g, Sq, Sk), v: (B, Sk, Hkv, hd) -> (B, Sq, H, hd)."""
    B, Hkv, g, Sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, Hkv * g, v.shape[-1])


def _attend_block(q, k, v, q_positions, kv_positions, causal: bool):
    """One q block of every row shard: q (B, M, qb, H, hd), q_positions
    (M, qb) -> (B, M, qb, H, hd_v)."""
    B, M, qb, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, M, qb, Hkv, H // Hkv, hd)
    scores = torch.einsum("bmqkgh,bskh->bmkgqs", qg, k)
    scores = (scores / _sqrt_hd(hd, q.dtype)).float()
    if causal:
        mask = (q_positions[None, :, None, None, :, None]
                >= kv_positions[None, None, None, None, None, :])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bmkgqs,bskh->bmqkgh", probs, v)
    return out.reshape(B, M, qb, H, v.shape[-1])


def attend_blocked(q, k, v, q_positions, kv_positions, causal: bool,
                   block_q: int = 512, seq_parallel: int = -1):
    """Blocked attention over q blocks of at most ``block_q`` rows, so the
    (Sq, Sk) scores are never held at once. Scores in q's dtype divided by
    sqrt(hd) cast to it, softmax in float32, probabilities in v's dtype (the
    reference's casts); v has a head dim of its own.

    seq_parallel=M > 0: the query rows are also split M ways on a leading
    dim pinned to the "model" mesh axis (sequence-parallel attention for
    head counts that do not divide the tensor-parallel degree; the dry
    run's ``seqpar`` variant). The default, -1, takes M from the
    ``activation_sharding`` context: 0 outside one. M = 1 unless M divides
    Sq; ragged (2-D) positions keep M = 1. One body for every M, as the
    reference's: (B, M, Sq / M, H, hd), a loop over its blocks of qb rows.
    Under autograd, when there are several blocks, each is recomputed in
    backward, as the reference's ``jax.checkpoint`` of its scan body does,
    so no block's probabilities wait for the backward (one block's are
    held for its own backward either way).

    q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, hd_v);
    positions 1-D. Returns (B, Sq, H, hd_v) in v's dtype."""
    B, Sq, H, hd = q.shape
    if seq_parallel < 0:
        seq_parallel = sharding.ctx_seq_parallel()
    if q_positions.ndim != 1:
        seq_parallel = 0
    M = seq_parallel if (seq_parallel and Sq % seq_parallel == 0) else 1
    Sl = Sq // M
    qb = min(block_q, Sl)
    while Sl % qb:
        qb //= 2
    qr = q.reshape(B, M, Sl, H, hd)
    if M > 1:
        qr = constrain(qr, "batch", "model", None, None, None)
    qpos = q_positions.reshape(M, Sl)
    remat = Sl > qb and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for s0 in range(0, Sl, qb):
        args = (qr[:, :, s0:s0 + qb], k, v, qpos[:, s0:s0 + qb],
                kv_positions, causal)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False)
                    if remat else _attend_block(*args))
    out = torch.cat(outs, dim=2)  # (B, M, Sl, H, hd_v)
    return out.reshape(B, Sq, H, out.shape[-1])


def attention_forward(params, x, cfg, positions=None, causal: bool = True,
                      kv_override=None, blocked: bool = False):
    """Full-sequence attention (prefill, the encoder, cross-attention).
    Returns (out (B,S,d), (k, v)) with k after rotary embedding, as the
    cache stores it.

    kv_override: (k, v, kv_positions) for cross-attention: the keys and
    values are the override's (B, Sk, Hkv, hd), and neither q nor k gets
    rotary embedding. The kernel's causal mask is by index, the
    reference's by position: the same wherever both are aranges (every
    caller's).

    blocked: the training arm. q/k/v go through ``attend_blocked`` (torch
    ops under autograd, masked by position) instead of the flash kernel,
    which has no backward. Meta tensors (the dry run) take it too, as the
    reference's dry run lowers its ``attend_blocked``."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if kv_override is None:
        q, k, v = _project_qkv(params, x, cfg)
        cos, sin = layers.rope_angles(positions, cfg.resolved_head_dim,
                                      cfg.rope_theta)
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
        kv_positions = positions
    else:
        q = x @ params["wq"]
        if cfg.qkv_bias:
            q = q + params["bq"]
        q = constrain(q.reshape(B, S, cfg.num_heads, cfg.resolved_head_dim),
                      "batch", None, "model", None)
        k, v, kv_positions = kv_override
    if blocked or x.device.type == "meta":
        out = attend_blocked(q, k, v, positions, kv_positions, causal)
    else:
        out = ops.flash_attention(q, k, v, causal=causal)
    out = out.reshape(B, S, -1) @ params["wo"]
    return constrain(out, "batch", None, None), (k, v)


def init_cache(cfg, batch: int, max_len: int, dtype, device):
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step_attention(params, x_step, cache, cur_len: int, cfg,
                          seq_axis: Optional[str] = None):
    """One-token decode over a KV cache.

    x_step: (B, 1, d). cur_len: host int — number of tokens already in the
    cache (the new token's position). The cache is updated IN PLACE (the
    JAX package returns a new one): the new token's k/v are written at
    ``cur_len`` and the same dict is returned. Returns (out (B,1,d), cache).

    seq_axis="<mesh axis>" inside ``activation_sharding(device_mesh)``: the
    cache is this rank's shard of the positions (S_local of them, from
    coordinate × S_local on that axis); each rank attends over its shard and
    the shards' partials combine over the axis's process group
    (``sharding.combine_partials``). Otherwise (no context, or one without a
    real ``DeviceMesh``) the cache is whole, as the reference's plain path.
    """
    B = x_step.shape[0]
    hd = cfg.resolved_head_dim
    q, k_new, v_new = _project_qkv(params, x_step, cfg)  # (B,1,H,hd)
    pos = torch.full((1,), cur_len, dtype=torch.int32, device=x_step.device)
    cos, sin = layers.rope_angles(pos, hd, cfg.rope_theta)
    q = layers.apply_rope(q, cos, sin)
    k_new = layers.apply_rope(k_new, cos, sin)
    out = _cached_attention_core(q, k_new, v_new, cache, cur_len,
                                 sharding.seq_shards(seq_axis))
    return out.reshape(B, 1, cfg.num_heads * hd) @ params["wo"], cache


def _cached_attention_core(q, k_new, v_new, cache, cur_len: int,
                           shards: Optional[sharding.SeqShards] = None):
    """Write the new token's k/v at ``cur_len`` (no write past the cache,
    as the JAX package's clipped, masked write), then attend over
    positions <= cur_len. Returns (B, H, hd) in q's dtype.

    With ``shards`` the cache holds positions [shard0, shard0 + S_local):
    only the owning rank writes, each rank's partial (its output and
    log-sum-exp, from B4 on the card) combines with the others'; a shard
    wholly past ``cur_len`` contributes nothing and launches nothing."""
    if shards is not None:  # DTensors (the dry run) to their local shards
        return sharding.on_local_shards(
            lambda q, kn, vn, c: _cached_local_core(q, kn, vn, c, cur_len,
                                                    shards),
            (q, k_new, v_new), cache, shards)
    return _cached_local_core(q, k_new, v_new, cache, cur_len, None)


def _cached_local_core(q, k_new, v_new, cache, cur_len: int, shards):
    """``_cached_attention_core`` on plain tensors: the whole cache, or
    this rank's shard of it."""
    S_local = cache["k"].shape[1]
    shard0 = 0 if shards is None else shards.coord * S_local
    local = cur_len - shard0
    if 0 <= local < S_local:
        cache["k"][:, local] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, local] = v_new[:, 0].to(cache["v"].dtype)
    if shards is None:
        return ops.decode_attention(q[:, 0], cache["k"], cache["v"], cur_len)
    B, _, H, hd = q.shape
    if local < 0:
        o = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
        lse = torch.full((B, H), float("-inf"), device=q.device)
        l_sum = torch.zeros((B, H), device=q.device)
    else:
        o, lse = ops.decode_attention(q[:, 0], cache["k"], cache["v"], local,
                                      return_lse=True)  # o in float32
        if shards.size == 1:
            return o.to(q.dtype)
        l_sum = torch.ones_like(lse)
    return sharding.combine_partials(lse, l_sum, o, shards).to(q.dtype)
