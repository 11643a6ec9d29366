"""Decoder-only LM assembly for ``block_kind="attn"`` (the JAX package's
``models/transformer.py``): the dense GQA family and the DeepSeek family —
GQA or MLA attention, a dense swiglu/geglu MLP or a fine-grained MoE, and
deepseek-v3's multi-token-prediction (MTP) block.

The JAX package stacks its layers on a leading axis and scans them; here
``params["blocks"]`` is a list of per-layer dicts and the stack is a Python
loop. Caches are a list of per-layer dicts: ``{"k", "v"}`` for GQA,
``{"ckv", "kr"}`` for MLA. The MTP subtree (``params["mtp"]``: ``proj``,
``block``, ``norm``) is made as the reference makes it; serving never reads
it (it trains with the MTP loss).

API:
  init_lm_params(cfg, seed, device)                -> params
  prefill(params, cfg, tokens, frontend=None)      -> (logits_last, caches)
  init_decode_caches(cfg, batch, max_len, dtype, device) -> caches
  decode_step(params, cfg, token, caches, cur_len) -> (logits, caches)

The mamba/attention hybrid, xLSTM and encoder-decoder blocks raise
``NotImplementedError`` (ROADMAP Queue A item 12); the training functions
(``forward_train``, ``lm_loss``, ``chunked_xent``) come with the training
slice (item 13).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mla, moe

# the parameter types the attention kernels take
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a block kind the port does not run."""
    if cfg.block_kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: block_kind={cfg.block_kind!r} is not ported yet "
            "(the port runs attention blocks: GQA or MLA, dense or MoE): "
            "ROADMAP Queue A item 12 ports the other model families")


def _uses_moe(cfg, layer_idx_in_group: int) -> bool:
    return cfg.mlp_kind == "moe" and (layer_idx_in_group % cfg.moe_every == 0)


def group_size(cfg) -> int:
    if cfg.block_kind == "mamba_attn":
        return cfg.attn_every
    if cfg.block_kind == "xlstm":
        return len(cfg.xlstm_pattern)
    return 1


def num_groups(cfg) -> int:
    g = group_size(cfg)
    assert cfg.num_layers % g == 0, (cfg.num_layers, g)
    return cfg.num_layers // g


def group_layer_kinds(cfg):
    check_supported(cfg)
    return ["attn"]


def lm_head_vocab(cfg) -> int:
    v = cfg.vocab_size
    return v if v % 2048 == 0 else layers.padded_vocab(v)


def _init_attn_layer(gen: torch.Generator, cfg, dtype, use_moe: bool):
    dev = gen.device
    p = {"ln1": layers.init_rms_norm(cfg.d_model, dtype, dev),
         "ln2": layers.init_rms_norm(cfg.d_model, dtype, dev)}
    if cfg.attn_kind == "mla":
        p["attn"] = mla.init_mla(gen, cfg, dtype)
    else:
        p["attn"] = attention.init_attention(gen, cfg, dtype)
    if use_moe:
        p["mlp"] = moe.init_moe(gen, cfg, dtype)
    elif cfg.mlp_kind != "none":
        p["mlp"] = layers.init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_lm_params(cfg, seed: int = 0, device="cuda"):
    """Random parameters from ``seed``, made one tensor at a time on
    ``device`` (the JAX package's distributions, not its bits)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    vp = lm_head_vocab(cfg)
    params = {"embed": layers.embed_init(gen, vp, cfg.d_model, dtype)}
    params["blocks"] = [_init_attn_layer(gen, cfg, dtype, _uses_moe(cfg, 0))
                        for _ in range(num_groups(cfg))]
    params["final_norm"] = layers.init_rms_norm(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model, vp, dtype)
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "proj": layers.dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype),
            "block": _init_attn_layer(gen, cfg, dtype, _uses_moe(cfg, 0)),
            "norm": layers.init_rms_norm(cfg.d_model, dtype, dev),
        }
    return params


def embed_tokens(params, cfg, tokens, frontend: Optional[torch.Tensor] = None):
    x = params["embed"][tokens.long()]  # (B,S,d)
    if cfg.name.startswith("gemma"):
        scale = torch.tensor(float(cfg.d_model), dtype=torch.float32).sqrt()
        x = x * scale.to(x.dtype).to(x.device)
    if frontend is not None and cfg.frontend_tokens > 0:
        F_ = frontend.shape[1]
        spliced = x.clone()
        spliced[:, :F_] = frontend.to(x.dtype)
        x = spliced
    return x


def lm_logits(params, cfg, x):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return layers.mask_padded_logits(logits.float(), cfg.vocab_size)


def _mlp_apply(p, x, cfg, use_moe: bool):
    """x: (B, S, d) -> out. (The MoE's aux loss is for training, item 13.)"""
    if cfg.mlp_kind == "none":
        return torch.zeros_like(x)
    if use_moe:
        B, S, d = x.shape
        return moe.moe_forward(p["mlp"], x.reshape(B * S, d), cfg)[0].reshape(
            B, S, d)
    # non-MoE layers of a moe_every>1 arch use a dense swiglu
    kind = cfg.mlp_kind if cfg.mlp_kind != "moe" else "swiglu"
    return layers.gated_mlp(p["mlp"], x, kind)


def _init_layer_cache(cfg, batch: int, max_len: int, dtype, device):
    if cfg.attn_kind == "mla":
        return mla.init_mla_cache(cfg, batch, max_len, dtype, device)
    return attention.init_cache(cfg, batch, max_len, dtype, device)


def init_decode_caches(cfg, batch: int, max_len: int, dtype, device):
    check_supported(cfg)
    dev = resolve_device(device)
    return [_init_layer_cache(cfg, batch, max_len, dtype, dev)
            for _ in range(num_groups(cfg))]


def _attn_layer_decode(p, x, cache, cur_len: int, cfg, use_moe: bool,
                       seq_axis):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a, cache = mla.mla_decode_step(p["attn"], h, cache, cur_len, cfg,
                                       seq_axis)
    else:
        a, cache = attention.decode_step_attention(p["attn"], h, cache,
                                                   cur_len, cfg, seq_axis)
    x = x + a
    return x + _mlp_apply(p, layers.rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                          use_moe), cache


def decode_step(params, cfg, token, caches, cur_len: int, seq_axis=None):
    """token: (B,1) int; cur_len: host int (tokens already cached).
    Returns (logits (B,1,V) float32, caches), the caches updated in place."""
    x = embed_tokens(params, cfg, token)
    for p, cache in zip(params["blocks"], caches):
        x, _ = _attn_layer_decode(p, x, cache, cur_len, cfg,
                                  _uses_moe(cfg, 0), seq_axis)
    return lm_logits(params, cfg, x), caches


def _attn_layer_prefill(p, x, cfg, positions, use_moe: bool):
    """One layer over the prompt. Returns (x, the layer's cache)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a, kv = mla.mla_forward(p["attn"], h, cfg, positions)
    else:
        a, (k, v) = attention.attention_forward(p["attn"], h, cfg, positions)
        kv = {"k": k, "v": v}
    x = x + a
    return x + _mlp_apply(p, layers.rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                          use_moe), kv


def prefill(params, cfg, tokens, frontend=None):
    """Run the full prompt; returns (last-token logits (B,1,V) float32,
    caches sized S: a list of per-layer {"k", "v"} or {"ckv", "kr"}), which
    match ``init_decode_caches(cfg, B, S, ...)`` for the decode side."""
    check_supported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, frontend)
    caches = []
    for p in params["blocks"]:
        x, kv = _attn_layer_prefill(p, x, cfg, positions, _uses_moe(cfg, 0))
        caches.append(kv)
    return lm_logits(params, cfg, x[:, -1:, :]), caches
