"""Decoder-only LM assembly for the dense GQA family (the JAX package's
``models/transformer.py`` for ``block_kind="attn"``, ``attn_kind="gqa"``
and a dense swiglu/geglu MLP).

The JAX package stacks its layers on a leading axis and scans them; here
``params["blocks"]`` is a list of per-layer dicts and the stack is a Python
loop. Caches are a list of per-layer ``{"k", "v"}`` dicts.

API:
  init_lm_params(cfg, seed, device)                -> params
  prefill(params, cfg, tokens, frontend=None)      -> (logits_last, caches)
  init_decode_caches(cfg, batch, max_len, dtype, device) -> caches
  decode_step(params, cfg, token, caches, cur_len) -> (logits, caches)

MoE, MLA, the mamba and xLSTM blocks and MTP raise ``NotImplementedError``
(ROADMAP Queue A item 12); the training functions (``forward_train``,
``lm_loss``, ``chunked_xent``) come with the training slice (item 13).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers

# the parameter types the attention kernels take
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a config outside the dense GQA family."""
    unported = []
    if cfg.block_kind != "attn":
        unported.append(f"block_kind={cfg.block_kind!r}")
    if cfg.attn_kind != "gqa":
        unported.append(f"attn_kind={cfg.attn_kind!r}")
    if cfg.mlp_kind not in ("swiglu", "geglu"):
        unported.append(f"mlp_kind={cfg.mlp_kind!r}")
    if cfg.mtp_depth:
        unported.append(f"mtp_depth={cfg.mtp_depth}")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} is not ported yet (the port "
            "runs dense GQA blocks with a swiglu/geglu MLP): ROADMAP Queue A "
            "item 12 ports the other model families")


def lm_head_vocab(cfg) -> int:
    v = cfg.vocab_size
    return v if v % 2048 == 0 else layers.padded_vocab(v)


def init_lm_params(cfg, seed: int = 0, device="cuda"):
    """Random parameters from ``seed``, made one tensor at a time on
    ``device`` (the JAX package's distributions, not its bits)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    vp = lm_head_vocab(cfg)
    params = {"embed": layers.embed_init(gen, vp, cfg.d_model, dtype)}
    params["blocks"] = [{
        "ln1": layers.init_rms_norm(cfg.d_model, dtype, dev),
        "ln2": layers.init_rms_norm(cfg.d_model, dtype, dev),
        "attn": attention.init_attention(gen, cfg, dtype),
        "mlp": layers.init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    } for _ in range(cfg.num_layers)]
    params["final_norm"] = layers.init_rms_norm(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model, vp, dtype)
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


def _mlp(p, x, cfg):
    return layers.gated_mlp(p["mlp"], x, cfg.mlp_kind)


def init_decode_caches(cfg, batch: int, max_len: int, dtype, device):
    check_supported(cfg)
    dev = resolve_device(device)
    return [attention.init_cache(cfg, batch, max_len, dtype, dev)
            for _ in range(cfg.num_layers)]


def decode_step(params, cfg, token, caches, cur_len: int, seq_axis=None):
    """token: (B,1) int; cur_len: host int (tokens already cached).
    Returns (logits (B,1,V) float32, caches), the caches updated in place."""
    x = embed_tokens(params, cfg, token)
    for p, cache in zip(params["blocks"], caches):
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = attention.decode_step_attention(p["attn"], h, cache, cur_len,
                                               cfg, seq_axis)
        x = x + a
        x = x + _mlp(p, layers.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return lm_logits(params, cfg, x), caches


def prefill(params, cfg, tokens, frontend=None):
    """Run the full prompt; returns (last-token logits (B,1,V) float32,
    caches sized S: a list of per-layer {"k", "v"}), which match
    ``init_decode_caches(cfg, B, S, ...)`` for the decode side."""
    check_supported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, frontend)
    caches = []
    for p in params["blocks"]:
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, (k, v) = attention.attention_forward(p["attn"], h, cfg, positions)
        x = x + a
        x = x + _mlp(p, layers.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
        caches.append({"k": k, "v": v})
    return lm_logits(params, cfg, x[:, -1:, :]), caches
