"""Architecture dispatch: init / loss / prefill / decode per family,
analytic parameter counts and MODEL_FLOPS (the JAX package's
``models/model_zoo.py``).

Every family of the JAX package is served and trained: decoder-only stacks
(``transformer``: attention blocks, the mamba/attention hybrid, xLSTM) and
the encoder-decoder (``encdec``). ``input_specs`` and ``param_specs`` make
meta tensors, the dry run's stand-ins for the reference's
``jax.ShapeDtypeStruct``s: shapes and dtypes, nothing allocated or drawn.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, mamba, transformer


def is_encdec(cfg) -> bool:
    return cfg.block_kind == "encdec"


def init_params(cfg, seed: int = 0, device="cuda"):
    if is_encdec(cfg):
        return encdec.init_encdec_params(cfg, seed, device)
    return transformer.init_lm_params(cfg, seed, device)


def loss_fn(cfg, params, batch):
    """(loss, metrics) under autograd. batch: {"tokens", "labels"} (B,S)
    int, ["frontend"] (B,F,d); under encdec {"frames" (B,S,d), "tokens",
    "labels"}."""
    if is_encdec(cfg):
        return encdec.encdec_loss(params, cfg, batch)
    return transformer.lm_loss(params, cfg, batch)


def prefill_fn(cfg, params, batch):
    """batch: {"tokens": (B,S) int, ["frontend"]: (B,F,d)}; under encdec
    {"frames": (B,S,d), "tokens": (B,S) int}."""
    if is_encdec(cfg):
        return encdec.encdec_prefill(params, cfg, batch["frames"],
                                     batch["tokens"])
    return transformer.prefill(params, cfg, batch["tokens"],
                               batch.get("frontend"))


def decode_fn(cfg, params, token, caches, cur_len: int, seq_axis=None):
    if is_encdec(cfg):
        return encdec.encdec_decode_step(params, cfg, token, caches, cur_len,
                                         seq_axis)
    return transformer.decode_step(params, cfg, token, caches, cur_len,
                                   seq_axis)


def init_decode_caches(cfg, batch: int, max_len: int, device="cuda"):
    """Zeroed decode caches; under encdec the cross ``ck``/``cv`` are
    ``max_len`` long, as the reference makes them."""
    dtype = transformer.DTYPES[cfg.dtype]
    dev = resolve_device(device)
    if is_encdec(cfg):
        return encdec.init_encdec_caches(cfg, batch, max_len, max_len, dtype,
                                         dev)
    return transformer.init_decode_caches(cfg, batch, max_len, dtype, dev)


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

META = torch.device("meta")


class _NoDraw(torch.Generator):
    """A generator whose every tensor is made on ``meta``: the init code's
    shapes and dtypes, with no bits drawn."""

    @property
    def device(self):
        return META


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg, shape):
    """Meta stand-ins for a cell's inputs, of the reference's shapes and
    dtypes (its ``ShapeDtypeStruct``s); decode caches in the port's
    per-layer layout."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f = transformer.DTYPES[cfg.dtype]

    if shape.kind in ("train", "prefill"):
        if is_encdec(cfg):
            batch = {"frames": _meta((B, S, cfg.d_model), f),
                     "tokens": _meta((B, S), i32)}
        else:
            batch = {"tokens": _meta((B, S), i32)}
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), i32)
        if not is_encdec(cfg) and cfg.frontend_tokens > 0:
            batch["frontend"] = _meta((B, cfg.frontend_tokens, cfg.d_model),
                                      f)
        return batch

    if shape.kind == "decode":
        if is_encdec(cfg):
            caches = encdec.build_encdec_caches(cfg, B, S, S, f, META)
        else:
            caches = transformer.build_decode_caches(cfg, B, S, f, META)
        return {"token": _meta((B, 1), i32), "caches": caches,
                "cur_len": _meta((), i32)}
    raise ValueError(shape.kind)


def param_specs(cfg):
    """The parameter tree as meta tensors (the port's per-layer layout),
    without allocating or drawing them."""
    if is_encdec(cfg):
        return encdec.build_encdec_params(cfg, _NoDraw())
    return transformer.build_lm_params(cfg, _NoDraw())


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


def _mamba_params(cfg) -> int:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    dtr = mamba.dt_rank_for(d)
    return (d * 2 * di + cfg.mamba_d_conv * di + di * (dtr + 2 * ds)
            + dtr * di + di * ds + di + di * d)


def _mlstm_params(cfg) -> int:
    d = cfg.d_model
    di = 2 * d
    return d * 2 * di + 4 * di + 3 * di * di + di * 2 * cfg.num_heads + di * d


def _slstm_params(cfg) -> int:
    d = cfg.d_model
    return d * 4 * d + 4 * d * (d // cfg.num_heads) + d * (4 * d) // 3 * 2


def analytic_param_count(cfg, active_only: bool = False) -> int:
    """The JAX package's count (embedding, untied head, each layer's mixer
    and MLP or MoE, the MTP block; biases, norms and the mLSTM/mamba conv
    biases are not counted). ``active_only`` counts the top-k routed
    experts of each MoE (the router and shared experts always)."""
    vp = transformer.lm_head_vocab(cfg)
    total = vp * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.d_model * vp  # head

    if cfg.block_kind == "xlstm":
        per_group = sum(_mlstm_params(cfg) if k == "mlstm" else _slstm_params(cfg)
                        for k in cfg.xlstm_pattern)
        return total + per_group * (cfg.num_layers // len(cfg.xlstm_pattern))

    if cfg.block_kind == "encdec":
        n_dec = cfg.num_layers - cfg.encoder_layers
        enc = cfg.encoder_layers * (_attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff)
        dec = n_dec * (2 * _attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff)
        return total + enc + dec

    # attn / mamba_attn stacks
    g = transformer.group_size(cfg)
    kinds = transformer.group_layer_kinds(cfg)
    per_group = 0
    for i, kind in enumerate(kinds):
        mixer = _attn_params(cfg) if kind == "attn" else _mamba_params(cfg)
        if cfg.mlp_kind == "moe" and (i % cfg.moe_every == 0):
            ffn = _moe_params(cfg, active_only)
        elif cfg.mlp_kind == "none":
            ffn = 0
        else:
            ffn = 3 * cfg.d_model * cfg.d_ff
        per_group += mixer + ffn
    total += per_group * (cfg.num_layers // g)
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
