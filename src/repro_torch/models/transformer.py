"""Decoder-only LM assembly for every non-encdec architecture (the JAX
package's ``models/transformer.py``): attention blocks (the dense GQA
family and the DeepSeek family — GQA or MLA attention, a dense swiglu/geglu
MLP or a fine-grained MoE, and deepseek-v3's multi-token-prediction (MTP)
block), the mamba/attention hybrid (jamba: ``attn_every`` layers a group,
attention at position ``attn_every // 2``, the MoE every ``moe_every``-th
layer and a dense swiglu between) and xLSTM (``xlstm_pattern``'s mLSTM and
sLSTM blocks a group).

The JAX package stacks its layers (or groups) on a leading axis and scans
them; here the stack is a Python loop over lists. Under
``block_kind="attn"`` ``params["blocks"]`` is a list of per-layer dicts and
the caches a list of per-layer ``{"k", "v"}`` (GQA) or ``{"ckv", "kr"}``
(MLA). Under ``"mamba_attn"`` and ``"xlstm"`` both are lists of per-group
dicts keyed ``l0`` … ``l{g-1}``, as the reference's groups: a mamba layer's
cache is ``{"h", "conv"}``, an mLSTM's ``{"C", "n", "m", "conv"}``, an
sLSTM's ``{"h", "c", "n", "m"}``. The MTP subtree (``params["mtp"]``:
``proj``, ``block``, ``norm``) is made as the reference makes it; serving
never reads it (it trains with the MTP loss).

API:
  init_lm_params(cfg, seed, device)                -> params
  forward_train(params, cfg, tokens, frontend=None)-> (logits, aux_loss, hidden)
  lm_loss(params, cfg, batch)                      -> (loss, metrics)
  prefill(params, cfg, tokens, frontend=None)      -> (logits_last, caches)
  init_decode_caches(cfg, batch, max_len, dtype, device) -> caches
  decode_step(params, cfg, token, caches, cur_len) -> (logits, caches)

Training runs under autograd over the same parameter tree: attention
through ``attend_blocked`` (``attention_forward(..., blocked=True)``; the
kernels have no backward), each layer (attention blocks) or group (hybrid,
xLSTM) recomputed in backward by ``torch.utils.checkpoint`` where the
reference's ``jax.checkpoint`` of its scan body recomputes it, and the vocab
head in sequence chunks (``chunked_xent``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention, layers, mamba, mla, moe, xlstm

# the parameter types the attention kernels take
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
AUX_WEIGHT = 0.01  # the MoE load-balancing loss's weight in lm_loss
MTP_WEIGHT = 0.3  # the multi-token-prediction loss's weight
XENT_CHUNK = 512  # chunked_xent's sequence chunk, halved until it divides S


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
    bk = cfg.block_kind
    if bk == "attn":
        return ["attn"]
    if bk == "mamba_attn":
        g = cfg.attn_every
        return ["attn" if i == g // 2 else "mamba" for i in range(g)]
    if bk == "xlstm":
        return list(cfg.xlstm_pattern)
    raise ValueError(bk)


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


def _init_mamba_layer(gen: torch.Generator, cfg, dtype, use_moe: bool):
    dev = gen.device
    p = {"ln1": layers.init_rms_norm(cfg.d_model, dtype, dev),
         "ln2": layers.init_rms_norm(cfg.d_model, dtype, dev),
         "mamba": mamba.init_mamba(gen, cfg, dtype)}
    if use_moe:
        p["mlp"] = moe.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = layers.init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


_XLSTM_INIT = {"mlstm": xlstm.init_mlstm, "slstm": xlstm.init_slstm}


def _init_layer(gen: torch.Generator, cfg, dtype, kind: str, i: int):
    if kind == "attn":
        return _init_attn_layer(gen, cfg, dtype, _uses_moe(cfg, i))
    if kind == "mamba":
        return _init_mamba_layer(gen, cfg, dtype, _uses_moe(cfg, i))
    return _XLSTM_INIT[kind](gen, cfg, dtype)


def init_group(gen: torch.Generator, cfg, dtype):
    """One group's layers, keyed ``l0`` … ``l{g-1}``."""
    return {f"l{i}": _init_layer(gen, cfg, dtype, kind, i)
            for i, kind in enumerate(group_layer_kinds(cfg))}


def init_lm_params(cfg, seed: int = 0, device="cuda"):
    """Random parameters from ``seed``, made one tensor at a time on
    ``device`` (the JAX package's distributions, not its bits)."""
    dev = resolve_device(device)
    return build_lm_params(cfg, torch.Generator(device=dev).manual_seed(seed))


def build_lm_params(cfg, gen: torch.Generator):
    """The parameter tree drawn from ``gen``, on ``gen.device``."""
    group_layer_kinds(cfg)  # ValueError for a block kind with no stack
    dev = gen.device
    dtype = DTYPES[cfg.dtype]
    vp = lm_head_vocab(cfg)
    params = {"embed": layers.embed_init(gen, vp, cfg.d_model, dtype)}
    groups = [init_group(gen, cfg, dtype) for _ in range(num_groups(cfg))]
    # attention blocks keep their per-layer layout (a group is one layer)
    params["blocks"] = ([g["l0"] for g in groups]
                        if cfg.block_kind == "attn" else groups)
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
        x = x * scale.to(x.dtype)  # a 0-d CPU tensor: a scalar to CUDA ops
    if frontend is not None and cfg.frontend_tokens > 0:
        F_ = frontend.shape[1]
        spliced = x.clone()
        spliced[:, :F_] = frontend.to(x.dtype)
        x = spliced
    return constrain(x, "batch", None, None)


def lm_logits(params, cfg, x):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return layers.mask_padded_logits(logits.float(), cfg.vocab_size)


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _mlp_apply(p, x, cfg, use_moe: bool):
    """x: (B, S, d) -> (out, aux): the MoE's load-balancing loss (a float32
    0-d tensor), 0.0 for a dense MLP. Serving drops it."""
    if cfg.mlp_kind == "none":
        return torch.zeros_like(x), 0.0
    if use_moe:
        B, S, d = x.shape
        y, aux = moe.moe_forward(p["mlp"], x.reshape(B * S, d), cfg)
        return y.reshape(B, S, d), aux
    # non-MoE layers of a moe_every>1 arch use a dense swiglu
    kind = cfg.mlp_kind if cfg.mlp_kind != "moe" else "swiglu"
    return layers.gated_mlp(p["mlp"], x, kind), 0.0


def _with_mlp(p, x, a, cfg, use_moe: bool):
    """x + a, then the layer's MLP (or MoE) on its ln2 norm, added.
    Returns (x, aux)."""
    x = x + a
    y, aux = _mlp_apply(p, layers.rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                        use_moe)
    return x + y, aux


# ---------------------------------------------------------------------------
# train forward / loss
# ---------------------------------------------------------------------------


def _attn_layer_train(p, x, cfg, positions, use_moe: bool):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a, _ = mla.mla_forward(p["attn"], h, cfg, positions)
    else:
        a, _ = attention.attention_forward(p["attn"], h, cfg, positions,
                                           blocked=True)
    return _with_mlp(p, x, a, cfg, use_moe)


def _mamba_layer_train(p, x, cfg, use_moe: bool):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    return _with_mlp(p, x, mamba.mamba_forward(p["mamba"], h, cfg), cfg,
                     use_moe)


_XLSTM_TRAIN = {"mlstm": xlstm.mlstm_forward, "slstm": xlstm.slstm_forward}


def group_train(p_group, x, cfg, positions):
    """One layer (``block_kind="attn"``: ``p_group`` is the layer's dict) or
    one group of layers. Returns (x, aux_loss)."""
    if cfg.block_kind == "attn":
        return _attn_layer_train(p_group, x, cfg, positions,
                                 _uses_moe(cfg, 0))
    aux = _zero(x)
    for i, kind in enumerate(group_layer_kinds(cfg)):
        p = p_group[f"l{i}"]
        if kind == "attn":
            x, a = _attn_layer_train(p, x, cfg, positions, _uses_moe(cfg, i))
        elif kind == "mamba":
            x, a = _mamba_layer_train(p, x, cfg, _uses_moe(cfg, i))
        else:
            x, a = _XLSTM_TRAIN[kind](p, x, cfg), 0.0
        aux = aux + a
    return x, aux


def backbone(params, cfg, x, positions):
    """The stack of layers or groups. x: (B,S,d) -> (x, aux_loss). Under
    autograd each layer or group keeps only its input and is recomputed in
    backward."""
    remat = torch.is_grad_enabled()
    aux = _zero(x)
    for p in params["blocks"]:
        if remat:
            x, a = checkpoint(group_train, p, x, cfg, positions,
                              use_reentrant=False)
        else:
            x, a = group_train(p, x, cfg, positions)
        x = constrain(x, "batch", None, None)
        aux = aux + a
    return x, aux


def forward_train(params, cfg, tokens, frontend=None):
    """Returns (logits (B,S,V) float32, aux_loss, the pre-norm hidden
    state for MTP)."""
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, frontend)
    x, aux = backbone(params, cfg, x, positions)
    return lm_logits(params, cfg, x), aux, x


def _xent(logits, labels, mask):
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def head_weight(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _xent_chunk(xc, W, lc, mc, vocab_size: int):
    """One sequence chunk's (Σ nll, Σ mask): (B,c,d) hidden, (B,c) labels
    and mask."""
    # padded-vocab ids never win: masked to finfo.min
    logits = layers.mask_padded_logits(
        constrain((xc @ W).float(), "batch", None, "model"), vocab_size)
    lse = torch.logsumexp(logits, dim=-1)  # (B,c)
    # the reference's one-hot einsum: every other term is 0 · finite. The
    # label's (B,c,1) dim goes after the subtraction: over vocab-sharded
    # logits (the dry run) the gather's pending mask has that shape
    lab = logits.gather(-1, lc[..., None])
    return torch.sum((lse[..., None] - lab)[..., 0] * mc), torch.sum(mc)


def chunked_xent(params, cfg, hidden, labels, mask):
    """Cross-entropy over the vocab head without the full (B, S, V) float32
    logits: the sequence in chunks of ``XENT_CHUNK`` (halved until it
    divides S, the reference's rule), each chunk's logits recomputed in
    backward. Returns (sum_nll, sum_mask)."""
    x = layers.rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    W = head_weight(params, cfg)
    S = x.shape[1]
    c = min(XENT_CHUNK, S)
    while S % c:
        c //= 2
    remat = torch.is_grad_enabled()
    labels = labels.long()
    s_nll, s_m = _zero(x), _zero(x)
    for s0 in range(0, S, c):
        args = (x[:, s0:s0 + c], W, labels[:, s0:s0 + c],
                mask[:, s0:s0 + c], cfg.vocab_size)
        nll, m = (checkpoint(_xent_chunk, *args, use_reentrant=False)
                  if remat else _xent_chunk(*args))
        s_nll, s_m = s_nll + nll, s_m + m
    return s_nll, s_m


def _shift(t):
    """t[:, 1:] with a zero column appended (the MTP's labels, t + 2)."""
    return torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], dim=1)


def lm_loss(params, cfg, batch):
    """batch: {"tokens": (B,S), "labels": (B,S), ["frontend"]: (B,F,d)};
    labels < 0 are masked out. Returns (loss, metrics {"xent", "aux",
    ["mtp"], "loss"}), each a float32 0-d tensor."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = embed_tokens(params, cfg, tokens, batch.get("frontend"))
    hidden, aux = backbone(params, cfg, x, positions)
    s_nll, s_m = chunked_xent(params, cfg, hidden, labels, mask)
    loss = s_nll / torch.clamp(s_m, min=1.0)
    metrics = {"xent": loss, "aux": aux}
    if cfg.mtp_depth > 0 and "mtp" in params:
        # MTP depth 1: predict t+2 from (hidden_t, embed(label_t))
        emb = params["embed"]
        emb_next = emb[labels.clamp(max=emb.shape[0] - 1).long()]
        h = torch.cat([hidden.to(emb_next.dtype), emb_next], dim=-1)
        h = constrain(h @ params["mtp"]["proj"], "batch", None, None)
        h, _ = _attn_layer_train(params["mtp"]["block"], h, cfg, positions,
                                 _uses_moe(cfg, 0))
        h = layers.rms_norm(h, params["mtp"]["norm"], cfg.norm_eps)
        m_nll, m_m = chunked_xent(params, cfg, h, _shift(labels),
                                  _shift(mask))
        mtp_loss = m_nll / torch.clamp(m_m, min=1.0)
        metrics["mtp"] = mtp_loss
        loss = loss + MTP_WEIGHT * mtp_loss
    loss = loss + AUX_WEIGHT * aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def _init_layer_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                      device):
    if kind == "attn":
        if cfg.attn_kind == "mla":
            return mla.init_mla_cache(cfg, batch, max_len, dtype, device)
        return attention.init_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba":
        return mamba.init_mamba_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xlstm.init_mlstm_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        return xlstm.init_slstm_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_decode_caches(cfg, batch: int, max_len: int, dtype, device):
    return build_decode_caches(cfg, batch, max_len, dtype,
                               resolve_device(device))


def build_decode_caches(cfg, batch: int, max_len: int, dtype,
                        dev: torch.device):
    """``init_decode_caches`` on a ``torch.device`` as it is (``meta`` for
    the dry run's stand-ins)."""
    kinds = group_layer_kinds(cfg)
    if cfg.block_kind == "attn":
        return [_init_layer_cache(cfg, "attn", batch, max_len, dtype, dev)
                for _ in range(num_groups(cfg))]
    return [{f"l{i}": _init_layer_cache(cfg, k, batch, max_len, dtype, dev)
             for i, k in enumerate(kinds)} for _ in range(num_groups(cfg))]


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------


def _attn_layer_decode(p, x, cache, cur_len: int, cfg, use_moe: bool,
                       seq_axis):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a, cache = mla.mla_decode_step(p["attn"], h, cache, cur_len, cfg,
                                       seq_axis)
    else:
        a, cache = attention.decode_step_attention(p["attn"], h, cache,
                                                   cur_len, cfg, seq_axis)
    return _with_mlp(p, x, a, cfg, use_moe)[0], cache


def _layer_decode(p, x, cache, cur_len: int, cfg, kind: str, i: int,
                  seq_axis):
    """One layer of a group at decode. Returns (x, the layer's cache)."""
    if kind == "attn":
        return _attn_layer_decode(p, x, cache, cur_len, cfg,
                                  _uses_moe(cfg, i), seq_axis)
    if kind == "mamba":
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, cache = mamba.mamba_decode_step(p["mamba"], h, cache, cfg)
        return _with_mlp(p, x, a, cfg, _uses_moe(cfg, i))[0], cache
    if kind == "mlstm":
        return xlstm.mlstm_decode_step(p, x, cache, cfg)
    return xlstm.slstm_decode_step(p, x, cache, cfg)


def group_decode(p_group, x, caches, cur_len: int, cfg, seq_axis=None):
    """One group at decode; the group's cache dict gets each layer's new
    cache in place. Returns (x, caches)."""
    for i, kind in enumerate(group_layer_kinds(cfg)):
        x, caches[f"l{i}"] = _layer_decode(p_group[f"l{i}"], x,
                                           caches[f"l{i}"], cur_len, cfg,
                                           kind, i, seq_axis)
    return x, caches


def decode_step(params, cfg, token, caches, cur_len: int, seq_axis=None):
    """token: (B,1) int; cur_len: host int (tokens already cached).
    Returns (logits (B,1,V) float32, caches), the caches updated in place
    (attention caches written at ``cur_len``; recurrent states replaced in
    their group's dict)."""
    x = embed_tokens(params, cfg, token)
    for p, cache in zip(params["blocks"], caches):
        if cfg.block_kind == "attn":
            x, _ = _attn_layer_decode(p, x, cache, cur_len, cfg,
                                      _uses_moe(cfg, 0), seq_axis)
        else:
            x, _ = group_decode(p, x, cache, cur_len, cfg, seq_axis)
    return lm_logits(params, cfg, x), caches


# ---------------------------------------------------------------------------
# prefill (returns populated caches for handoff to the decode pool)
# ---------------------------------------------------------------------------


def _attn_layer_prefill(p, x, cfg, positions, use_moe: bool):
    """One layer over the prompt. Returns (x, the layer's cache)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a, kv = mla.mla_forward(p["attn"], h, cfg, positions)
    else:
        a, (k, v) = attention.attention_forward(p["attn"], h, cfg, positions)
        kv = {"k": k, "v": v}
    return _with_mlp(p, x, a, cfg, use_moe)[0], kv


def _layer_prefill(p, x, cfg, positions, kind: str, i: int):
    """One layer of a group over the prompt. Returns (x, the layer's
    cache: k/v, or the recurrent end state and conv tail)."""
    if kind == "attn":
        return _attn_layer_prefill(p, x, cfg, positions, _uses_moe(cfg, i))
    if kind == "mamba":
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, cache = mamba.mamba_block(p["mamba"], h, cfg)
        return _with_mlp(p, x, a, cfg, _uses_moe(cfg, i))[0], cache
    if kind == "mlstm":
        return xlstm.mlstm_block(p, x, cfg)
    return xlstm.slstm_block(p, x, cfg)


def prefill(params, cfg, tokens, frontend=None):
    """Run the full prompt; returns (last-token logits (B,1,V) float32,
    caches sized S), which match ``init_decode_caches(cfg, B, S, ...)`` for
    the decode side: attention layers store their k/v (ckv/kr under MLA),
    recurrent layers their end-of-prompt state."""
    kinds = group_layer_kinds(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, frontend)
    caches = []
    for p in params["blocks"]:
        if cfg.block_kind == "attn":
            x, kv = _attn_layer_prefill(p, x, cfg, positions,
                                        _uses_moe(cfg, 0))
            caches.append(kv)
            continue
        group = {}
        for i, kind in enumerate(kinds):
            x, group[f"l{i}"] = _layer_prefill(p[f"l{i}"], x, cfg, positions,
                                               kind, i)
        caches.append(group)
    return lm_logits(params, cfg, x[:, -1:, :]), caches
