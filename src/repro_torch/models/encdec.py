"""Encoder–decoder transformer (the seamless-m4t backbone) — the JAX
package's ``models/encdec.py``.

The audio frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (B, S_enc, d_model). Decoder = causal
self-attention (cached at decode) + cross-attention over the encoder
output + gated MLP. ``params["encoder"]`` and ``params["decoder"]`` are
lists of per-layer dicts (the reference stacks them on a layer axis and
scans), and the caches a list of per-decoder-layer ``{"k", "v", "ck",
"cv"}``.

On the card the encoder's self-attention, the decoder's causal
self-attention and the cross-attention (non-causal, Sq ≠ Sk) run the
flash-attention kernel, and the decode step's self-attention the
decode-attention kernel. The decode step's cross-attention over the
static encoder keys is the reference's XLA ``gqa_scores`` → float32
softmax → ``gqa_values``, unmasked; no TPU kernel stands behind it, so it
is torch ops here. Training (``encdec_loss``) runs all three attentions
through ``attend_blocked`` under autograd, each layer recomputed in
backward (the reference's ``jax.checkpoint`` of its scan bodies).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers
from repro_torch.models.transformer import DTYPES, lm_head_vocab


def init_encdec_params(cfg, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` on ``device`` (the reference's
    distributions, not its bits)."""
    dev = resolve_device(device)
    return build_encdec_params(cfg,
                               torch.Generator(device=dev).manual_seed(seed))


def build_encdec_params(cfg, gen: torch.Generator):
    """The parameter tree drawn from ``gen``, on ``gen.device``."""
    dev = gen.device
    dtype = DTYPES[cfg.dtype]
    d = cfg.d_model
    vp = lm_head_vocab(cfg)
    n_enc = cfg.encoder_layers
    n_dec = cfg.num_layers - n_enc

    def enc_layer():
        return {"ln1": layers.init_rms_norm(d, dtype, dev),
                "ln2": layers.init_rms_norm(d, dtype, dev),
                "attn": attention.init_attention(gen, cfg, dtype),
                "mlp": layers.init_gated_mlp(gen, d, cfg.d_ff, dtype)}

    def dec_layer():
        return {"ln1": layers.init_rms_norm(d, dtype, dev),
                "lnx": layers.init_rms_norm(d, dtype, dev),
                "ln2": layers.init_rms_norm(d, dtype, dev),
                "self_attn": attention.init_attention(gen, cfg, dtype),
                "cross_attn": attention.init_attention(gen, cfg, dtype),
                "mlp": layers.init_gated_mlp(gen, d, cfg.d_ff, dtype)}

    params = {"embed": layers.embed_init(gen, vp, d, dtype)}
    params["encoder"] = [enc_layer() for _ in range(n_enc)]
    params["decoder"] = [dec_layer() for _ in range(n_dec)]
    params["final_norm"] = layers.init_rms_norm(d, dtype, dev)
    params["lm_head"] = layers.dense_init(gen, d, vp, dtype)
    return params


def _run_layers(layer, params_list, x, train: bool, *args):
    """``layer(p, x, *args) -> (x, out)`` over the stack. Returns (x, the
    outs). Training recomputes each layer in backward and keeps no outs."""
    outs = []
    for p in params_list:
        if train and torch.is_grad_enabled():
            x = checkpoint(lambda p_, x_: layer(p_, x_, *args)[0], p, x,
                           use_reentrant=False)
        else:
            x, out = layer(p, x, *args)
            outs.append(out)
    return x, outs


def _encoder_layer(p, x, cfg, positions, train: bool):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = attention.attention_forward(p["attn"], h, cfg, positions,
                                       causal=False, blocked=train)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.gated_mlp(p["mlp"], h, cfg.mlp_kind), None


def encode(params, cfg, frames, train: bool = False):
    """frames: (B, S_enc, d) stub frontend embeddings -> encoder output.
    ``train``: the training arm (blocked attention, layers recomputed)."""
    S = frames.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=frames.device)
    return _run_layers(_encoder_layer, params["encoder"], frames, train, cfg,
                       positions, train)[0]


def _cross_kv(p, enc_out, cfg):
    B, S, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ p["cross_attn"]["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (enc_out @ p["cross_attn"]["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    return k, v


def _decoder_layer(p, x, cfg, positions, enc_out, enc_pos, train: bool):
    """One decoder layer. Returns (x, its cache {"k", "v", "ck", "cv"})."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, (k, v) = attention.attention_forward(p["self_attn"], h, cfg,
                                            positions, blocked=train)
    x = x + a
    h = layers.rms_norm(x, p["lnx"], cfg.norm_eps)
    ck, cv = _cross_kv(p, enc_out, cfg)
    a, _ = attention.attention_forward(
        p["cross_attn"], h, cfg, positions, causal=False,
        kv_override=(ck, cv, enc_pos), blocked=train)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + layers.gated_mlp(p["mlp"], h, cfg.mlp_kind)
    return x, {"k": k, "v": v, "ck": ck, "cv": cv}


def _decoder_stack(params, cfg, tokens, enc_out, train: bool = False):
    """Teacher-forced decoder pass. Returns (pre-norm hidden (B,S,d), the
    per-layer caches {"k", "v", "ck", "cv"}; none when training)."""
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                           device=enc_out.device)
    x = params["embed"][tokens.long()]
    return _run_layers(_decoder_layer, params["decoder"], x, train, cfg,
                       positions, enc_out, enc_pos, train)


def decoder_hidden(params, cfg, tokens, enc_out):
    """Teacher-forced decoder pass (the training arm) returning pre-norm
    hidden states."""
    return _decoder_stack(params, cfg, tokens, enc_out, train=True)[0]


def encdec_loss(params, cfg, batch):
    """batch: {"frames": (B,S,d), "tokens": (B,S), "labels": (B,S)}.
    Returns (loss, {"loss", "xent", "aux"}). The frames are cast to the
    model's dtype, as the port's server makes them (ROADMAP C6)."""
    from repro_torch.models.transformer import chunked_xent

    frames = batch["frames"].to(params["embed"].dtype)
    enc_out = encode(params, cfg, frames, train=True)
    hidden = decoder_hidden(params, cfg, batch["tokens"], enc_out)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    s_nll, s_m = chunked_xent(params, cfg, hidden, labels.clamp(min=0), mask)
    loss = s_nll / torch.clamp(s_m, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"loss": loss, "xent": loss, "aux": aux}


def _logits(params, cfg, x):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.mask_padded_logits((x @ params["lm_head"]).float(),
                                     cfg.vocab_size)


def decoder_forward(params, cfg, tokens, enc_out):
    """Teacher-forced decoder pass. Returns (logits (B,S,V) float32,
    caches)."""
    x, caches = _decoder_stack(params, cfg, tokens, enc_out)
    return _logits(params, cfg, x), caches


def init_encdec_caches(cfg, batch: int, max_len: int, enc_len: int, dtype,
                       device):
    return build_encdec_caches(cfg, batch, max_len, enc_len, dtype,
                               resolve_device(device))


def build_encdec_caches(cfg, batch: int, max_len: int, enc_len: int, dtype,
                        dev: torch.device):
    """``init_encdec_caches`` on a ``torch.device`` as it is (``meta`` for
    the dry run's stand-ins)."""
    n_dec = cfg.num_layers - cfg.encoder_layers
    hd = cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=dev)
    self_shape = (batch, max_len, cfg.num_kv_heads, hd)
    cross_shape = (batch, enc_len, cfg.num_kv_heads, hd)
    return [{"k": torch.zeros(self_shape, **kw),
             "v": torch.zeros(self_shape, **kw),
             "ck": torch.zeros(cross_shape, **kw),
             "cv": torch.zeros(cross_shape, **kw)} for _ in range(n_dec)]


def encdec_prefill(params, cfg, frames, tokens):
    """Encoder pass + teacher-forced decoder prefill -> (logits of the last
    position (B,1,V) float32, caches sized S). The head runs on the last
    position only: the norm and the head act on each position alone, so
    these are the reference's ``logits[:, -1:]`` without the (B, S, V)
    float32 tensor (2.1 GB at seamless's vocab, B 4, S 512)."""
    enc_out = encode(params, cfg, frames)
    x, caches = _decoder_stack(params, cfg, tokens, enc_out)
    return _logits(params, cfg, x[:, -1:, :]), caches


def encdec_decode_step(params, cfg, token, caches, cur_len: int,
                       seq_axis=None):
    """One decoder token with cached self-KV (written in place at
    ``cur_len``) and the encoder's cross-KV. Returns (logits (B,1,V)
    float32, caches)."""
    x = params["embed"][token.long()]
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    for p, c in zip(params["decoder"], caches):
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = attention.decode_step_attention(p["self_attn"], h, c, cur_len,
                                               cfg, seq_axis)
        x = x + a
        # cross attention over the static encoder kv
        h = layers.rms_norm(x, p["lnx"], cfg.norm_eps)
        q = (h @ p["cross_attn"]["wq"]).reshape(B, 1, cfg.num_heads, hd)
        scores = attention.gqa_scores(q, c["ck"]).float()
        probs = torch.softmax(scores, dim=-1).to(c["cv"].dtype)
        a = attention.gqa_values(probs, c["cv"]).reshape(B, 1, -1)
        x = x + a @ p["cross_attn"]["wo"]
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + layers.gated_mlp(p["mlp"], h, cfg.mlp_kind)
    return _logits(params, cfg, x), caches
