"""Architecture dispatch: init / prefill / decode per family, and analytic
parameter counts (the JAX package's ``models/model_zoo.py``).

The port serves the dense GQA family; the other families raise
``NotImplementedError`` naming ROADMAP Queue A item 12, and the training
entry (``loss_fn``) waits for item 13. ``input_specs`` and ``param_specs``
build ``jax.ShapeDtypeStruct`` stand-ins for the TPU dry run and have no
counterpart here (item 14).
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
    return (cfg.d_model * cfg.num_heads * hd
            + 2 * cfg.d_model * cfg.num_kv_heads * hd
            + cfg.num_heads * hd * cfg.d_model)


def analytic_param_count(cfg, active_only: bool = False) -> int:
    """The JAX package's count for the dense family (embedding, untied
    head, attention and a gated MLP per layer; biases and norms are not
    counted there either). ``active_only`` changes nothing without MoE."""
    transformer.check_supported(cfg)
    vp = transformer.lm_head_vocab(cfg)
    total = vp * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.d_model * vp  # head
    per_layer = _attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff
    return total + per_layer * cfg.num_layers
