"""Shared model layers: norms, rotary embeddings, gated MLPs, embedding
tables and the padded vocab head (the JAX package's ``models/layers.py``).

Parameters are plain dicts of tensors made by the ``init_*`` functions;
forward passes are plain functions. Dense kernels are stored
(d_in, d_out), as in the JAX package, so a converted parameter tree is used
as it is. Initialisation draws from a ``torch.Generator`` with the JAX
package's distributions (normal / sqrt(d_in), embeddings x 0.02, norms 0)
but not its bits; each tensor is made on its device in float32 and cast,
one at a time. The JAX package's ``constrain`` (sharding annotations) has
no counterpart on one card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype):
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(0.02).to(dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def init_rms_norm(d: int, dtype, device):
    # stored as delta from 1.0 (gemma-style); works for all archs
    return torch.zeros((d,), dtype=dtype, device=device)


def rope_angles(positions, head_dim: int, theta: float):
    """positions: int tensor [...]; returns (cos, sin) of shape
    [..., head_dim//2], float32."""
    half = head_dim // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim//2].

    Rotates pairs (x[..., :half], x[..., half:]) — the "split-half"
    convention used by llama/gemma/qwen/phi3 HF implementations.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), the reference's formula (torch's
    ``F.softplus`` rounds otherwise and returns x itself above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def chunk_len(S: int, chunk: int = 256) -> int:
    """A chunked scan's chunk: min(chunk, S), halved until it divides S
    (the reference's rule for mLSTM and mamba)."""
    Lc = min(chunk, S)
    while S % Lc:
        Lc //= 2
    return Lc


def causal_taps(xp, w, S: int):
    """Σ_j xp[:, j:j+S] · w[j] over the taps of a depthwise causal conv
    (xp holds the len(w) − 1 inputs before the S new ones), summed in the
    reference's order."""
    return sum(xp[:, j:j + S, :] * w[j] for j in range(w.shape[0]))


def init_gated_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return {
        "wi_gate": dense_init(gen, d_model, d_ff, dtype),
        "wi_up": dense_init(gen, d_model, d_ff, dtype),
        "wo": dense_init(gen, d_ff, d_model, dtype),
    }


def gated_mlp(params, x, kind: str = "swiglu"):
    spec = ["batch"] + [None] * (x.ndim - 2) + ["model"]
    gate = constrain(x @ params["wi_gate"], *spec)
    up = constrain(x @ params["wi_up"], *spec)
    if kind == "swiglu":
        act = F.silu(gate)
    elif kind == "geglu":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(kind)
    return constrain((act * up) @ params["wo"],
                     "batch", *([None] * (x.ndim - 1)))


def padded_vocab(vocab_size: int, multiple: int = 2048) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


def mask_padded_logits(logits, true_vocab: int):
    v = logits.shape[-1]
    if v == true_vocab:
        return logits
    mask = torch.arange(v, device=logits.device) < true_vocab
    return torch.where(mask, logits, torch.finfo(logits.dtype).min)
