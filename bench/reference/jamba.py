"""Plain reference of the Jamba period that the serving cell runs, in
float32 with TF32 off, written from the configuration file and its
``departures`` (not from the port's code): pre-norm residual layers, a
Mamba-1 mixer on every layer but one attention layer (position
``attn_layer_offset`` of the period, GQA with split-half RoPE), a
top-2 mixture of experts on every ``expert_layer_period``-th layer from
``expert_layer_offset`` and a SwiGLU MLP on the others, RMSNorm with the
weight stored as its offset from 1.

The MoE keeps the configuration's capacity drops: each MoE call is one
group of tokens (every token of the batch at prefill, the batch's tokens
of one position at a decode step); a token's pairs are ranked in token
order within their expert, and a pair past the group's capacity is
dropped. So a call's drops depend on its whole batch, and the reference
runs the whole batch, layer by layer, holding one layer's weights in
float32 at a time.

``quant="fp8"`` is the control: every matmul weight but the router's and
the embedding's rounded to float8 e4m3 with a scale a output column,
the arithmetic as before.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.precision import tf32_off

F32 = torch.float32
FP8_MAX = 448.0


class Dims:
    """The sizes the reference reads from the configuration file."""

    def __init__(self, c: dict):
        self.d = c["hidden_size"]
        self.h = c["num_attention_heads"]
        self.hkv = c["num_key_value_heads"]
        self.hd = c["assumed"].get("head_dim") or self.d // self.h
        self.f = c["intermediate_size"]
        self.e = c["num_experts"]
        self.k = c["num_experts_per_tok"]
        self.di = c["mamba_expand"] * self.d
        self.ds = c["mamba_d_state"]
        self.dc = c["mamba_d_conv"]
        self.dtr = c["mamba_dt_rank"]
        self.eps = c["rms_norm_eps"]
        self.theta = c["assumed"]["rope_theta"]
        self.cf = c["assumed"]["capacity_factor"]
        self.layers = c["num_hidden_layers"]
        self.attn_period = c["attn_layer_period"]
        self.attn_offset = c["attn_layer_offset"]
        self.moe_period = c["expert_layer_period"]
        self.moe_offset = c["expert_layer_offset"]

    def is_attn(self, i: int) -> bool:
        return i % self.attn_period == self.attn_offset

    def is_moe(self, i: int) -> bool:
        return i % self.moe_period == self.moe_offset

    def capacity(self, tokens: int) -> int:
        c = math.ceil(tokens * self.k / self.e * self.cf)
        return max(8, -(-c // 8) * 8)


def fp8(w):
    """``w`` rounded to float8 e4m3, a scale per output column (the last
    axis), back in float32."""
    w = w.float()
    s = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


class Layer:
    """One layer's weights in float32 (rounded under the control)."""

    def __init__(self, p: dict, quant):
        self.p, self.quant = p, quant

    def w(self, *path):
        t = self.p
        for k in path:
            t = t[k]
        return fp8(t) if self.quant == "fp8" else t.float()

    def raw(self, *path):
        t = self.p
        for k in path:
            t = t[k]
        return t.float()


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba(L: Layer, x, dm: Dims, chunk: int = 32):
    """x (B,T,d) -> (B,T,d): in projection, causal depthwise conv + SiLU,
    the selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
    y_t = C_t . h_t + D x_t, gated by SiLU(z), out projection."""
    B, T, _ = x.shape
    xin, z = (x @ L.w("mamba", "in_proj")).split(dm.di, dim=-1)
    cw, cb = L.raw("mamba", "conv_w"), L.raw("mamba", "conv_b")
    xp = F.pad(xin, (0, 0, dm.dc - 1, 0))
    conv = sum(xp[:, j:j + T] * cw[j] for j in range(dm.dc)) + cb
    xin = F.silu(conv)
    proj = xin @ L.w("mamba", "x_proj")
    dt, Bs, Cs = proj.split([dm.dtr, dm.ds, dm.ds], dim=-1)
    dt = softplus(dt @ L.w("mamba", "dt_proj") + L.raw("mamba", "dt_bias"))
    A = -torch.exp(L.raw("mamba", "A_log"))  # (di, ds)
    h = x.new_zeros((B, dm.di, dm.ds))
    y = torch.empty_like(xin)
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(t0 + chunk, T))
        a = torch.exp(dt[:, sl, :, None] * A)
        b = (dt[:, sl] * xin[:, sl])[..., None] * Bs[:, sl, None, :]
        for j in range(a.shape[1]):
            h = a[:, j] * h + b[:, j]
            y[:, t0 + j] = (h * Cs[:, t0 + j, None, :]).sum(-1)
    y = y + L.raw("mamba", "D") * xin
    return (y * F.silu(z)) @ L.w("mamba", "out_proj")


def rope(x, theta):
    """Split-half rotary embedding at positions 0..T-1. x (B,T,H,hd)."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(half, dtype=F32, device=x.device)
                      * (math.log(theta) / half))
    ang = torch.arange(T, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(L: Layer, x, dm: Dims):
    """Causal GQA: query head j reads kv head j // (h / hkv)."""
    B, T, _ = x.shape
    q = rope((x @ L.w("attn", "wq")).view(B, T, dm.h, dm.hd), dm.theta)
    k = rope((x @ L.w("attn", "wk")).view(B, T, dm.hkv, dm.hd), dm.theta)
    v = (x @ L.w("attn", "wv")).view(B, T, dm.hkv, dm.hd)
    g = dm.h // dm.hkv
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    out = torch.empty_like(q)
    for b in range(B):
        kb = k[b].repeat_interleave(g, dim=1)  # (T, h, hd)
        vb = v[b].repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", q[b], kb) / math.sqrt(dm.hd)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[b] = torch.einsum("hqk,khd->qhd", p, vb)
    return out.reshape(B, T, dm.h * dm.hd) @ L.w("attn", "wo")


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def moe(L: Layer, x, dm: Dims, group: str):
    """Top-k routing (ties to the lower expert), gates softmaxed over the
    k selected logits, capacity drops by token order within each expert
    of each group: ``"batch"`` one group of every token (token b*T + t),
    ``"position"`` one group a position of the batch's tokens (order b)."""
    B, T, d = x.shape
    logits = x @ L.raw("mlp", "router")  # the router stays float32
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[..., :dm.k], dim=-1)
    idx = idx[..., :dm.k]  # (B,T,k)
    onehot = F.one_hot(idx, dm.e).sum(-2)  # (B,T,E): 0 or 1 each
    if group == "batch":
        order = onehot.reshape(1, B * T, dm.e)
        cap = dm.capacity(B * T)
    else:
        order = onehot.transpose(0, 1)  # (T,B,E)
        cap = dm.capacity(B)
    rank = order.cumsum(1) - order  # earlier pairs at the same expert
    if group == "batch":
        rank = rank.reshape(B, T, dm.e)
    else:
        rank = rank.transpose(0, 1)
    keep = rank.gather(-1, idx) < cap  # (B,T,k)
    xf = x.reshape(B * T, d)
    out = torch.zeros_like(xf)
    flat_idx, flat_gate = idx.reshape(-1, dm.k), gates.reshape(-1, dm.k)
    flat_keep = keep.reshape(-1, dm.k)
    for e in range(dm.e):
        sel = (flat_idx == e) & flat_keep  # (BT,k)
        tok = sel.any(-1).nonzero().squeeze(-1)
        if tok.numel() == 0:
            continue
        g = (flat_gate * sel).sum(-1)[tok]
        y = swiglu(xf[tok], _expert(L, "w_gate", e), _expert(L, "w_up", e),
                   _expert(L, "w_down", e))
        out.index_add_(0, tok, y * g[:, None])
    dropped = int((~keep).sum())
    return out.reshape(B, T, d), dropped


def _expert(L: Layer, name: str, e: int):
    w = L.p["mlp"][name][e]
    return fp8(w) if L.quant == "fp8" else w.float()


def hidden(weights, dm: Dims, tokens, group: str, quant=None):
    """The final-norm hidden state (B,T,d) of ``tokens`` (B,T), and the
    pairs the MoE dropped."""
    x = weights["embed"][tokens].float()
    dropped = 0
    for i in range(dm.layers):
        p = weights["blocks"][i // dm.attn_period][f"l{i % dm.attn_period}"]
        L = Layer(p, quant)
        h = rms_norm(x, L.raw("ln1"), dm.eps)
        x = x + (attention(L, h, dm) if dm.is_attn(i) else mamba(L, h, dm))
        h = rms_norm(x, L.raw("ln2"), dm.eps)
        if dm.is_moe(i):
            y, n = moe(L, h, dm, group)
            dropped += n
        else:
            y = swiglu(h, L.w("mlp", "wi_gate"), L.w("mlp", "wi_up"),
                       L.w("mlp", "wo"))
        x = x + y
        del h, y
    return rms_norm(x, weights["final_norm"].float(), dm.eps), dropped


def logits_at(weights, config: dict, tokens, positions, group: str,
              quant=None):
    """(B, len(positions), V) float32 logits at ``positions`` of
    ``tokens`` (B,T), and the MoE's dropped pairs."""
    dm = Dims(config)
    with torch.no_grad(), tf32_off():
        x, dropped = hidden(weights, dm, tokens, group, quant)
        head = weights["lm_head"][:, :config["vocab_size"]]
        head = fp8(head) if quant == "fp8" else head.float()
        return x[:, positions] @ head, dropped
