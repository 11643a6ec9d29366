"""Mamba-1 selective SSM block: a chunked scan for prefill, the O(1)-state
recurrent update for decode — the JAX package's ``models/mamba.py``.

The recurrence h_t = a_t ⊙ h_{t-1} + b_t is computed chunk by chunk: a
``scan`` over the chunk's positions (torch has no
``lax.associative_scan``) writes h into the chunk's one buffer in place,
h carried across chunks by a ``scan`` as the reference's ``lax.scan``
carries it. Only one chunk's (B, Lc, d_inner, d_state) elements exist at
a time (the reference stacks ``h`` over the whole sequence; at jamba's
widths that is 2.1 GB a tensor at B 4, S 512). The
sums run in another order than XLA's tree, so float32 results agree with
the reference to rounding (the tests state 1e-5). No TPU kernel stands
behind the block: it is torch ops on every device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers
from repro_torch.models.scan import scan

# leaves the reference keeps float32 in a bfloat16 model
F32_LEAVES = ("A_log", "D")


def dt_rank_for(d_model: int) -> int:
    return max(1, math.ceil(d_model / 16))


def init_mamba(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dtr = dt_rank_for(d)
    dev = gen.device
    p = {"in_proj": layers.dense_init(gen, d, 2 * di, dtype)}
    p["conv_w"] = torch.randn((dc, di), generator=gen, dtype=torch.float32,
                              device=dev).div_(math.sqrt(dc)).to(dtype)
    p["conv_b"] = torch.zeros((di,), dtype=dtype, device=dev)
    p["x_proj"] = layers.dense_init(gen, di, dtr + 2 * ds, dtype)
    p["dt_proj"] = layers.dense_init(gen, dtr, di, dtype, scale=dtr ** -0.5)
    p["dt_bias"] = torch.full((di,), math.log(math.e - 1), dtype=torch.float32,
                              device=dev).to(dtype)  # softplus^-1(1)
    # S4D-real initialisation for A
    a_init = torch.arange(1, ds + 1, dtype=torch.float32,
                          device=dev)[None, :].repeat(di, 1)
    p["A_log"] = torch.log(a_init)
    p["D"] = torch.ones((di,), dtype=torch.float32, device=dev)
    p["out_proj"] = layers.dense_init(gen, di, d, dtype)
    return p


def _ssm_inputs(params, xin, cfg):
    """xin: (B, S, di) post-conv activations -> (dt (B,S,di), B_ssm
    (B,S,ds), C_ssm (B,S,ds)), float32. The scan's elements are
    a = exp(dt ⊗ A) and b = (dt · xin) ⊗ B_ssm (``_scan_elements``)."""
    ds = cfg.mamba_d_state
    dtr = dt_rank_for(cfg.d_model)
    proj = xin @ params["x_proj"]
    dt, B_ssm, C_ssm = proj.split([dtr, ds, ds], dim=-1)
    dt = layers.softplus(dt @ params["dt_proj"] + params["dt_bias"]).float()
    return dt, B_ssm.float(), C_ssm.float()


def _scan_elements(params, dt, xin, B_ssm):
    """(a, b) of h_t = a_t·h_{t-1} + b_t over the positions given: each
    (B, L, di, ds) float32."""
    A = -torch.exp(params["A_log"])  # (di, ds)
    a = torch.exp(dt[..., None] * A)
    b = (dt * xin.float())[..., None] * B_ssm[..., None, :]
    return a, b


def _causal_conv(params, x, cfg, conv_state=None):
    """Depthwise causal conv over S. x: (B,S,di). conv_state: (B,dc-1,di).
    Returns (silu(conv + bias), the new state: the last dc-1 inputs)."""
    dc = cfg.mamba_d_conv
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+dc-1, di)
    S = x.shape[1]
    out = layers.causal_taps(xp, params["conv_w"], S)
    new_state = xp[:, -(dc - 1):, :] if dc > 1 else pad
    return F.silu(out + params["conv_b"]), new_state


def _scan_chunk(a, b, h):
    """h_t = a_t·h_{t-1} + b_t over the chunk's positions (axis 1), from
    h. Returns (h at every position (B, Lc, di, ds), the last one)."""
    def step(carry, t):
        h, out = carry
        h = torch.addcmul(b[:, int(t)], a[:, int(t)], h)
        out[:, int(t)] = h
        return (h, out), None

    # the position index on the host: the step slices a and b and writes h
    # into the chunk's one buffer as the loop did (autograd's layouts kept);
    # the buffer rides in the carry, so the dry run's count sees its writes
    (h, out), _ = scan(step, (h, torch.empty_like(b)),
                       torch.arange(a.shape[1]))
    return out, h


def _ssm(params, xin, cfg, chunk: int = 256):
    """The selective scan over the prompt from h = 0. xin: (B,S,di)
    post-conv. Returns (y (B,S,di) float32 = C·h + D·xin, h at the end)."""
    B, S, di = xin.shape
    dt, B_ssm, C_ssm = _ssm_inputs(params, xin, cfg)
    # the layouts the chunks are sliced from (the identity outside the dry
    # run): d_inner over "model", the d_state projections whole, reduced
    # once here and not once a position
    xin, dt = (constrain(t, "batch", None, "model") for t in (xin, dt))
    B_ssm, C_ssm = (constrain(t, "batch", None, None) for t in (B_ssm, C_ssm))
    h = constrain(xin.new_zeros((B, di, cfg.mamba_d_state),
                                dtype=torch.float32), "batch", "model", None)
    Lc = layers.chunk_len(S, chunk)

    def step(h, i):
        sl = slice(int(i) * Lc, (int(i) + 1) * Lc)
        a, b = _scan_elements(params, dt[:, sl], xin[:, sl], B_ssm[:, sl])
        h_all, h = _scan_chunk(a, b, h)
        del a, b
        return h, torch.einsum("bsdn,bsn->bsd", h_all, C_ssm[:, sl])

    h, ys = scan(step, h, torch.arange(S // Lc))
    y = ys.movedim(0, 1).reshape(B, S, di)
    return y + params["D"] * xin.float(), h


def _gate_out(params, y, z, dtype):
    y = (y * F.silu(z.float())).to(dtype)
    return y @ params["out_proj"]


def mamba_block(params, x, cfg, chunk: int = 256):
    """x: (B,S,d) -> (out (B,S,d), the decode cache it leaves: h and the
    conv tail). Its input and output are pinned whole over "model" (the
    identity outside the dry run), as the reference pins the residual
    stream: the projections then split their weights, not gather them."""
    x = constrain(x, "batch", None, None)
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xin, conv_state = _causal_conv(params, xin, cfg)
    y, h_end = _ssm(params, xin, cfg, chunk)
    out = constrain(_gate_out(params, y, z, x.dtype), "batch", None, None)
    return out, {"h": h_end, "conv": conv_state}


def mamba_forward(params, x, cfg, chunk: int = 256):
    """x: (B,S,d) -> (B,S,d). The prefill path."""
    return mamba_block(params, x, cfg, chunk)[0]


def init_mamba_cache(cfg, batch: int, dtype, device):
    di = cfg.mamba_expand * cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.mamba_d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                dtype=dtype, device=device)}


def mamba_decode_step(params, x_step, cache, cfg):
    """x_step: (B,1,d). The O(1) recurrent update. Returns (out, a new
    cache dict)."""
    xin, z = (x_step @ params["in_proj"]).chunk(2, dim=-1)
    xin, conv_state = _causal_conv(params, xin, cfg, conv_state=cache["conv"])
    dt, B_ssm, C_ssm = _ssm_inputs(params, xin, cfg)  # S=1
    a, b = _scan_elements(params, dt, xin, B_ssm)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = torch.einsum("bdn,bn->bd", h, C_ssm[:, 0])[:, None, :]
    y = y + params["D"] * xin.float()
    return _gate_out(params, y, z, x_step.dtype), {"h": h, "conv": conv_state}
