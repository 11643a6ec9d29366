"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel prefill form) and
sLSTM (scalar memory, sequential by nature) — the JAX package's
``models/xlstm.py``.

mLSTM stabilised exponential gating (per head):
  log_f_t = logsigmoid(f̃_t)
  b_t     = Σ_{s<=t} log_f_s                     (cumulative decay)
  m_t     = max(b_t + m_0, b_t + cummax_s(i_s − b_s))
  C_t     = Σ_s exp(b_t − b_s + i_s − m_t) v_s k_sᵀ + exp(b_t + m_0 − m_t) C_0
  n_t     = (same weights over k_s, n_0)
  h̃_t    = C_t q_t / max(|n_t · q_t|, 1)

Prefill evaluates this chunk by chunk (within-chunk quadratic einsums, the
(C, n, m) state carried across chunks by ``scan``, as the reference's
``lax.scan`` carries it); decode is the O(1) recurrent update. Gates and
states are float32 inside a bfloat16 model, cast where the reference
casts. No TPU kernel stands behind either
block: they are torch ops on every device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers
from repro_torch.models.scan import scan

M0 = -1e30  # the state's initial log-scale: b + M0 stays finite in float32


def _logsigmoid(x):
    return -layers.softplus(-x)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _max1(x):
    """``jnp.maximum(x, 1.0)`` with its gradient: half to each side of a
    tie. ``clamp`` would pass all of it, and ties are the rule here: the
    sLSTM's first step has n = 1 exactly."""
    return torch.maximum(x, x.new_ones(()))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    di = 2 * d  # pre-up-projection factor 2 (xLSTM paper)
    H = cfg.num_heads
    dev = gen.device
    p = {"norm": layers.init_rms_norm(d, dtype, dev),
         "up": layers.dense_init(gen, d, 2 * di, dtype)}
    p["conv_w"] = torch.randn((4, di), generator=gen, dtype=torch.float32,
                              device=dev).div_(2.0).to(dtype)
    p["conv_b"] = torch.zeros((di,), dtype=dtype, device=dev)
    for name in ("wq", "wk", "wv"):
        p[name] = layers.dense_init(gen, di, di, dtype)
    p["w_if"] = layers.dense_init(gen, di, 2 * H, dtype)
    p["b_if"] = torch.cat([torch.zeros((H,), device=dev),
                           3.0 * torch.ones((H,), device=dev)]).to(dtype)
    p["out_norm"] = layers.init_rms_norm(di, dtype, dev)
    p["down"] = layers.dense_init(gen, di, d, dtype)
    return p


def _mlstm_qkvif(params, x, cfg):
    """x: (B,S,d) -> q,k,v: (B,S,H,dh); i,f: (B,S,H) float32; z gate:
    (B,S,di); xm: (B,S,di) (the conv's input, whose tail is the decode
    cache's ``conv``)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    xn = layers.rms_norm(x, params["norm"], cfg.norm_eps)
    xm, z = (xn @ params["up"]).chunk(2, dim=-1)  # (B,S,di)
    di = xm.shape[-1]
    # causal conv(4) + silu on the q/k path
    xp = torch.cat([xm.new_zeros((B, 3, di)), xm], dim=1)
    xc = F.silu(layers.causal_taps(xp, params["conv_w"], S) + params["conv_b"])
    dh = di // H
    q = (xc @ params["wq"]).reshape(B, S, H, dh)
    k = ((xc @ params["wk"]) / math.sqrt(dh)).reshape(B, S, H, dh)
    v = (xm @ params["wv"]).reshape(B, S, H, dh)
    gif = (xm @ params["w_if"] + params["b_if"]).float()
    i_gate, f_gate = gif.chunk(2, dim=-1)  # (B,S,H)
    return q, k, v, i_gate, f_gate, z, xm


def _mlstm_chunk(q, k, v, i_g, f_g, state):
    """One chunk of the chunkwise-parallel mLSTM. q,k,v: (B,Lc,H,dh);
    i_g,f_g: (B,Lc,H); state: (C0, n0, m0) with shapes (B,H,dh,dh),
    (B,H,dh), (B,H). Returns (h (B,Lc,H,dh) float32, end state)."""
    C0, n0, m0 = state
    qf, kf, vf = q.float(), k.float(), v.float()
    log_f = _logsigmoid(f_g)  # (B,Lc,H)
    b = torch.cumsum(log_f, dim=1)
    g = i_g - b  # (B,Lc,H)
    m_intra = torch.cummax(g, dim=1).values
    m_t = b + torch.maximum(m0[:, None], m_intra)  # (B,Lc,H)

    # intra-chunk weights: w[t,s] = exp(b_t - b_s + i_s - m_t),  s <= t
    expo = (b[:, :, None] - b[:, None, :] + i_g[:, None, :]
            - m_t[:, :, None])  # (B,Lc_t,Lc_s,H)
    Lc = q.shape[1]
    causal = torch.ones((Lc, Lc), dtype=torch.bool, device=q.device).tril()
    # the exponent is masked before exp: the reference exps the whole
    # square and masks after, the same forward values, but above the
    # diagonal expo passes 88 once the gates spread within a chunk, and the
    # masked inf then turns every gradient NaN (ROADMAP C9)
    w = torch.exp(torch.where(causal[None, :, :, None], expo, -math.inf))

    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * w  # (B,Lc,Lc,H)
    num_intra = torch.einsum("btsh,bshd->bthd", scores, vf)
    # denominator: n_t · q_t = Σ_s w_ts (k_s · q_t) + decay (n_0 · q_t)
    den_intra = scores.sum(dim=2)  # (B,Lc,H)

    decay0 = torch.exp(b + m0[:, None] - m_t)  # (B,Lc,H)
    # C is v⊗k (C[d,e] = v_d k_e): q contracts the k-dim (e)
    num_inter = torch.einsum("bthe,bhde->bthd", qf, C0) * decay0[..., None]
    den_inter = torch.einsum("bthd,bhd->bth", qf, n0) * decay0

    num = num_intra + num_inter
    den = den_intra + den_inter
    h = num / _max1(den.abs())[..., None]  # (B,Lc,H,dh)

    # chunk-end state (t = Lc-1)
    mL = m_t[:, -1]  # (B,H)
    wL = torch.exp(b[:, -1:, :] - b + i_g - mL[:, None])  # (B,Lc,H)
    carry = torch.exp(b[:, -1] + m0 - mL)  # (B,H)
    C_end = torch.einsum("bshd,bshe->bhde", wL[..., None] * vf, kf) \
        + carry[..., None, None] * C0
    n_end = torch.einsum("bsh,bshd->bhd", wL, kf) + carry[..., None] * n0
    return h, (C_end, n_end, mL)


def mlstm_block(params, x, cfg, chunk: int = 256):
    """The mLSTM block over a sequence. Returns (x + out, the decode
    cache it leaves: C, n, m and the conv tail). Its input and output are
    pinned whole over "model" (the identity outside the dry run), as the
    reference pins the residual stream."""
    x = constrain(x, "batch", None, None)
    B, S, _ = x.shape
    H = cfg.num_heads
    q, k, v, i_g, f_g, z, xm = _mlstm_qkvif(params, x, cfg)
    di = z.shape[-1]
    dh = di // H
    Lc = layers.chunk_len(S, chunk)
    # the state is made from x (``new_*``) and takes the batch's layout:
    # the identity outside the dry run
    f32 = torch.float32
    state = (x.new_zeros((B, H, dh, dh), dtype=f32),
             x.new_zeros((B, H, dh), dtype=f32),
             x.new_full((B, H), M0, dtype=f32))
    state = tuple(constrain(t, "batch", *([None] * (t.ndim - 1)))
                  for t in state)

    # whole over "model" (xlstm-350m's 4 heads do not split 16 ways; the
    # head dim split 16 ways gathers the state's products every chunk),
    # their partial sums reduced once here and not once a chunk
    q, k, v, i_g, f_g = (constrain(t, "batch", *([None] * (t.ndim - 1)))
                         for t in (q, k, v, i_g, f_g))

    def step(state, i):
        sl = slice(int(i) * Lc, (int(i) + 1) * Lc)
        h, state = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], i_g[:, sl],
                                f_g[:, sl], state)
        return state, h

    # the chunk index on the host: the step slices its chunk as the loop
    # did, which keeps autograd's gradient layouts
    state, hs = scan(step, state, torch.arange(S // Lc))
    h = hs.movedim(0, 1).reshape(B, S, di)
    h = layers.rms_norm(h.to(x.dtype), params["out_norm"], cfg.norm_eps)
    h = h * F.silu(z)
    conv = torch.cat([xm.new_zeros((B, 3, di)), xm], dim=1)[:, -3:, :]
    cache = {"C": state[0], "n": state[1], "m": state[2], "conv": conv}
    return constrain(x + h @ params["down"], "batch", None, None), cache


def mlstm_forward(params, x, cfg, chunk: int = 256):
    return mlstm_block(params, x, cfg, chunk)[0]


def init_mlstm_cache(cfg, batch: int, dtype, device):
    H = cfg.num_heads
    di = 2 * cfg.d_model
    dh = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), M0, **f32),
            "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device)}


def mlstm_decode_step(params, x_step, cache, cfg):
    """x_step: (B,1,d) -> the O(1) recurrent update. Returns (out, a new
    cache dict)."""
    B = x_step.shape[0]
    H = cfg.num_heads
    xn = layers.rms_norm(x_step, params["norm"], cfg.norm_eps)
    xm, z = (xn @ params["up"]).chunk(2, dim=-1)
    di = xm.shape[-1]
    xp = torch.cat([cache["conv"].to(xm.dtype), xm], dim=1)  # (B,4,di)
    xc = F.silu(layers.causal_taps(xp, params["conv_w"], 1) + params["conv_b"])
    dh = di // H
    q = (xc @ params["wq"]).reshape(B, H, dh).float()
    k = ((xc @ params["wk"]) / math.sqrt(dh)).reshape(B, H, dh).float()
    v = (xm @ params["wv"]).reshape(B, H, dh).float()
    gif = (xm @ params["w_if"] + params["b_if"]).float()[:, 0]
    i_g, f_g = gif.chunk(2, dim=-1)  # (B,H)

    log_f = _logsigmoid(f_g)
    m_new = torch.maximum(log_f + cache["m"], i_g)
    f_t = torch.exp(log_f + cache["m"] - m_new)
    i_t = torch.exp(i_g - m_new)
    C = f_t[..., None, None] * cache["C"] + i_t[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v, k)
    n_ = f_t[..., None] * cache["n"] + i_t[..., None] * k
    num = torch.einsum("bhde,bhe->bhd", C, q)
    den = torch.einsum("bhd,bhd->bh", n_, q)
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    h = h.reshape(B, 1, di).to(x_step.dtype)
    h = layers.rms_norm(h, params["out_norm"], cfg.norm_eps)
    h = h * F.silu(z)
    new_cache = {"C": C, "n": n_, "m": m_new, "conv": xp[:, 1:, :]}
    return x_step + h @ params["down"], new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    dev = gen.device
    p = {"norm": layers.init_rms_norm(d, dtype, dev),
         # input weights for gates z,i,f,o
         "w_x": layers.dense_init(gen, d, 4 * d, dtype)}
    # block-diagonal recurrent weights, per head: (H, dh, 4*dh)
    p["w_h"] = torch.randn((H, dh, 4 * dh), generator=gen,
                           dtype=torch.float32, device=dev) \
        .div_(math.sqrt(dh)).to(dtype)
    p["bias"] = torch.cat([torch.zeros((2 * d,), device=dev),
                           3.0 * torch.ones((d,), device=dev),
                           torch.zeros((d,), device=dev)]).to(dtype)
    p["out_norm"] = layers.init_rms_norm(d, dtype, dev)
    # post-up-projection MLP (factor 4/3, gated)
    p["up_gate"] = layers.dense_init(gen, d, (4 * d) // 3, dtype)
    p["up_out"] = layers.dense_init(gen, (4 * d) // 3, d, dtype)
    return p


def _slstm_cell(params, xg, state, H, dh):
    """xg: (B, 4d) float32 input gates; state: (h, c, n, m), each (B, d)
    float32."""
    h_prev, c_prev, n_prev, m_prev = state
    B = xg.shape[0]
    d = H * dh
    rec = torch.einsum("bhd,hde->bhe", h_prev.reshape(B, H, dh),
                       params["w_h"].float()).reshape(B, 4 * d)
    z_g, i_g, f_g, o_g = (xg + rec).chunk(4, dim=-1)  # (B,d) each
    z_t = torch.tanh(z_g)
    o_t = torch.sigmoid(o_g)
    log_f = _logsigmoid(f_g)
    m_new = torch.maximum(log_f + m_prev, i_g)
    i_t = torch.exp(i_g - m_new)
    f_t = torch.exp(log_f + m_prev - m_new)
    c_new = f_t * c_prev + i_t * z_t
    n_new = f_t * n_prev + i_t
    h_new = o_t * c_new / _max1(n_new)
    return h_new, c_new, n_new, m_new


def _slstm_out(params, h, x, cfg):
    h = layers.rms_norm(h.to(x.dtype), params["out_norm"], cfg.norm_eps)
    return x + _gelu(h @ params["up_gate"]) @ params["up_out"]


def slstm_block(params, x, cfg):
    """The sLSTM block over a sequence: a ``scan`` over time (sLSTM has no
    parallel form). Returns (x + out, its end state as a decode cache).
    Input and output pinned as ``mlstm_block``'s."""
    x = constrain(x, "batch", None, None)
    B, S, d = x.shape
    H = cfg.num_heads
    xn = layers.rms_norm(x, params["norm"], cfg.norm_eps)
    xg = (xn @ params["w_x"] + params["bias"]).float()  # (B,S,4d)
    # ``init_slstm_cache``'s state, made from x and laid out as
    # ``mlstm_block``'s
    state = (x.new_zeros((B, d), dtype=torch.float32),) * 3 \
        + (x.new_full((B, d), M0, dtype=torch.float32),)
    state = tuple(constrain(t, "batch", None) for t in state)

    def step(state, t):
        state = _slstm_cell(params, xg[:, int(t)], state, H, d // H)
        return state, state[0]

    # the time index on the host, as ``mlstm_block``'s chunk index
    state, hs = scan(step, state, torch.arange(S))
    out = constrain(_slstm_out(params, hs.movedim(0, 1).contiguous(), x, cfg),
                    "batch", None, None)
    return out, dict(zip(("h", "c", "n", "m"), state))


def slstm_forward(params, x, cfg):
    return slstm_block(params, x, cfg)[0]


def init_slstm_cache(cfg, batch: int, dtype, device):
    """The sLSTM state: float32 whatever the model's ``dtype``."""
    f32 = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), **f32),
            "c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), M0, **f32)}


def slstm_decode_step(params, x_step, cache, cfg):
    d = cfg.d_model
    H = cfg.num_heads
    xn = layers.rms_norm(x_step, params["norm"], cfg.norm_eps)
    xg = (xn @ params["w_x"] + params["bias"]).float()[:, 0]
    state = _slstm_cell(params, xg, (cache["h"], cache["c"], cache["n"],
                                     cache["m"]), H, d // H)
    out = _slstm_out(params, state[0][:, None, :], x_step, cfg)
    return out, dict(zip(("h", "c", "n", "m"), state))
