"""The port's ``scan`` (``models/scan.py``, the counterpart of
``jax.lax.scan``) and the counter's ``repeat`` scope (``launch/cost.py``).

On tensors with values ``scan`` runs every step: it equals the explicit
loop bit for bit, under an active ``CostCounter`` too, and ``jax.lax.scan``
on the same inputs to float32 rounding. On meta tensors under a counter it
runs five steps and counts the middle one n − 4 times: its flops, bytes,
collectives, live and peak bytes then equal the unrolled loop's (the same
code with the counted path switched off here), in forward, under autograd,
inside ``torch.utils.checkpoint``, and for a scan nested in a scan."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.cost import CostCounter  # noqa: E402
from repro_torch.models import layers, mamba, model_zoo, xlstm  # noqa: E402
from repro_torch.models import scan as scan_mod  # noqa: E402
from repro_torch.models.scan import scan  # noqa: E402
from repro_torch.training import data  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.train_loop import value_and_grad  # noqa: E402

B, D = 3, 8


def _lstm_step(w):
    """An LSTM-like step: the carry (h, c) and the output h, which is also
    the carry (the sLSTM's pattern: the stacked outputs alias the state)."""
    def body(carry, x):
        h, c = carry
        z, i, f, o = (x + h @ w).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h
    return body


def _chunked(A, n_chunks, Lc):
    """mamba's pattern: a scan over chunks whose body scans the chunk's
    positions, outputs a contraction of them and closes over ``A``."""
    def inner(h, ab):
        h = torch.addcmul(ab[1], ab[0], h)
        return h, h

    def outer(h, c):
        x, C = c  # (B, Lc, D), (B, Lc, 4)
        a = torch.exp(x[..., None] * A)
        b = x[..., None] * C[..., None, :]
        h, hs = scan(inner, h, (a.movedim(1, 0), b.movedim(1, 0)))
        y = torch.einsum("sbdn,sbn->sbd", hs, C.movedim(1, 0))
        return h, y.movedim(0, 1)

    def run(xs, Cs):
        def chunks(t):
            return t.reshape(B, n_chunks, Lc, *t.shape[2:]).movedim(1, 0)
        h0 = torch.zeros((B, D, 4), device=xs.device)
        return scan(outer, h0, (chunks(xs), chunks(Cs)))
    return run


def _unrolled(monkeypatch):
    monkeypatch.setattr(scan_mod, "_counter_for", lambda carry: None)


@pytest.mark.parametrize("counter", [False, True])
@pytest.mark.parametrize("n", [1, 5, 9])
def test_scan_equals_the_loop_bit_for_bit(n, counter):
    """float32 CPU tensors from a numpy seed: the last carry and every
    stacked output equal an explicit Python loop's exactly, and the body
    runs n times, also with a ``CostCounter`` active (the counted path is
    for meta tensors only)."""
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.normal(size=(D, 4 * D)).astype(np.float32))
    xs = torch.from_numpy(rng.normal(size=(n, B, 4 * D)).astype(np.float32))
    body = _lstm_step(w)
    calls = []

    def counted_body(carry, x):
        calls.append(1)
        return body(carry, x)

    c0 = (torch.zeros(B, D), torch.zeros(B, D))
    with CostCounter() if counter else torch.no_grad():
        (h, c), hs = scan(counted_body, c0, xs)
    carry, want = c0, []
    for t in range(n):
        carry, y = body(carry, xs[t])
        want.append(y)
    assert len(calls) == n
    assert torch.equal(h, carry[0]) and torch.equal(c, carry[1])
    assert torch.equal(hs, torch.stack(want))


def test_scan_matches_lax_scan():
    """The same numpy inputs through ``jax.lax.scan`` and the port's
    ``scan``, nested and not: 1e-6 (float32 sums in other orders)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    rng = np.random.default_rng(0)
    n_chunks, Lc = 3, 6
    A = rng.normal(size=(D, 4)).astype(np.float32) * 0.1
    xs = rng.normal(size=(B, n_chunks * Lc, D)).astype(np.float32)
    Cs = rng.normal(size=(B, n_chunks * Lc, 4)).astype(np.float32)

    def j_inner(h, ab):
        h = ab[0] * h + ab[1]
        return h, h

    def j_outer(h, c):
        x, C = c
        a = jnp.exp(x[..., None] * A)
        b = x[..., None] * C[..., None, :]
        h, hs = jax.lax.scan(j_inner, h, (jnp.moveaxis(a, 1, 0),
                                          jnp.moveaxis(b, 1, 0)))
        y = jnp.einsum("sbdn,sbn->bsd", hs, jnp.moveaxis(C, 1, 0))
        return h, y

    def j_chunks(t):
        return jnp.moveaxis(t.reshape(B, n_chunks, Lc, *t.shape[2:]), 1, 0)

    jh, jys = jax.lax.scan(j_outer, jnp.zeros((B, D, 4)),
                           (j_chunks(xs), j_chunks(Cs)))
    th, tys = _chunked(torch.from_numpy(A), n_chunks, Lc)(
        torch.from_numpy(xs), torch.from_numpy(Cs))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-6,
                               atol=1e-6)


def test_repeat_multiplies_work_not_memory():
    """Under ``repeat(5)`` a (64, 64) matmul counts 5 · 2 · 64³ flops and 5
    times its bytes; the peak counts its output once."""
    x = torch.empty((64, 64), device="meta")
    with CostCounter() as once:
        x @ x
    with CostCounter() as c:
        with c.repeat(5):
            x @ x
    assert c.totals()["flops"] == 5 * once.totals()["flops"] == 5 * 2 * 64 ** 3
    assert c.totals()["bytes_accessed"] == 5 * once.totals()["bytes_accessed"]
    assert c.totals()["peak_bytes"] == once.totals()["peak_bytes"] \
        == 64 * 64 * 4


def _toy_counts(kind, mode, n):
    """Counts of one toy scan on meta tensors: ``mode`` is "forward",
    "grad" (backward too) or "remat" (the scan inside
    ``torch.utils.checkpoint``, recomputed in backward)."""
    grad = mode != "forward"
    dev = "meta"
    if kind == "lstm":
        params = (torch.empty(D, 4 * D, device=dev, requires_grad=grad),
                  torch.empty(B, n, 4 * D, device=dev, requires_grad=grad))

        def loss_fn(w, xs):
            c0 = tuple(torch.zeros(B, D, device=dev) for _ in range(2))
            (h, c), hs = scan(_lstm_step(w), c0, xs.movedim(1, 0))
            return (hs.movedim(0, 1) ** 2).sum() + c.sum()
    else:
        n_chunks, Lc = n, n + 1
        params = (torch.empty(D, 4, device=dev, requires_grad=grad),
                  torch.empty(B, n_chunks * Lc, D, device=dev,
                              requires_grad=grad),
                  torch.empty(B, n_chunks * Lc, 4, device=dev,
                              requires_grad=grad))

        def loss_fn(A, xs, Cs):
            h, ys = _chunked(A, n_chunks, Lc)(xs, Cs)
            return (ys ** 2).sum() + h.sum()
    with torch.set_grad_enabled(grad), CostCounter() as c:
        if mode == "remat":
            loss = checkpoint(loss_fn, *params, use_reentrant=False)
        else:
            loss = loss_fn(*params)
        if grad:
            loss.backward()
        live = c.live_bytes
    return dict(c.totals(), live_bytes=live)


def _spy_repeat(monkeypatch):
    """Record (the scan's caller, n) of every ``repeat`` scope entered."""
    import sys

    calls = []
    repeat = CostCounter.repeat

    def spy(self, n, carry=()):
        scan_frame = sys._getframe(1)
        if scan_frame.f_code.co_name == "scan":
            calls.append((scan_frame.f_back.f_code.co_name, n))
        return repeat(self, n, carry)

    monkeypatch.setattr(CostCounter, "repeat", spy)
    return calls


@pytest.mark.parametrize("n", [6, 9])
@pytest.mark.parametrize("mode", ["forward", "grad", "remat"])
@pytest.mark.parametrize("kind", ["lstm", "nested"])
def test_counted_scan_counts_as_the_unrolled_loop(kind, mode, n,
                                                  monkeypatch):
    """Flops, bytes accessed, collectives and the live bytes left of the
    counted scan equal the unrolled loop's exactly: the middle step's
    backward and the gradient sums it feeds count n − 4 times, and the
    storages it keeps stand for the other steps'. The peak is equal in
    forward; with backward it is at least the unrolled loop's and at most
    ``held_bytes`` above it (``launch/cost.py``). The counted path ran:
    one ``repeat(n − 4)`` a scan (the chunk scan's in ``run``, its five
    steps' position scans in ``outer``), and none unrolled. Nested scans
    multiply (the chunks' scans inside the chunk scan's middle step count
    (n − 4)² times)."""
    calls = _spy_repeat(monkeypatch)
    got = _toy_counts(kind, mode, n)
    want_calls = [("loss_fn", n - 4)] if kind == "lstm" else \
        [("run", n - 4)] + [("outer", n + 1 - 4)] * 5
    # checkpoint's recompute in backward runs the scans again
    assert sorted(calls) == sorted(want_calls * (2 if mode == "remat" else 1))
    _unrolled(monkeypatch)
    del calls[:]
    want = _toy_counts(kind, mode, n)
    assert calls == []
    peak, want_peak = got.pop("peak_bytes"), want.pop("peak_bytes")
    held = got.pop("held_bytes")
    assert want.pop("held_bytes") == 0
    assert got == want
    if mode == "forward":
        assert peak == want_peak
    else:
        assert want_peak <= peak <= want_peak + held
    assert got["flops"] > 0


# The recurrent blocks as Python loops, as the modules ran them before
# ``scan``: the reference for the blocks' values and gradient layouts.

def _slstm_loop(params, x, cfg):
    B, S, d = x.shape
    H = cfg.num_heads
    xn = layers.rms_norm(x, params["norm"], cfg.norm_eps)
    xg = (xn @ params["w_x"] + params["bias"]).float()
    state = xlstm.init_slstm_cache(cfg, B, x.dtype, x.device)
    state = (state["h"], state["c"], state["n"], state["m"])
    hs = []
    for t in range(S):
        state = xlstm._slstm_cell(params, xg[:, t], state, H, d // H)
        hs.append(state[0])
    out = xlstm._slstm_out(params, torch.stack(hs, dim=1), x, cfg)
    return out, dict(zip(("h", "c", "n", "m"), state))


def _mlstm_loop(params, x, cfg, chunk=256):
    B, S, _ = x.shape
    H = cfg.num_heads
    q, k, v, i_g, f_g, z, xm = xlstm._mlstm_qkvif(params, x, cfg)
    di = z.shape[-1]
    dh = di // H
    Lc = layers.chunk_len(S, chunk)
    state = (torch.zeros((B, H, dh, dh)), torch.zeros((B, H, dh)),
             torch.full((B, H), xlstm.M0))
    hs = []
    for s0 in range(0, S, Lc):
        sl = slice(s0, s0 + Lc)
        h, state = xlstm._mlstm_chunk(q[:, sl], k[:, sl], v[:, sl],
                                      i_g[:, sl], f_g[:, sl], state)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, di)
    h = layers.rms_norm(h.to(x.dtype), params["out_norm"], cfg.norm_eps)
    h = h * F.silu(z)
    conv = torch.cat([xm.new_zeros((B, 3, di)), xm], dim=1)[:, -3:, :]
    cache = {"C": state[0], "n": state[1], "m": state[2], "conv": conv}
    return x + h @ params["down"], cache


def _ssm_loop(params, xin, cfg, chunk=256):
    B, S, di = xin.shape
    dt, B_ssm, C_ssm = mamba._ssm_inputs(params, xin, cfg)
    h = torch.zeros((B, di, cfg.mamba_d_state))
    Lc = layers.chunk_len(S, chunk)
    ys = []
    for s0 in range(0, S, Lc):
        sl = slice(s0, s0 + Lc)
        a, b = mamba._scan_elements(params, dt[:, sl], xin[:, sl],
                                    B_ssm[:, sl])
        out = torch.empty_like(b)
        for t in range(a.shape[1]):
            h = torch.addcmul(b[:, t], a[:, t], h)
            out[:, t] = h
        ys.append(torch.einsum("bsdn,bsn->bsd", out, C_ssm[:, sl]))
    return torch.cat(ys, dim=1) + params["D"] * xin.float(), h


def _loss_grads_prefill(cfg):
    params = model_zoo.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in data.SyntheticLMData(
        cfg.vocab_size, 32, 4, seed=1).batch_at(0).items()}
    loss, _, grads = value_and_grad(cfg, params, batch)
    with torch.no_grad():
        out = model_zoo.prefill_fn(cfg, params, batch)
    return [loss.detach()] + [g.detach() for g in tree_leaves(grads)] + [
        t for t in torch.utils._pytree.tree_leaves(out)
        if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_blocks_equal_their_loops_with_gradients(arch, dtype, monkeypatch):
    """The smoke config's loss, every gradient leaf (the groups under
    ``torch.utils.checkpoint``) and the prefill's outputs, 32 tokens in
    chunks of 8, equal bit for bit those of the blocks run as the Python
    loops ``scan`` replaced: the steps slice their inputs and the outputs
    are laid out as the loops did, so autograd's sums and products see the
    same layouts."""
    chunk_len = layers.chunk_len
    monkeypatch.setattr(layers, "chunk_len", lambda S, _=256: chunk_len(S, 8))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    got = _loss_grads_prefill(cfg)
    monkeypatch.setattr(xlstm, "slstm_block", _slstm_loop)
    monkeypatch.setattr(xlstm, "mlstm_block", _mlstm_loop)
    monkeypatch.setattr(mamba, "_ssm", _ssm_loop)
    want = _loss_grads_prefill(cfg)
    assert len(got) == len(want) > 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))
