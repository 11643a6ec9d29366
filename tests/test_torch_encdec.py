"""The port's encoder-decoder (``models/encdec.py``, the seamless-m4t
backbone) and ``attention_forward``'s ``kv_override`` against the JAX
package on the CPU: cross-attention with Sq ≠ Sk, the encoder, the
teacher-forced decoder, then the seamless smoke config end to end —
prefill and 8 decode steps with every cache leaf, the reference's
decode-consistency contract with ``ck``/``cv`` filled from the encoder,
the parameter-tree conversion, the counts and MODEL_FLOPS, and
``RealServer`` with its stub frames. Float32, 1e-5 where not stated
otherwise."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_family_parity as fam  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention, encdec, model_zoo  # noqa: E402

ARCH = "seamless-m4t-large-v2"
TOL = fam.TOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return fam.models(ARCH)


def _frames(cfg, S, seed):
    return np.random.default_rng(seed).normal(
        size=(fam.B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("Sq,Sk,causal", [(12, 20, False), (20, 12, False),
                                          (16, 16, True), (1, 9, False)])
def test_attention_kv_override_matches_jax(model, Sq, Sk, causal):
    """Cross-attention: q from x, k/v the override's, no rotary embedding
    on either; Sq ≠ Sk. Returns the override's k/v."""
    cfg, jcfg, jp, tp = model
    jl, tl = jp["decoder"], tp["decoder"][0]
    jpa = jax.tree_util.tree_map(lambda a: a[0], jl["cross_attn"])
    x = _frames(cfg, Sq, 1)
    hd = cfg.resolved_head_dim
    kv = np.random.default_rng(2).normal(
        size=(2, fam.B, Sk, cfg.num_kv_heads, hd)).astype(np.float32)
    pos = np.arange(Sq, dtype=np.int32)
    kpos = np.arange(Sk, dtype=np.int32)
    jo, (jk, _) = jattn.attention_forward(
        jpa, jnp.asarray(x), jcfg, jnp.asarray(pos), causal=causal,
        kv_override=(jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                     jnp.asarray(kpos)))
    k, v = torch.from_numpy(kv[0]), torch.from_numpy(kv[1])
    to, (tk, tv) = attention.attention_forward(
        tl["cross_attn"], torch.from_numpy(x), cfg, torch.from_numpy(pos),
        causal=causal, kv_override=(k, v, torch.from_numpy(kpos)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert tk is k and tv is v


def test_encoder_matches_jax(model):
    cfg, jcfg, jp, tp = model
    f = _frames(cfg, 20, 3)
    np.testing.assert_allclose(
        encdec.encode(tp, cfg, torch.from_numpy(f)).numpy(),
        np.asarray(jed.encode(jp, jcfg, jnp.asarray(f))), **TOL)


def test_decoder_forward_matches_jax(model):
    """Every position's logits of the teacher-forced decoder (the prefill
    keeps only the last) and its caches, over an encoder output of
    another length."""
    cfg, jcfg, jp, tp = model
    enc = _frames(cfg, 12, 4)
    toks = fam.batch(cfg, seed=5)["tokens"]
    jl, jc = jed.decoder_forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(enc))
    tl, tc = encdec.decoder_forward(tp, cfg, torch.from_numpy(toks),
                                    torch.from_numpy(enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    fam.assert_tree_close(fam.stacked(tc), jc)


def test_prefill_and_decode_match_jax():
    fam.check_prefill_and_decode(ARCH)


def test_decode_consistency_with_cross_kv_filled(model):
    """The reference's test_encdec_decode_consistency on the port: with
    ck/cv built from the encoder output per layer, the prompt fed token by
    token through decode gives prefill's last logits (here within 1e-4,
    the reference's test takes 2e-2) and prefill's self k/v."""
    cfg, _, _, tp = model
    b = fam.batch(cfg, seed=6)
    frames, toks = torch.from_numpy(b["frames"]), torch.from_numpy(b["tokens"])
    ref, pc = encdec.encdec_prefill(tp, cfg, frames, toks)
    enc_out = encdec.encode(tp, cfg, frames)
    caches = encdec.init_encdec_caches(cfg, fam.B, fam.S + 4, fam.S,
                                       torch.float32, "cpu")
    for p, c in zip(tp["decoder"], caches):
        c["ck"], c["cv"] = encdec._cross_kv(p, enc_out, cfg)
    for i in range(fam.S):
        lg, caches = encdec.encdec_decode_step(tp, cfg, toks[:, i:i + 1],
                                               caches, i)
    torch.testing.assert_close(lg, ref, rtol=1e-4, atol=1e-4)
    for c, p in zip(caches, pc):
        for name in ("k", "v"):
            torch.testing.assert_close(c[name][:, :fam.S], p[name], rtol=1e-4,
                                       atol=1e-4)
            assert not c[name][:, fam.S:].any()


def test_prefill_logits_are_the_last_position(model):
    """encdec_prefill runs the head on the last position only: the same
    values as the reference's full (B, S, V) logits sliced."""
    cfg, jcfg, jp, tp = model
    b = fam.batch(cfg, seed=7)
    enc = jed.encode(jp, jcfg, jnp.asarray(b["frames"]))
    full, _ = jed.decoder_forward(jp, jcfg, jnp.asarray(b["tokens"]), enc)
    last, _ = encdec.encdec_prefill(tp, cfg, torch.from_numpy(b["frames"]),
                                    torch.from_numpy(b["tokens"]))
    np.testing.assert_allclose(last.numpy(), np.asarray(full[:, -1:]), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_converts_exactly(dtype):
    tp = fam.check_convert_round_trip(ARCH, dtype)
    cfg = get_smoke_config(ARCH)
    assert len(tp["encoder"]) == cfg.encoder_layers
    assert len(tp["decoder"]) == cfg.num_layers - cfg.encoder_layers
    assert tp["decoder"][0]["cross_attn"]["wq"].dtype == getattr(torch, dtype)


def test_counts_and_flops_equal_jax():
    """1,283,457,024 parameters at the published size."""
    fam.check_counts(ARCH, want=1_283_457_024)


def test_encdec_caches_and_frames_dtype():
    """init_decode_caches makes the cross ck/cv max_len long, as the
    reference; RealServer's stub frames are in the model's dtype, so a
    bfloat16 model prefills (the reference's float32 frames make its
    bfloat16 prefill raise)."""
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    c = model_zoo.init_decode_caches(cfg, 2, 11, device="cpu")
    assert len(c) == cfg.num_layers - cfg.encoder_layers
    assert {k: tuple(v.shape) for k, v in c[0].items()} == {
        k: (2, 11, cfg.num_kv_heads, cfg.resolved_head_dim)
        for k in ("k", "v", "ck", "cv")}
    assert {v.dtype for v in c[0].values()} == {torch.bfloat16}
    server = serve.RealServer(cfg, VectorPoolConfig(**fam.POOL),
                              rag_interval=0, device="cpu")
    seen = {}
    prefill = server._prefill

    def spy(p, b):
        seen["frames"] = b["frames"]
        return prefill(p, b)

    server._prefill = spy
    toks, _ = server.generate(np.zeros((2, 6), np.int32), max_new=2)
    assert toks.shape == (2, 2)
    assert seen["frames"].dtype == torch.bfloat16
    assert torch.equal(seen["frames"], torch.full_like(seen["frames"], 0.1))


def test_server_matches_jax():
    fam.check_server(ARCH)


def test_cli_serves_on_cpu(capsys):
    fam.check_cli(ARCH, capsys)
