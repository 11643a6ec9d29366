"""The port's MLA (``models/mla.py``) and blocked attention
(``attention.attend_blocked``, ``gqa_scores``, ``gqa_values``) against the
JAX package's on the CPU: ``mla_forward`` and the cache it returns, each of
8 ``mla_decode_step``s (output and cache), a decode step past the cache
(writes nothing), at the deepseek-v3 smoke config's widths and at its MLA
dims over more heads. Float32, 1e-5; inputs from numpy seeds, the JAX
parameters carried across."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention, mla  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v3-671b"
# the smoke config, and its MLA over 8 heads of d_model 128
WIDTHS = {"smoke": {}, "wide": dict(d_model=128, num_heads=8, num_kv_heads=8)}


@pytest.fixture(scope="module", params=list(WIDTHS))
def layer(request):
    """(port cfg, JAX cfg, JAX params, port params) of one MLA layer."""
    change = WIDTHS[request.param]
    jcfg = dataclasses.replace(j_smoke(ARCH), **change)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **change)
    jp = jmla.init_mla(jax.random.PRNGKey(3), jcfg, jnp.float32)
    # the norms are zero at init: give them values so they count
    rng = np.random.default_rng(4)
    jp = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1)
              if k.endswith("norm") else v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    return cfg, jcfg, jp, tp


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def test_mla_forward_and_cache_match_jax(layer):
    cfg, jcfg, jp, tp = layer
    x = _x(cfg, 2, 24, seed=0)
    jo, jc = jmla.mla_forward(jp, jnp.asarray(x), jcfg)
    to, tc = mla.mla_forward(tp, torch.from_numpy(x), cfg)
    assert to.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert set(tc) == {"ckv", "kr"}
    for name in tc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_mla_decode_steps_match_jax(layer):
    """Each of 8 absorbed decode steps: output and the whole cache."""
    cfg, jcfg, jp, tp = layer
    x = _x(cfg, 2, 8, seed=1)
    jc = jmla.init_mla_cache(jcfg, 2, 10, jnp.float32)
    tc = mla.init_mla_cache(cfg, 2, 10, torch.float32, "cpu")
    step = jax.jit(lambda p, xs, c, n: jmla.mla_decode_step(p, xs, c, n, jcfg))
    for i in range(8):
        jo, jc = step(jp, jnp.asarray(x[:, i:i + 1]), jc, jnp.int32(i))
        to, same = mla.mla_decode_step(tp, torch.from_numpy(x[:, i:i + 1]),
                                       tc, i, cfg)
        assert same is tc  # updated in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for name in tc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                       **TOL)


def test_mla_decode_matches_prefill(layer):
    """The prompt fed token by token through the absorbed decode gives the
    naive prefill's outputs and cache (the two forms are one function; 1e-4
    as the sums run in another order)."""
    cfg, _, _, tp = layer
    x = torch.from_numpy(_x(cfg, 2, 12, seed=2))
    ref, pc = mla.mla_forward(tp, x, cfg)
    tc = mla.init_mla_cache(cfg, 2, 16, torch.float32, "cpu")
    for i in range(12):
        out, _ = mla.mla_decode_step(tp, x[:, i:i + 1], tc, i, cfg)
        torch.testing.assert_close(out[:, 0], ref[:, i], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tc["ckv"][:, :12], pc["ckv"])
    assert not tc["ckv"][:, 12:].any()


def test_mla_decode_past_the_cache_writes_nothing(layer):
    """cur_len at S_max writes nothing, attends over the whole cache, and
    equals the JAX package's step there."""
    cfg, jcfg, jp, tp = layer
    x = _x(cfg, 2, 5, seed=3)
    jc = jmla.init_mla_cache(jcfg, 2, 4, jnp.float32)
    tc = mla.init_mla_cache(cfg, 2, 4, torch.float32, "cpu")
    for i in range(4):
        jo, jc = jmla.mla_decode_step(jp, jnp.asarray(x[:, i:i + 1]), jc,
                                      jnp.int32(i), jcfg)
        mla.mla_decode_step(tp, torch.from_numpy(x[:, i:i + 1]), tc, i, cfg)
    before = {k: v.clone() for k, v in tc.items()}
    jo, jc = jmla.mla_decode_step(jp, jnp.asarray(x[:, 4:5]), jc, jnp.int32(4),
                                  jcfg)
    to, _ = mla.mla_decode_step(tp, torch.from_numpy(x[:, 4:5]), tc, 4, cfg)
    assert all(torch.equal(before[k], tc[k]) for k in tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_mla_sequence_sharded_decode_raises(layer):
    """seq_axis outside an ``activation_sharding`` context over a device
    mesh takes the unsharded path, as the reference's does with no mesh in
    its context (it raised before the mesh code was ported): the same
    output and cache, bit for bit; the sharded path is
    ``test_torch_seqshard.py``'s."""
    cfg, _, _, tp = layer
    x = torch.from_numpy(_x(cfg, 1, 1, seed=5))
    outs = []
    for seq_axis in (None, "model"):
        tc = mla.init_mla_cache(cfg, 1, 4, torch.float32, "cpu")
        out, tc = mla.mla_decode_step(tp, x, tc, 0, cfg, seq_axis=seq_axis)
        outs.append((out, tc))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(outs[0][1][k], outs[1][1][k]) for k in tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,H,Hkv,hd,hd_v,causal,block_q", [
    (24, 24, 4, 4, 24, 16, True, 512),   # MLA's smoke dims
    (40, 40, 8, 2, 16, 16, True, 16),    # GQA, several q blocks
    (12, 30, 4, 1, 8, 12, False, 4),     # cross-length, not causal
    (48, 48, 2, 2, 192, 128, True, 32),  # deepseek-v3's qk 192, v 128
])
def test_attend_blocked_matches_jax(dtype, Sq, Sk, H, Hkv, hd, hd_v, causal,
                                    block_q):
    """attend_blocked, gqa_scores and gqa_values with their dtype casts:
    float32 at 1e-5; bfloat16 at 2e-2 (the output rounds to bfloat16)."""
    rng = np.random.default_rng(Sq + H)
    q, k = (rng.normal(size=(2, s, h, hd)).astype(np.float32)
            for s, h in ((Sq, H), (Sk, Hkv)))
    v = rng.normal(size=(2, Sk, Hkv, hd_v)).astype(np.float32)
    qpos = np.arange(Sk - Sq, Sk, dtype=np.int32) if Sq <= Sk \
        else np.arange(Sq, dtype=np.int32)
    kpos = np.arange(Sk, dtype=np.int32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    J = [jnp.asarray(a, jd) for a in (q, k, v)]
    T = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    jo = jattn.attend_blocked(J[0], J[1], J[2], jnp.asarray(qpos),
                              jnp.asarray(kpos), causal, block_q=block_q,
                              seq_parallel=0)
    to = attention.attend_blocked(T[0], T[1], T[2], torch.from_numpy(qpos),
                                  torch.from_numpy(kpos), causal,
                                  block_q=block_q)
    assert to.shape == (2, Sq, H, hd_v) and to.dtype == td
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               **tol)
    js = jattn.gqa_scores(J[0], J[1])
    ts = attention.gqa_scores(T[0], T[1])
    np.testing.assert_allclose(ts.float().numpy(), np.asarray(js, np.float32),
                               **tol)
    probs = rng.random(ts.shape).astype(np.float32)
    np.testing.assert_allclose(
        attention.gqa_values(torch.from_numpy(probs).to(td), T[2]).float().numpy(),
        np.asarray(jattn.gqa_values(jnp.asarray(probs, jd), J[2]), np.float32),
        **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,H,Hkv,hd,M,block_q", [
    (16, 16, 8, 2, 16, 4, 512),   # one q block per row shard
    (32, 32, 8, 2, 16, 4, 4),     # two q blocks per row shard
    (24, 40, 4, 1, 8, 4, 2),      # Sq != Sk, three blocks per shard
    (48, 48, 2, 2, 24, 8, 4),     # M 8, hd_v 16 below
    (10, 10, 4, 2, 8, 4, 512),    # M does not divide Sq: M = 1
])
def test_attend_blocked_seq_parallel_matches_jax(dtype, causal, Sq, Sk, H,
                                                 Hkv, hd, M, block_q):
    """attend_blocked at seq_parallel=M (the query rows split M ways on a
    leading dim, each shard in blocks) against the JAX package's at the
    same M: float32 at 1e-5, bfloat16 at 2e-2; and against the port's own
    seq_parallel=0 at the same tolerances."""
    rng = np.random.default_rng(Sq * M + H)
    hd_v = 16 if M == 8 else hd
    q, k = (rng.normal(size=(2, s, h, hd)).astype(np.float32)
            for s, h in ((Sq, H), (Sk, Hkv)))
    v = rng.normal(size=(2, Sk, Hkv, hd_v)).astype(np.float32)
    qpos = np.arange(Sk - Sq, Sk, dtype=np.int32) if Sq <= Sk \
        else np.arange(Sq, dtype=np.int32)
    kpos = np.arange(Sk, dtype=np.int32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    J = [jnp.asarray(a, jd) for a in (q, k, v)]
    T = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    tp = (torch.from_numpy(qpos), torch.from_numpy(kpos))
    jo = jattn.attend_blocked(J[0], J[1], J[2], jnp.asarray(qpos),
                              jnp.asarray(kpos), causal, block_q=block_q,
                              seq_parallel=M)
    to = attention.attend_blocked(*T, *tp, causal, block_q=block_q,
                                  seq_parallel=M)
    assert to.shape == (2, Sq, H, hd_v) and to.dtype == td
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               **tol)
    one = attention.attend_blocked(*T, *tp, causal, block_q=block_q,
                                   seq_parallel=0)
    np.testing.assert_allclose(to.float().numpy(), one.float().numpy(), **tol)
