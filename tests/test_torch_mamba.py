"""The port's mamba block (``models/mamba.py``) and the jamba
mamba/attention hybrid (the ``mamba_attn`` groups of
``models/transformer.py``) against the JAX package on the CPU: the causal
conv and its state, the chunked scan (one chunk and several), the block's
forward and decode step on converted weights, then the jamba smoke config
end to end — prefill and 8 decode steps with every cache leaf, the port's
own teacher-forced contract, the parameter-tree conversion (``A_log`` and
``D`` float32 in a bfloat16 tree), the counts and MODEL_FLOPS (the
published config and the one-group, 8-expert cut the card serves), and
``RealServer``. Float32, 1e-5 where not stated otherwise: the port's scan
is a loop over a chunk's positions, the reference's an associative tree,
so the sums run in other orders."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_family_parity as fam  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import mamba as jm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import mamba, model_zoo, transformer  # noqa: E402

ARCH = "jamba-1.5-large-398b"
TOL = fam.TOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(seed=0):
    """(port cfg, JAX cfg, JAX params, port params) of one mamba mixer."""
    jcfg = j_smoke(ARCH)
    jp = jm.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return get_smoke_config(ARCH), jcfg, jp, fam.to_torch(jp)


def _x(cfg, S, seed, width=None):
    return np.random.default_rng(seed).normal(
        size=(2, S, width or cfg.d_model)).astype(np.float32)


def test_causal_conv_and_its_state_match_jax():
    cfg, jcfg, jp, tp = _layer()
    di = cfg.mamba_expand * cfg.d_model
    x = _x(cfg, 7, 1, di)
    state = _x(cfg, cfg.mamba_d_conv - 1, 2, di)
    for st in (None, state):
        jo, js = jm._causal_conv(jp, jnp.asarray(x), jcfg,
                                 None if st is None else jnp.asarray(st))
        to, ts = mamba._causal_conv(tp, torch.from_numpy(x), cfg,
                                    None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("S,chunk", [(20, 256), (24, 8), (20, 8)])
def test_forward_matches_jax(S, chunk):
    """One chunk, three chunks, and a chunk halved until it divides S
    (20 → 4): h carried across chunks."""
    cfg, jcfg, jp, tp = _layer(seed=3)
    x = _x(cfg, S, 4)
    want = jm.mamba_forward(jp, jnp.asarray(x), jcfg, chunk=chunk)
    got = mamba.mamba_forward(tp, torch.from_numpy(x), cfg, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunked_scan_end_state_matches_jax():
    """The end state h of the chunked scan, against the reference's
    ``_chunked_linear_scan`` on the same (a, b)."""
    cfg, jcfg, jp, tp = _layer(seed=5)
    di = cfg.mamba_expand * cfg.d_model
    xin = _x(cfg, 24, 6, di)
    ja, jb, _ = jm._ssm_inputs(jp, jnp.asarray(xin), jcfg)
    h0 = jnp.zeros((2, di, cfg.mamba_d_state), jnp.float32)
    _, jh = jm._chunked_linear_scan(ja, jb, h0, 8)
    _, th = mamba._ssm(tp, torch.from_numpy(xin), cfg, chunk=8)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_decode_steps_match_jax():
    """8 recurrent steps from the zero state: each output and the final
    h and conv state equal the JAX package's."""
    cfg, jcfg, jp, tp = _layer(seed=7)
    x = _x(cfg, 8, 8)
    jc = jm.init_mamba_cache(jcfg, 2, jnp.float32)
    tc = mamba.init_mamba_cache(cfg, 2, torch.float32, "cpu")
    for i in range(8):
        jo, jc = jm.mamba_decode_step(jp, jnp.asarray(x[:, i:i + 1]), jc, jcfg)
        to, tc = mamba.mamba_decode_step(tp, torch.from_numpy(x[:, i:i + 1]),
                                         tc, cfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    fam.assert_tree_close({k: v.numpy() for k, v in tc.items()}, jc)


def test_block_state_continues_forward():
    """The end state the prefill block leaves, stepped on by decode, gives
    the forward of the longer sequence (1e-4: a chunked scan against a
    recurrence)."""
    cfg, _, _, tp = _layer(seed=9)
    x = torch.from_numpy(_x(cfg, 16, 10))
    full, _ = mamba.mamba_block(tp, x, cfg, chunk=4)
    _, cache = mamba.mamba_block(tp, x[:, :12], cfg, chunk=4)
    for i in range(12, 16):
        out, cache = mamba.mamba_decode_step(tp, x[:, i:i + 1], cache, cfg)
        torch.testing.assert_close(out[:, 0], full[:, i], rtol=1e-4,
                                   atol=1e-4)


def test_group_layout():
    """jamba's group: attention at attn_every // 2, mamba elsewhere, the
    MoE every moe_every-th layer and a dense swiglu between."""
    cfg = get_smoke_config(ARCH)
    assert transformer.group_layer_kinds(cfg) == ["mamba", "attn"]
    full = dataclasses.replace(cfg, attn_every=8)
    assert transformer.group_layer_kinds(full) == ["mamba"] * 4 + ["attn"] \
        + ["mamba"] * 3
    tp = model_zoo.init_params(cfg, device="cpu")
    assert len(tp["blocks"]) == transformer.num_groups(cfg) == 2
    assert set(tp["blocks"][0]["l0"]["mlp"]) == {"router", "w_gate", "w_up",
                                                  "w_down"}
    assert set(tp["blocks"][0]["l1"]["mlp"]) == {"wi_gate", "wi_up", "wo"}
    assert "mamba" in tp["blocks"][0]["l0"] and "attn" in tp["blocks"][0]["l1"]


def test_prefill_and_decode_match_jax():
    """Prefill within 1e-5; the decode steps within 3e-5: the libm exp
    and log the port's scan elements take differ from XLA's by an ulp or
    two, and each step's state carries the difference on through the
    group's 4 layers and its MoE (1.51e-5 at worst over the 8 steps)."""
    fam.check_prefill_and_decode(ARCH, decode_tol=dict(rtol=3e-5, atol=3e-5))


def test_decode_matches_teacher_forced_prefill():
    """The port's own PD contract: the prompt fed token by token through
    decode gives prefill's last logits, k/v and end states (1e-4). The
    smoke config's capacity factor 4.0 drops no token at prefill
    (asserted)."""
    from repro_torch.models import moe

    cfg, _, _, tp = fam.models(ARCH)
    assert moe.capacity_for(fam.B * fam.S, cfg) >= fam.B * fam.S
    toks = torch.from_numpy(fam.batch(cfg, seed=11)["tokens"])
    ref, pc = model_zoo.prefill_fn(cfg, tp, {"tokens": toks})
    caches = model_zoo.init_decode_caches(cfg, fam.B, fam.S, device="cpu")
    for i in range(fam.S):
        lg, caches = model_zoo.decode_fn(cfg, tp, toks[:, i:i + 1], caches, i)
    torch.testing.assert_close(lg, ref, rtol=1e-4, atol=1e-4)
    fam.assert_tree_close(fam.stacked(caches), fam.stacked(pc), rtol=1e-4,
                          atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_converts_exactly(dtype):
    """A_log, D and the router stay float32 in a bfloat16 tree, as the
    reference's init makes them; casting them would be a parity fault."""
    tp = fam.check_convert_round_trip(ARCH, dtype)
    m = tp["blocks"][0]["l0"]["mamba"]
    assert m["A_log"].dtype == m["D"].dtype == torch.float32
    assert tp["blocks"][0]["l0"]["mlp"]["router"].dtype == torch.float32
    assert m["in_proj"].dtype == m["dt_bias"].dtype == getattr(torch, dtype)


def test_counts_and_flops_equal_jax():
    """The published config and the cut the card serves (one group of 8
    layers, 8 of the 16 experts, every width kept): 25,910,362,112
    parameters."""
    fam.check_counts(ARCH, want=25_910_362_112, cut=lambda c: dict(
        num_layers=8, moe=dataclasses.replace(c.moe, num_experts=8)))
    from repro.configs import get_config as j_full
    from repro.models import model_zoo as j_zoo
    from repro_torch.configs import get_config

    for active in (False, True):
        assert model_zoo.analytic_param_count(get_config(ARCH), active) == \
            j_zoo.analytic_param_count(j_full(ARCH), active)


def test_recurrent_caches_in_model_dtype():
    """mamba's conv tail is in the model's dtype and h float32, in
    prefill's caches and the zeroed ones alike; k/v in the model's
    dtype."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    tp = model_zoo.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 6), dtype=torch.int32)
    _, pc = model_zoo.prefill_fn(cfg, tp, {"tokens": toks})
    zc = model_zoo.init_decode_caches(cfg, 1, 6, device="cpu")
    for caches in (pc, zc):
        assert {k: v.dtype for k, v in caches[1]["l0"].items()} == {
            "h": torch.float32, "conv": torch.bfloat16}
        assert {v.dtype for v in caches[1]["l1"].values()} == {torch.bfloat16}


def test_server_matches_jax():
    fam.check_server(ARCH)


def test_cli_serves_on_cpu(capsys):
    fam.check_cli(ARCH, capsys)
