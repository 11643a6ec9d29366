"""The port's xLSTM (``models/xlstm.py`` and the ``xlstm`` groups of
``models/transformer.py``) against the JAX package on the CPU: the mLSTM
block (chunked forward, one chunk and several; the recurrent decode step)
and the sLSTM block (forward, decode step) on converted weights, then the
xlstm-350m smoke config end to end — prefill and 8 decode steps with every
cache leaf, the port's own teacher-forced contract, the parameter-tree
conversion, the counts and MODEL_FLOPS, and ``RealServer``. Float32, 1e-5
(sums in other orders on the two frameworks' CPU backends) where not
stated otherwise."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_family_parity as fam  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import layers, model_zoo, xlstm  # noqa: E402

ARCH = "xlstm-350m"
TOL = fam.TOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(cfg, S, seed):
    return np.random.default_rng(seed).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)


def _block(kind, seed=0):
    """(port cfg, JAX cfg, JAX params, port params) of one block."""
    jcfg = j_smoke(ARCH)
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return get_smoke_config(ARCH), jcfg, jp, fam.to_torch(jp)


@pytest.mark.parametrize("S,chunk", [(20, 256), (24, 8), (20, 8)])
def test_mlstm_forward_matches_jax(S, chunk):
    """One chunk, three chunks, and a chunk halved until it divides S
    (20 → 4): the cross-chunk (C, n, m) carry."""
    cfg, jcfg, jp, tp = _block("mlstm")
    x = _x(cfg, S, 1)
    want = jx.mlstm_forward(jp, jnp.asarray(x), jcfg, chunk=chunk)
    got = xlstm.mlstm_forward(tp, torch.from_numpy(x), cfg, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert layers.chunk_len(20, 8) == 4 and layers.chunk_len(512) == 256


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_jax(kind):
    """8 recurrent steps from the zero state: each output and the final
    state (every cache leaf) equal the JAX package's."""
    cfg, jcfg, jp, tp = _block(kind, seed=2)
    x = _x(cfg, 8, 3)
    jmod = {"mlstm": (jx.init_mlstm_cache, jx.mlstm_decode_step),
            "slstm": (jx.init_slstm_cache, jx.slstm_decode_step)}[kind]
    tmod = {"mlstm": (xlstm.init_mlstm_cache, xlstm.mlstm_decode_step),
            "slstm": (xlstm.init_slstm_cache, xlstm.slstm_decode_step)}[kind]
    jc = jmod[0](jcfg, 2, jnp.float32)
    tc = tmod[0](cfg, 2, torch.float32, "cpu")
    for i in range(8):
        jo, jc = jmod[1](jp, jnp.asarray(x[:, i:i + 1]), jc, jcfg)
        to, tc = tmod[1](tp, torch.from_numpy(x[:, i:i + 1]), tc, cfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    fam.assert_tree_close({k: v.numpy() for k, v in tc.items()}, jc)


def test_slstm_forward_matches_jax():
    cfg, jcfg, jp, tp = _block("slstm", seed=4)
    x = _x(cfg, 20, 5)
    want = jx.slstm_forward(jp, jnp.asarray(x), jcfg)
    got = xlstm.slstm_forward(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_state_continues_forward(kind):
    """The port's prefill contract per block: the end state a block's
    forward leaves, stepped on by decode, gives the forward of the longer
    sequence (1e-4: a chunked sum against a recurrence)."""
    cfg, _, _, tp = _block(kind, seed=6)
    x = torch.from_numpy(_x(cfg, 16, 7))
    block = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    step = xlstm.mlstm_decode_step if kind == "mlstm" \
        else xlstm.slstm_decode_step
    full, _ = block(tp, x, cfg)
    _, cache = block(tp, x[:, :12], cfg)
    for i in range(12, 16):
        out, cache = step(tp, x[:, i:i + 1], cache, cfg)
        torch.testing.assert_close(out[:, 0], full[:, i], rtol=1e-4,
                                   atol=1e-4)


def test_prefill_and_decode_match_jax():
    fam.check_prefill_and_decode(ARCH)


def test_decode_matches_teacher_forced_prefill():
    """The port's own PD contract: the prompt fed token by token through
    decode gives prefill's last logits and prefill's end states (1e-4:
    chunked sums against recurrences)."""
    cfg, _, _, tp = fam.models(ARCH)
    toks = torch.from_numpy(fam.batch(cfg, seed=8)["tokens"])
    ref, pc = model_zoo.prefill_fn(cfg, tp, {"tokens": toks})
    caches = model_zoo.init_decode_caches(cfg, fam.B, fam.S, device="cpu")
    for i in range(fam.S):
        lg, caches = model_zoo.decode_fn(cfg, tp, toks[:, i:i + 1], caches, i)
    torch.testing.assert_close(lg, ref, rtol=1e-4, atol=1e-4)
    fam.assert_tree_close(fam.stacked(caches), fam.stacked(pc), rtol=1e-4,
                          atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_converts_exactly(dtype):
    tp = fam.check_convert_round_trip(ARCH, dtype)
    assert tp["blocks"][0]["l1"]["w_h"].dtype == getattr(torch, dtype)
    assert set(tp["blocks"][0]) == {"l0", "l1"}


def test_counts_and_flops_equal_jax():
    """525,852,670 parameters at the published size. The reference's sLSTM
    term counts its gated MLP as ``d * (4 * d) // 3 * 2``, which Python
    reads as ((4d²) // 3) · 2, against the 2 · d · (4d // 3) weights it
    makes: 42 more a sLSTM layer at the smoke config's d = 64 (two
    layers)."""
    d = get_smoke_config(ARCH).d_model
    extra = d * (4 * d) // 3 * 2 - 2 * d * ((4 * d) // 3)
    assert extra == 42
    fam.check_counts(ARCH, want=525_852_670, overcount=2 * extra)


def test_recurrent_caches_in_model_dtype():
    """mLSTM's conv tail is in the model's dtype, every other state
    float32, in prefill's caches and the zeroed ones alike."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    tp = model_zoo.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 6), dtype=torch.int32)
    _, pc = model_zoo.prefill_fn(cfg, tp, {"tokens": toks})
    zc = model_zoo.init_decode_caches(cfg, 1, 6, device="cpu")
    for caches in (pc, zc):
        assert {k: v.dtype for k, v in caches[0]["l0"].items()} == {
            "C": torch.float32, "n": torch.float32, "m": torch.float32,
            "conv": torch.bfloat16}
        assert {v.dtype for v in caches[0]["l1"].values()} == {torch.float32}


def test_server_matches_jax():
    fam.check_server(ARCH)


def test_cli_serves_on_cpu(capsys):
    fam.check_cli(ARCH, capsys)
