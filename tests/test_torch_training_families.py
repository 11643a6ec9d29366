"""The port's training of xLSTM, the jamba mamba hybrid and the seamless
encoder-decoder against the JAX package on the CPU: the recurrent blocks
under autograd (the mLSTM over several chunks, the sLSTM's time loop, the
mamba scan written in place chunk by chunk), then each smoke config end to
end — loss, metrics and every gradient leaf from converted weights, and
five ``Trainer`` steps. Tolerances are in ``torch_training_parity.py``."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_training_parity as tp  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import mamba, xlstm  # noqa: E402

ARCHS = ["xlstm-350m", "jamba-1.5-large-398b", "seamless-m4t-large-v2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(cfg, S, seed=5):
    return np.random.default_rng(seed).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)


def test_mlstm_chunk_gradient_finite_where_the_reference_is_nan():
    """ROADMAP C9: with the forget gates at -30 the decay spreads 210 over
    an 8-position chunk, so the reference's exp of the whole square
    overflows above the diagonal and its gradient is NaN; the port masks
    the exponent first: the same forward, finite gradients."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    B, Lc, H, dh = 1, 8, 2, 4
    arrays = [rng.normal(size=(B, Lc, H, dh)).astype(np.float32)
              for _ in range(3)]
    arrays += [rng.normal(size=(B, Lc, H)).astype(np.float32),
               np.full((B, Lc, H), -30.0, np.float32)]
    state = (np.zeros((B, H, dh, dh), np.float32),
             np.zeros((B, H, dh), np.float32),
             np.full((B, H), xlstm.M0, np.float32))
    r = rng.normal(size=(B, Lc, H, dh)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(j_xlstm._mlstm_chunk(
            *a, tuple(map(jnp.asarray, state)))[0] * r)

    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))
    assert any(np.isnan(np.asarray(g)).any() for g in jgrads)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    h, end = xlstm._mlstm_chunk(*leaves, tuple(map(torch.from_numpy, state)))
    jh, jend = j_xlstm._mlstm_chunk(*map(jnp.asarray, arrays),
                                    tuple(map(jnp.asarray, state)))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(end, jend):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    torch.sum(h * torch.from_numpy(r)).backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)


@pytest.mark.parametrize("chunk", [8, 256])
def test_mlstm_grads_match(chunk):
    """The chunkwise mLSTM under autograd: 24 positions in chunks of 8 (the
    state carried across chunks) and in one."""
    arch = "xlstm-350m"
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    params = tp.layer_params(tp.models(arch)[2], "blocks", "l0")
    tp.check_block_grads(
        lambda p, x: j_xlstm.mlstm_forward(p, x, jcfg, chunk),
        lambda p, x: xlstm.mlstm_forward(p, x, cfg, chunk), params,
        _x(cfg, 24))


def test_slstm_grads_match():
    """The sLSTM's time loop under autograd (its first step's n = 1 tie
    splits the gradient as jnp.maximum does)."""
    arch = "xlstm-350m"
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    i = cfg.xlstm_pattern.index("slstm")
    params = tp.layer_params(tp.models(arch)[2], "blocks", f"l{i}")
    tp.check_block_grads(lambda p, x: j_xlstm.slstm_forward(p, x, jcfg),
                         lambda p, x: xlstm.slstm_forward(p, x, cfg),
                         params, _x(cfg, 20))


@pytest.mark.parametrize("chunk", [4, 256])
def test_mamba_scan_grads_match(chunk):
    """The selective scan under autograd: each chunk's h written in place
    position by position (20 positions in chunks of 4, and in one)."""
    arch = "jamba-1.5-large-398b"
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    params = tp.layer_params(tp.models(arch)[2], "blocks", "l0", "mamba")
    tp.check_block_grads(
        lambda p, x: j_mamba.mamba_forward(p, x, jcfg, chunk),
        lambda p, x: mamba.mamba_forward(p, x, cfg, chunk), params,
        _x(cfg, 20))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch):
    tp.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_steps_match(arch):
    tp.check_trainer(arch)

