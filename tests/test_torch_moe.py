"""The port's MoE (``models/moe.py``) against the JAX package's on the CPU:
``moe_forward``'s output and aux loss on both DeepSeek smoke configs
(float32, 1e-5; the JAX parameters carried across), the routing indices
exactly (forced ties break to the lower expert id, as ``jax.lax.top_k``
does), the capacity drop path with an explicit small capacity, and
``capacity_for`` over a range of token counts. Inputs from numpy seeds."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _moe_params(arch, seed=0):
    """(port cfg, JAX cfg, JAX params, port params) of one MoE layer."""
    jcfg = j_smoke(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), jax.device_get(jp))
    return get_smoke_config(arch), jcfg, jp, tp


def _tokens(cfg, T, seed):
    return np.random.default_rng(seed).normal(
        size=(T, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("T", [1, 2, 40, 128])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, T):
    cfg, jcfg, jp, tp = _moe_params(arch)
    x = _tokens(cfg, T, seed=T)
    jo, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    to, taux = moe.moe_forward(tp, torch.from_numpy(x), cfg)
    assert to.shape == (T, cfg.d_model) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_topk_indices_exact_with_ties(arch):
    """Routing indices equal the JAX package's exactly, also where logits
    tie (whole rows equal, pairs equal at the top-k boundary); gates within
    float32 rounding."""
    cfg = get_smoke_config(arch)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(64, E)).astype(np.float32)
    logits[:8] = 0.5  # every expert tied
    logits[8:16, 3] = logits[8:16, 5] = 9.0  # a tied pair on top
    logits[16:24] = np.round(logits[16:24])  # many ties at the boundary
    jg, ji = jmoe.route_topk(jnp.asarray(logits), k)
    tg, ti = moe.route_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    assert (ti[:8] == torch.arange(k)).all()  # lower expert ids first


@pytest.mark.parametrize("capacity", [8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_jax(arch, capacity):
    """An explicit small capacity drops pairs (each expert keeps its first
    ``capacity`` pairs in token order); the survivors' combine equals the
    JAX package's."""
    cfg, jcfg, jp, tp = _moe_params(arch, seed=2)
    T = 96  # 96 * k pairs over E experts: far above 8 or 16 an expert
    x = _tokens(cfg, T, seed=3)
    _, idx = moe.route_topk(torch.from_numpy(x) @ tp["router"], cfg.moe.top_k)
    occupancy = torch.bincount(idx.reshape(-1), minlength=cfg.moe.num_experts)
    assert (occupancy > capacity).any()  # the drop path is taken
    jo, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg, capacity=capacity)
    to, taux = moe.moe_forward(tp, torch.from_numpy(x), cfg, capacity=capacity)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    full, _ = moe.moe_forward(tp, torch.from_numpy(x), cfg)
    assert not torch.allclose(full, to)  # dropping changed the output


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_for_matches_jax(arch):
    for get, jget in ((get_smoke_config, j_smoke), (get_config, j_full)):
        cfg, jcfg = get(arch), jget(arch)
        for T in list(range(1, 70)) + [127, 128, 129, 512, 2048, 4096]:
            assert moe.capacity_for(T, cfg) == jmoe.capacity_for(T, jcfg), T
    assert moe.capacity_for(4 * 512, get_config("deepseek-moe-16b")) == 240
    assert moe.capacity_for(4 * 512, get_config("deepseek-v3-671b")) == 80
    assert moe.capacity_for(4, get_config("deepseek-v3-671b")) == 8


def test_bfloat16_moe_keeps_router_float32():
    """In a bfloat16 model the router's weights and logits stay float32 and
    the experts are bfloat16, as in the JAX package; the output is
    bfloat16 and within bfloat16 rounding of the JAX package's."""
    arch = "deepseek-moe-16b"
    jcfg = dataclasses.replace(j_smoke(arch), dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    tp = moe.init_moe(gen, cfg, torch.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert {tp[n].dtype for n in ("w_gate", "w_up", "w_down")} == {torch.bfloat16}
    assert tp["w_gate"].shape == (8, 64, 48) and tp["w_down"].shape == (8, 48, 64)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    assert jp["router"].dtype == jnp.float32
    x = _tokens(cfg, 40, seed=4)
    jo, _ = jmoe.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            torch.float32 if a.dtype == jnp.float32 else torch.bfloat16),
        jax.device_get(jp))
    to, _ = moe.moe_forward(tp, torch.from_numpy(x).bfloat16(), cfg)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), rtol=2e-2, atol=2e-2)


def test_combine_is_deterministic():
    cfg, _, _, tp = _moe_params("deepseek-v3-671b")
    x = torch.from_numpy(_tokens(cfg, 128, seed=5))
    a, _ = moe.moe_forward(tp, x, cfg)
    b, _ = moe.moe_forward(tp, x, cfg)
    assert torch.equal(a, b)
