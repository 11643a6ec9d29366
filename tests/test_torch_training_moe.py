"""The port's training of the DeepSeek family against the JAX package on
the CPU: the MoE under autograd (the router's gradient through the gates'
scatter into their slots, the load-balancing aux loss returned), then the
two smoke configs end to end — deepseek-moe-16b (MoE) and deepseek-v3-671b
(MLA, MoE aux, MTP): loss, metrics and every gradient leaf from converted
weights, and five ``Trainer`` steps. Tolerances are in
``torch_training_parity.py``."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_training_parity as tp  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_grads_match(arch):
    """Σ out · r + aux through moe_forward: the gradients of the router,
    every expert stack, the shared experts and the tokens."""
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    _, _, jp, _ = tp.models(arch)
    params = tp.layer_params(jp, "blocks", "l0", "mlp")
    x = np.random.default_rng(4).normal(size=(40, cfg.d_model)).astype(
        np.float32)
    tp.check_block_grads(lambda p, xx: j_moe.moe_forward(p, xx, jcfg),
                         lambda p, xx: moe.moe_forward(p, xx, cfg),
                         params, x)


def test_mlp_apply_returns_the_moe_aux():
    """The training path's _mlp_apply returns moe_forward's aux loss; a
    dense layer's is 0."""
    cfg = get_smoke_config("deepseek-moe-16b")
    p = transformer.init_lm_params(cfg, 0, device="cpu")["blocks"][0]
    x = torch.randn((2, 8, cfg.d_model))
    y, aux = transformer._mlp_apply(p, x, cfg, use_moe=True)
    want_y, want_aux = moe.moe_forward(p["mlp"], x.reshape(16, -1), cfg)
    assert torch.equal(y, want_y.reshape(2, 8, -1))
    assert torch.equal(aux, want_aux) and float(aux) > 0
    dense = get_smoke_config("phi3-medium-14b")
    pd = transformer.init_lm_params(dense, 0, device="cpu")["blocks"][0]
    assert transformer._mlp_apply(pd, torch.randn((1, 3, dense.d_model)),
                                  dense, use_moe=False)[1] == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch):
    grads = tp.check_loss_and_grads(arch)
    router = grads["blocks"][0]["mlp"]["router"]
    assert float(router.abs().max()) > 0  # the gates' scatter carried it


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_steps_match(arch):
    tp.check_trainer(arch)
