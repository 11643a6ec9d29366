"""Checks shared by the training parity files (``test_torch_training*.py``):
one smoke config's loss, metrics and gradients, ``forward_train``, and a
few ``Trainer`` steps, through the port and the JAX package on the CPU, on
one set of weights (the JAX package's, carried across by
``convert.lm_params_from_numpy``; the port's gradients carried back by
``convert.lm_params_to_numpy``), in float32 or, with ``dtype="bfloat16"``,
at the published configs' dtype."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import model_zoo as j_zoo
from repro.models import transformer as j_transformer
from repro.training.data import SyntheticEncDecData as JEncDecData
from repro.training.data import SyntheticLMData as JLMData
from repro.training.optimizer import AdamWConfig as JAdamW
from repro.training.train_loop import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import model_zoo, transformer
from repro_torch.training.data import SyntheticEncDecData, SyntheticLMData
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer, value_and_grad

B, S = 2, 24
LOSS_RTOL = 1e-5  # loss and metrics, relative
GRAD_TOL = 1e-4  # each gradient leaf, of its leaf's max |g|
HIST_RTOL = 1e-4  # Trainer loss histories, relative
# bfloat16, set from what these checks read on the CPU (the xlstm-350m,
# phi3-medium-14b and seamless-m4t-large-v2 smoke configs): loss and
# metrics 0.9e-4–1.5e-4 apart, each gradient leaf within 0.020–0.125 of
# its max |g|, all leaves 0.015–0.057 apart in norm, five Trainer losses
# within 2.3e-3. XLA fuses elementwise ops and rounds once where eager
# torch rounds after every op (``jax.nn.silu`` is one rounding under jit,
# two op by op), so the JAX package's own jit and op-by-op runs differ
# about as much, and a float32 run of the port is about as close. These
# catch a wrong dtype and gross errors; the casts are held bit for bit
# where both round alike (``test_torch_training.py``: ``attend_blocked``
# and AdamW on bfloat16 leaves).
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_TOL = 0.25  # each leaf, of its max |g|
BF16_GRAD_NORM = 0.1  # |g_port - g_jax| / |g_jax| over all leaves
BF16_HIST_RTOL = 1e-2


def flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in flat(t, f"{path}/{k}").items()}
    return {path: np.asarray(tree, np.float32)}


def leaf_dtypes(tree, path=""):
    """Each leaf's dtype by name, ``bfloat16`` whether numpy holds it as
    ``ml_dtypes``' type or as two raw bytes (``convert.BF16_VOID``)."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in leaf_dtypes(t, f"{path}/{k}").items()}
    dt = np.asarray(tree).dtype
    return {path: "bfloat16" if dt == convert.BF16_VOID else dt.name}


def configs(arch, dtype="float32"):
    """(port cfg, JAX cfg): the smoke config in ``dtype``."""
    return (dataclasses.replace(get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(j_smoke(arch), dtype=dtype))


def models(arch, seed=0, dtype="float32"):
    """(port cfg, JAX cfg, JAX params, port params on the CPU)."""
    cfg, jcfg = configs(arch, dtype)
    jp = j_zoo.init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jp, convert.lm_params_from_numpy(
        cfg, jax.device_get(jp), device="cpu")


def data(cfg, seq, batch, seed, port=True):
    """The synthetic pipeline ``launch/train.py`` gives ``cfg``."""
    if model_zoo.is_encdec(cfg):
        cls = SyntheticEncDecData if port else JEncDecData
        return cls(cfg.vocab_size, seq, batch, cfg.d_model, seed=seed)
    cls = SyntheticLMData if port else JLMData
    return cls(cfg.vocab_size, seq, batch, seed=seed)


def batch(cfg, seed=1):
    """Numpy batch 0 of ``data``; a frontend of normal draws where the
    config splices one in (internvl2)."""
    out = data(cfg, S, B, seed).batch_at(0)
    if cfg.frontend_tokens > 0:
        out["frontend"] = np.random.default_rng(seed).normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jax_batch(b, jcfg):
    """The batch for the JAX package: the frames in the model's dtype, as
    the port casts them (the reference raises on float32 frames in a
    bfloat16 model, ROADMAP C6)."""
    out = {k: jnp.asarray(v) for k, v in b.items()}
    if "frames" in out:
        out["frames"] = out["frames"].astype(jcfg.dtype)
    return out


def check_forward_train(cfg, jcfg, jp, tp_, b):
    """forward_train's (logits, aux, hidden) have the JAX package's dtypes
    and, in float32, its values within LOSS_RTOL of the largest; ``_xent``
    of the logits equals the JAX package's."""
    frontend = b.get("frontend")
    jl, jaux, jh = jax.jit(lambda p, t, f: j_transformer.forward_train(
        p, jcfg, t, f))(jp, jnp.asarray(b["tokens"]),
                        None if frontend is None else jnp.asarray(frontend))
    with torch.no_grad():
        tl, taux, th = transformer.forward_train(
            tp_, cfg, torch.from_numpy(b["tokens"]),
            None if frontend is None else torch.from_numpy(frontend))
    assert [str(t.dtype).removeprefix("torch.") for t in (tl, taux, th)] \
        == [np.asarray(a).dtype.name for a in (jl, jaux, jh)]
    if cfg.dtype != "float32":
        return
    labels = np.maximum(b["labels"], 0)
    mask = (b["labels"] >= 0).astype(np.float32)
    for got, want in ((tl, jl), (taux, jaux), (th, jh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LOSS_RTOL * np.abs(want).max())
    np.testing.assert_allclose(
        float(transformer._xent(tl, torch.from_numpy(labels),
                                torch.from_numpy(mask))),
        float(j_transformer._xent(jl, jnp.asarray(labels),
                                  jnp.asarray(mask))), rtol=LOSS_RTOL)


def check_loss_and_grads(arch, dtype="float32"):
    """loss_fn's loss and metrics within LOSS_RTOL, every gradient leaf
    within GRAD_TOL of its leaf's max |g|, same keys and dtypes (the
    BF16_* tolerances in bfloat16); forward_train as
    ``check_forward_train`` has it."""
    cfg, jcfg, jp, tp_ = models(arch, dtype=dtype)
    bf16 = dtype == "bfloat16"
    b = batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, x: j_zoo.loss_fn(jcfg, p, x), has_aux=True))(
        jp, _jax_batch(b, jcfg))
    tl, tm, tg = value_and_grad(cfg, tp_, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
    assert tm.keys() == jm.keys()
    rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    for k in jm:
        assert tm[k].dtype == torch.float32, k
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=rtol, atol=1e-7, err_msg=k)
    assert leaf_dtypes(convert.lm_params_to_numpy(tg, keep_dtype=True)) \
        == leaf_dtypes(jax.device_get(jg))
    got, want = flat(convert.lm_params_to_numpy(tg)), flat(
        jax.device_get(jg))
    assert got.keys() == want.keys()
    tol = BF16_GRAD_TOL if bf16 else GRAD_TOL
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=tol * np.abs(want[k]).max(),
                                   err_msg=k)
    if bf16:
        diff = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
        norm = sum(float(np.sum(want[k] ** 2)) for k in want)
        assert np.sqrt(diff / norm) <= BF16_GRAD_NORM
    if not model_zoo.is_encdec(cfg):
        check_forward_train(cfg, jcfg, jp, tp_, b)
    return tg


def check_trainer(arch, steps=5, dtype="float32"):
    """``steps`` Trainer steps from the JAX Trainer's initial weights give
    loss histories within HIST_RTOL (BF16_HIST_RTOL in bfloat16)."""
    cfg, jcfg = configs(arch, dtype)
    jtr = JTrainer(jcfg, data(cfg, 16, 4, 2, port=False),
                   JAdamW(lr=1e-3, warmup_steps=2))
    params = convert.lm_params_from_numpy(cfg, jax.device_get(jtr.params),
                                          device="cpu")
    tr = Trainer(cfg, data(cfg, 16, 4, 2), AdamWConfig(lr=1e-3,
                                                       warmup_steps=2),
                 device="cpu", params=params)
    got = tr.run(steps, log=None)
    want = jtr.run(steps, log=None)
    assert len(got) == steps and tr.step == steps
    np.testing.assert_allclose(
        got, want, rtol=BF16_HIST_RTOL if dtype == "bfloat16" else HIST_RTOL)
    return got


def layer_params(jp, *path, i=0):
    """Layer ``i`` of a stacked JAX subtree (``jp[path...]``) as numpy."""
    tree = jp
    for k in path:
        tree = tree[k]
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[i],
                                  jax.device_get(tree))


def check_block_grads(jfn, tfn, params, x, seed=0):
    """The gradients of Σ out · r (+ aux where the block returns (out,
    aux)) with respect to every parameter of a block and its input, the
    JAX block ``jfn(params, x)`` against the port's ``tfn``, each within
    GRAD_TOL of its leaf's max |g|; the objective within LOSS_RTOL."""
    def split(o):
        return o if isinstance(o, tuple) else (o, 0.0)

    out, _ = split(jax.eval_shape(jfn, params, jnp.asarray(x)))
    r = np.random.default_rng(seed).normal(size=out.shape).astype(np.float32)

    def jobj(p, xx):
        o, aux = split(jfn(p, xx))
        return jnp.sum(o.astype(jnp.float32) * r) + aux

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jobj, argnums=(0, 1)))(
        params, jnp.asarray(x))
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), params)
    tx = torch.from_numpy(np.array(x)).requires_grad_(True)
    o, aux = split(tfn(tparams, tx))
    tl = torch.sum(o.float() * torch.from_numpy(r)) + aux
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    got = flat(jax.tree_util.tree_map(lambda t: t.grad.numpy(), tparams))
    got["x"] = tx.grad.numpy()
    want = flat(jax.device_get(jgp))
    want["x"] = np.asarray(jgx)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=GRAD_TOL * np.abs(want[k]).max(),
                                   err_msg=k)
