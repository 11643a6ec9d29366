"""Checks shared by the model-family parity files (``test_torch_xlstm.py``,
``test_torch_mamba.py``, ``test_torch_encdec.py``): one smoke config through
the port and the JAX package on the CPU, on one set of weights (the JAX
package's, carried across by ``convert.lm_params_from_numpy``).

The port's caches are lists of per-group (or per-layer) dicts; the JAX
package's are one dict of leaves stacked on a leading group (layer) axis.
``stacked`` brings the port's into that layout so every leaf is compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import VectorPoolConfig as JPoolConfig
from repro.launch.serve import RealServer as JServer
from repro.models import model_zoo as j_zoo
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES, VectorPoolConfig
from repro_torch.launch import serve
from repro_torch.models import model_zoo

B, S = 2, 20
TOL = dict(rtol=1e-5, atol=1e-5)
POOL = dict(num_vectors=1500, dim=64, max_requests=16, top_m=16,
            task_batch=512, visited_slots=256, top_k=5)


def to_torch(tree):
    """A JAX parameter subtree as float32 CPU tensors."""
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)),
        jax.device_get(tree))


def models(arch, seed=0):
    """(port cfg, JAX cfg, JAX params, port params on the CPU)."""
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    jp = j_zoo.init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jp, convert.lm_params_from_numpy(
        cfg, jax.device_get(jp), device="cpu")


def batch(cfg, seed=0, length=S):
    """Numpy prompts (and the encoder's frames under encdec)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(B, length)).astype(np.int32)}
    if model_zoo.is_encdec(cfg):
        out["frames"] = rng.normal(size=(B, length, cfg.d_model)).astype(
            np.float32)
    return out


def stacked(caches):
    """The port's list of per-group dicts as the JAX layout: each leaf
    stacked on a leading axis, as float32 numpy."""
    if isinstance(caches[0], dict):
        return {k: stacked([c[k] for c in caches]) for k in caches[0]}
    return np.stack([c.detach().float().numpy() for c in caches])


def flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in flat(t, f"{path}/{k}").items()}
    return {path: np.asarray(tree, np.float32)}


def assert_tree_close(got, want, **tol):
    """Every leaf of ``got`` (JAX layout) against ``want``'s, same keys."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **(tol or TOL))


def check_prefill_and_decode(arch, steps=8, decode_tol=None):
    """Prefill's logits and every cache leaf, then ``steps`` decode steps
    from zeroed caches (each step's logits, every leaf at the end), equal
    to the JAX package's within TOL (the decode steps within
    ``decode_tol`` where given)."""
    cfg, jcfg, jp, tp = models(arch)
    b = batch(cfg)
    jl, jc = j_zoo.prefill_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tc = model_zoo.prefill_fn(cfg, tp, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_tree_close(stacked(tc), jc)

    toks = batch(cfg, seed=1)["tokens"]
    decode = jax.jit(lambda p, t, c, n: j_zoo.decode_fn(jcfg, p, t, c, n))
    jc = j_zoo.init_decode_caches(jcfg, B, steps + 2)
    tc = model_zoo.init_decode_caches(cfg, B, steps + 2, device="cpu")
    assert_tree_close(stacked(tc), jc, rtol=0, atol=0)
    for i in range(steps):
        jl, jc = decode(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.int32(i))
        tl, tc = model_zoo.decode_fn(cfg, tp, torch.from_numpy(
            toks[:, i:i + 1]), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **(decode_tol or TOL))
    assert_tree_close(stacked(tc), jc, **(decode_tol or TOL))


def check_convert_round_trip(arch, dtype):
    """A JAX tree in ``dtype`` converts bit for bit, each leaf in the dtype
    the port's own init gives it, and back."""
    jcfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp = jax.device_get(j_zoo.init_params(jcfg, jax.random.PRNGKey(2)))
    tp = convert.lm_params_from_numpy(cfg, jp, device="cpu")
    assert dtypes(tp) == dtypes(model_zoo.init_params(cfg, device="cpu"))
    assert_tree_close(convert.lm_params_to_numpy(tp), jp, rtol=0, atol=0)
    again = convert.lm_params_from_numpy(
        cfg, convert.lm_params_to_numpy(tp), device="cpu")
    assert dtypes(again) == dtypes(tp)
    assert all(torch.equal(a, b) for a, b in zip(leaves(again), leaves(tp)))
    return tp


def leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def dtypes(tree, path=""):
    """{leaf path: dtype} of a port parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree.dtype}
    return {p: d for k, v in items for p, d in dtypes(v, f"{path}/{k}").items()}


# leaves the analytic count leaves out: norms, biases, the conv biases
UNCOUNTED = ("ln1", "ln2", "lnx", "bq", "bk", "bv", "conv_b", "b_if", "bias",
             "dt_bias")


def counted_weights(tree, name=""):
    if isinstance(tree, dict):
        return sum(counted_weights(v, k) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(counted_weights(v) for v in tree)
    if name.endswith("norm") or name in UNCOUNTED:
        return 0
    return tree.numel()


def check_counts(arch, want, cut=None, overcount=0):
    """The analytic counts (all and active) of the smoke config equal the
    JAX package's and the port's real number of weights plus
    ``overcount`` (what the reference's formula counts beyond the weights
    it makes); those of the published config (``cut`` replacing fields of
    both) equal the JAX package's and ``want``, and MODEL_FLOPS at every
    shape too."""
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    n = model_zoo.analytic_param_count(cfg)
    assert n == j_zoo.analytic_param_count(jcfg) == cfg.param_count()
    assert counted_weights(model_zoo.init_params(cfg, device="cpu")) \
        + overcount == n
    cfg, jcfg = get_config(arch), j_full(arch)
    if cut:
        cfg = dataclasses.replace(cfg, **cut(cfg))
        jcfg = dataclasses.replace(jcfg, **cut(jcfg))
    for active in (False, True):
        assert model_zoo.analytic_param_count(cfg, active) == \
            j_zoo.analytic_param_count(jcfg, active)
    assert model_zoo.analytic_param_count(cfg) == want
    for name in SHAPES:
        assert model_zoo.model_flops(cfg, SHAPES[name]) == \
            j_zoo.model_flops(jcfg, J_SHAPES[name])


def check_server(arch, max_new=6):
    """RealServer's greedy tokens and probes equal the JAX server's on the
    same weights, and a second call gives the same tokens."""
    jserver = JServer(j_smoke(arch), JPoolConfig(**POOL), rag_interval=4)
    cfg = get_smoke_config(arch)
    params = convert.lm_params_from_numpy(
        cfg, jax.device_get(jserver.params), device="cpu")
    tserver = serve.RealServer(cfg, VectorPoolConfig(**POOL), rag_interval=4,
                               device="cpu", params=params)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jt, js = jserver.generate(prompts, max_new=max_new)
    tt, ts = tserver.generate(prompts, max_new=max_new)
    np.testing.assert_array_equal(tt, jt)
    assert (ts["rag_probes"], ts["stalls"]) == (js["rag_probes"], js["stalls"])
    again, _ = tserver.generate(prompts, max_new=max_new)
    np.testing.assert_array_equal(again, tt)


def check_cli(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "1",
                "--prompt-len", "16", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "generated tokens (first request):" in out and "ttft_s" in out
