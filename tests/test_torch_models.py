"""The port's models against the JAX package on the CPU: layers,
attention, the transformer stack and the model zoo on the smoke configs of
every attention-block arch (``block_kind="attn"``: the five dense GQA
archs and the DeepSeek family: MoE, MLA, MTP), with the JAX parameters
carried across by ``convert.lm_params_from_numpy``. The xLSTM, mamba
hybrid and encoder-decoder families have files of their own
(``test_torch_xlstm.py``, ``test_torch_mamba.py``,
``test_torch_encdec.py``). Float32 throughout; 1e-5 where the two
compute the same sums (matmuls in another order on the two frameworks'
CPU backends), looser where stated. A layer's cache is {"k", "v"} (GQA) or
{"ckv", "kr"} (MLA)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model_zoo as j_zoo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.models import layers, model_zoo, transformer  # noqa: E402

# the attention-block archs: their caches are per-layer {"k", "v"} or
# {"ckv", "kr"}, as the tests below read them
ARCHS = [a for a in list_archs() if get_smoke_config(a).block_kind == "attn"]
B, S = 2, 20
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).clone()


@pytest.fixture(scope="module")
def models():
    """arch -> (port cfg, JAX params, port params on the CPU)."""
    out = {}
    for arch in ARCHS:
        jp = j_zoo.init_params(j_smoke(arch), jax.random.PRNGKey(0))
        cfg = get_smoke_config(arch)
        out[arch] = (cfg, jp, convert.lm_params_from_numpy(
            cfg, jax.device_get(jp), device="cpu"))
    return out


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend_tokens > 0:
        batch["frontend"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        _np(j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    pos = np.arange(5, dtype=np.int32) + 7
    cos, sin = layers.rope_angles(_t(pos), 32, 10000.0)
    jcos, jsin = j_layers.rope_angles(jnp.asarray(pos), 32, 10000.0)
    np.testing.assert_allclose(cos.numpy(), _np(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), _np(jsin), **TOL)
    np.testing.assert_allclose(
        layers.apply_rope(_t(x), cos, sin).numpy(),
        _np(j_layers.apply_rope(jnp.asarray(x), jcos, jsin)), **TOL)
    mlp = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
           (("wi_gate", (32, 48)), ("wi_up", (32, 48)), ("wo", (48, 32)))}
    xm = rng.normal(size=(2, 5, 32)).astype(np.float32)
    for kind in ("swiglu", "geglu"):
        np.testing.assert_allclose(
            layers.gated_mlp({k: _t(v) for k, v in mlp.items()}, _t(xm),
                             kind).numpy(),
            _np(j_layers.gated_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                                   jnp.asarray(xm), kind)), **TOL)
    assert layers.padded_vocab(151655) == j_layers.padded_vocab(151655)
    logits = rng.normal(size=(2, 1, 2048)).astype(np.float32)
    np.testing.assert_array_equal(
        layers.mask_padded_logits(_t(logits), 512).numpy(),
        _np(j_layers.mask_padded_logits(jnp.asarray(logits), 512)))


def test_init_distributions_and_placement():
    """Random init follows the JAX package's distributions: dense kernels
    N(0, 1/d_in), embeddings N(0, 0.02²), norms and biases zero, in
    cfg.dtype; the same seed gives the same weights."""
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-32b"), d_model=256,
                              d_ff=512, num_layers=1)
    p = model_zoo.init_params(cfg, seed=3, device="cpu")
    again = model_zoo.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(p["blocks"][0]["mlp"]["wo"],
                       again["blocks"][0]["mlp"]["wo"])
    wq = p["blocks"][0]["attn"]["wq"]
    assert wq.shape == (256, 256) and wq.dtype == torch.float32
    assert abs(wq.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(p["embed"].std().item() - 0.02) < 0.001
    assert not p["blocks"][0]["ln1"].any() and not p["final_norm"].any()
    assert not p["blocks"][0]["attn"]["bq"].any()
    assert p["embed"].shape == (transformer.lm_head_vocab(cfg), 256)


# ---------------------------------------------------------------------------
# prefill / decode against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, models):
    cfg, jp, tp = models[arch]
    batch = _batch(cfg)
    jl, jc = j_zoo.prefill_fn(j_smoke(arch), jp,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = model_zoo.prefill_fn(cfg, tp, {k: _t(v) for k, v in batch.items()})
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    assert len(tc) == cfg.num_layers
    for i, c in enumerate(tc):
        assert set(c) == set(jc["l0"])
        for name in c:
            np.testing.assert_allclose(c[name].numpy(),
                                       _np(jc["l0"][name][i]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, models):
    """Each decode step's logits and caches equal the JAX package's."""
    cfg, jp, tp = models[arch]
    jcfg = j_smoke(arch)
    toks = _batch(cfg, seed=1)["tokens"]
    steps = 8
    decode = jax.jit(lambda p, t, c, n: j_zoo.decode_fn(jcfg, p, t, c, n))
    jc = j_zoo.init_decode_caches(jcfg, B, steps + 2)
    tc = model_zoo.init_decode_caches(cfg, B, steps + 2, device="cpu")
    for i in range(steps):
        jl, jc = decode(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.int32(i))
        tl, tc = model_zoo.decode_fn(cfg, tp, _t(toks[:, i:i + 1]), tc, i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for i, c in enumerate(tc):
        assert set(c) == set(jc["l0"])
        for name in c:
            np.testing.assert_allclose(c[name].numpy(),
                                       _np(jc["l0"][name][i]), **TOL)


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if get_smoke_config(a).frontend_tokens == 0])
def test_decode_matches_teacher_forced_prefill(arch, models):
    """The port's own PD contract: the prompt fed token by token through
    decode gives prefill's last logits, and the decode cache holds
    prefill's k/v (ckv/kr under MLA) (the JAX package's
    test_decode_matches_teacher_forced_forward; 1e-4 as sums run in
    another order). Under MoE this holds only where capacity drops no
    token at prefill: the smoke configs' capacity_factor 4.0 drops none
    (asserted), decode never drops (capacity >= 8 slots for B tokens)."""
    cfg, _, tp = models[arch]
    toks = _t(_batch(cfg, seed=2)["tokens"])
    if cfg.mlp_kind == "moe":
        from repro_torch.models import moe

        assert moe.capacity_for(B * S, cfg) >= B * S  # no expert can overflow
    ref, pc = model_zoo.prefill_fn(cfg, tp, {"tokens": toks})
    caches = model_zoo.init_decode_caches(cfg, B, S + 4, device="cpu")
    for i in range(S):
        lg, caches = model_zoo.decode_fn(cfg, tp, toks[:, i:i + 1], caches, i)
    torch.testing.assert_close(lg, ref, rtol=1e-4, atol=1e-4)
    for c, p in zip(caches, pc):
        for name in c:
            torch.testing.assert_close(c[name][:, :S], p[name], rtol=1e-4,
                                       atol=1e-4)
            assert not c[name][:, S:].any()


def test_decode_past_the_cache_writes_nothing(models):
    """cur_len at or past S_max writes nothing (the JAX package's masked
    write) and attends over the whole cache."""
    cfg, _, tp = models["phi3-medium-14b"]
    caches = model_zoo.init_decode_caches(cfg, B, 4, device="cpu")
    tok = torch.ones((B, 1), dtype=torch.int32)
    for i in range(4):
        model_zoo.decode_fn(cfg, tp, tok, caches, i)
    before = [c["k"].clone() for c in caches]
    lg, _ = model_zoo.decode_fn(cfg, tp, tok, caches, 4)
    assert all(torch.equal(b, c["k"]) for b, c in zip(before, caches))
    assert torch.isfinite(lg).all()


def test_mla_model_decode_past_the_cache_matches_jax(models):
    """The same at the model level under MLA and MoE (deepseek-v3's smoke
    config), each step's logits equal to the JAX package's."""
    arch = "deepseek-v3-671b"
    cfg, jp, tp = models[arch]
    jcfg = j_smoke(arch)
    jc = j_zoo.init_decode_caches(jcfg, B, 4)
    caches = model_zoo.init_decode_caches(cfg, B, 4, device="cpu")
    toks = _batch(cfg, seed=6)["tokens"]
    for i in range(5):
        if i == 4:
            before = [{k: v.clone() for k, v in c.items()} for c in caches]
        jl, jc = j_zoo.decode_fn(jcfg, jp, jnp.asarray(toks[:, i:i + 1]), jc,
                                 jnp.int32(i))
        tl, caches = model_zoo.decode_fn(cfg, tp, _t(toks[:, i:i + 1]),
                                         caches, i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    assert all(torch.equal(b[k], c[k]) for b, c in zip(before, caches)
               for k in c)


# gemma-7b's structure at its head dim: GeGLU, tied embeddings, as many kv
# heads as query heads, hd 256 (the path of the flash_wgmma256 kernel on the
# card), cut to 2 layers of d_model 512 and 2 heads
GEMMA_HD256 = dict(num_layers=2, d_model=512, num_heads=2, num_kv_heads=2,
                   head_dim=256, d_ff=1024)


@pytest.fixture(scope="module")
def gemma_hd256():
    """(JAX cfg, port cfg, JAX params, port params on the CPU)."""
    jcfg = dataclasses.replace(j_smoke("gemma-7b"), **GEMMA_HD256)
    cfg = dataclasses.replace(get_smoke_config("gemma-7b"), **GEMMA_HD256)
    jp = j_zoo.init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, cfg, jp, convert.lm_params_from_numpy(
        cfg, jax.device_get(jp), device="cpu")


def test_gemma_hd256_prefill_matches_jax(gemma_hd256):
    jcfg, cfg, jp, tp = gemma_hd256
    assert cfg.resolved_head_dim == 256 and cfg.mlp_kind == "geglu"
    batch = _batch(cfg, seed=3)
    jl, jc = j_zoo.prefill_fn(jcfg, jp,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = model_zoo.prefill_fn(cfg, tp, {k: _t(v) for k, v in batch.items()})
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for i, c in enumerate(tc):
        np.testing.assert_allclose(c["k"].numpy(), _np(jc["l0"]["k"][i]), **TOL)


def test_gemma_hd256_greedy_decode_matches_jax(gemma_hd256):
    """The prompt fed through decode, then greedy tokens: each step's logits
    within the file's tolerance and the same tokens on both sides."""
    jcfg, cfg, jp, tp = gemma_hd256
    prompt = _batch(cfg, seed=4)["tokens"][:, :8]
    steps = 6
    decode = jax.jit(lambda p, t, c, n: j_zoo.decode_fn(jcfg, p, t, c, n))
    jc = j_zoo.init_decode_caches(jcfg, B, prompt.shape[1] + steps)
    tc = model_zoo.init_decode_caches(cfg, B, prompt.shape[1] + steps,
                                      device="cpu")
    jtok = ttok = None
    jout, tout = [], []
    for i in range(prompt.shape[1] + steps):
        if i < prompt.shape[1]:
            jin = tin = prompt[:, i:i + 1]
        else:
            jin, tin = np.asarray(jtok), ttok.numpy()
            jout.append(jin)
            tout.append(tin)
        jl, jc = decode(jp, jnp.asarray(jin), jc, jnp.int32(i))
        tl, tc = model_zoo.decode_fn(cfg, tp, _t(tin), tc, i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))


# ---------------------------------------------------------------------------
# conversion, counts, an unknown block kind
# ---------------------------------------------------------------------------


def _counted_weights(tree, name=""):
    """Weights the analytic count covers: every leaf but norms and
    biases."""
    if isinstance(tree, dict):
        return sum(_counted_weights(v, k) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_counted_weights(v) for v in tree)
    if name.endswith("norm") or name in ("ln1", "ln2", "bq", "bk", "bv"):
        return 0
    return tree.numel()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_round_trip_and_count(arch, models):
    """lm_params_from_numpy carries every leaf bit for bit (the MoE's
    stacked experts and the unstacked ``mtp`` subtree too), its inverse
    gives the JAX layout back, and the analytic count equals the JAX
    package's and the real number of weights (norms and biases aside)."""
    cfg, jp, tp = models[arch]
    flat_j = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]}
    back = convert.lm_params_to_numpy(tp)
    flat_b = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(back)[0]}
    assert flat_j.keys() == flat_b.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_b[k], flat_j[k], err_msg=k)
    n = model_zoo.analytic_param_count(cfg)
    assert n == j_zoo.analytic_param_count(j_smoke(arch))
    active = model_zoo.analytic_param_count(cfg, active_only=True)
    assert active == j_zoo.analytic_param_count(j_smoke(arch), active_only=True)
    assert cfg.param_count() == n and cfg.active_param_count() == active
    assert (active < n) == (cfg.mlp_kind == "moe")
    assert ("mtp" in tp) == (cfg.mtp_depth > 0)
    assert _counted_weights(tp) == n


def test_bfloat16_params_convert_exactly():
    cfg = dataclasses.replace(get_smoke_config("gemma-7b"), dtype="bfloat16")
    tp = model_zoo.init_params(cfg, seed=1, device="cpu")
    again = convert.lm_params_from_numpy(cfg, convert.lm_params_to_numpy(tp),
                                         device="cpu")
    assert again["embed"].dtype == torch.bfloat16
    assert torch.equal(again["embed"], tp["embed"])
    assert torch.equal(again["blocks"][1]["mlp"]["wo"],
                       tp["blocks"][1]["mlp"]["wo"])


def _dtypes(tree, path=""):
    """{leaf path: dtype} of a port parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree.dtype}
    return {p: d for k, v in items for p, d in _dtypes(v, f"{path}/{k}").items()}


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_bfloat16_moe_tree_converts_exactly(arch):
    """A bfloat16 DeepSeek tree from the JAX package (its router float32)
    converts bit for bit, each leaf in the dtype the port's
    ``init_lm_params`` gives it (the router float32, the rest bfloat16;
    ``mtp`` included), and back."""
    jcfg = dataclasses.replace(j_smoke(arch), dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    jp = jax.device_get(j_zoo.init_params(jcfg, jax.random.PRNGKey(2)))
    assert jp["blocks"]["l0"]["mlp"]["router"].dtype == np.float32
    tp = convert.lm_params_from_numpy(cfg, jp, device="cpu")
    assert _dtypes(tp) == _dtypes(model_zoo.init_params(cfg, device="cpu"))
    assert tp["blocks"][0]["mlp"]["router"].dtype == torch.float32
    if cfg.mtp_depth:
        assert tp["mtp"]["block"]["mlp"]["router"].dtype == torch.float32
        assert tp["mtp"]["proj"].dtype == torch.bfloat16
    flat_j = {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_b = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(
                  convert.lm_params_to_numpy(tp))[0]}
    assert flat_j.keys() == flat_b.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_b[k], flat_j[k], err_msg=k)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_published_counts_and_flops_equal_jax(arch):
    """The published configs' parameter counts (all and active) and
    MODEL_FLOPS at every shape equal the JAX package's."""
    from repro.configs import get_config as j_full
    from repro.configs.base import SHAPES as J_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES

    cfg, jcfg = get_config(arch), j_full(arch)
    want = {"deepseek-moe-16b": (16_879_452_160, 2_830_630_912),
            "deepseek-v3-671b": (715_432_525_824, 38_270_533_632)}[arch]
    got = (model_zoo.analytic_param_count(cfg),
           model_zoo.analytic_param_count(cfg, active_only=True))
    assert got == want == (j_zoo.analytic_param_count(jcfg),
                           j_zoo.analytic_param_count(jcfg, active_only=True))
    for name in SHAPES:
        assert model_zoo.model_flops(cfg, SHAPES[name]) == \
            j_zoo.model_flops(jcfg, J_SHAPES[name])
    cut = dataclasses.replace(cfg, num_layers=1)
    assert model_zoo.analytic_param_count(cut) == j_zoo.analytic_param_count(
        dataclasses.replace(jcfg, num_layers=1))


def test_unknown_block_kind_raises():
    """A block kind the reference has no stack for raises ValueError, as
    the reference's ``init_group`` and ``group_layer_kinds`` do."""
    cfg = dataclasses.replace(get_smoke_config("phi3-medium-14b"),
                              block_kind="nope")
    for call in (lambda: model_zoo.init_params(cfg, device="cpu"),
                 lambda: model_zoo.init_decode_caches(cfg, 1, 4, device="cpu"),
                 lambda: model_zoo.analytic_param_count(cfg),
                 lambda: convert.lm_params_from_numpy(cfg, {}, device="cpu")):
        with pytest.raises(ValueError, match="nope"):
            call()


def test_sequence_sharded_decode_raises(models):
    """seq_axis with no device mesh in the ``activation_sharding`` context
    decodes over the whole cache, as the reference's plain branch does (it
    raised before the mesh code was ported): logits and caches equal to
    the decode without it, bit for bit."""
    cfg, _, tp = models["phi3-medium-14b"]
    tok = torch.zeros((1, 1), dtype=torch.int32)
    runs = []
    for seq_axis in (None, "model"):
        caches = model_zoo.init_decode_caches(cfg, 1, 4, device="cpu")
        runs.append(model_zoo.decode_fn(cfg, tp, tok, caches, 0,
                                        seq_axis=seq_axis))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert all(torch.equal(a[k], b[k]) for k in a)
