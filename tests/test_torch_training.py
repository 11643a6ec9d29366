"""The port's training (``training/``, ``models/model_zoo.loss_fn``) against
the JAX package on the CPU: the synthetic batches (bit for bit), AdamW on
numpy-made trees, then the dense attention archs' smoke configs — loss,
metrics and every gradient leaf from converted weights, five ``Trainer``
steps — bfloat16's casts where they round as the reference's do
(``attend_blocked``, AdamW), microbatching, loss descent,
and the kernel dispatchers' refusal of inputs that need a gradient. The DeepSeek family (MoE, MLA, MTP) is in
``test_torch_training_moe.py``; xLSTM, the mamba hybrid and the
encoder-decoder in ``test_torch_training_families.py``. Tolerances are in
``torch_training_parity.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

import torch_training_parity as tp  # noqa: E402
from repro.models import attention as j_attention  # noqa: E402
from repro.models import transformer as j_transformer  # noqa: E402
from repro.training import data as j_data  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, model_zoo, transformer  # noqa: E402
from repro_torch.training import data, optimizer  # noqa: E402
from repro_torch.training.train_loop import (Trainer,  # noqa: E402
                                             make_train_step, value_and_grad)

DENSE = ["phi3-medium-14b", "gemma-7b", "command-r-plus-104b", "qwen1.5-32b",
         "internvl2-1b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (512, 16, 4, 2, 0), (50304, 128, 8, 0, 19), (8192, 33, 3, 7, 123)])
def test_lm_batches_bit_equal(vocab, seq, batch, seed, step):
    got = data.SyntheticLMData(vocab, seq, batch, seed=seed).batch_at(step)
    want = j_data.SyntheticLMData(vocab, seq, batch, seed=seed).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_encdec_batches_bit_equal():
    got = data.SyntheticEncDecData(512, 16, 2, 64, seed=3).batch_at(5)
    want = j_data.SyntheticEncDecData(512, 16, 2, 64, seed=3).batch_at(5)
    assert got.keys() == want.keys() == {"frames", "tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 4)).astype(np.float32) * scale,
            "blocks": {"b": rng.normal(size=(3,)).astype(np.float32) * scale,
                       "a": rng.normal(size=(2, 5)).astype(np.float32)
                       * scale}}


def _port(tree):
    return optimizer.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


CASES = {
    # tests/test_training.py's two cases
    "bias_correction": (
        {"w": np.ones((4, 4), np.float32)},
        {"w": np.full((4, 4), 0.5, np.float32)},
        dict(lr=1e-2, weight_decay=0.0, grad_clip=1e9, warmup_steps=1), 1),
    "clipping": (
        {"w": np.ones((2,), np.float32)}, {"w": np.full((2,), 1e6, np.float32)},
        dict(lr=1.0, grad_clip=1.0, weight_decay=0.0, warmup_steps=1), 1),
    # a nested tree, weight decay, warm-up and clipping over three steps
    "tree_three_steps": (_tree(0), _tree(1, 3.0),
                         dict(lr=1e-3, warmup_steps=10), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_matches_reference(case):
    params, grads, kw, steps = CASES[case]
    cfg, jcfg = optimizer.AdamWConfig(**kw), j_opt.AdamWConfig(**kw)
    p, g = _port(params), _port(grads)
    st = optimizer.init_opt_state(p)
    jp, jg = _jax(params), _jax(grads)
    jst = j_opt.init_opt_state(jp)
    assert st["step"].dtype == torch.int64 and int(st["step"]) == 0
    for _ in range(steps):
        p, st, m = optimizer.adamw_update(cfg, p, g, st)
        jp, jst, jm = j_opt.adamw_update(jcfg, jp, jg, jst)
    for got, want in ((p, jp), (st["m"], jst["m"]), (st["v"], jst["v"])):
        got, want = tp.flat(optimizer.tree_map(lambda t: t.numpy(), got)), \
            tp.flat(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert int(st["step"]) == int(jst["step"]) == steps
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)
    if case == "bias_correction":  # the first step is ~lr * sign(g)
        np.testing.assert_allclose(p["w"].numpy(), 1.0 - 1e-2, rtol=1e-3)
    if case == "clipping":  # one step moves each weight by at most lr
        assert float(optimizer.global_norm(g)) > 1e6
        assert float((p["w"] - 1.0).abs().max()) <= 1.0 + 1e-6


def test_adamw_on_bf16_leaves_matches_reference_bit_for_bit():
    """bfloat16 leaves: the update in float32, cast back to each leaf's
    bfloat16 every step (the reference's order), equal to the JAX package's
    bit for bit over three steps, the moments float32 and equal. Float32
    master copies rounded once at the end would not be equal."""
    rng = np.random.default_rng(4)
    leaves = {"w": (64, 64), "b": (64,)}
    p = {k: rng.normal(size=s).astype(ml_dtypes.bfloat16)
         for k, s in leaves.items()}
    g = {k: (rng.normal(size=s) * 0.1).astype(ml_dtypes.bfloat16)
         for k, s in leaves.items()}
    # no clipping: the two packages sum the global norm in different
    # leaf orders, and its last bit would scale every gradient
    kw = dict(lr=1e-2, warmup_steps=1, grad_clip=1e9)

    def port(tree, dtype=torch.bfloat16):
        return {k: torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
                for k, a in tree.items()}

    jp, jg = _jax(p), _jax(g)
    jst = j_opt.init_opt_state(jp)
    tp_, tg, f32 = port(p), port(g), port(p, torch.float32)
    st, st32 = optimizer.init_opt_state(tp_), optimizer.init_opt_state(f32)
    for _ in range(3):
        jp, jst, _ = j_opt.adamw_update(j_opt.AdamWConfig(**kw), jp, jg, jst)
        tp_, st, _ = optimizer.adamw_update(optimizer.AdamWConfig(**kw), tp_,
                                            tg, st)
        f32, st32, _ = optimizer.adamw_update(optimizer.AdamWConfig(**kw),
                                              f32, port(g, torch.float32),
                                              st32)
    for k in leaves:
        assert tp_[k].dtype == torch.bfloat16
        want = np.asarray(jp[k], np.float32)
        np.testing.assert_array_equal(tp_[k].float().numpy(), want)
        for m in ("m", "v"):
            assert st[m][k].dtype == torch.float32
            np.testing.assert_array_equal(st[m][k].numpy(),
                                          np.asarray(jst[m][k]))
        assert not np.array_equal(
            f32[k].to(torch.bfloat16).float().numpy(), want)


def test_attend_blocked_bf16_rounds_as_the_reference():
    """bfloat16 q/k/v over several q blocks: scores in q's dtype over
    sqrt(hd), softmax in float32, probabilities in v's dtype. The output
    equals the JAX package's run op by op (``jax.disable_jit``: each op
    rounded to bfloat16, as eager torch rounds it) bit for bit; the same
    inputs in float32, rounded once at the end, are not equal."""
    rng = np.random.default_rng(6)
    shapes = [(2, 48, 4, 32), (2, 48, 2, 32), (2, 48, 2, 32)]
    qkv = [rng.normal(size=s).astype(ml_dtypes.bfloat16) for s in shapes]
    pos = np.arange(48, dtype=np.int32)
    with jax.disable_jit():
        want = np.asarray(j_attention.attend_blocked(
            *map(jnp.asarray, qkv), jnp.asarray(pos), jnp.asarray(pos), True,
            block_q=16), np.float32)
    tpos = torch.from_numpy(pos)

    def port(dtype):
        return attention.attend_blocked(
            *(torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
              for a in qkv), tpos, tpos, True, block_q=16)

    got = port(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not np.array_equal(
        port(torch.float32).to(torch.bfloat16).float().numpy(), want)


def test_adamw_keeps_leaf_dtype_and_inputs():
    p = {"a": torch.ones((3,), dtype=torch.bfloat16),
         "b": [torch.ones((2,)), torch.zeros((2, 2))]}
    g = optimizer.tree_map(lambda t: torch.full_like(t, 0.25), p)
    st = optimizer.init_opt_state(p)
    p2, st2, _ = optimizer.adamw_update(optimizer.AdamWConfig(), p, g, st)
    assert p2["a"].dtype == torch.bfloat16 and isinstance(p2["b"], list)
    assert st2["m"]["a"].dtype == torch.float32
    assert bool((p["a"] == 1).all()) and int(st["step"]) == 0  # untouched


# ---------------------------------------------------------------------------
# dense archs: loss, gradients, Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match(arch):
    tp.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_trainer_steps_match(arch):
    tp.check_trainer(arch)


def test_value_and_grad_leaves_the_tree_servable():
    """Gradients are taken on aliases of the leaves: after value_and_grad
    and a Trainer step from the same tree, its leaves need no gradient and
    it still prefills through the kernel dispatchers, which refuse inputs
    that need one."""
    cfg = get_smoke_config("phi3-medium-14b")
    params = model_zoo.init_params(cfg, 0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in tp.batch(cfg).items()}
    value_and_grad(cfg, params, b)
    Trainer(cfg, data.SyntheticLMData(cfg.vocab_size, 16, 2, seed=1),
            device="cpu", params=params).run(1, log=None)
    assert not any(p.requires_grad for p in optimizer.tree_leaves(params))
    logits, _ = transformer.prefill(params, cfg, b["tokens"])
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_xent_over_several_chunks_matches(chunk, monkeypatch):
    """chunked_xent over several sequence chunks (S 24: chunks of 8, and
    16 halved to 8) and its gradients against the JAX package's with the
    same chunk; the smoke configs' S fits in one chunk of 512."""
    cfg, jcfg, jp, tparams = tp.models("gemma-7b")
    rng = np.random.default_rng(chunk)
    hidden = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) > 0.2).astype(np.float32)
    sub = {k: jp[k] for k in ("embed", "final_norm")}
    (jn, jm), (jg, jh) = jax.value_and_grad(
        lambda p, h: j_transformer.chunked_xent(
            p, jcfg, h, jnp.asarray(labels), jnp.asarray(mask), chunk=chunk),
        argnums=(0, 1), has_aux=True)(sub, jnp.asarray(hidden))
    monkeypatch.setattr(transformer, "XENT_CHUNK", chunk)
    tsub = {k: tparams[k].detach().requires_grad_(True) for k in sub}
    th = torch.from_numpy(hidden).requires_grad_(True)
    tn, tm = transformer.chunked_xent(tsub, cfg, th, torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    tn.backward()
    np.testing.assert_allclose(float(tn.detach()), float(jn),
                               rtol=tp.LOSS_RTOL)
    assert float(tm) == float(jm)
    for got, want in ((tsub["embed"].grad, jg["embed"]),
                      (tsub["final_norm"].grad, jg["final_norm"]),
                      (th.grad, jh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tp.GRAD_TOL * np.abs(want).max())


def test_grad_accumulation_matches_single_batch():
    """Two microbatches equal one (tests/test_training.py's tolerance), and
    the two-microbatch loss equals the one-batch loss."""
    cfg = get_smoke_config("phi3-medium-14b")
    b = {k: torch.from_numpy(v) for k, v in
         data.SyntheticLMData(cfg.vocab_size, 16, 8, seed=3).batch_at(0)
         .items()}
    params = model_zoo.init_params(cfg, 0, device="cpu")
    opt = optimizer.init_opt_state(params)
    s1 = make_train_step(cfg, optimizer.AdamWConfig(lr=1e-3), 1)
    s2 = make_train_step(cfg, optimizer.AdamWConfig(lr=1e-3), 2)
    p1, _, m1 = s1(params, opt, b)
    p2, o2, m2 = s2(params, opt, b)
    for a, c in zip(optimizer.tree_leaves(p1), optimizer.tree_leaves(p2)):
        np.testing.assert_allclose(a.float().numpy(), c.float().numpy(),
                                   rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    assert int(o2["step"]) == 1 and int(opt["step"]) == 0


def test_loss_decreases():
    """tests/test_training.py::test_loss_decreases on the port."""
    cfg = get_smoke_config("qwen1.5-32b")
    tr = Trainer(cfg, data.SyntheticLMData(cfg.vocab_size, 32, 8, seed=1),
                 optimizer.AdamWConfig(lr=1e-3, warmup_steps=10),
                 device="cpu")
    hist = tr.run(25, log_every=100, log=None)
    assert hist[-1] < hist[0] - 0.4
    assert len(tr.step_s) == 25


# ---------------------------------------------------------------------------
# the kernels stay off the training path
# ---------------------------------------------------------------------------


def _attn_inputs(grad):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 4, 16), generator=g, requires_grad=grad)
    k = torch.randn((1, 8, 2, 16), generator=g)
    v = torch.randn((1, 8, 2, 16), generator=g)
    return q, k, v


def _distance_inputs(grad):
    g = torch.Generator().manual_seed(0)
    db = torch.randn((32, 8), generator=g, requires_grad=grad)
    q = torch.randn((4, 8), generator=g)
    ids = torch.randint(0, 32, (256,), generator=g, dtype=torch.int32)
    slots = torch.randint(0, 4, (256,), generator=g, dtype=torch.int32)
    return db, q, ids, slots


CALLS = {
    "flash_attention": lambda grad: ops.flash_attention(*_attn_inputs(grad)),
    "decode_attention": lambda grad: ops.decode_attention(
        _attn_inputs(grad)[0][:, 0], *_attn_inputs(False)[1:], 5),
    "distance_tasks": lambda grad: ops.distance_tasks(*_distance_inputs(grad)),
    "distance_tasks_group": lambda grad: ops.distance_tasks_group(
        *(t[None] for t in _distance_inputs(grad))),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_ops_refuse_inputs_that_need_a_gradient(name):
    """A ctypes-bound kernel has no backward: the dispatcher raises on an
    input that requires grad while autograd is on, on the CPU as on the
    card, and runs under no_grad or without such an input."""
    with pytest.raises(RuntimeError, match="no backward"):
        CALLS[name](True)
    with torch.no_grad():
        CALLS[name](True)
    CALLS[name](False)


@pytest.mark.parametrize("arch", ["gemma-7b", "seamless-m4t-large-v2"])
def test_training_path_never_reaches_the_kernels(arch, monkeypatch):
    """loss_fn and its backward with every dispatcher replaced by one that
    raises: the training path (decoder, encoder and cross-attention
    included) goes through attend_blocked only."""
    def refuse(*a, **k):
        raise AssertionError("a kernel dispatcher was called in training")

    for name in CALLS:
        monkeypatch.setattr(ops, name, refuse)
    cfg = get_smoke_config(arch)
    params = model_zoo.init_params(cfg, 0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in tp.batch(cfg).items()}
    loss, _, grads = value_and_grad(cfg, params, b)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all())
               for g in optimizer.tree_leaves(grads))


def test_blocked_arm_equals_the_kernel_arm():
    """attention_forward's training arm computes the serving arm's function
    (on the CPU the serving arm is the kernel's plain version)."""
    cfg = get_smoke_config("phi3-medium-14b")
    p = model_zoo.init_params(cfg, 0, device="cpu")["blocks"][0]["attn"]
    x = torch.randn((2, 20, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        a, kv = attention.attention_forward(p, x, cfg)
        b, kv2 = attention.attention_forward(p, x, cfg, blocked=True)
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(u, w) for u, w in zip(kv, kv2))
