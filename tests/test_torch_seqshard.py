"""The port's sequence-sharded decode (``seq_axis``) on 8 CPU gloo ranks
against the port's unsharded decode and the JAX package's shard_map decode.

Smoke configs of phi3-medium-14b (GQA) and deepseek-v3-671b (MLA), B 2,
S 32, every prompt token decoded from empty caches, as
``tests/seqshard_check_script.py`` does. The ranks form a (2, 4) host mesh
on ("data", "model"): each takes one batch row and a quarter of the cache's
positions (``tests/torch_seqshard_worker.py``), and rendezvous through a
``FileStore`` under ``tmp_path``. The JAX reference runs once per module in
a subprocess with 8 host devices and a mesh of Auto axes (jax's
``make_mesh`` makes Explicit axes, which its ``with_sharding_constraint``
refuses), and hands over its parameters and logits. Tolerances: 1e-5
against the port's unsharded decode (float32: only the combine's sum order
differs); 2e-3 against the JAX package, that script's own.
"""
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_seqshard_worker as worker  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("phi3-medium-14b", "deepseek-v3-671b")
B, S, WORLD = 2, 32, 8
JOIN_S = 120  # a rank that has not finished by then fails the test

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    sys.path.insert(0, sys.argv[2])
    import torch_seqshard_worker as worker
    from repro.configs import get_smoke_config
    from repro.distributed import sharding as shard
    from repro.models import model_zoo

    out = sys.argv[1]
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    toks = np.random.default_rng(0).integers(0, 500, (2, 32))
    for arch in ("phi3-medium-14b", "deepseek-v3-671b"):
        cfg = get_smoke_config(arch)
        params = model_zoo.init_params(cfg, jax.random.PRNGKey(0))
        caches = model_zoo.init_decode_caches(cfg, 2, 32)
        with mesh, shard.activation_sharding(mesh):
            fn = jax.jit(lambda p, t, c, n: model_zoo.decode_fn(
                cfg, p, t, c, n, seq_axis="model"))
            logits = []
            for i in range(32):
                lg, caches = fn(params, jnp.asarray(toks[:, i:i + 1],
                                                    jnp.int32),
                                caches, jnp.int32(i))
                logits.append(np.asarray(lg, np.float32))
        np.savez(os.path.join(out, arch + "__params.npz"),
                 **worker.flatten(jax.device_get(params)))
        np.save(os.path.join(out, arch + "__logits.npy"), np.stack(logits))
    print("DONE")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's seqshard logits and parameters, once a module."""
    out = tmp_path_factory.mktemp("jax_seqshard")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(out),
         os.path.dirname(__file__)], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0 and "DONE" in res.stdout, res.stderr[-3000:]
    return out


def _tokens():
    return np.random.default_rng(0).integers(0, 500, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Each rank's saved results, both archs in one run of 8 processes."""
    tmp = tmp_path_factory.mktemp("seqshard_ranks")
    ctx = multiprocessing.get_context("spawn")
    params = [str(reference / f"{arch}__params.npz") for arch in ARCHS]
    outs = [[str(tmp / f"{arch}_rank{r}.npz") for arch in ARCHS]
            for r in range(WORLD)]
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, str(tmp / "store"), ARCHS, params,
                               _tokens(), outs[r]))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish in {JOIN_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * WORLD, codes
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return {arch: [dict(np.load(outs[r][i])) for r in range(WORLD)]
            for i, arch in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_seqshard_decode_on_eight_ranks(arch, reference, ranks):
    """Every rank's logits, at every step, equal the port's unsharded decode
    of its batch row within 1e-5 and the JAX package's seqshard decode
    within 2e-3."""
    cfg = get_smoke_config(arch)
    j_logits = np.load(reference / f"{arch}__logits.npy")  # (S, B, 1, V)
    with np.load(reference / f"{arch}__params.npz") as f:
        params = lm_params_from_numpy(cfg, worker.unflatten(dict(f)),
                                      device="cpu")
    toks = torch.from_numpy(_tokens())
    caches = model_zoo.init_decode_caches(cfg, B, S, device="cpu")
    base = []
    with torch.no_grad():
        for i in range(S):
            lg, caches = model_zoo.decode_fn(cfg, params, toks[:, i:i + 1],
                                             caches, i)
            base.append(lg.numpy())
    base = np.stack(base)
    np.testing.assert_allclose(base, j_logits, rtol=2e-3, atol=2e-3)
    for r in ranks[arch]:
        rows = r["rows"]
        np.testing.assert_allclose(r["logits"], base[:, rows], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["logits"], j_logits[:, rows], rtol=2e-3,
                                   atol=2e-3)
    print(json.dumps({"arch": arch, "max_vs_unsharded": float(max(
        np.abs(r["logits"] - base[:, r["rows"]]).max() for r in ranks[arch])),
        "max_vs_jax": float(max(np.abs(r["logits"]
                                       - j_logits[:, r["rows"]]).max()
                                for r in ranks[arch]))}))


def test_seqshard_core_with_shards_past_cur_len(ranks):
    """The GQA attention core alone, over each rank's quarter of a cache,
    equals the whole cache's plain decode at cur_len 0, 5, 13 and 31 (at 0
    and 5 three shards hold no valid position and contribute nothing;
    positions past cur_len hold 1e4 and are never read)."""
    for r in ranks[ARCHS[0]]:
        assert float(r["core_err"]) < 1e-5


@pytest.mark.parametrize("M,cur_len", [(2, 40), (4, 9), (8, 63), (8, 0)])
def test_merge_stacked_equals_one_pass_over_the_cache(M, cur_len):
    """``sharding.merge_stacked`` (the arithmetic ``combine_partials`` runs
    between its all_reduces, and ``chip_smoke.py``'s sliced check on the
    card) over M slices of one cache: each slice's plain partial (out and
    log-sum-exp; a slice wholly past cur_len as m = -inf, l = 0) merged
    equals the plain decode over the whole cache within 1e-6 (float32)."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ref

    B, S, H, Hkv, hd = 2, 64, 8, 2, 16
    rng = np.random.default_rng(M + cur_len)
    q = torch.from_numpy(rng.normal(size=(B, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, Hkv, hd))
                             .astype(np.float32)) for _ in range(2))
    want = ref.decode_attn_ref(q, k, v, cur_len)
    S_loc = S // M
    ms, ls, os_ = [], [], []
    for i in range(M):
        local = cur_len - i * S_loc
        if local < 0:
            ms.append(torch.full((B, H), float("-inf")))
            ls.append(torch.zeros((B, H)))
            os_.append(torch.zeros((B, H, hd)))
            continue
        o, lse = ref.decode_attn_ref(q, k[:, i * S_loc:(i + 1) * S_loc],
                                     v[:, i * S_loc:(i + 1) * S_loc],
                                     local, return_lse=True)
        ms.append(lse)
        ls.append(torch.ones_like(lse))
        os_.append(o)
    got = sharding.merge_stacked(torch.stack(ms), torch.stack(ls),
                                 torch.stack(os_))
    assert got.shape == (B, H, hd) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
