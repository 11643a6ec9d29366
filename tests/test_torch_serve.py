"""The port's ``RealServer`` on the CPU against the JAX package's: the
qwen1.5-32b smoke model (QKV bias) and both DeepSeek smoke models (MoE;
MLA with MTP) with ``tests/test_system.py``'s pool, the JAX weights carried
across by ``convert.lm_params_from_numpy``. Greedy tokens are equal, the
pool serves the same probes, and generation is deterministic."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import VectorPoolConfig as JPoolConfig  # noqa: E402
from repro.launch.serve import RealServer as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import VectorPoolConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

POOL = dict(num_vectors=1500, dim=64, max_requests=16, top_m=16,
            task_batch=512, visited_slots=256, top_k=5)


@pytest.fixture(scope="module")
def servers():
    jserver = JServer(j_smoke("qwen1.5-32b"), JPoolConfig(**POOL),
                      rag_interval=4)
    cfg = get_smoke_config("qwen1.5-32b")
    params = convert.lm_params_from_numpy(
        cfg, jax.device_get(jserver.params), device="cpu")
    tserver = serve.RealServer(cfg, VectorPoolConfig(**POOL), rag_interval=4,
                               device="cpu", params=params)
    return jserver, tserver


def test_generate_matches_jax(servers):
    jserver, tserver = servers
    assert np.array_equal(tserver.pool.db, jserver.pool.db)
    assert isinstance(tserver.pool.db, np.ndarray)  # a host view, as in JAX
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 500, size=(2, 16)).astype(np.int32)
    jt, js = jserver.generate(prompts, max_new=10)
    tt, ts = tserver.generate(prompts, max_new=10)
    assert tt.shape == (2, 10) and tt.dtype == jt.dtype
    np.testing.assert_array_equal(tt, jt)
    assert set(ts) == set(js)
    for key in ("rag_probes", "stalls"):
        assert ts[key] == js[key], key
    assert ts["rag_p95_ms"] == pytest.approx(js["rag_p95_ms"], rel=1e-9)
    assert ts["rag_probes"] >= 2 + 2  # two prefill probes, two decode probes


def test_generation_is_deterministic(servers):
    _, tserver = servers
    prompts = np.random.default_rng(1).integers(
        0, 500, size=(1, 12)).astype(np.int32)
    t1, _ = tserver.generate(prompts, max_new=6)
    t2, _ = tserver.generate(prompts, max_new=6)
    np.testing.assert_array_equal(t1, t2)


def test_random_weights_are_seeded():
    """Without params the server draws its weights from ``seed``: two
    servers with one seed generate the same tokens, another seed differs."""
    cfg = get_smoke_config("phi3-medium-14b")
    pool = VectorPoolConfig(**POOL)
    prompts = np.random.default_rng(2).integers(
        0, 500, size=(2, 8)).astype(np.int32)
    toks = [serve.RealServer(cfg, pool, device="cpu", seed=s).generate(
        prompts, max_new=4)[0] for s in (0, 0, 1)]
    np.testing.assert_array_equal(toks[0], toks[1])
    assert not np.array_equal(toks[0], toks[2])


def test_cli_runs_on_cpu(capsys):
    serve.main(["--arch", "internvl2-1b", "--device", "cpu", "--requests", "1",
                "--prompt-len", "20", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "generated tokens (first request):" in out
    assert "rag_probes" in out and "ttft_s" in out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_deepseek_generate_matches_jax(arch):
    """MoE (and MLA) served through RealServer: the same greedy tokens and
    probes as the JAX package's server on the same weights, and the same
    tokens again on a second call."""
    jserver = JServer(j_smoke(arch), JPoolConfig(**POOL), rag_interval=4)
    cfg = get_smoke_config(arch)
    params = convert.lm_params_from_numpy(
        cfg, jax.device_get(jserver.params), device="cpu")
    tserver = serve.RealServer(cfg, VectorPoolConfig(**POOL), rag_interval=4,
                               device="cpu", params=params)
    prompts = np.random.default_rng(3).integers(
        0, 500, size=(2, 12)).astype(np.int32)
    jt, js = jserver.generate(prompts, max_new=6)
    tt, ts = tserver.generate(prompts, max_new=6)
    np.testing.assert_array_equal(tt, jt)
    assert (ts["rag_probes"], ts["stalls"]) == (js["rag_probes"], js["stalls"])
    again, _ = tserver.generate(prompts, max_new=6)
    np.testing.assert_array_equal(again, tt)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_cli_serves_deepseek_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "1",
                "--prompt-len", "16", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "generated tokens (first request):" in out and "ttft_s" in out
