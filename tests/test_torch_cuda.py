"""Hopper kernels against their plain-PyTorch versions on the card.

Needs an NVIDIA GPU with nvcc; skipped elsewhere. Imports nothing of JAX,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda

SWEEP = [(500, 128, 8, 256), (1000, 64, 16, 512), (256, 256, 4, 256),
         (300, 127, 8, 256), (300, 130, 8, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, d, R, T, seed, dev):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, size=T).astype(np.int32)
    ids[::5] = -1
    arrays = (rng.normal(size=(N, d)).astype(np.float32),
              rng.normal(size=(R, d)).astype(np.float32), ids,
              rng.integers(0, R, size=T).astype(np.int32))
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("N,d,R,T", SWEEP)
def test_kernel_matches_plain(cuda, mode, metric, N, d, R, T):
    from repro_torch.kernels import distance, ops, ref

    args = _inputs(N, d, R, T, seed=N + d, dev=cuda)
    name = "distance_slot_gather" if mode == "slot_gather" \
        else "distance_onehot"
    before = distance.launches[name]
    out = ops.distance_tasks(*args, metric=metric, mode=mode)
    plain = (ref.distance_tasks_ref if mode == "slot_gather"
             else ref.distance_tasks_onehot_ref)(*args, metric=metric)
    torch.cuda.synchronize()
    assert distance.launches[name] == before + 1
    valid = args[2] >= 0
    torch.testing.assert_close(out[valid], plain[valid], rtol=1e-5, atol=1e-3)
    assert bool((out[~valid] == 1e30).all())


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
def test_kernel_padding_invariant_and_deterministic(cuda, mode):
    from repro_torch.kernels import ops

    db, q, ids, slot = _inputs(300, 64, 8, 256, seed=5, dev=cuda)
    base = ops.distance_tasks(db, q, ids, slot, mode=mode)
    again = ops.distance_tasks(db, q, ids, slot, mode=mode)
    pids = torch.cat([ids, ids.new_full((256,), -1)])
    pslot = torch.cat([slot, slot.new_zeros((256,))])
    padded = ops.distance_tasks(db, q, pids, pslot, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(base, again)
    assert torch.equal(base, padded[:256])
    assert bool((padded[256:] == 1e30).all())


def test_engine_on_card_matches_cpu(cuda):
    """A few engine chunks on the card give the CPU run's ids."""
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.core.continuous_batching import ContinuousBatchingEngine
    from repro_torch.vector.dataset import make_dataset
    from repro_torch.vector.graph import make_cagra_graph

    cfg = VectorPoolConfig(num_vectors=2000, dim=64, graph_degree=8,
                           max_requests=8, top_m=16, task_batch=256,
                           visited_slots=256)
    db, queries = make_dataset(2000, 64, num_clusters=16, num_queries=8,
                               seed=7)
    graph = make_cagra_graph(db, 8, seed=7)
    out = {}
    for dev in ("cpu", "cuda"):
        e = ContinuousBatchingEngine(cfg, db, graph, device=dev, seed=3)
        e.admit_batch([(i, queries[i]) for i in range(8)])
        out[dev] = {rid: ids for rid, ids, _, _ in e.run_to_completion()}
    assert out["cpu"].keys() == out["cuda"].keys()
    same = np.mean([np.array_equal(out["cpu"][r], out["cuda"][r])
                    for r in out["cpu"]])
    assert same >= 0.99
