"""The port's distance stage on the CPU: the plain-PyTorch versions and the
device dispatcher against the JAX package's Pallas kernels (interpret
mode) and its jnp references, on the sweep of tests/test_kernels.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import distance as tdist  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SWEEP = [(500, 128, 8, 256), (1000, 64, 16, 512), (256, 256, 4, 256)]


def _inputs(N, d, R, T, seed, dummy_every=5):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(N, d)).astype(np.float32)
    queries = rng.normal(size=(R, d)).astype(np.float32)
    ids = rng.integers(0, N, size=T).astype(np.int32)
    ids[::dummy_every] = -1  # masked dummies
    slot = rng.integers(0, R, size=T).astype(np.int32)
    return db, queries, ids, slot


def _port(fn, db, queries, ids, slot, **kw):
    return fn(torch.from_numpy(db), torch.from_numpy(queries),
              torch.from_numpy(ids), torch.from_numpy(slot), **kw).numpy()


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("N,d,R,T", SWEEP)
def test_plain_matches_pallas_and_jnp_ref(mode, metric, N, d, R, T):
    db, queries, ids, slot = _inputs(N, d, R, T, seed=N + d)
    got = _port(tops.distance_tasks, db, queries, ids, slot, metric=metric,
                mode=mode)
    pallas = np.asarray(jops.distance_tasks(db, queries, ids, slot,
                                            metric=metric, mode=mode))
    jnp_ref = jref.distance_tasks_ref if mode == "slot_gather" \
        else jref.distance_tasks_onehot_ref
    want = np.asarray(jnp_ref(db, queries, ids, slot, metric=metric))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[ids < 0], np.float32(1e30))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_slot_gather_matches_onehot(metric):
    """The O(T·d) slot-gather form agrees with the one-hot form to 1e-4
    (tests/test_kernels.py holds the JAX pair to the same bound)."""
    db, queries, ids, slot = _inputs(800, 96, 12, 512, seed=40, dummy_every=7)
    gather = _port(tref.distance_tasks_ref, db, queries, ids, slot,
                   metric=metric)
    onehot = _port(tref.distance_tasks_onehot_ref, db, queries, ids, slot,
                   metric=metric)
    np.testing.assert_allclose(gather, onehot, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
def test_dummy_padding_invariant(mode):
    """Appending masked dummies never changes real task results."""
    db, queries, ids, slot = _inputs(300, 64, 8, 256, seed=5, dummy_every=9)
    base = _port(tops.distance_tasks, db, queries, ids, slot, mode=mode)
    pids = np.concatenate([ids, np.full(256, -1, np.int32)])
    pslot = np.concatenate([slot, np.zeros(256, np.int32)])
    padded = _port(tops.distance_tasks, db, queries, pids, pslot, mode=mode)
    np.testing.assert_array_equal(base, padded[:256])
    np.testing.assert_array_equal(padded[256:], np.float32(1e30))


def test_out_of_range_ids_clamp_like_jax():
    """Ids past N gather the last row, as the JAX gather clamps."""
    db, queries, ids, slot = _inputs(50, 32, 4, 256, seed=9)
    ids[1::7] = 50 + np.arange(len(ids[1::7]))
    got = _port(tref.distance_tasks_ref, db, queries, ids, slot)
    want = np.asarray(jref.distance_tasks_ref(
        jnp.asarray(db), jnp.asarray(queries), jnp.asarray(ids),
        jnp.asarray(slot)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_dispatcher_contract():
    db, queries, ids, slot = _inputs(100, 32, 4, 256, seed=1)
    t = [torch.from_numpy(a) for a in (db, queries, ids, slot)]
    with pytest.raises(ValueError, match="task_block"):
        tops.distance_tasks(*t, task_block=96)
    with pytest.raises(ValueError, match="mode"):
        tops.distance_tasks(*t, mode="dense")
    with pytest.raises(ValueError):
        tops.distance_tasks(*t, metric="cosine")


def test_kernel_wrappers_refuse_cpu_and_bad_inputs():
    """The CUDA wrappers check every input and never take a CPU tensor
    (a CPU tensor goes to the plain version through the dispatcher)."""
    db, queries, ids, slot = (torch.from_numpy(a) for a in
                              _inputs(100, 32, 4, 256, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        tdist.distance_slot_gather(db, queries, ids, slot)
    with pytest.raises(ValueError, match="CUDA"):
        tdist.distance_onehot(db, queries, ids, slot)
    assert tdist.launches == {"distance_slot_gather": 0, "distance_onehot": 0}
    bad = [(db.double(), queries, ids, slot), (db.t(), queries, ids, slot),
           (db, queries[:, :16], ids, slot), (db, queries, ids.long(), slot),
           (db, queries, ids, slot[:10]), (db, queries, ids[None], slot)]
    for args in bad:
        with pytest.raises(ValueError):
            tdist.check_inputs(*args, metric="l2")
    with pytest.raises(ValueError):
        tdist.check_inputs(db, queries, ids, slot, metric="cos")
