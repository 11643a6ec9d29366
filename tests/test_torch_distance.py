"""The port's distance stage on the CPU: the plain-PyTorch versions and the
device dispatcher against the JAX package's Pallas kernels (interpret
mode) and its jnp references, on the sweep of tests/test_kernels.py; the
lane form (``distance_tasks_group``) against ``jax.vmap`` of the same."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import distance as jdist  # noqa: E402
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


# ---------------------------------------------------------------------------
# the lane form: G engines' tasks in one call
# ---------------------------------------------------------------------------

def _lane_inputs(G, N, d, R, T, seed, out_of_range=False):
    """G lanes, each with its own db, queries, ids and slots; each lane's
    dummies at other positions; ``out_of_range``: some ids past N."""
    rng = np.random.default_rng(seed)
    dbs = rng.normal(size=(G, N, d)).astype(np.float32)
    queries = rng.normal(size=(G, R, d)).astype(np.float32)
    ids = rng.integers(0, N, size=(G, T)).astype(np.int32)
    for g in range(G):
        ids[g, g::5 + g] = -1
        if out_of_range:
            ids[g, 1 + g::7] = N + g + np.arange(len(ids[g, 1 + g::7]))
    slot = rng.integers(0, R, size=(G, T)).astype(np.int32)
    return dbs, queries, ids, slot


_JAX_REF = {"slot_gather": jref.distance_tasks_ref,
            "matmul_onehot": jref.distance_tasks_onehot_ref}


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("N,d,R,T", SWEEP)
def test_group_matches_vmapped_pallas_and_jnp_ref(mode, metric, G, N, d, R,
                                                  T):
    """Lane g of ``distance_tasks_group`` is the JAX stage on lane g:
    ``jax.vmap`` of the Pallas kernel (interpret mode) and of the jnp
    reference, at the tolerance of the (T,) test above."""
    dbs, queries, ids, slot = _lane_inputs(G, N, d, R, T, seed=N + d + G)
    got = _port(tops.distance_tasks_group, dbs, queries, ids, slot,
                metric=metric, mode=mode)
    pallas = np.asarray(jax.vmap(
        lambda *a: jdist.distance_tasks(*a, metric=metric, mode=mode,
                                        interpret=True))(
        dbs, queries, ids, slot))
    want = np.asarray(jax.vmap(
        lambda *a: _JAX_REF[mode](*a, metric=metric))(dbs, queries, ids,
                                                     slot))
    assert got.shape == (G, T)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[ids < 0], np.float32(1e30))


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_group_out_of_range_ids_clamp_per_lane(mode, metric):
    """Ids past N gather each lane's own last row, as ``jax.vmap`` of the
    JAX gather does."""
    dbs, queries, ids, slot = _lane_inputs(3, 60, 32, 4, 256, seed=11,
                                           out_of_range=True)
    got = _port(tops.distance_tasks_group, dbs, queries, ids, slot,
                metric=metric, mode=mode)
    want = np.asarray(jax.vmap(
        lambda *a: _JAX_REF[mode](*a, metric=metric))(dbs, queries, ids,
                                                     slot))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["slot_gather", "matmul_onehot"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_group_of_one_is_the_single_call(mode, metric):
    """G = 1 gives the (T,) call's bits, and each lane of G = 3 gives the
    (T,) call's bits on that lane."""
    dbs, queries, ids, slot = _lane_inputs(3, 400, 64, 8, 256, seed=21)
    group = _port(tops.distance_tasks_group, dbs, queries, ids, slot,
                  metric=metric, mode=mode)
    for g in range(3):
        single = _port(tops.distance_tasks, dbs[g], queries[g], ids[g],
                       slot[g], metric=metric, mode=mode)
        one = _port(tops.distance_tasks_group, dbs[g:g + 1],
                    queries[g:g + 1], ids[g:g + 1], slot[g:g + 1],
                    metric=metric, mode=mode)
        np.testing.assert_array_equal(one[0], single)
        np.testing.assert_array_equal(group[g], single)


def test_group_refuses_mismatched_lanes_dims_and_dtypes():
    dbs, queries, ids, slot = (torch.from_numpy(a) for a in
                               _lane_inputs(2, 100, 32, 4, 256, seed=3))
    bad = [(dbs, queries[:1], ids, slot),        # G differs
           (dbs, queries, ids[:1], slot[:1]),
           (dbs, queries, ids, slot[:1]),
           (dbs, queries[..., :16], ids, slot),  # d differs
           (dbs, queries, ids, slot[:, :128]),   # T differs
           (dbs[0], queries, ids, slot),         # db not (G, N, d)
           (dbs, queries[0], ids, slot),
           (dbs, queries, ids[0], slot),
           (dbs.double(), queries, ids, slot),   # dtypes
           (dbs, queries.half(), ids, slot),
           (dbs, queries, ids.long(), slot),
           (dbs, queries, ids, slot.long()),
           (dbs.transpose(1, 2).contiguous().transpose(1, 2), queries, ids,
            slot)]                               # not contiguous
    for args in bad:
        with pytest.raises(ValueError):
            tops.distance_tasks_group(*args)
    with pytest.raises(ValueError, match="task_block"):
        tops.distance_tasks_group(dbs, queries, ids, slot, task_block=96)
    with pytest.raises(ValueError, match="mode"):
        tops.distance_tasks_group(dbs, queries, ids, slot, mode="dense")
    with pytest.raises(ValueError):
        tops.distance_tasks_group(dbs, queries, ids, slot, metric="cosine")


def test_group_kernel_wrappers_refuse_cpu_and_bad_inputs():
    """The lane wrappers take CUDA tensors only, and each form only its own
    shapes: (G, N, d) for ``*_group``, (N, d) for the (T,) wrappers."""
    dbs, queries, ids, slot = (torch.from_numpy(a) for a in
                               _lane_inputs(2, 100, 32, 4, 256, seed=4))
    for fn in (tdist.distance_slot_gather_group, tdist.distance_onehot_group):
        with pytest.raises(ValueError, match="CUDA"):
            fn(dbs, queries, ids, slot)
        with pytest.raises(ValueError):
            fn(dbs[0], queries[0], ids[0], slot[0])
    for fn in (tdist.distance_slot_gather, tdist.distance_onehot):
        with pytest.raises(ValueError):
            fn(dbs, queries, ids, slot)
    assert tdist.launches == {"distance_slot_gather": 0, "distance_onehot": 0}
