"""The port's continuous-batching engine against the JAX engine on the same
numpy inputs: bit-equal result ids, extend counts and task counts, with
distances at rtol 1e-6 (the two sum in different orders), with the JAX
engine on its jnp reference and on its Pallas kernel in interpret mode.
Also: evict→restore inside the port, a JAX checkpoint and a JAX engine
state resumed in the port, admission-order independence, per-slot params."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import VectorPoolConfig  # noqa: E402
from repro.core import continuous_batching as jcb  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro.vector.graph import make_cagra_graph  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import continuous_batching as tcb  # noqa: E402

CFG = VectorPoolConfig(num_vectors=2000, dim=64, graph_degree=8,
                       max_requests=8, top_m=16, parents_per_step=2,
                       task_batch=256, visited_slots=256, top_k=10,
                       extend_chunk=4)


@pytest.fixture(scope="module")
def data():
    db, queries = make_dataset(2000, 64, num_clusters=16, num_queries=64,
                               seed=7)
    graph = make_cagra_graph(db, degree=8, seed=7)
    return db, graph, queries


def _engines(cfg, data, use_pallas=False, seed=3):
    db, graph, _ = data
    return (jcb.ContinuousBatchingEngine(cfg, db, graph,
                                         use_pallas=use_pallas, seed=seed),
            tcb.ContinuousBatchingEngine(cfg, db, graph, device="cpu",
                                         seed=seed))


# Distance tolerance by (metric, mode). Slot-gather l2 distances are sums
# of squares: the two summation orders agree to rtol 1e-6. ip distances
# cancel (they can be ~0), so their error is absolute, ~d·eps·|x||q|
# (d = 64 here). The one-hot form computes |x|² − 2x·q + |q|² with terms
# of ~10², so its error is absolute too: the 1e-4 that tests/test_kernels.py
# allows between the two modes.
ATOL = {("l2", "slot_gather"): 0.0, ("ip", "slot_gather"): 1e-5,
        ("l2", "matmul_onehot"): 1e-4}


def _assert_same_completions(cj, ct, atol=0.0):
    """Completion tuples (rid, ids, dists, extends[, substep]) equal."""
    assert [c[0] for c in cj] == [c[0] for c in ct]
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(np.asarray(a[1]), b[1], err_msg="ids")
        np.testing.assert_allclose(b[2], np.asarray(a[2]), rtol=1e-6,
                                   atol=atol)
        assert tuple(a[3:]) == tuple(b[3:]), (a[0], a[3:], b[3:])


def _assert_same_state(sj, st, atol=0.0):
    sj = jax.device_get(sj)
    for f in ("top_ids", "expanded", "visited", "active", "extends",
              "budget"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    np.testing.assert_allclose(st.top_dists.numpy(), np.asarray(sj.top_dists),
                               rtol=1e-6, atol=atol)
    np.testing.assert_array_equal(st.query_vecs.numpy(),
                                  np.asarray(sj.query_vecs))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("metric,mode", [("l2", "slot_gather"),
                                         ("ip", "slot_gather"),
                                         ("l2", "matmul_onehot")])
def test_engine_bit_equal_to_jax(data, use_pallas, metric, mode):
    cfg = dataclasses.replace(CFG, metric=metric, distance_mode=mode)
    ej, et = _engines(cfg, data, use_pallas)
    queries = data[2]
    reqs = [(i, queries[i]) for i in range(6)]
    atol = ATOL[metric, mode]
    assert ej.admit_batch(reqs) == et.admit_batch(reqs)
    _assert_same_state(ej.state, et.state, atol)
    for k in (4, 1, 4):
        cj, tj = ej.step_multi(k)
        ct, tt = et.step_multi(k)
        _assert_same_completions(cj, ct, atol)
        np.testing.assert_array_equal(tt, np.asarray(tj))
    _assert_same_state(ej.state, et.state, atol)
    # refill the freed slots mid-flight, then drain
    more = [(100 + i, queries[10 + i]) for i in range(ej.num_free)]
    ej.admit_batch(more)
    et.admit_batch(more)
    _assert_same_completions(ej.run_to_completion(), et.run_to_completion(),
                             atol)
    assert ej.steps == et.steps and ej.total_tasks == et.total_tasks
    assert ej.total_live_slots == et.total_live_slots


def test_step_and_slot_params_bit_equal(data):
    """Per-slot search params (budget, top-k, entry segment) and the
    single-step API."""
    ej, et = _engines(CFG, data)
    queries = data[2]
    params = [None, tcb.SlotParams(top_k=4), tcb.SlotParams(budget=3),
              tcb.SlotParams(entry_lo=1000, entry_hi=2000, top_k=6)]
    jparams = [None if p is None else jcb.SlotParams(**dataclasses.asdict(p))
               for p in params]
    ej.admit_batch([(i, queries[i], p) for i, p in enumerate(jparams)])
    et.admit_batch([(i, queries[i], p) for i, p in enumerate(params)])
    done_j, done_t = [], []
    while ej.num_active:
        cj, nj = ej.step()
        ct, nt = et.step()
        assert nj == nt
        done_j += cj
        done_t += ct
    assert et.num_active == 0
    _assert_same_completions(done_j, done_t)
    got = {c[0]: c for c in done_t}
    assert len(got[1][1]) == 4 and got[2][3] == 3 and len(got[3][1]) == 6


def _drain(engine):
    return {rid: (ids, dists, ext)
            for rid, ids, dists, ext in engine.run_to_completion()}


def test_evict_restore_bit_identity(data):
    """Inside the port: a search preempted mid-flight and resumed gives
    the same ids, distances and extend count as one run uninterrupted."""
    db, graph, queries = data
    e1 = tcb.ContinuousBatchingEngine(CFG, db, graph, device="cpu", seed=3)
    e1.admit_batch([(i, queries[i]) for i in range(6)])
    r1 = _drain(e1)
    e2 = tcb.ContinuousBatchingEngine(CFG, db, graph, device="cpu", seed=3)
    e2.admit_batch([(i, queries[i]) for i in range(6)])
    e2.step_multi(2)
    before = {f: getattr(e2.state, f).clone() for f in ("top_ids", "active")}
    live = sorted(e2.slot_request.values())
    snaps = e2.snapshot(live)  # non-destructive
    for f, v in before.items():
        assert torch.equal(getattr(e2.state, f), v), f
    victims = live[:3]
    ckpts = e2.preempt(victims)
    assert sorted(r for r, _ in ckpts) == victims and e2.num_free >= 3
    for (_, a), (_, b) in zip(ckpts, snaps[:3]):
        np.testing.assert_array_equal(a.visited, b.visited)
    e2.step_multi(4)  # survivors progress while victims sit evicted
    e2.resume_batch(ckpts)
    r2 = _drain(e2)
    assert r1.keys() == r2.keys()
    for rid in r1:
        np.testing.assert_array_equal(r1[rid][0], r2[rid][0])
        np.testing.assert_array_equal(r1[rid][1], r2[rid][1])
        assert r1[rid][2] == r2[rid][2]


def test_jax_checkpoint_resumes_in_port(data):
    """A JAX SlotCheckpoint, converted, finishes in the port engine with the
    JAX engine's uninterrupted result."""
    db, graph, queries = data
    ref = jcb.ContinuousBatchingEngine(CFG, db, graph, use_pallas=False,
                                       seed=3)
    ref.admit_batch([(i, queries[i]) for i in range(5)])
    want = _drain(ref)
    ej = jcb.ContinuousBatchingEngine(CFG, db, graph, use_pallas=False,
                                      seed=3)
    ej.admit_batch([(i, queries[i]) for i in range(5)])
    ej.step_multi(3)
    live = sorted(ej.slot_request.values())
    ckpts = [(rid, convert.checkpoint_from_numpy(c))
             for rid, c in ej.preempt(live)]
    et = tcb.ContinuousBatchingEngine(CFG, db, graph, device="cpu", seed=99)
    et.resume_batch(ckpts)
    got = _drain(et)
    assert sorted(got) == live
    for rid in live:
        np.testing.assert_array_equal(got[rid][0], np.asarray(want[rid][0]))
        np.testing.assert_allclose(got[rid][1], np.asarray(want[rid][1]),
                                   rtol=1e-6)
        assert got[rid][2] == want[rid][2]


def test_jax_engine_state_continues_in_port(data):
    """A whole JAX EngineState pulled with jax.device_get and converted
    continues in the port step for step."""
    ej, et = _engines(CFG, data)
    queries = data[2]
    reqs = [(i, queries[i]) for i in range(8)]
    ej.admit_batch(reqs)
    et.admit_batch(reqs)
    ej.step_multi(4)
    et.state = convert.engine_state_from_numpy(jax.device_get(ej.state),
                                               device="cpu")
    et.slot_request = dict(ej.slot_request)
    et.free_slots = list(ej.free_slots)
    _assert_same_completions(ej.run_to_completion(), et.run_to_completion())


def test_results_independent_of_admission_order(data):
    db, graph, queries = data
    e1 = tcb.ContinuousBatchingEngine(CFG, db, graph, device="cpu", seed=3)
    e1.admit_batch([(i, queries[i]) for i in range(6)])
    e2 = tcb.ContinuousBatchingEngine(CFG, db, graph, device="cpu", seed=3)
    e2.admit_batch([(i, queries[i]) for i in reversed(range(6))])
    r1, r2 = _drain(e1), _drain(e2)
    assert r1.keys() == r2.keys()
    for rid in r1:
        np.testing.assert_array_equal(r1[rid][0], r2[rid][0])


def test_index_shared_not_copied(data):
    """Engines over index tensors use them as they are (no copy of db)."""
    db, graph, _ = data
    db_t, graph_t = convert.index_from_numpy(db, graph, device="cpu")
    e = tcb.ContinuousBatchingEngine(CFG, db_t, graph_t, device="cpu")
    assert e.db.data_ptr() == db_t.data_ptr()
    assert e.graph.data_ptr() == graph_t.data_ptr()
