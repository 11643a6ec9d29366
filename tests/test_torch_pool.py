"""The port's VectorPool against the JAX package's on the same request
streams: equal per-request result ids, ``extends_used`` and
``t_completed``, and equal PoolMetrics counters — on the quickstart's
mixed prefill/decode stream, a preemption storm, replica kills (with and
without checkpoint rescue), cancellation, drains and elastic scaling."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.configs.base import VectorPoolConfig  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro.vector.graph import make_cagra_graph  # noqa: E402
from repro_torch.configs.base import VectorPoolConfig as TConfig  # noqa: E402

CFG = dict(num_vectors=2000, dim=64, graph_degree=8, max_requests=8,
           top_m=16, parents_per_step=2, task_batch=256, visited_slots=256,
           top_k=10, extend_chunk=4)
COUNTERS = ("extend_steps", "tasks_emitted", "tasks_capacity", "preemptions",
            "resumes", "preempt_time", "replica_deaths", "rescued", "retries",
            "retries_exhausted", "probes_cancelled", "drains")


@pytest.fixture(scope="module")
def data():
    db, queries = make_dataset(2000, 64, num_clusters=16, num_queries=64,
                               seed=11)
    graph = make_cagra_graph(db, degree=8, seed=11)
    return db, graph, queries


def _pools(data, replicas=1, **overrides):
    db, graph, _ = data
    jp = jcore.VectorPool(VectorPoolConfig(**CFG, **overrides), db, graph,
                          replicas=replicas, use_pallas=False, seed=0)
    tp = tcore.VectorPool(TConfig(**CFG, **overrides), db, graph,
                          replicas=replicas, device="cpu", seed=0)
    return jp, tp


def _quickstart_stream(mod, pool, queries, n, gap=1e-4):
    """examples/quickstart.py's stream: Poisson arrivals, 30% prefill
    (5 ms deadline), the rest decode (50 ms)."""
    rng = np.random.default_rng(0)
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(gap))
        kind = "prefill" if rng.random() < 0.3 else "decode"
        deadline = t + (0.005 if kind == "prefill" else 0.05)
        pool.submit(mod.VectorRequest(i, kind, queries[i], t, deadline))
    return t


def _assert_same(jp, tp):
    cj = {r.rid: r for r in jp.metrics.completed}
    ct = {r.rid: r for r in tp.metrics.completed}
    assert len(cj) == len(jp.metrics.completed)  # exactly once
    assert len(ct) == len(tp.metrics.completed)
    assert cj.keys() == ct.keys()
    for rid, a in cj.items():
        b = ct[rid]
        assert a.t_completed == b.t_completed, rid
        assert a.extends_used == b.extends_used, rid
        assert a.preemptions == b.preemptions and a.rescues == b.rescues
        if a.result_ids is None:
            assert b.result_ids is None and a.failed and b.failed
            continue
        np.testing.assert_array_equal(b.result_ids, np.asarray(a.result_ids))
        np.testing.assert_allclose(b.result_dists, np.asarray(a.result_dists),
                                   rtol=1e-6)
    for f in COUNTERS:
        assert getattr(jp.metrics, f) == getattr(tp.metrics, f), f
    assert jp.scheduler.controller.history == tp.scheduler.controller.history


@pytest.mark.parametrize("preemption", [True, False])
def test_quickstart_stream_matches_jax(data, preemption):
    queries = data[2]
    jp, tp = _pools(data, preemption_enabled=preemption)
    for mod, pool in ((jcore, jp), (tcore, tp)):
        t = _quickstart_stream(mod, pool, queries, 64, gap=2e-5)
        pool.run_until(t + 0.05)
    assert len(tp.metrics.completed) == 64
    _assert_same(jp, tp)
    assert tp.metrics.occupancy == jp.metrics.occupancy


def test_preemption_storm_matches_jax(data):
    """A prefill storm on a 20x-slowed replica plus tight decode probes:
    victims are evicted, checkpointed and resumed identically."""
    queries = data[2]
    kw = dict(decode_deadline_ms=3.0, prefill_deadline_ms=60.0,
              preempt_slack_ms=2.5, max_preemptions=1)
    jp, tp = _pools(data, **kw)
    for mod, pool in ((jcore, jp), (tcore, tp)):
        pool.set_slowdown(0, 20.0)
        for i in range(16):
            pool.submit(mod.VectorRequest(i, "prefill", queries[i], 0.0,
                                          60e-3))
        t = 0.3e-3
        for j in range(12):
            pool.submit(mod.VectorRequest(100 + j, "decode",
                                          queries[32 + j], t, t + 2e-3))
            t += 0.25e-3
        pool.run_until(0.2)
    assert tp.metrics.preemptions > 0
    assert tp.metrics.resumes == tp.metrics.preemptions
    _assert_same(jp, tp)


@pytest.mark.parametrize("rescue,backoff,retries", [(True, 0.0, 0),
                                                    (False, 0.0, 0),
                                                    (False, 1.0, 1)])
def test_kill_replica_mid_run_matches_jax(data, rescue, backoff, retries):
    queries = data[2]
    jp, tp = _pools(data, replicas=2, rescue_enabled=rescue,
                    retry_backoff_ms=backoff, max_retries=retries)
    for mod, pool in ((jcore, jp), (tcore, tp)):
        t = _quickstart_stream(mod, pool, queries, 48, gap=1e-5)
        pool.run_until(t * 0.5)
        assert sum(len(r.in_flight) for r in pool.replicas) > 0
        pool.kill_replica(0)
        pool.add_replica()
        pool.run_until(t * 0.7)
        pool.kill_replica(1)
        pool.run_until(t + 0.05)
    assert tp.metrics.replica_deaths == 2
    if rescue:
        assert tp.metrics.rescued > 0
    else:
        assert tp.metrics.retries > 0
    _assert_same(jp, tp)


def test_cancel_drain_and_elastic_match_jax(data):
    queries = data[2]
    jp, tp = _pools(data, replicas=2)
    for pool in (jp, tp):
        pool.elastic, pool.max_replicas = True, 3
    for mod, pool in ((jcore, jp), (tcore, tp)):
        t = _quickstart_stream(mod, pool, queries, 56, gap=2e-6)
        pool.run_until(t * 0.6)
        for rid in (0, 30, 55):  # in flight / queued / not yet released
            pool.cancel(rid)
        assert pool.drain_replica()
        pool.run_until(t + 0.05)
    assert tp.metrics.probes_cancelled >= 2 and tp.metrics.drains == 1
    assert tp.peak_replicas == jp.peak_replicas
    _assert_same(jp, tp)


def test_unported_features_raise(data):
    """Once raising, now ported: the runtime sanitizer (ROADMAP item 11)
    wraps the pool's seams (with the knob off nothing is wrapped), and the
    sharded pool takes rebalancing and the cache backup and loses a shard
    (item A9b); the answer cache and online inserts work as before."""
    db, graph, queries = data
    san = tcore.VectorPool(TConfig(**CFG, sanitizer_enabled=True), db, graph,
                           device="cpu")
    assert san.sanitizer is not None and "run_until" in vars(san)
    pool = tcore.VectorPool(TConfig(**CFG, semantic_cache_enabled=True),
                            db, graph, device="cpu")
    assert pool.sanitizer is None and "run_until" not in vars(pool)
    row = pool.submit_insert(queries[0], meta={"tokens": 1})
    assert row == len(db) and pool.cache_size == 1
    assert pool.submit_insert(queries[1]) is None  # rides the scheduler
    pool.run_until(1.0)
    assert pool.cache_size == 2 and pool.metrics.inserts == 2
    assert pool.meta_at(row, 1.0) == {"tokens": 1}
    sharded = dict(CFG, num_shards=2, semantic_cache_enabled=True)
    spool = tcore.ShardedVectorPool(
        TConfig(**sharded, rebalance_enabled=True, cache_backup_enabled=True,
                sanitizer_enabled=True), db, device="cpu")
    for i in range(3):
        spool.submit_insert(queries[i], meta={"tokens": i}, t_now=0.0)
    spool.run_until(1.0)
    s = spool.shards.cache_shards()[0]
    n = spool.shards.shards[s].cache_size
    spool.lose_shard(s)
    assert spool.metrics.shard_losses == 1
    assert spool.metrics.cache_recovered == n and spool.cache_size == 3
    spool.run_until(2.0)
    spool.sanitizer.assert_clean()


def test_replicas_share_one_index(data):
    db, graph, _ = data
    pool = tcore.VectorPool(TConfig(**CFG), db, graph, replicas=3,
                            device="cpu")
    ptrs = {r.engine.db.data_ptr() for r in pool.replicas}
    assert ptrs == {pool.index.db.data_ptr()}


def test_pool_db_is_the_host_corpus_view(data):
    """``pool.db`` is the host corpus, as the JAX pool keeps it (the serving
    path draws its probe vectors from it): the array passed in, or a numpy
    copy of a tensor."""
    jp, tp = _pools(data)
    assert tp.db is data[0] and jp.db is data[0]
    from_tensor = tcore.VectorPool(TConfig(**CFG), torch.as_tensor(data[0]),
                                   data[1], device="cpu")
    assert isinstance(from_tensor.db, np.ndarray)
    np.testing.assert_array_equal(from_tensor.db, jp.db)
