"""The port's ShardedVectorPool against the JAX package's on the scenarios
of ``test_sharded.py`` and ``test_dispatch_pipeline.py``: completions in
the same order, result ids bit-equal and in the same order, distances
within 1e-5, simulated completion times and every ``PoolMetrics`` counter
equal.

Each arm is held against the JAX package's same arm: the legacy serial
path (``megabatch_enabled=False``) against the JAX legacy arm, and the
megabatched path — device merge and double buffer each on and off —
against the JAX megabatch arm (the JAX arms are not bit-equal to each
other under inserts: ROADMAP Queue C)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs.base import VectorPoolConfig  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import trinity_pool as jtp  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro_torch.configs.base import VectorPoolConfig as TConfig  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import trinity_pool as ttp  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its tests run many tiny ops,
    and several test workers on one machine would otherwise oversubscribe
    its cores with torch's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARMS = {
    "legacy": dict(megabatch_enabled=False, device_merge_enabled=False,
                   double_buffer_enabled=False),
    "mega": dict(megabatch_enabled=True, device_merge_enabled=False,
                 double_buffer_enabled=False),
    "mega+merge": dict(megabatch_enabled=True, device_merge_enabled=True,
                       double_buffer_enabled=False),
    "mega+dbuf": dict(megabatch_enabled=True, device_merge_enabled=False,
                      double_buffer_enabled=True),
    "mega+merge+dbuf": dict(megabatch_enabled=True, device_merge_enabled=True,
                            double_buffer_enabled=True),
}
TWO_ARMS = ("legacy", "mega+merge+dbuf")
COUNTERS = ("extend_steps", "tasks_emitted", "tasks_capacity", "preemptions",
            "resumes", "preempt_time", "inserts", "cache_evictions",
            "broadcasts", "sub_searches", "merges", "shard_reassignments",
            "drains", "replica_deaths", "rescued", "retries",
            "retries_exhausted", "hedges", "hedges_won", "hedges_wasted",
            "probes_cancelled", "shard_waits", "rebalances",
            "migrated_entries", "shard_losses", "cache_recovered",
            "cache_lost")


@pytest.fixture(scope="module")
def setup():
    return make_dataset(1600, 16, num_clusters=12, num_queries=64, seed=1)


def _cfgs(arm, **kw):
    base = dict(num_vectors=1600, dim=16, graph_degree=8, max_requests=8,
                top_m=16, parents_per_step=2, task_batch=256,
                visited_slots=256, top_k=10, num_shards=4,
                semantic_cache_enabled=True, cache_capacity=16)
    base.update(ARMS[arm])
    base.update(kw)
    return VectorPoolConfig(**base), TConfig(**base)


def _pools(setup, arm, replicas_per_shard=1, **kw):
    db, _ = setup
    jc, tc = _cfgs(arm, **kw)
    return (jtp.ShardedVectorPool(jc, db, use_pallas=False, seed=0,
                                  replicas_per_shard=replicas_per_shard),
            ttp.ShardedVectorPool(tc, db, device="cpu", seed=0,
                                  replicas_per_shard=replicas_per_shard))


def _assert_same(jp, tp):
    cj, ct = jp.metrics.completed, tp.metrics.completed
    assert [r.rid for r in ct] == [r.rid for r in cj]  # same order, once
    assert len({r.rid for r in ct}) == len(ct)
    for a, b in zip(cj, ct):
        assert (b.t_completed, b.extends_used, b.t_admitted, b.failed) == \
            (a.t_completed, a.extends_used, a.t_admitted, a.failed), a.rid
        if a.result_ids is None:
            assert b.result_ids is None, a.rid
            continue
        np.testing.assert_array_equal(b.result_ids, np.asarray(a.result_ids),
                                      err_msg=str(a.rid))
        np.testing.assert_allclose(b.result_dists,
                                   np.asarray(a.result_dists), rtol=1e-5,
                                   atol=1e-5, err_msg=str(a.rid))
    for f in COUNTERS:
        assert getattr(tp.metrics, f) == getattr(jp.metrics, f), f
    assert tp.cache_meta == jp.cache_meta
    assert [r.clock for r in tp.replicas] == [r.clock for r in jp.replicas]
    for a, b in zip(tp.shards.shards, jp.shards.shards):
        np.testing.assert_array_equal(a.db.numpy(), np.asarray(b.db))
        np.testing.assert_array_equal(a.graph.numpy(), np.asarray(b.graph))


def _drive(pool, mod, queries, n=40, gap=1e-4, insert_every=0, chaos=None,
           lookups=0):
    """test_dispatch_pipeline's paced probe (+ insert) stream, optional
    fault callbacks keyed by submission index, then ``lookups`` cache
    lookups: even ones repeat an inserted vector, odd ones are fresh."""
    rng = np.random.default_rng(5)
    t, inserted = 0.0, []
    for i in range(n):
        if insert_every and i % insert_every == 3:
            v = rng.standard_normal(pool.cfg.dim).astype(np.float32)
            inserted.append(v)
            pool.submit_insert(v, meta={"i": i}, t_now=t)
        else:
            pool.submit(mod.VectorRequest(i, "prefill",
                                          queries[i % len(queries)], t,
                                          t + 10.0))
        t += gap
        if chaos and i in chaos:
            pool.run_until(t)
            chaos[i](pool, t)
    pool.run_until(t + 5.0)
    t += 5.0
    for j in range(lookups):
        q = inserted[j % len(inserted)] if j % 2 == 0 \
            else rng.standard_normal(pool.cfg.dim).astype(np.float32)
        pool.submit(mod.VectorRequest(1000 + j, "cache_lookup", q, t,
                                      t + 1.0))
        t += gap
    pool.run_until(t + 5.0)


def _both(jp, tp, queries, **kw):
    _drive(jp, jsched, queries, **kw)
    _drive(tp, tsched, queries, **kw)
    _assert_same(jp, tp)


@pytest.mark.parametrize("arm", list(ARMS))
def test_probe_stream_matches_jax(setup, arm):
    jp, tp = _pools(setup, arm)
    _both(jp, tp, setup[1], n=32)
    assert tp.metrics.merges == 32 and tp.metrics.sub_searches == 32 * 4


@pytest.mark.parametrize("arm", list(ARMS))
def test_inserts_and_cache_lookups_match_jax(setup, arm):
    """Probes interleaved with inserts (each broadcast to its owning shard's
    replicas only), then repeated and fresh cache lookups fanned to the
    cache-holding shards."""
    jp, tp = _pools(setup, arm)
    _both(jp, tp, setup[1], n=48, insert_every=6, lookups=12)
    assert tp.metrics.inserts == 8
    hits = [r for r in tp.metrics.completed
            if r.kind == "cache_lookup" and r.result_ids is not None
            and r.result_dists[0] <= tp.cfg.cache_hit_threshold]
    assert len(hits) >= 3
    for r in hits:
        for gid in r.result_ids:
            assert tp.meta_at(int(gid), r.t_completed) == \
                jp.meta_at(int(gid), r.t_completed)


@pytest.mark.parametrize("arm", TWO_ARMS)
def test_bounded_cache_evictions_match_jax(setup, arm):
    jp, tp = _pools(setup, arm, cache_max_entries=2, cache_ttl_s=3e-4)
    _both(jp, tp, setup[1], n=60, gap=2e-4, insert_every=4, lookups=8)
    assert tp.metrics.cache_evictions > 0


@pytest.mark.parametrize("arm", TWO_ARMS)
def test_routed_fanout_matches_jax(setup, arm):
    jp, tp = _pools(setup, arm, nprobe_shards=1)
    _both(jp, tp, setup[1], n=24)
    assert tp.metrics.sub_searches == 24


@pytest.mark.parametrize("arm", TWO_ARMS)
def test_insert_routes_to_owning_shard_only(setup, arm):
    """test_sharded's insert routing: the owner gets every node and the
    broadcasts (two replicas, ``cache_replication``); no other shard's
    tensors are swapped."""
    db, _ = setup
    jp, tp = _pools(setup, arm)
    before = [sh.db for sh in tp.shards.shards]
    vec = db[7] + 0.01
    own = tp.shards.owning_shard(vec)
    for pool in (jp, tp):
        rng = np.random.default_rng(0)
        t = 0.0
        for i in range(10):
            pool.submit_insert(vec + rng.normal(0, 0.01, 16).astype(
                np.float32), meta={"tokens": i}, t_now=t)
            t += 5e-4
            pool.run_until(t)
        pool.run_until(t + 1.0)
    _assert_same(jp, tp)
    assert tp.shards.shards[own].cache_size == 10
    assert tp.metrics.broadcasts == 10 * len(tp.shard_replicas(own)) == 20
    for s, sh in enumerate(tp.shards.shards):
        if s != own:
            assert sh.cache_size == 0 and sh.db is before[s]


@pytest.mark.parametrize("arm", TWO_ARMS)
def test_empty_cache_lookup_and_registered_class_match_jax(setup, arm):
    _, queries = setup
    jp, tp = _pools(setup, arm)
    for mod, pool in ((jsched, jp), (tsched, tp)):
        pool.submit(mod.VectorRequest(1, "cache_lookup", queries[0], 0.0,
                                      0.1))
        pool.scheduler.register(mod.RetrievalClass("bulk", "fifo", 500.0))
        pool.submit(mod.VectorRequest(2, "bulk", queries[1], 0.0, 0.5))
        pool.run_until(1.0)
    _assert_same(jp, tp)
    assert tp.metrics.completed[0].result_ids is None  # immediate miss


@pytest.mark.parametrize("arm", TWO_ARMS)
def test_sole_shard_replica_straggler_matches_jax(setup, arm):
    jp, tp = _pools(setup, arm)
    for pool in (jp, tp):
        pool.set_slowdown(0, 10.0)
    _both(jp, tp, setup[1], n=16, gap=1e-3)
    assert len(tp.metrics.completed) == 16


def test_capacity_error_and_sharded_capacity(setup):
    db, queries = setup
    _, tc = _cfgs("mega+merge+dbuf", replica_max_rows=500)
    with pytest.raises(ttp.CapacityError, match="num_shards"):
        ttp.VectorPool(tc, db, np.zeros((len(db), 8), np.int32),
                       device="cpu")
    jp, tp = _pools(setup, "mega+merge+dbuf", replica_max_rows=500)
    assert all(sh.db.shape[0] <= 500 for sh in tp.shards.shards)
    _both(jp, tp, queries, n=8)


def test_merge_buffer_overflow_falls_back_to_host_merge(setup):
    """Two device merge-buffer rows for many concurrent parents: the rest
    take the sticky host path, as in the JAX package."""
    jp, tp = _pools(setup, "mega+merge+dbuf", merge_buffer_rows=2)
    _both(jp, tp, setup[1], n=32, gap=1e-5)


def test_lane_stack_grows_past_common_row_count(setup):
    """Two shards of 960 rows + a 64-row cache fill the stacked tensors'
    1024 rows; inserts into one shard double its cache mid-run, so the
    (G, N, d) stack doubles to 2048 rows with every lane's rows and state
    kept, and the results stay equal to the JAX megabatch arm's."""
    db, queries = make_dataset(1920, 16, num_clusters=12, num_queries=64,
                               seed=2)
    jc, tc = _cfgs("mega+merge+dbuf", num_vectors=1920, num_shards=2)
    jp = jtp.ShardedVectorPool(jc, db, use_pallas=False, seed=0)
    tp = ttp.ShardedVectorPool(tc, db, device="cpu", seed=0)
    assert tp._group.n_max == 1024
    vec = db[3]
    rng = np.random.default_rng(1)
    vecs = [vec + rng.normal(0, 0.05, 16).astype(np.float32)
            for _ in range(70)]
    for mod, pool in ((jsched, jp), (tsched, tp)):
        t = 0.0
        for i, v in enumerate(vecs):
            pool.submit_insert(v, t_now=t)
            pool.submit(mod.VectorRequest(i, "prefill", queries[i % 64], t,
                                          t + 10.0))
            t += 2e-4
            pool.run_until(t)
        pool.run_until(t + 5.0)
    assert tp._group.n_max == 2048
    _assert_same(jp, tp)
    g = tp._group
    for rep in tp.replicas:
        sh = tp.shards.shards[rep.shard]
        n = sh.db.shape[0]
        assert torch.equal(g.dbs[rep.engine.lane, :n], sh.db)
        assert torch.equal(g.graphs[rep.engine.lane, :n], sh.graph)


def test_checkpoints_are_shard_portable_across_lanes(setup):
    """A child preempted on one lane of a shard resumes bit-identically on
    the other lane of the same shard."""
    _, queries = setup
    _, tp = _pools(setup, "mega+merge+dbuf", replicas_per_shard=2)
    a, b = (r.engine for r in tp.shard_replicas(0))
    a.admit(77, queries[0])
    ref = a.run_to_completion()
    a.admit(77, queries[0])
    a.step_multi(2)
    b.resume_batch(a.preempt([77]))
    out = b.run_to_completion()
    np.testing.assert_array_equal(out[0][1], ref[0][1])
    assert out[0][3] == ref[0][3]


def test_unported_knobs_raise_naming_a9b(setup):
    """Once raising (ROADMAP A9b and item 11), now ported: the pool takes
    ``rebalance_enabled``, ``cache_backup_enabled`` and
    ``sanitizer_enabled``, and ``lose_shard`` runs; each equals the JAX
    package's on a stream with inserts and lookups around the loss."""
    kw = dict(rebalance_enabled=True, cache_backup_enabled=True,
              sanitizer_enabled=True, replicas_per_shard=2)
    for arm in ("legacy", "mega+merge+dbuf"):
        jp, tp = _pools(setup, arm, **kw)
        assert tp.sanitizer is not None
        for mod, pool in ((jsched, jp), (tsched, tp)):
            _drive(pool, mod, setup[1], n=24, insert_every=4)
            pool.lose_shard(pool.shards.cache_shards()[0])
            t = pool.replicas[0].clock
            for i, gid in enumerate(sorted(pool.cache_meta)):
                loc = pool.shards._gid_loc[gid]
                q = pool.shards.shards[loc[0]].db[loc[1]]
                pool.submit(mod.VectorRequest(2000 + i, "cache_lookup",
                                              np.asarray(q), t, t + 1.0))
            pool.run_until(t + 5.0)
        assert tp.metrics.shard_losses == 1 and tp.metrics.cache_lost == 0
        assert tp.metrics.cache_recovered > 0
        tp.sanitizer.assert_clean()
        _assert_same(jp, tp)
