"""The port's workload-adaptive shard rebalancing against the JAX
package's, on the scenarios of ``test_rebalance.py``: replica
reassignment toward a hot shard, cooldown and hysteresis, a planned move
with children in flight (checkpoint-intact), the per-shard engine seed,
and cache-entry migration with stable gids and timestamps.

Both packages run each scenario on the same inputs; the port's arm is held
to the JAX package's same arm (its default megabatched arm, and the legacy
arm where named) with the equalities of ``test_torch_sharded_pool.py``:
completions in the same order with equal ids, times and counters, equal
replica clocks and equal shard contents."""
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

from test_torch_sharded_pool import ARMS, _assert_same  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its tests run many tiny ops,
    and several test workers on one machine would otherwise oversubscribe
    its cores with torch's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return make_dataset(3000, 32, num_clusters=16, num_queries=64, seed=1)


def _kw(arm="default", **kw):
    base = dict(num_vectors=3000, dim=32, graph_degree=16, max_requests=8,
                top_m=32, parents_per_step=2, task_batch=2048,
                visited_slots=512, top_k=10, semantic_cache_enabled=True,
                cache_capacity=64, num_shards=4, rebalance_enabled=True,
                rebalance_cooldown_s=0.002)
    if arm != "default":
        base.update(ARMS[arm])
    base.update(kw)
    return base


def _static(**kw):
    """test_rebalance's seed-matched static arm: the machinery on (one
    engine seed a shard) but thresholds no action can clear."""
    return dict(dict(rebalance_hot_factor=1e18,
                     rebalance_migrate_watermark=1e18), **kw)


def _pools(setup, kw, rps=2):
    db, _ = setup
    return (jtp.ShardedVectorPool(VectorPoolConfig(**kw), db,
                                  use_pallas=False, replicas_per_shard=rps,
                                  seed=0),
            ttp.ShardedVectorPool(TConfig(**kw), db, device="cpu",
                                  replicas_per_shard=rps, seed=0))


def _skewed_stream(pool, mod, queries, n=60, gap=5e-5):
    t = 0.0
    for i in range(n):
        q = queries[0] + np.float32(1e-3 * (i % 7))
        pool.submit(mod.VectorRequest(i, "prefill", q, t, t + 0.025))
        t += gap
    pool.run_until(t + 2.0)
    return t


def _lanes_hold_their_shards(tp):
    """Every lane of the megabatched port pool holds its shard's index."""
    if tp._group is None:
        return
    g = tp._group
    for rep in tp.replicas:
        sh = tp.shards.shards[rep.shard]
        n = sh.db.shape[0]
        assert torch.equal(g.dbs[rep.engine.lane, :n], sh.db)
        assert torch.equal(g.graphs[rep.engine.lane, :n], sh.graph)


@pytest.mark.parametrize("arm", ["default", "legacy"])
def test_rebalance_moves_replicas_to_hot_shard_matches_jax(setup, arm):
    _, queries = setup
    jp, tp = _pools(setup, _kw(arm, nprobe_shards=1))
    _skewed_stream(jp, jsched, queries)
    _skewed_stream(tp, tsched, queries)
    assert tp.metrics.rebalances > 0 and len(tp.metrics.completed) == 60
    _assert_same(jp, tp)
    assert [r.shard for r in tp.replicas] == [r.shard for r in jp.replicas]
    assert tp.shard_load_summary(0.01) == jp.shard_load_summary(0.01)
    _lanes_hold_their_shards(tp)
    moves = [c for c in tp.lane_copies if c[0] == "move"]
    assert len(moves) == tp.metrics.rebalances if arm == "default" \
        else not moves


def test_reassignment_is_result_neutral_as_in_jax(setup):
    """With one engine seed a shard, the moving arm returns the static
    arm's ids and distances; both arms equal the JAX package's."""
    _, queries = setup
    outs, moves = [], []
    for kw in (_kw(**_static(nprobe_shards=1)), _kw(nprobe_shards=1)):
        jp, tp = _pools(setup, kw)
        _skewed_stream(jp, jsched, queries, n=40)
        _skewed_stream(tp, tsched, queries, n=40)
        _assert_same(jp, tp)
        outs.append({r.rid: r for r in tp.metrics.completed})
        moves.append(tp.metrics.rebalances)
    assert moves[0] == 0 and moves[1] > 0
    assert set(outs[0]) == set(outs[1])
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid].result_ids,
                                      outs[1][rid].result_ids)


def test_cooldown_and_hysteresis_match_jax(setup):
    _, queries = setup
    jp, tp = _pools(setup, _kw(nprobe_shards=1, rebalance_cooldown_s=10.0))
    for mod, pool in ((jsched, jp), (tsched, tp)):
        t = 0.0
        for i in range(40):
            pool.submit(mod.VectorRequest(i, "prefill", queries[i % 2], t,
                                          t + 0.025))
            t += 5e-5
        pool.run_until(t + 2.0)
    assert tp.metrics.rebalances <= 1
    _assert_same(jp, tp)
    jp, tp = _pools(setup, _kw(rebalance_cooldown_s=0.0))
    for mod, pool in ((jsched, jp), (tsched, tp)):
        t = 0.0
        for i in range(32):
            pool.submit(mod.VectorRequest(i, "prefill", queries[i % 16], t,
                                          t + 0.025))
            t += 2e-4
        pool.run_until(t + 2.0)
    assert tp.metrics.rebalances == 0
    _assert_same(jp, tp)


@pytest.mark.parametrize("arm", ["default", "legacy"])
def test_planned_move_with_children_in_flight_matches_jax(setup, arm):
    """``_move_replica`` with the donor holding children: they are
    preempted off its lane, re-queued checkpoint-intact and resumed on the
    shard's other replica; the replacement lane holds the new shard."""
    _, queries = setup
    jp, tp = _pools(setup, _kw(arm, **_static(nprobe_shards=1)))
    for mod, pool in ((jsched, jp), (tsched, tp)):
        for i in range(24):
            pool.submit(mod.VectorRequest(
                i, "prefill", queries[0] + np.float32(1e-3 * (i % 7)), 0.0,
                0.025))

    def donor_load(pool):
        per_shard = {}
        for r in pool.replicas:
            per_shard[r.shard] = min(per_shard.get(r.shard, 1 << 30),
                                     len(r.in_flight))
        return max(per_shard.items(), key=lambda kv: kv[1])

    t = 0.0
    while donor_load(tp)[1] == 0:
        t += 2e-5
        assert t < 0.025
        jp.run_until(t)
        tp.run_until(t)
    src, n_in = donor_load(tp)
    assert donor_load(jp) == (src, n_in)
    for pool in (jp, tp):
        pool._move_replica(src, (src + 1) % 4, t, exclude=None)
    resumed = [r for r in tp.schedulers[src].q_edf if r.checkpoint is not None]
    assert 0 < len(resumed) <= n_in
    _lanes_hold_their_shards(tp)
    for pool in (jp, tp):
        pool.run_until(1.0)
    _assert_same(jp, tp)
    assert tp.metrics.resumes > 0
    assert all(r.preemptions == 0 for r in tp.metrics.completed)


def test_engine_seed_gating_matches_jax(setup):
    """Knob on: one engine seed a shard; knob off: one a replica — the
    port's per-request PRNG keys equal the JAX package's."""
    for kw in (_kw(), _kw(rebalance_enabled=False)):
        jp, tp = _pools(setup, kw)
        for s in range(4):
            jk = [np.asarray(r.engine._key).tolist()
                  for r in jp.shard_replicas(s)]
            tk = [np.asarray(r.engine._key).tolist()
                  for r in tp.shard_replicas(s)]
            assert tk == jk
            assert (tk[0] == tk[1]) == kw["rebalance_enabled"]


def _insert_skewed(pool, db, n, t_gap=2e-3):
    rng = np.random.default_rng(0)
    t = 0.0
    for i in range(n):
        pool.submit_insert(db[7] + rng.normal(0, .01, 32).astype(np.float32),
                           meta={"tokens": i}, t_now=t)
        t += t_gap
        pool.run_until(t)
    pool.run_until(t + 1.0)
    return t + 1.0


MIGRATE = dict(cache_capacity=16, cache_max_entries=12,
               rebalance_migrate_watermark=0.6, rebalance_migrate_batch=4,
               rebalance_cooldown_s=1e-3)


@pytest.mark.parametrize("arm", ["default", "legacy"])
def test_migration_matches_jax(setup, arm):
    """Cache entries migrate off the pressed shard before the cap evicts:
    the same gids land on the same shards and rows, with their metadata
    and birth times, and the lanes take the migrated rows."""
    db, _ = setup
    jp, tp = _pools(setup, _kw(arm, **MIGRATE))
    t_end = _insert_skewed(jp, db, 20)
    assert _insert_skewed(tp, db, 20) == t_end
    assert tp.metrics.migrated_entries > 0
    assert tp.metrics.cache_evictions == 0
    _assert_same(jp, tp)
    assert tp.shards._gid_loc == jp.shards._gid_loc
    for gid in tp.cache_meta:
        assert tp.meta_at(gid, t_end) == jp.meta_at(gid, t_end)
        assert tp.shards.born_at(gid) == jp.shards.born_at(gid)
    _lanes_hold_their_shards(tp)
    # a lookup finds a migrated entry on its new shard, as in JAX
    vec = db[7] + np.float32(0.01)
    for mod, pool in ((jsched, jp), (tsched, tp)):
        pool.submit(mod.VectorRequest(5000, "cache_lookup", vec, t_end,
                                      t_end + 0.1))
        pool.run_until(t_end + 1.0)
    _assert_same(jp, tp)


def test_corpus_search_after_migration_matches_jax(setup):
    db, queries = setup
    jp, tp = _pools(setup, _kw(**MIGRATE))
    for mod, pool in ((jsched, jp), (tsched, tp)):
        _insert_skewed(pool, db, 20)
        t = 10.0
        for i in range(16):
            pool.submit(mod.VectorRequest(1000 + i, "prefill", queries[i], t,
                                          t + 0.025))
            t += 2e-4
        pool.run_until(t + 1.0)
    assert tp.metrics.migrated_entries > 0
    _assert_same(jp, tp)


def test_migration_ttl_and_knob_off_match_jax(setup):
    """Birth times travel with migrated entries (TTL judged against the
    original insert), and with the knob off nothing moves."""
    db, queries = setup
    jp, tp = _pools(setup, _kw(cache_ttl_s=30.0, **MIGRATE))
    for pool in (jp, tp):
        _insert_skewed(pool, db, 20, t_gap=0.5)
    assert tp.metrics.migrated_entries > 0
    _assert_same(jp, tp)
    born0 = tp.shards.born_at(3000)
    assert born0 == jp.shards.born_at(3000)
    assert tp.meta_at(3000, born0 + 29.0) is not None
    assert tp.meta_at(3000, born0 + 31.0) is None
    jp, tp = _pools(setup, _kw(rebalance_enabled=False, nprobe_shards=1))
    _skewed_stream(jp, jsched, queries, n=40)
    _skewed_stream(tp, tsched, queries, n=40)
    assert tp.metrics.rebalances == tp.metrics.migrated_entries == 0
    _assert_same(jp, tp)
