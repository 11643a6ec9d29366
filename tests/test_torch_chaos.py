"""The port's chaos harness (``serving/chaos.py``) and the pool's recovery
paths against the JAX package's, on the scenarios of ``test_chaos.py``:
deterministic fault schedules, replica kills and stragglers driven by
``run_pool``, checkpoint rescue, whole-shard loss with and without the
cache backup, the retry cap and backoff, and, on the cluster, instance
kills that tear down their probes and a schedule armed on the sim's event
heap (``arm``).

Each scenario runs in both packages on the same inputs: the injector logs
are equal, and the pools (``test_torch_sharded_pool._assert_same``) and
sims (``test_torch_cluster.assert_sims_equal``) end equal."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs.base import VectorPoolConfig  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import trinity_pool as jtp  # noqa: E402
from repro.serving import chaos as jchaos  # noqa: E402
from repro.serving import request as jreq  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro.vector.graph import make_cagra_graph  # noqa: E402
from repro_torch.configs.base import VectorPoolConfig as TConfig  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import trinity_pool as ttp  # noqa: E402
from repro_torch.serving import chaos as tchaos  # noqa: E402
from repro_torch.serving import request as treq  # noqa: E402

from test_torch_cluster import assert_sims_equal, make_sims  # noqa: E402
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


def _kw(**kw):
    base = dict(num_vectors=3000, dim=32, graph_degree=16, max_requests=16,
                top_m=32, parents_per_step=2, task_batch=2048,
                visited_slots=512, top_k=10, semantic_cache_enabled=True,
                cache_capacity=64, num_shards=4)
    base.update(kw)
    return base


def _pools(setup, rps=None, **kw):
    db, _ = setup
    extra = {} if rps is None else dict(replicas_per_shard=rps)
    return (jtp.ShardedVectorPool(VectorPoolConfig(**_kw(**kw)), db,
                                  use_pallas=False, seed=0, **extra),
            ttp.ShardedVectorPool(TConfig(**_kw(**kw)), db, device="cpu",
                                  seed=0, **extra))


def _burst(pool, mod, queries, n, gap=1e-4, deadline=0.05):
    t = 0.0
    for i in range(n):
        pool.submit(mod.VectorRequest(i, "prefill", queries[i], t,
                                      t + deadline))
        t += gap
    return t


def _once(pool, n):
    assert sorted(r.rid for r in pool.metrics.completed) == list(range(n))


def test_schedules_equal_jax():
    """Same arguments, same schedule, per kind independent of the others,
    in both packages."""
    rates = {"kill_replica": 5.0, "straggle_replica": 3.0, "kv_degrade": 2.0}
    for seed, more in ((7, {}), (8, {"kill_decode": 1.0}),
                       (3, {"lose_shard": 9.0, "straggle_decode": 4.0})):
        r = dict(rates, **more)
        a = tchaos.make_schedule(seed, 0.0, 4.0, r, slow_factor=5.0,
                                 slow_duration=0.02, downtime=0.3)
        b = jchaos.make_schedule(seed, 0.0, 4.0, r, slow_factor=5.0,
                                 slow_duration=0.02, downtime=0.3)
        assert [vars(e) for e in a] == [vars(e) for e in b] and a
    assert tchaos.POOL_KINDS == jchaos.POOL_KINDS
    assert tchaos.CLUSTER_KINDS == jchaos.CLUSTER_KINDS
    with pytest.raises(AssertionError):
        tchaos.make_schedule(0, 0.0, 1.0, {"set_on_fire": 1.0})


@pytest.mark.parametrize("arm", ["default", "legacy"])
def test_replica_kills_and_stragglers_match_jax(setup, arm):
    """A seeded kill + straggler schedule driven by ``run_pool`` against a
    live burst: every request once, the respawns restore the count, the
    injector logs equal."""
    _, queries = setup
    jp, tp = _pools(setup, **(ARMS[arm] if arm != "default" else {}))
    n_reps = len(tp.replicas)
    t_last = _burst(jp, jsched, queries, 48)
    _burst(tp, tsched, queries, 48)
    logs = []
    for chaos, pool in ((jchaos, jp), (tchaos, tp)):
        sched = chaos.make_schedule(
            3, 5e-4, t_last + 0.02,
            {"kill_replica": 400.0, "straggle_replica": 200.0},
            slow_duration=2e-3, downtime=2e-3)
        inj = chaos.ChaosInjector(sched, seed=3)
        inj.run_pool(pool, t_last + 1.0)
        logs.append((inj.log, inj.injected))
    assert logs[1] == logs[0] and logs[1][1] >= 3
    assert tp.metrics.replica_deaths >= 1 and len(tp.replicas) == n_reps
    _once(tp, 48)
    _assert_same(jp, tp)


def test_impossible_faults_skip_as_in_jax(setup):
    db, queries = setup
    graph = make_cagra_graph(db, 16, seed=1)
    kw = _kw(num_shards=1, semantic_cache_enabled=False)
    jp = jtp.VectorPool(VectorPoolConfig(**kw), db, graph, use_pallas=False)
    tp = ttp.VectorPool(TConfig(**kw), db, graph, device="cpu")
    logs = []
    for chaos, mod, pool in ((jchaos, jsched, jp), (tchaos, tsched, tp)):
        _burst(pool, mod, queries, 4)
        inj = chaos.ChaosInjector([chaos.FaultEvent(1e-4, "lose_shard"),
                                   chaos.FaultEvent(2e-4, "kill_replica")],
                                  seed=0)
        inj.run_pool(pool, 1.0)
        logs.append(inj.log)
    assert logs[1] == logs[0]
    assert [e["applied"] for e in logs[1]] == [False, False]
    _once(tp, 4)
    assert [r.t_completed for r in tp.metrics.completed] == \
        [r.t_completed for r in jp.metrics.completed]


def test_rescued_children_match_jax_and_the_undisturbed_run(setup):
    """rescue_enabled with one engine seed a shard: a mid-burst kill
    rescues every in-flight child from its snapshot; the results equal
    the undisturbed run's and the JAX package's."""
    _, queries = setup
    kw = dict(rebalance_enabled=True, rescue_enabled=True)
    _, ref = _pools(setup, **kw)
    t_last = _burst(ref, tsched, queries, 24)
    ref.run_until(t_last + 1.0)
    jp, tp = _pools(setup, **kw)
    for mod, pool in ((jsched, jp), (tsched, tp)):
        _burst(pool, mod, queries, 24)
        t = 0.0
        while not any(rep.in_flight for rep in pool.replicas):
            t += 2e-4
            assert t < t_last
            pool.run_until(t)
        pool.kill_replica(max(range(len(pool.replicas)),
                              key=lambda i: len(pool.replicas[i].in_flight)))
        pool.run_until(t_last + 1.0)
    assert tp.metrics.rescued >= 1 and tp.metrics.retries == 0
    _assert_same(jp, tp)
    want = {r.rid: r for r in ref.metrics.completed}
    for r in tp.metrics.completed:
        np.testing.assert_array_equal(r.result_ids, want[r.rid].result_ids)
        assert r.extends_used == want[r.rid].extends_used


def _fill_cache(pool, db, k=6):
    rng = np.random.default_rng(0)
    t = 0.0
    for i in range(k):
        vec = (db[7] + rng.normal(0, 0.01, db.shape[1])).astype(np.float32)
        pool.submit_insert(vec, meta={"tokens": i}, t_now=t)
        t += 5e-4
        pool.run_until(t)
    pool.run_until(t + 0.5)
    return t + 0.5


@pytest.mark.parametrize("backup", [True, False], ids=["backup", "no-backup"])
@pytest.mark.parametrize("arm", ["default", "legacy"])
def test_shard_loss_matches_jax(setup, backup, arm):
    """``lose_shard`` on the cache-holding shard: with the backup every
    entry is re-homed onto the least-occupied surviving shard under its
    gid, and repeat lookups hit it; without, every entry is lost and a
    lookup misses at once. The megabatched port's lanes hold their shards'
    indexes afterwards."""
    db, _ = setup
    jp, tp = _pools(setup, cache_backup_enabled=backup,
                    **(ARMS[arm] if arm != "default" else {}))
    t = _fill_cache(jp, db)
    assert _fill_cache(tp, db) == t
    gids = sorted(tp.cache_meta)
    s = tp.shards.cache_shards()[0]
    assert jp.shards.cache_shards()[0] == s
    for pool in (jp, tp):
        pool.lose_shard(s)
    m = tp.metrics
    assert (m.shard_losses, m.cache_recovered, m.cache_lost) == \
        ((1, 6, 0) if backup else (1, 0, 6))
    assert sorted(tp.cache_meta) == (gids if backup else [])
    _assert_same(jp, tp)
    assert tp.shards._gid_loc == jp.shards._gid_loc
    if tp._group is not None:
        g = tp._group
        for rep in tp.replicas:
            sh = tp.shards.shards[rep.shard]
            n = sh.db.shape[0]
            assert torch.equal(g.dbs[rep.engine.lane, :n], sh.db)
            assert torch.equal(g.graphs[rep.engine.lane, :n], sh.graph)
        assert [c[0] for c in tp.lane_copies].count("rehome") == 1
    for mod, pool in ((jsched, jp), (tsched, tp)):
        rng = np.random.default_rng(0)
        tt = t
        for i in range(6):
            vec = (db[7] + rng.normal(0, 0.01, db.shape[1])).astype(
                np.float32)
            pool.submit(mod.VectorRequest(1000 + i, "cache_lookup", vec, tt,
                                          tt + 0.05))
            tt += 1e-3
        pool.run_until(tt + 1.0)
    _assert_same(jp, tp)
    done = {r.rid: r for r in tp.metrics.completed if r.rid >= 1000}
    for i in range(6):
        ids = done[1000 + i].result_ids
        assert (int(ids[0]) in gids) if backup else ids is None


def _run_until_in_flight(pool):
    pool.set_slowdown(0, 50.0)
    t = pool.replicas[0].clock
    while not pool.replicas[0].in_flight:
        t += 2e-4
        assert t < 1.0
        pool.run_until(t)


@pytest.mark.parametrize("case", ["retry_cap", "backoff"])
def test_retry_cap_and_backoff_match_jax(setup, case):
    _, queries = setup
    kw = dict(max_retries=1) if case == "retry_cap" \
        else dict(retry_backoff_ms=5.0)
    jp, tp = _pools(setup, rps=1, num_shards=1, **kw)
    for mod, pool in ((jsched, jp), (tsched, tp)):
        pool.submit(mod.VectorRequest(0, "prefill", queries[0], 0.0, 10.0))
        _run_until_in_flight(pool)
        pool.kill_replica(0)
        if case == "retry_cap":
            _run_until_in_flight(pool)
            pool.kill_replica(0)
        else:
            assert len(pool._pending) == 1
        pool.set_slowdown(0, 1.0)
        pool.run_until(pool.replicas[0].clock + 1.0)
    done = tp.metrics.completed
    assert len(done) == 1 and done[0].failed == (case == "retry_cap")
    _assert_same(jp, tp)


@pytest.fixture(scope="module")
def mono(setup):
    db, _ = setup
    return db, make_cagra_graph(db, 16, seed=1)


def _cluster(mono, **kw):
    return make_sims(*mono, _kw(num_shards=1), **kw)


def _arrivals(sims, n, seed, max_new, rag, gap):
    for sim, G in zip(sims, (jreq.GenRequest, treq.GenRequest)):
        rng = np.random.default_rng(seed)
        t = 0.0
        for i in range(n):
            t += float(rng.exponential(gap))
            sim.arrive(G(i, prompt_len=int(rng.integers(64, 512)),
                         max_new_tokens=max_new, t_arrival=t,
                         rag_interval=rag))
    return t


def test_cancel_probes_tears_down_orphans_as_in_jax(mono):
    sims = _cluster(mono)
    for sim, G in zip(sims, (jreq.GenRequest, treq.GenRequest)):
        req = G(5, prompt_len=128, max_new_tokens=8, t_arrival=0.0)
        sim._submit_probe(req, "prefill", lambda r, v: None)
        other = G(6, prompt_len=128, max_new_tokens=8, t_arrival=0.0)
        sim._submit_probe(other, "prefill", lambda r, v: None)
        sim._cancel_probes(req)
        assert len(sim._probe_cb) == 1
        sim.vector_pool.run_until(1.0)
    assert [r.rid for r in sims[1].vector_pool.metrics.completed] == \
        [r.rid for r in sims[0].vector_pool.metrics.completed]
    assert sims[1].vector_pool.metrics.probes_cancelled == 1


@pytest.mark.parametrize("kind", ["kill_decode", "kill_prefill", "armed"])
def test_cluster_faults_match_jax(mono, kind):
    """A decode instance killed while its requests hold probes (the probes
    are cancelled, the requests re-prefilled), a prefill instance killed
    and revived, and a schedule of every cluster fault kind (instance
    kills, decode stragglers, KV link degradations) armed on the sim:
    every request finishes once, and the sims end equal."""
    js, ts = _cluster(mono, n_decode=3 if kind != "kill_prefill" else 2)
    if kind == "kill_prefill":
        t = _arrivals((js, ts), 8, 1, 12, 8, 0.003)
        for sim in (js, ts):
            sim.schedule(2e-3, sim.kill_prefill(0))
            sim.schedule(0.05, sim.revive_prefill(0))
    elif kind == "kill_decode":
        t = _arrivals((js, ts), 10, 0, 16, 4, 0.004)
        def kill_when_probed(sim):
            def fire():
                for _, (greq, _, _) in sim._probe_cb.items():
                    for idx, inst in enumerate(sim.decode_pool):
                        if inst.health.alive and \
                                greq in inst.active.values():
                            sim.kill_decode(idx)()
                            return
                sim.schedule(sim.t_now + 5e-4, fire)
            return fire

        for sim in (js, ts):
            sim.schedule(t * 0.2, kill_when_probed(sim))
    else:
        t = _arrivals((js, ts), 10, 2, 16, 4, 0.004)
        injs = []
        for chaos, sim in ((jchaos, js), (tchaos, ts)):
            sched = chaos.make_schedule(
                0, 0.0, t, {k: 120.0 for k in chaos.CLUSTER_KINDS},
                slow_duration=0.02, downtime=0.05)
            inj = chaos.ChaosInjector(sched, seed=0)
            inj.arm(sim)
            injs.append(inj)
    for sim in (js, ts):
        sim.run(t + 0.5)
    s = ts.metrics.summary(t + 0.5)
    assert sorted(r.rid for r in ts.metrics.finished) == \
        list(range(s["requests"]))
    assert_sims_equal(js, ts, t + 0.5)
    if kind == "kill_decode":
        assert s["decode_deaths"] == 1 and s["probes_cancelled"] >= 1
    elif kind == "kill_prefill":
        assert s["prefill_deaths"] == 1 and ts.prefill_pool[0].health.alive
    else:
        assert injs[1].log == injs[0].log and injs[1].injected >= 1
        assert {e["kind"] for e in injs[1].log if e["applied"]} == \
            set(tchaos.CLUSTER_KINDS)
        assert ts.kv_link.bandwidth == pytest.approx(js.kv_link.bandwidth)
