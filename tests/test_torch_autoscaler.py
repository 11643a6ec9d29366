"""The port's SLO autoscaler (``serving/autoscaler.py``) against the JAX
package's, on the scenarios of ``test_autoscaler.py``: the closed loop on
a smoke-size ``drifting_mix_trace`` with ``bench_autoscale``'s controller
settings (equal ``signals_log`` and scale events), graceful prefill and
decode drains mid-burst, the vector pool's checkpoint-intact drain under
the sanitizer (clean, and tripping on a planted bug), and the budget and
knobs-off rules.

Both packages run each scenario on the same inputs; the sims end equal
(``test_torch_cluster.assert_sims_equal``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import AutoscalerConfig as JAuto  # noqa: E402
from repro.configs.base import VectorPoolConfig  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import trinity_pool as jtp  # noqa: E402
from repro.serving import cluster as jcl  # noqa: E402
from repro.serving import traffic as jtraffic  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro.vector.graph import make_cagra_graph  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import AutoscalerConfig as TAuto  # noqa: E402
from repro_torch.configs.base import VectorPoolConfig as TConfig  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import trinity_pool as ttp  # noqa: E402
from repro_torch.serving import cluster as tcl  # noqa: E402
from repro_torch.serving import traffic as ttraffic  # noqa: E402

from test_torch_cluster import (POOL_KW, assert_pools_equal,  # noqa: E402
                                assert_sims_equal, make_sims, workload)


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
def mono():
    db, queries = make_dataset(2000, 64, num_clusters=16, num_queries=32,
                               seed=7)
    return db, make_cagra_graph(db, 16, seed=7), queries


def controller(budget):
    """``benchmarks/bench_autoscale.py``'s controller settings."""
    return dict(epoch_s=0.02, window_s=0.3, ttft_slo_s=0.150,
                tpot_slo_s=0.008, probe_miss_budget=0.1, gpu_budget=budget,
                queue_target=2.0, queue_target_vector=4.0, hot_factor=1.0,
                cold_factor=0.5, cooldown_up_s=0.06, cooldown_down_s=0.12,
                itl_protect_factor=1.2)


@pytest.mark.parametrize("t_trace,rps,slots,budget",
                         [(0.4, 50.0, 1, 4), (0.3, 80.0, 2, 5)])
def test_drifting_mix_closed_loop_matches_jax(mono, t_trace, rps, slots,
                                              budget):
    """phi3-medium-14b at its published widths on the V5E price, a choked
    vector pool, the drifting mix (bulk prefill, RAG decode, repeat chat):
    the controller publishes the same signals every epoch and takes the
    same scale actions in both packages, within its budget."""
    db, graph, _ = mono
    pool = dict(POOL_KW, max_requests=slots, task_batch=256,
                top_m=32 if slots == 2 else 16, parents_per_step=1,
                visited_slots=512, semantic_cache_enabled=True,
                cache_capacity=64)
    kw = dict(n_prefill=1, n_decode=2, vector_replicas=1, decode_batch=8)
    js = jcl.ClusterSim(jget("phi3-medium-14b"), VectorPoolConfig(**pool),
                        db, graph, use_pallas=False,
                        autoscaler=JAuto(**controller(budget)), **kw)
    ts = tcl.ClusterSim(tget("phi3-medium-14b"), TConfig(**pool), db, graph,
                        device="cpu", autoscaler=TAuto(**controller(budget)),
                        **kw)
    for sim, tr in ((js, jtraffic), (ts, ttraffic)):
        for r in tr.drifting_mix_trace(t_trace, rps, seed=3).generate(
                t_trace):
            sim.arrive(r)
        sim.run(t_trace + 0.5)
    assert_sims_equal(js, ts, t_trace + 0.5)
    log = ts.autoscaler.signals_log
    assert len(log) > 10 and all(s.gpu_units <= budget for s in log)
    assert len(ts.metrics.scale_events) >= 4
    assert ts.autoscaler.budget == js.autoscaler.budget == budget


def test_sharded_pool_autoscaler_matches_jax():
    """``make_sharded_pool_sim`` with the controller on: vector scale-ups
    spawn on the hottest shard and drains come off the coldest one above
    its floor, with rebalancing, the cache backup and the sanitizer on."""
    over = dict(sanitizer_enabled=True, rebalance_enabled=True,
                cache_backup_enabled=True)
    # slowed replicas and a low vector setpoint: the vector pool falls
    # behind and the controller grants it a unit
    ctl = dict(controller(12), queue_target_vector=0.1,
               probe_miss_budget=0.02, cooldown_up_s=0.02,
               cooldown_down_s=0.02)
    js, _, _ = jcl.make_sharded_pool_sim(
        use_pallas=False, autoscaler=JAuto(**ctl), pool_overrides=over)
    ts, _, _ = tcl.make_sharded_pool_sim(
        device="cpu", autoscaler=TAuto(**ctl), pool_overrides=over)
    for sim in (js, ts):
        for i in range(len(sim.vector_pool.replicas)):
            sim.vector_pool.set_slowdown(i, 100.0)
    t_end = workload(js, n=8, prompts=3, rag_interval=2, gap=0.002) + 0.3
    workload(ts, n=8, prompts=3, rag_interval=2, gap=0.002)
    for sim in (js, ts):
        sim.run(t_end)
    assert_sims_equal(js, ts, t_end)
    assert ("vector", 1) in [(e.pool, e.delta)
                             for e in ts.metrics.scale_events]
    assert [r.shard for r in ts.vector_pool.replicas] == \
        [r.shard for r in js.vector_pool.replicas]
    ts.vector_pool.sanitizer.assert_clean()


@pytest.mark.parametrize("pool_name", ["decode", "prefill"])
def test_graceful_drain_mid_burst_matches_jax(mono, pool_name):
    db, graph, _ = mono
    n = dict(n_decode=3) if pool_name == "decode" else dict(n_prefill=2)
    js, ts = make_sims(db, graph, POOL_KW, **n)
    t_last = workload(js, n=12, max_new=16)
    workload(ts, n=12, max_new=16)
    for sim in (js, ts):
        drain = sim.drain_decode_instance if pool_name == "decode" \
            else sim.drain_prefill_instance
        sim.schedule(t_last * (0.4 if pool_name == "decode" else 0.3),
                     lambda d=drain: d(reason="test_drain", signal=1.0))
        sim.run(t_last + 0.5)
    assert sorted(r.rid for r in ts.metrics.finished) == list(range(12))
    assert sum(r.re_prefills for r in ts.metrics.finished) == 0
    insts = ts.decode_pool if pool_name == "decode" else ts.prefill_pool
    assert sum(1 for i in insts if i.health.retired) == 1
    assert_sims_equal(js, ts, t_last + 0.5)
    assert ts.gpu_units() == js.gpu_units()


@pytest.mark.parametrize("planted", [False, True], ids=["clean", "planted"])
def test_vector_drain_under_sanitizer_matches_jax(mono, planted):
    """The pool's drain re-queues the donor's in-flight work
    checkpoint-intact (clean), or trips the replica-conservation check when
    ``engine.preempt`` is gutted (planted); the records are equal."""
    db, graph, queries = mono
    kw = dict(POOL_KW, sanitizer_enabled=True)
    n = 2 if planted else 3
    pools = (jtp.VectorPool(VectorPoolConfig(**kw), db, graph, replicas=n,
                            use_pallas=False),
             ttp.VectorPool(TConfig(**kw), db, graph, replicas=n,
                            device="cpu"))
    for mod, pool in zip((jsched, tsched), pools):
        for i in range(len(pool.replicas)):
            pool.set_slowdown(i, 50.0)
        for i in range(24 if planted else 48):
            pool.submit(mod.VectorRequest(i, "decode",
                                          queries[i % len(queries)],
                                          t_arrival=i * 1e-5, deadline=None))
        pool.run_until(0.004)
        assert any(rep.in_flight for rep in pool.replicas)
        if planted:
            for rep in pool.replicas:
                rep.engine.preempt = lambda rids: []
        assert pool.drain_replica()
        if not planted:
            pool.run_until(30.0)
    jp, tp = pools
    assert tp.sanitizer.report() == jp.sanitizer.report()
    if planted:
        assert any(v.kind == "replica" for v in tp.sanitizer.violations)
    else:
        tp.sanitizer.assert_clean()
        assert sorted(r.rid for r in tp.metrics.completed) == \
            list(range(48))
        assert_pools_equal(jp, tp)
    # a drain never takes the pool below its serving floor
    assert not ttp.VectorPool(TConfig(**POOL_KW), db, graph, replicas=1,
                              device="cpu").drain_replica()


def test_budget_and_knobs_off_match_jax(mono):
    db, graph, _ = mono
    js, ts = make_sims(db, graph, POOL_KW, n_prefill=2, n_decode=3,
                       autoscaler=None)
    assert ts.autoscaler is None
    workload(js)
    workload(ts)
    for sim in (js, ts):
        sim.run(1.0)
    assert ts.metrics.scale_events == []
    assert_sims_equal(js, ts, 1.0)
    js = jcl.ClusterSim(jget("phi3-medium-14b"), VectorPoolConfig(**POOL_KW),
                        db, graph, use_pallas=False, n_prefill=2, n_decode=3,
                        autoscaler=JAuto(gpu_budget=0))
    ts = tcl.ClusterSim(tget("phi3-medium-14b"), TConfig(**POOL_KW), db,
                        graph, device="cpu", n_prefill=2, n_decode=3,
                        autoscaler=TAuto(gpu_budget=0))
    assert ts.autoscaler.budget == js.autoscaler.budget == 2 + 3 + 1
    assert dataclasses.asdict(ts.autoscaler.snapshot(0.0)) == \
        dataclasses.asdict(js.autoscaler.snapshot(0.0))
