"""The port's runtime sanitizer (``serving/sanitizer.py``) against the JAX
package's, on the scenarios of ``test_sanitizer.py``: off by default
(nothing wrapped), silent on a clean chaotic run, and tripping on each
hand-broken invariant — a clock rollback, a duplicate or untimed
completion, a kill or a planned move that drops in-flight work, a rescue
without its checkpoint, a corrupt gid map and an orphaned cluster probe.

Each scenario runs in both packages on the same inputs; the recorded
violations are equal, text for text, and the pools end in the same state
(``test_torch_sharded_pool._assert_same``)."""
import copy

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import VectorPoolConfig  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import trinity_pool as jtp  # noqa: E402
from repro.serving import chaos as jchaos  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro_torch.configs.base import VectorPoolConfig as TConfig  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import trinity_pool as ttp  # noqa: E402
from repro_torch.serving import chaos as tchaos  # noqa: E402

from test_torch_sharded_pool import _assert_same  # noqa: E402


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
                cache_capacity=64, num_shards=4, sanitizer_enabled=True)
    base.update(kw)
    return base


def _pools(setup, **kw):
    db, _ = setup
    return (jtp.ShardedVectorPool(VectorPoolConfig(**_kw(**kw)), db,
                                  use_pallas=False, seed=0),
            ttp.ShardedVectorPool(TConfig(**_kw(**kw)), db, device="cpu",
                                  seed=0))


def _burst(pool, mod, queries, n, gap=1e-4, deadline=0.05):
    t = 0.0
    for i in range(n):
        pool.submit(mod.VectorRequest(i, "prefill", queries[i], t,
                                      t + deadline))
        t += gap
    return t


def _both(jp, tp, fn):
    """Run ``fn(pool, scheduler_module)`` on both pools."""
    return fn(jp, jsched), fn(tp, tsched)


def _same_reports(jp, tp):
    assert tp.sanitizer.report() == jp.sanitizer.report()
    return {v.kind for v in tp.sanitizer.violations}


def test_sanitizer_off_wraps_nothing(setup):
    jp, tp = _pools(setup, sanitizer_enabled=False)
    assert tp.sanitizer is None and jp.sanitizer is None
    assert "run_until" not in vars(tp) and "insert_local" not in vars(
        tp.shards)
    _, tp = _pools(setup)
    assert "run_until" in vars(tp) and "insert_local" in vars(tp.shards)


@pytest.mark.parametrize("mega", [True, False], ids=["mega", "legacy"])
def test_clean_chaotic_run_matches_jax(setup, mega):
    """Kills, stragglers and shard losses against a live burst: nothing
    trips in either package, and the runs end equal."""
    _, queries = setup
    jp, tp = _pools(setup, rescue_enabled=True, hedge_enabled=True,
                    megabatch_enabled=mega)
    t_last = _burst(jp, jsched, queries, 48)
    _burst(tp, tsched, queries, 48)
    rates = {"kill_replica": 400.0, "straggle_replica": 200.0,
             "lose_shard": 100.0}
    injs = []
    for chaos, pool in ((jchaos, jp), (tchaos, tp)):
        sched = chaos.make_schedule(3, 5e-4, t_last + 0.02, rates,
                                    slow_duration=2e-3, downtime=2e-3)
        inj = chaos.ChaosInjector(sched, seed=3)
        inj.run_pool(pool, t_last + 1.0)
        injs.append(inj)
    assert injs[1].log == injs[0].log and injs[1].injected >= 3
    assert sorted(r.rid for r in tp.metrics.completed) == list(range(48))
    tp.sanitizer.assert_clean()
    assert _same_reports(jp, tp) == set()
    _assert_same(jp, tp)


def _settled(setup, n=8):
    _, queries = setup
    jp, tp = _pools(setup)
    t_last = _burst(jp, jsched, queries, n)
    _burst(tp, tsched, queries, n)
    for pool in (jp, tp):
        pool.run_until(t_last + 0.5)
        pool.sanitizer.assert_clean()
    return jp, tp, t_last


def test_clock_rollback_trips_as_in_jax(setup):
    jp, tp, _ = _settled(setup)
    for pool in (jp, tp):
        pool.replicas[0].clock = 0.0  # planted: time travels backwards
        pool.run_until(1e-5)
    assert "clock" in _same_reports(jp, tp)
    with pytest.raises(AssertionError, match="clock moved backwards"):
        tp.sanitizer.assert_clean()


def test_duplicate_and_untimed_completions_trip_as_in_jax(setup):
    jp, tp, t_last = _settled(setup)
    for pool in (jp, tp):
        pool.metrics.completed.append(pool.metrics.completed[0])  # dup
        ghost = copy.copy(pool.metrics.completed[1])
        ghost.rid = 9999
        ghost.t_completed = None  # completed with no time
        pool.metrics.completed.append(ghost)
        pool.run_until(t_last + 0.6)
    assert "completion" in _same_reports(jp, tp)
    with pytest.raises(AssertionError, match="completed twice"):
        tp.sanitizer.assert_clean()
    assert any("without a completion time" in v.detail
               for v in tp.sanitizer.violations)


def _run_to_inflight(pool, t_hi=2.4e-3, step=2e-4):
    t = 0.0
    while not any(rep.in_flight for rep in pool.replicas):
        t += step
        assert t < t_hi, "burst drained with no observable in-flight"
        pool.run_until(t)
    return t


def _busiest(pool):
    return max(range(len(pool.replicas)),
               key=lambda i: len(pool.replicas[i].in_flight))


@pytest.mark.parametrize("bug", ["kill_drops", "rescue_no_ckpt",
                                 "move_drops"])
def test_dropped_work_trips_as_in_jax(setup, bug):
    """A kill whose restart vanishes, a rescue that throws its checkpoint
    away and a planned move whose re-queue is a no-op each trip the
    checkpoint-conservation check, with the same record in both
    packages."""
    _, queries = setup
    jp, tp = _pools(setup, rescue_enabled=(bug == "rescue_no_ckpt"))
    for mod, pool in ((jsched, jp), (tsched, tp)):
        _burst(pool, mod, queries, 24)
        _run_to_inflight(pool)
        victim = _busiest(pool)
        rep = pool.replicas[victim]
        assert rep.in_flight
        if bug == "kill_drops":
            for sched in pool.schedulers:
                sched.submit = lambda req: None
            pool.kill_replica(victim)
        elif bug == "rescue_no_ckpt":
            assert rep.snapshots

            def bad_rescue(req, ckpt, t, _s=pool.schedulers[rep.shard]):
                req.checkpoint = None
                _s.submit(req)

            pool.schedulers[rep.shard].requeue_rescued = bad_rescue
            pool.kill_replica(victim)
        else:
            src = rep.shard
            pool.schedulers[src].requeue_preempted = \
                lambda req, ckpt, t: None
            pool._move_replica(src, (src + 1) % 4,
                               min(r.clock for r in pool.replicas))
    assert "checkpoint" in _same_reports(jp, tp)
    want = {"kill_drops": "nowhere afterwards",
            "rescue_no_ckpt": "no checkpoint attached",
            "move_drops": "planned move"}[bug]
    assert any(want in v.detail for v in tp.sanitizer.violations)


def test_gid_corruption_trips_as_in_jax(setup):
    jp, tp, t_last = _settled(setup)
    for pool in (jp, tp):
        pool.shards._gid_loc[10 ** 6] = (0, 0)  # planted dangling gid
        pool.run_until(t_last + 0.6)
    assert "gid" in _same_reports(jp, tp)


def test_orphaned_probe_trips_as_in_jax(setup):
    from repro.configs import get_smoke_config as jget
    from repro.serving.cluster import ClusterSim as JSim
    from repro.vector.graph import make_cagra_graph
    from repro_torch.configs import get_smoke_config as tget
    from repro_torch.serving.cluster import ClusterSim as TSim
    db, _ = setup
    graph = make_cagra_graph(db, 16, seed=1)
    kw = dict(placement="disaggregated", policy="trinity", n_prefill=2,
              n_decode=2, decode_batch=8)
    sims = (JSim(jget("phi3-medium-14b"),
                 VectorPoolConfig(**_kw(num_shards=1)), db, graph,
                 use_pallas=False, **kw),
            TSim(tget("phi3-medium-14b"), TConfig(**_kw(num_shards=1)), db,
                 graph, device="cpu", **kw))
    for sim in sims:
        san = sim.vector_pool.sanitizer
        sim._collect_pool_completions()
        assert san.report() == []
        sim._probe_cb[999_999] = (None, lambda r, v: None, 0.0)
        sim._collect_pool_completions()
    assert sims[1].vector_pool.sanitizer.report() == \
        sims[0].vector_pool.sanitizer.report()
    with pytest.raises(AssertionError, match="orphaned probe"):
        sims[1].vector_pool.sanitizer.assert_clean()
