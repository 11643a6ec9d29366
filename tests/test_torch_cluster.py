"""The port's ``ClusterSim`` (``serving/cluster.py``) against the JAX
package's: PD-disaggregated prefill and decode pools priced by the V5E
roofline model, the KV link, and the shared vector pool (the port's on
the CPU), monolithic and sharded, under the three placements and the four
scheduling policies, with the answer cache (``test_semantic_cache.py``'s
scenarios) and ``make_sharded_pool_sim``'s fixture.

The JAX package runs with ``use_pallas=False``, as its own cluster tests
do. Equality is exact: every finished request's fields (times, tokens,
cache hits), ``ClusterMetrics.summary()``, scale events and the
autoscaler's ``signals_log``, and in the pool every completion's rid,
time and result ids, every counter and every replica clock."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.configs.base import VectorPoolConfig  # noqa: E402
from repro.serving import cluster as jcl  # noqa: E402
from repro.serving import request as jreq  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro.vector.graph import make_cagra_graph  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.configs.base import VectorPoolConfig as TConfig  # noqa: E402
from repro_torch.serving import cluster as tcl  # noqa: E402
from repro_torch.serving import request as treq  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its tests run many tiny ops,
    and several test workers on one machine would otherwise oversubscribe
    its cores with torch's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POOL_KW = dict(num_vectors=2000, dim=64, graph_degree=16, max_requests=16,
               top_m=16, parents_per_step=2, task_batch=512,
               visited_slots=256, top_k=5)
SIM_KW = dict(placement="disaggregated", policy="trinity", n_prefill=2,
              n_decode=2, decode_batch=8)
POOL_FIELDS = [f.name for f in dataclasses.fields(
    __import__("repro_torch.core.trinity_pool",
               fromlist=["PoolMetrics"]).PoolMetrics) if f.name != "completed"]


@pytest.fixture(scope="module")
def mono():
    db, _ = make_dataset(2000, 64, num_clusters=16, num_queries=4, seed=7)
    return db, make_cagra_graph(db, degree=16, seed=7)


def make_sims(db, graph, pool_kw, **kw):
    """The JAX and the port ``ClusterSim`` over the same inputs."""
    kw = dict(SIM_KW, **kw)
    model = kw.pop("model", "phi3-medium-14b")
    return (jcl.ClusterSim(jget(model), VectorPoolConfig(**pool_kw), db,
                           graph, use_pallas=False, **kw),
            tcl.ClusterSim(tget(model), TConfig(**pool_kw), db, graph,
                           device="cpu", **kw))


def sharded_sims(**kw):
    """``make_sharded_pool_sim`` in both packages (its fixture size)."""
    js, db, q = jcl.make_sharded_pool_sim(use_pallas=False, **kw)
    ts, _, _ = tcl.make_sharded_pool_sim(device="cpu", **kw)
    return js, ts, db, q


def workload(sim, n=8, seed=0, rag_interval=4, max_new=8, gap=0.004,
             prompts=None):
    """test_serving's Poisson arrivals; ``prompts`` draws prompt ids from
    that many distinct prompts (repeats hit the answer cache)."""
    G = jreq.GenRequest if isinstance(sim, jcl.ClusterSim) \
        else treq.GenRequest
    rng = np.random.default_rng(seed)
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(gap))
        pid = int(rng.integers(0, prompts)) if prompts else None
        sim.arrive(G(i, prompt_len=int(rng.integers(64, 512)),
                     max_new_tokens=max_new, t_arrival=t,
                     rag_interval=rag_interval, prompt_id=pid))
    return t


def both(js, ts, fn):
    return fn(js), fn(ts)


def assert_pools_equal(jp, tp):
    cj, ct = jp.metrics.completed, tp.metrics.completed
    assert [r.rid for r in ct] == [r.rid for r in cj]
    for a, b in zip(cj, ct):
        assert (b.kind, b.t_completed, b.t_admitted, b.extends_used,
                b.failed) == (a.kind, a.t_completed, a.t_admitted,
                              a.extends_used, a.failed), a.rid
        if a.result_ids is None:
            assert b.result_ids is None, a.rid
        else:
            np.testing.assert_array_equal(np.asarray(b.result_ids),
                                          np.asarray(a.result_ids),
                                          err_msg=str(a.rid))
    for f in POOL_FIELDS:
        assert getattr(tp.metrics, f) == getattr(jp.metrics, f), f
    assert [r.clock for r in tp.replicas] == [r.clock for r in jp.replicas]
    assert tp.cache_meta == jp.cache_meta


def assert_sims_equal(js, ts, t_end):
    assert ts.metrics.summary(t_end) == js.metrics.summary(t_end)
    assert [dataclasses.asdict(r) for r in ts.metrics.finished] == \
        [dataclasses.asdict(r) for r in js.metrics.finished]
    assert [dataclasses.asdict(e) for e in ts.metrics.scale_events] == \
        [dataclasses.asdict(e) for e in js.metrics.scale_events]
    if js.autoscaler is not None:
        assert [dataclasses.asdict(s) for s in ts.autoscaler.signals_log] \
            == [dataclasses.asdict(s) for s in js.autoscaler.signals_log]
    assert ts.t_now == js.t_now
    assert_pools_equal(js.vector_pool, ts.vector_pool)


CASES = [("disaggregated", "trinity"), ("coupled", "trinity"),
         ("prefill_coloc", "trinity"), ("disaggregated", "prefill_first"),
         ("disaggregated", "decode_first"), ("disaggregated", "fifo_shared")]


@pytest.mark.parametrize("placement,policy", CASES)
def test_monolithic_cluster_matches_jax(mono, placement, policy):
    js, ts = make_sims(*mono, POOL_KW, placement=placement, policy=policy)
    t_end = workload(js) + 2.0
    workload(ts)
    for sim in (js, ts):
        sim.run(t_end)
    assert ts.metrics.summary(t_end)["requests"] == 8
    assert_sims_equal(js, ts, t_end)


@pytest.mark.parametrize("model", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_deepseek_cluster_matches_jax(mono, model):
    """The DeepSeek family priced by the port's analytic counts (MoE's
    active experts, MLA's latent cache): the same cluster as the JAX
    package's."""
    js, ts = make_sims(*mono, POOL_KW, model=model)
    t_end = workload(js) + 2.0
    workload(ts)
    for sim in (js, ts):
        sim.run(t_end)
    assert ts.metrics.summary(t_end)["requests"] == 8
    assert_sims_equal(js, ts, t_end)


@pytest.mark.parametrize("placement,policy",
                         [("disaggregated", "fifo_shared"),
                          ("coupled", "trinity"),
                          ("prefill_coloc", "decode_first")])
def test_sharded_cluster_matches_jax(placement, policy):
    """make_sharded_pool_sim: a corpus past one replica's rows, four shards,
    the answer cache on; repeated prompts hit."""
    js, ts, _, _ = sharded_sims(placement=placement, policy=policy)
    t_end = workload(js, prompts=3) + 0.5
    workload(ts, prompts=3)
    for sim in (js, ts):
        sim.run(t_end)
    s = ts.metrics.summary(t_end)
    assert s["requests"] == 8 and s["cache_hits"] > 0
    assert_sims_equal(js, ts, t_end)


@pytest.mark.parametrize("arm", ["legacy", "mega"])
def test_sharded_cluster_arms_match_jax(arm):
    """The other arms of the sharded pool (the default, megabatched with
    the device merge and the double buffer, runs above) against the JAX
    package's same arm: every completion up to a poll's ``t_end`` is
    resolved when the port's ``run_until`` returns, so the cluster's
    callbacks fire at the same simulated times."""
    from test_torch_sharded_pool import ARMS
    js, ts, _, _ = sharded_sims(pool_overrides=ARMS[arm])
    t_end = workload(js, prompts=3, rag_interval=2) + 0.5
    workload(ts, prompts=3, rag_interval=2)
    for sim in (js, ts):
        sim.run(t_end)
    assert_sims_equal(js, ts, t_end)


def _two(sim, G, t1=0.5, pid=42):
    first = G(0, prompt_len=256, max_new_tokens=8, t_arrival=0.0,
              rag_interval=0, prompt_id=pid)
    repeat = G(1, prompt_len=256, max_new_tokens=8, t_arrival=t1,
               rag_interval=0, prompt_id=pid)
    sim.arrive(first)
    sim.arrive(repeat)
    return first, repeat


@pytest.mark.parametrize("scenario", ["lifecycle", "busy_link",
                                      "free_answer", "cache_off"])
def test_answer_cache_matches_jax(mono, scenario):
    """test_semantic_cache's lifecycle: a miss inserts, a repeat hits and
    skips the PD pipeline; a hit behind a busy KV link queues for it; no
    answer bytes make a hit free; the cache off takes the legacy path."""
    kw = dict(POOL_KW, semantic_cache_enabled=scenario != "cache_off",
              cache_capacity=64)
    if scenario == "free_answer":
        kw["answer_bytes_per_token"] = 0.0
    js, ts = make_sims(*mono, kw)
    reqs = [_two(js, jreq.GenRequest), _two(ts, treq.GenRequest)]
    if scenario == "busy_link":
        for sim in (js, ts):
            sim.schedule(0.5, lambda s=sim: s.kv_link.transfer(
                0.5, s.kv_link.bandwidth * 0.05))
    for sim in (js, ts):
        sim.run(1.5)
    assert_sims_equal(js, ts, 1.5)
    first, repeat = reqs[1]
    assert repeat.cache_hit == (scenario != "cache_off")
    if scenario == "busy_link":
        assert repeat.t_first_token >= 0.55
    assert ts.kv_link.busy_until == js.kv_link.busy_until


def test_repeated_prompt_workload_matches_jax(mono):
    kw = dict(POOL_KW, semantic_cache_enabled=True, cache_capacity=64)
    js, ts = make_sims(*mono, kw)
    for sim in (js, ts):
        G = jreq.GenRequest if sim is js else treq.GenRequest
        rng = np.random.default_rng(0)
        t = 0.0
        for i in range(20):
            t += float(rng.exponential(0.02))
            sim.arrive(G(i, prompt_len=128, max_new_tokens=6, t_arrival=t,
                         rag_interval=0, prompt_id=int(rng.integers(0, 4))))
        sim.run(t + 1.0)
    s = ts.metrics.summary(t + 1.0)
    assert s["cache_hits"] >= 10
    assert ts.vector_pool.metrics.inserts == 20 - s["cache_hits"]
    assert_sims_equal(js, ts, t + 1.0)


def test_feedback_and_elastic_decode_match_jax(mono):
    """The control loop's feedback over alive decode instances only, and
    an elastic decode scale-up that inherits the placement."""
    js, ts = make_sims(*mono, POOL_KW, n_decode=3)
    for sim in (js, ts):
        sim._recent_stalls.append(0.01)
        sim.decode_pool[0].health.alive = False
        sim.decode_pool[0].health.step_ewma = 1e9
        sim.decode_pool[1].health.step_ewma = 1e-3
        sim.decode_pool[2].health.step_ewma = 2e-3
        sim._update_feedback()
    assert dataclasses.asdict(ts.vector_pool.feedback) == \
        dataclasses.asdict(js.vector_pool.feedback)
    js, ts = make_sims(*mono, POOL_KW, placement="coupled", n_decode=1,
                       elastic_decode=True)
    for sim, G in ((js, jreq.GenRequest), (ts, treq.GenRequest)):
        for i in range(16):
            sim.decode_queue.append(G(i, 64, 4, 0.0))
        sim._try_admit_decode()
    assert len(ts.decode_pool) == 2
    for a, b in zip(js.decode_pool, ts.decode_pool):
        assert (b.chips, b.contention, b.ep_penalty, b.max_batch) == \
            (a.chips, a.contention, a.ep_penalty, a.max_batch)
    assert [dataclasses.asdict(e) for e in ts.metrics.scale_events] == \
        [dataclasses.asdict(e) for e in js.metrics.scale_events]
