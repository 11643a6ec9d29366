"""The port's online index against the JAX package's: ``insert_batch`` on
the same arrays (l2 and ip, padding rows, empty neighbour slots), the
``OnlineIndex`` insert, growth and eviction streams of
``test_online_insert.py`` and ``test_cache_eviction.py`` (rows, graph,
eviction log, timestamps), and the monolithic pool's insert path and answer
cache (completions, ``meta_at``, dropped metadata of evicted entries)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.configs.base import VectorPoolConfig  # noqa: E402
from repro.vector import online as jonline  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro.vector.graph import make_cagra_graph  # noqa: E402
from repro_torch.configs.base import VectorPoolConfig as TConfig  # noqa: E402
from repro_torch.vector import online as tonline  # noqa: E402


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
    db, queries = make_dataset(1200, 32, num_clusters=8, num_queries=16,
                               seed=5)
    graph = make_cagra_graph(db, degree=16, seed=5)
    return db, graph, queries


def _vec(rng, d=32):
    return rng.normal(size=d).astype(np.float32)


def _assert_index_equal(j, t):
    np.testing.assert_array_equal(t.db.numpy(), np.asarray(j.db))
    np.testing.assert_array_equal(t.graph.numpy(), np.asarray(j.graph))
    assert (t.cache_size, t.cache_rows, t.cache_capacity) == \
        (j.cache_size, j.cache_rows, j.cache_capacity)
    np.testing.assert_array_equal(t._live, j._live)
    np.testing.assert_array_equal(t._t_insert, j._t_insert)
    assert t._free == j._free
    for row in range(j.base_n - 1, j.base_n + j.cache_capacity + 1):
        assert t.born_at(row) == j.born_at(row), row
        assert t.is_live(row) == j.is_live(row), row


# ---------------------------------------------------------------------------
# insert_batch: one dispatch, in order, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_batch_matches_jax(metric, seed):
    """A cache segment with some rows already linked, then a padded batch
    whose neighbour lists name each other, old rows and empty slots: the
    patches read what earlier patches wrote, so order matters."""
    rng = np.random.default_rng(seed)
    N, d, D, base = 96, 16, 8, 32
    db = np.zeros((N, d), np.float32)
    db[:base + 20] = rng.normal(size=(base + 20, d))
    graph = np.full((N, D), -1, np.int32)
    graph[base:base + 20, :5] = rng.integers(base, base + 20, (20, 5))
    B = 5  # padded to 8 like OnlineIndex.insert_many
    rows = np.asarray(list(range(base + 20, base + 20 + B)) + [-1] * 3,
                      np.int32)
    vecs = rng.normal(size=(8, d)).astype(np.float32)
    vecs[B:] = vecs[0]
    nbrs = rng.integers(base, base + 20 + B, (8, D)).astype(np.int32)
    nbrs[rng.random((8, D)) < 0.3] = -1
    nbrs[B:] = nbrs[0]
    jdb, jgraph = jonline.insert_batch(jnp.asarray(db), jnp.asarray(graph),
                                       jnp.asarray(rows), jnp.asarray(vecs),
                                       jnp.asarray(nbrs), metric=metric)
    tdb, tgraph, touched = tonline.insert_batch(
        torch.as_tensor(db.copy()), torch.as_tensor(graph.copy()), rows,
        vecs, nbrs, metric=metric)
    np.testing.assert_array_equal(tdb.numpy(), np.asarray(jdb))
    np.testing.assert_array_equal(tgraph.numpy(), np.asarray(jgraph))
    changed = np.flatnonzero((np.asarray(jgraph) != graph).any(1)
                             | (np.asarray(jdb) != db).any(1))
    assert set(changed.tolist()) <= set(touched)


# ---------------------------------------------------------------------------
# OnlineIndex streams
# ---------------------------------------------------------------------------


def _pair(db, graph, **kw):
    return (jonline.OnlineIndex(db, graph, **kw),
            tonline.OnlineIndex(db, graph, device="cpu", **kw))


@pytest.mark.parametrize("cache_capacity", [0, 16])
def test_growth_stream_matches_jax(setup, cache_capacity):
    """140 inserts with no neighbour lists: the segment doubles (few
    shapes), random long edges from the same RNG stream."""
    db, graph, _ = setup
    j, t = _pair(db, graph, cache_capacity=cache_capacity)
    rng = np.random.default_rng(0)
    for i in range(140):
        v = _vec(rng)
        assert j.insert(v, t_now=float(i)) == t.insert(v, t_now=float(i))
    _assert_index_equal(j, t)
    assert t.entry_range("cache") == j.entry_range("cache")
    np.testing.assert_array_equal(t.cache_vectors(), j.cache_vectors())
    np.testing.assert_array_equal(t.db.numpy()[:1200], db)  # corpus intact


def test_reverse_edge_ring_matches_jax(setup):
    """test_online_insert's ring: 40 close nodes all naming earlier rows —
    every reverse-edge patch decision equal."""
    db, graph, _ = setup
    j, t = _pair(db, graph, cache_capacity=64)
    rng = np.random.default_rng(2)
    base = _vec(rng)
    rows = [j.insert(base)]
    assert t.insert(base) == rows[0]
    for _ in range(40):
        v = base + rng.normal(0, 0.1, size=32).astype(np.float32)
        r = j.insert(v, neighbor_ids=rows)
        assert t.insert(v, neighbor_ids=rows) == r
        rows.append(r)
    _assert_index_equal(j, t)


@pytest.mark.parametrize("kw", [dict(max_entries=8), dict(ttl=1.0),
                                dict(ttl=3.0, max_entries=5),
                                dict(max_entries=6, cache_capacity=16)],
                         ids=["cap", "ttl", "ttl+cap", "cap16"])
def test_eviction_stream_matches_jax(setup, kw):
    """test_cache_eviction's streams: TTL and capacity eviction, slot
    reuse, tombstones and cut edges; the eviction log drained after every
    insert, with neighbour lists naming live, evicted and corpus rows."""
    db, graph, _ = setup
    kw = dict(dict(cache_capacity=16), **kw)
    j, t = _pair(db, graph, **kw)
    rng = np.random.default_rng(3)
    rows = []
    for i in range(120):
        v = _vec(rng)
        cand = rows[-12:] + [5, -1] if i % 3 else None
        r = j.insert(v, neighbor_ids=cand, t_now=0.4 * i)
        assert t.insert(v, neighbor_ids=cand, t_now=0.4 * i) == r
        rows.append(r)
        assert t.drain_evicted() == j.drain_evicted()
    _assert_index_equal(j, t)


def test_batched_insert_many_and_wipe_match_jax(setup):
    db, graph, _ = setup
    j, t = _pair(db, graph, cache_capacity=16, max_entries=20)
    rng = np.random.default_rng(4)
    for i in range(6):
        vecs = [_vec(rng) for _ in range(3 + i)]
        cand = [None] + [list(range(1200, 1200 + 10))] * (len(vecs) - 1)
        assert j.insert_many(vecs, cand, t_now=float(i)) == \
            t.insert_many(vecs, cand, t_now=float(i))
        assert t.drain_evicted() == j.drain_evicted()
    _assert_index_equal(j, t)
    j.wipe_cache()
    t.wipe_cache()
    assert t.drain_evicted() == j.drain_evicted()
    _assert_index_equal(j, t)


def test_extract_and_adopt_match_jax(setup):
    """The two halves of a migration on one index pair each: extraction
    (TTL first, then the oldest) and adoption with original timestamps."""
    db, graph, _ = setup
    j, t = _pair(db, graph, cache_capacity=16, ttl=10.0)
    rng = np.random.default_rng(6)
    for i in range(30):
        v = _vec(rng)
        j.insert(v, t_now=float(i))
        t.insert(v, t_now=float(i))
    jr, jv, jb = j.extract_entries(7, t_now=35.0)
    tr, tv, tb = t.extract_entries(7, t_now=35.0)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)
    assert t.drain_evicted() == j.drain_evicted()
    ja, ta = _pair(db, graph, cache_capacity=16, ttl=10.0)
    assert ja.adopt_entries(jv, jb, t_now=36.0) == \
        ta.adopt_entries(tv, tb, t_now=36.0)
    _assert_index_equal(ja, ta)
    _assert_index_equal(j, t)


def test_row_budget_and_ip_refusal_match_jax(setup):
    db, graph, _ = setup
    j, t = _pair(db, graph, cache_capacity=32, max_rows=1264)
    rng = np.random.default_rng(9)
    for i in range(64):
        v = _vec(rng)
        j.insert(v, t_now=float(i))
        t.insert(v, t_now=float(i))
    v = _vec(rng)
    with pytest.raises(jonline.CapacityError):
        j.insert(v, t_now=65.0)
    with pytest.raises(tonline.CapacityError, match="re-shard"):
        t.insert(v, t_now=65.0)
    _assert_index_equal(j, t)
    with pytest.raises(ValueError, match="l2"):
        tonline.OnlineIndex(db[:4], graph[:4], metric="ip", ttl=1.0,
                            device="cpu")
    with pytest.raises(tonline.CapacityError, match="num_shards"):
        tonline.OnlineIndex(db, graph, max_rows=100, device="cpu")


def test_rebuilt_cache_graph_matches_jax(setup):
    db, graph, _ = setup
    j, t = _pair(db, graph, cache_capacity=16)
    rng = np.random.default_rng(10)
    for _ in range(40):
        v = _vec(rng)
        j.insert(v)
        t.insert(v)
    np.testing.assert_array_equal(t.rebuilt_cache_graph(seed=0),
                                  j.rebuilt_cache_graph(seed=0))


# ---------------------------------------------------------------------------
# the monolithic pool's insert path and answer cache
# ---------------------------------------------------------------------------

POOL = dict(num_vectors=1200, dim=32, graph_degree=16, max_requests=8,
            top_m=16, parents_per_step=2, task_batch=512, visited_slots=256,
            top_k=4, semantic_cache_enabled=True, cache_capacity=16)
COUNTERS = ("extend_steps", "tasks_emitted", "tasks_capacity", "inserts",
            "cache_evictions", "broadcasts", "preemptions", "resumes")


def _pools(setup, **kw):
    db, graph, _ = setup
    return (jcore.VectorPool(VectorPoolConfig(**POOL, **kw), db, graph,
                             use_pallas=False, seed=0),
            tcore.VectorPool(TConfig(**POOL, **kw), db, graph, device="cpu",
                             seed=0))


def _assert_pools_equal(jp, tp):
    cj = {r.rid: r for r in jp.metrics.completed}
    ct = {r.rid: r for r in tp.metrics.completed}
    assert len(ct) == len(tp.metrics.completed)  # exactly once
    assert cj.keys() == ct.keys()
    for rid, a in cj.items():
        b = ct[rid]
        assert (a.t_completed, a.extends_used) == \
            (b.t_completed, b.extends_used), rid
        if a.result_ids is None:
            assert b.result_ids is None
            continue
        np.testing.assert_array_equal(b.result_ids, np.asarray(a.result_ids))
        np.testing.assert_allclose(b.result_dists,
                                   np.asarray(a.result_dists), rtol=1e-5,
                                   atol=1e-5)
    for f in COUNTERS:
        assert getattr(jp.metrics, f) == getattr(tp.metrics, f), f
    assert tp.cache_meta == jp.cache_meta
    assert tp.cache_size == jp.cache_size
    np.testing.assert_array_equal(tp.index.db.numpy(),
                                  np.asarray(jp.index.db))
    np.testing.assert_array_equal(tp.index.graph.numpy(),
                                  np.asarray(jp.index.graph))


@pytest.mark.parametrize("kw", [{}, dict(cache_max_entries=3),
                                dict(cache_ttl_s=2e-3)],
                         ids=["unbounded", "cap3", "ttl"])
def test_pool_insert_and_lookup_stream_matches_jax(setup, kw):
    """Background inserts (searched neighbour selection, broadcast to two
    replicas) interleaved with corpus probes, then cache lookups of
    repeated and fresh vectors: completions, the grown index, the answer
    metadata (evicted entries' dropped) and ``meta_at`` equal."""
    _, _, queries = setup
    jp, tp = _pools(setup, **kw)
    rng = np.random.default_rng(6)
    vecs = [_vec(rng) for _ in range(10)]
    for mod, pool in ((jcore, jp), (tcore, tp)):
        pool.add_replica()
        t = 0.0
        for i, v in enumerate(vecs):
            pool.submit_insert(v, meta={"tokens": i}, t_now=t)
            pool.submit(mod.VectorRequest(i, "prefill", queries[i], t,
                                          t + 0.01))
            t += 5e-4
            pool.run_until(t)
        pool.run_until(t + 0.1)
        for i in range(8):
            q = vecs[i] if i % 2 == 0 else _vec(np.random.default_rng(i))
            pool.submit(mod.VectorRequest(100 + i, "cache_lookup", q,
                                          t + 0.1, t + 0.2))
        pool.run_until(t + 1.0)
    _assert_pools_equal(jp, tp)
    for r in jp.metrics.completed:
        if r.kind == "cache_lookup" and r.result_ids is not None:
            for row in np.asarray(r.result_ids):
                for when in (r.t_completed, r.t_completed + 10.0):
                    assert tp.meta_at(int(row), when) == \
                        jp.meta_at(int(row), when)
    if "cache_max_entries" in kw:
        assert tp.metrics.cache_evictions == len(vecs) - 3
        assert len(tp.cache_meta) == 3


def test_pool_meta_at_guards_match_jax(setup):
    """test_cache_eviction's serve-time guards: TTL expiry without any
    eviction, and a reused slot refusing an older lookup."""
    rng = np.random.default_rng(7)
    vecs = [_vec(rng) for _ in range(2)]
    jp, tp = _pools(setup, cache_max_entries=1, cache_ttl_s=5.0)
    for pool in (jp, tp):
        row = pool.submit_insert(vecs[0], meta={"tokens": 1}, t_now=0.0)
        assert pool.meta_at(row, 4.9) == {"tokens": 1}
        assert pool.meta_at(row, 1000.0) is None
        assert pool.submit_insert(vecs[1], meta={"tokens": 2},
                                  t_now=2.0) is None
        pool.run_until(3.0)
        assert pool.meta_at(row, 1.0) is None
        assert pool.meta_at(row, 3.0) == {"tokens": 2}
    _assert_pools_equal(jp, tp)


def test_pool_cancelled_insert_drops_its_meta(setup):
    jp, tp = _pools(setup)
    rng = np.random.default_rng(8)
    vecs = [_vec(rng) for _ in range(3)]
    for pool in (jp, tp):
        for i, v in enumerate(vecs):
            pool.submit_insert(v, meta={"tokens": i}, t_now=0.0)
        assert pool.cancel((1 << 28) + 1)  # the second queued insert
        assert not pool._insert_meta.get((1 << 28) + 1)
        pool.run_until(1.0)
    assert tp.cache_size == 2
    _assert_pools_equal(jp, tp)
