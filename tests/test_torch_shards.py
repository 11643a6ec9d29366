"""The port's sharded index, IVF machinery and partial-top-k merges against
the JAX package's: ``kmeans`` and ``balanced_partition`` bit-equal, routing
and exact search equal, the coarse quantizer and IVF scan equal, and the
three merges (with ties and padding) bit-equal to ``repro.kernels.ops``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.vector import ivf as jivf  # noqa: E402
from repro.vector import shards as jshards  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.vector import ivf as tivf  # noqa: E402
from repro_torch.vector import shards as tshards  # noqa: E402


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


# ---------------------------------------------------------------------------
# partition, routing, exact search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nlist,seed", [(4, 0), (16, 3)])
def test_kmeans_bit_equal(setup, nlist, seed):
    db, _ = setup
    jc, ja = jivf.kmeans(db, nlist, iters=5, seed=seed)
    tc, ta = tivf.kmeans(db, nlist, iters=5, seed=seed)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ta, ja)


@pytest.mark.parametrize("S", [1, 3, 4, 7])
def test_balanced_partition_bit_equal(setup, S):
    db, _ = setup
    jc, jparts = jshards.balanced_partition(db, S, seed=0)
    tc, tparts = tshards.balanced_partition(db, S, seed=0)
    np.testing.assert_array_equal(tc, jc)
    assert len(tparts) == len(jparts) == S
    for a, b in zip(tparts, jparts):
        np.testing.assert_array_equal(a, b)
    assert max(len(p) for p in tparts) <= -(-len(db) // S)


@pytest.mark.parametrize("S", [2, 4, 5])
def test_route_and_exact_search_match_jax(setup, S):
    db, queries = setup
    j = jshards.ShardedIndex(db, num_shards=S, build_graphs=False, seed=0)
    t = tshards.ShardedIndex(db, num_shards=S, build_graphs=False, seed=0,
                             device="cpu")
    np.testing.assert_array_equal(t._fine_centroids, j._fine_centroids)
    for nprobe in range(1, S + 1):
        routed = t.route(queries, nprobe)
        np.testing.assert_array_equal(routed, j.route(queries, nprobe))
        ji, jd = j.exact_search(queries, 10, shard_lists=routed)
        ti, td = t.exact_search(queries, 10, shard_lists=routed)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    for q in queries[:16]:
        assert t.owning_shard(q) == j.owning_shard(q)


def test_exact_merge_randomized_sweep_matches_jax():
    """test_sharded's seeded sweep: fan-out-all exact search equals the
    JAX package's (and so the monolithic oracle) id for id."""
    rng0 = np.random.default_rng(42)
    for _ in range(10):
        n = int(rng0.integers(24, 241))
        s = int(rng0.integers(1, 9))
        k = min(int(rng0.integers(1, 13)), n)
        seed = int(rng0.integers(0, 2**31 - 1))
        rng = np.random.default_rng(seed)
        db = rng.normal(size=(n, 8)).astype(np.float32)
        q = rng.normal(size=(int(rng0.integers(1, 7)), 8)).astype(np.float32)
        kw = dict(num_shards=s, build_graphs=False, seed=seed % 1000)
        ji, jd = jshards.ShardedIndex(db, **kw).exact_search(q, k)
        ti, td = tshards.ShardedIndex(db, device="cpu",
                                      **kw).exact_search(q, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)


def test_sharded_index_shards_and_ids_match_jax(setup):
    """Shard indexes (padded frozen segments, graphs below the exact
    threshold), cache-id assignment and translation, ``born_at`` and
    ``clone`` (same partition and graphs, fresh caches)."""
    db, _ = setup
    kw = dict(num_shards=3, degree=8, cache_capacity=16, seed=0)
    j = jshards.ShardedIndex(db[:900], **kw)
    t = tshards.ShardedIndex(db[:900], device="cpu", **kw)
    assert t.pad_n == j.pad_n
    for a, b in zip(t.shards, j.shards):
        np.testing.assert_array_equal(a.db.numpy(), np.asarray(b.db))
        np.testing.assert_array_equal(a.graph.numpy(), np.asarray(b.graph))
        assert a.corpus_n == b.corpus_n
    rng = np.random.default_rng(2)
    for i in range(20):
        v = rng.normal(size=32).astype(np.float32)
        s = j.owning_shard(v)
        assert t.owning_shard(v) == s
        assert t.insert_local(s, v, None, t_now=float(i)) == \
            j.insert_local(s, v, None, t_now=float(i))
    assert t.cache_shards() == j.cache_shards()
    assert t.cache_size == j.cache_size == 20
    for s in range(3):
        np.testing.assert_array_equal(t.global_map(s), j.global_map(s))
        local = np.arange(-1, len(j.global_map(s)) + 2)
        np.testing.assert_array_equal(t.to_global(s, local),
                                      j.to_global(s, local))
    for gid in range(895, 925):
        assert t.born_at(gid) == j.born_at(gid)
    c = t.clone()
    assert c.cache_size == 0 and c.pad_n == t.pad_n
    for a, b in zip(c.shards, j.shards):
        np.testing.assert_array_equal(a.graph.numpy()[:a.base_n],
                                      np.asarray(b.graph)[:b.base_n])
    np.testing.assert_array_equal(c.route(db[:50], 2), j.route(db[:50], 2))


def test_rebalancing_and_shard_loss_raise_naming_a9b(setup):
    """Once raising (ROADMAP A9b), now ported: ``migrate_entries`` moves a
    shard's oldest entries with their gids and birth times (TTL-expired
    rows retired, not moved), ``drop_shard_cache`` loses a shard's cache,
    ``restore_entries`` re-homes the lost gids; the id maps, rows, graphs
    and the returned gid lists equal the JAX package's after each."""
    db, _ = setup
    kw = dict(num_shards=3, degree=8, cache_capacity=16, seed=0, ttl=40.0)
    j = jshards.ShardedIndex(db[:900], **kw)
    t = tshards.ShardedIndex(db[:900], device="cpu", **kw)
    rng = np.random.default_rng(4)
    vecs = []
    for i in range(24):
        v = (db[11] + rng.normal(0, 0.05, 32)).astype(np.float32) if i % 3 \
            else rng.normal(size=32).astype(np.float32)
        vecs.append(v)
        s = j.owning_shard(v)
        assert t.insert_local(s, v, None, t_now=float(i)) == \
            j.insert_local(s, v, None, t_now=float(i))

    def same():
        assert t._gid_loc == j._gid_loc
        assert t._next_cache_gid == j._next_cache_gid
        for s in range(3):
            np.testing.assert_array_equal(t.global_map(s), j.global_map(s))
            a, b = t.shards[s], j.shards[s]
            np.testing.assert_array_equal(a.db.numpy(), np.asarray(b.db))
            np.testing.assert_array_equal(a.graph.numpy(),
                                          np.asarray(b.graph))
            assert a.cache_size == b.cache_size
        for gid in range(900, 930):
            assert t.born_at(gid) == j.born_at(gid)

    src = max(range(3), key=lambda s: t.shards[s].cache_size)
    dst = (src + 1) % 3
    for n, t_now in ((4, 30.0), (3, 50.0), (0, 50.0)):
        out = t.migrate_entries(src, dst, n, t_now=t_now)
        assert out == j.migrate_entries(src, dst, n, t_now=t_now)
        same()
    assert t.shards[dst].cache_size > 0
    lost = t.drop_shard_cache(dst)
    assert lost == j.drop_shard_cache(dst) and lost
    same()
    back = np.stack([vecs[g - 900] for g in lost])
    born = [float(g - 900) for g in lost]
    other = 3 - src - dst
    assert t.restore_entries(other, lost, back, born, t_now=55.0) == \
        j.restore_entries(other, lost, back, born, t_now=55.0)
    same()
    # the rows each step wrote reach the lanes through drain_touched
    assert t.shards[other].drain_touched()


def test_clone_leaves_instance_wrapped_methods_behind(setup):
    """A method wrapped on an index instance (the sanitizer wraps
    ``insert_local`` and the migration seams) acts on that index: a clone
    calls its own, so inserts into the clone never reach the original."""
    db, _ = setup
    t = tshards.ShardedIndex(db[:600], num_shards=2, degree=8,
                             cache_capacity=16, device="cpu")
    calls = []
    inner = t.insert_local
    t.insert_local = lambda *a, **kw: calls.append(a) or inner(*a, **kw)
    c = t.clone()
    assert "insert_local" not in vars(c)
    c.insert_local(0, db[0], None)
    assert not calls and t.cache_size == 0 and c.cache_size == 1
    t.insert_local(1, db[1], None)
    assert len(calls) == 1 and t.cache_size == 1 and c.cache_size == 1


# ---------------------------------------------------------------------------
# coarse quantizer and IVF
# ---------------------------------------------------------------------------


def test_coarse_probe_and_centroid_distances_match_jax(setup):
    db, queries = setup
    c, _ = jivf.kmeans(db, 16, iters=4, seed=0)
    jd = np.asarray(jivf.centroid_distances(jnp.asarray(c),
                                            jnp.asarray(queries)))
    td = tivf.centroid_distances(torch.as_tensor(c),
                                 torch.as_tensor(queries)).numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
    for nprobe in (1, 4, 16):
        ji, jd2 = jivf.coarse_probe(jnp.asarray(c), jnp.asarray(queries),
                                    nprobe=nprobe)
        ti, td2 = tivf.coarse_probe(torch.as_tensor(c),
                                    torch.as_tensor(queries), nprobe=nprobe)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("nprobe", [2, 8])
def test_ivf_flat_search_matches_jax(setup, nprobe):
    db, queries = setup
    j = jivf.IVFFlat(db, nlist=32, iters=4)
    t = tivf.IVFFlat(db, nlist=32, iters=4, device="cpu")
    np.testing.assert_array_equal(t.list_ids.numpy(), np.asarray(j.list_ids))
    ji, jd, jr = j.search(queries, k=10, nprobe=nprobe)
    ti, td, tr = t.search(queries, k=10, nprobe=nprobe)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tr, jr)


# ---------------------------------------------------------------------------
# the three merges: bit-equal, ties to the lower flat index
# ---------------------------------------------------------------------------


def test_merge_partial_topk_padding_and_order():
    ids = np.asarray([[[3, 7, -1], [5, -1, -1]]], np.int32)  # (1, 2, 3)
    d = np.asarray([[[0.5, 2.0, 0.0], [1.0, 0.0, 0.0]]], np.float32)
    out_ids, out_d = tops.merge_partial_topk(ids, d, k=4)
    np.testing.assert_array_equal(out_ids.numpy()[0], [3, 5, 7, -1])
    assert out_d.numpy()[0, 3] >= 1e29


@pytest.mark.parametrize("seed", range(6))
def test_merge_partial_topk_bit_equal_with_ties(seed):
    """Distances drawn from a handful of values (many exact ties), −1
    padding with finite garbage distances, batch dims: ids and distances
    bit-equal to the JAX merge."""
    rng = np.random.default_rng(seed)
    shape = (3, int(rng.integers(1, 6)), int(rng.integers(2, 9)))
    ids = rng.integers(0, 1000, shape).astype(np.int32)
    ids[rng.random(shape) < 0.3] = -1
    d = rng.integers(0, 4, shape).astype(np.float32) * 0.25
    k = int(rng.integers(1, shape[1] * shape[2] + 1))
    ji, jd = jops.merge_partial_topk(jnp.asarray(ids), jnp.asarray(d), k=k)
    ti, td = tops.merge_partial_topk(torch.as_tensor(ids),
                                     torch.as_tensor(d), k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("seed", range(4))
def test_fold_and_finalize_bit_equal(seed):
    """Random children of a (G, R, M) grouped state folded into (P, S, M)
    buffers through an (S, T) translation table — ids past T clip to the
    −1 sentinel — with power-of-two padding by repeating entry 0, then
    finalized (tied distances included): buffers and merged rows
    bit-equal to the JAX ops."""
    rng = np.random.default_rng(seed)
    G, R, M, P, S, T = 4, 6, 8, 5, 3, 16
    top_ids = rng.integers(-1, T + 4, (G, R, M)).astype(np.int32)
    top_d = rng.integers(0, 5, (G, R, M)).astype(np.float32)
    trans = rng.integers(0, 500, (S, T)).astype(np.int32)
    trans[:, -1] = -1
    trans[rng.random((S, T)) < 0.2] = -1
    B = 6
    g_idx = rng.integers(0, G, B)
    slots = rng.integers(0, R, B)
    rows = rng.integers(0, P, B)
    cols = rng.integers(0, S, B)

    def pad(x):
        x = list(x)
        return np.asarray(x + x[:1] * (8 - len(x)), np.int32)

    args = [pad(a) for a in (g_idx, slots, rows, cols)]
    jb = (jnp.full((P, S, M), -1, jnp.int32),
          jnp.full((P, S, M), jnp.float32(1e30)))
    jb = jops.fold_partial_topk(*jb, jnp.asarray(top_ids),
                                jnp.asarray(top_d), jnp.asarray(trans),
                                *map(jnp.asarray, args))
    tb = (torch.full((P, S, M), -1, dtype=torch.int32),
          torch.full((P, S, M), 1e30, dtype=torch.float32))
    tb = tops.fold_partial_topk(*tb, torch.as_tensor(top_ids),
                                torch.as_tensor(top_d),
                                torch.as_tensor(trans),
                                *(torch.as_tensor(a, dtype=torch.int64)
                                  for a in args))
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rows_f = pad(sorted(set(rows.tolist())))
    jout = jops.finalize_partial_topk(*jb, jnp.asarray(rows_f), k=M)
    tout = tops.finalize_partial_topk(
        *tb, torch.as_tensor(rows_f, dtype=torch.int64), k=M)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (tout[0].numpy()[rows_f] == -1).all()  # rows cleared for reuse
