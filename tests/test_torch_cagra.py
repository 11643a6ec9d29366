"""``_hash_probe`` and ``_merge_topm`` of the port are bit-equal to the JAX
package's (vmapped over slots), including hash-slot conflicts, duplicate
candidates, and distance ties (``jax.lax.top_k`` breaks ties to the lower
index; the port's stable sort must too); so are the per-request lockstep
search's ``init_state``, ``_extend_one`` and ``search_batch`` (ids,
distances, extends and iterations) at the pools' widths (64, 128)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.vector import cagra as jcagra  # noqa: E402
from repro.vector.dataset import make_dataset  # noqa: E402
from repro.vector.graph import make_cagra_graph  # noqa: E402
from repro_torch.vector import cagra as tcagra  # noqa: E402

_j_probe = jax.jit(jax.vmap(jcagra._hash_probe))
_j_merge = jax.jit(jax.vmap(jcagra._merge_topm))


def _probe_both(visited, ids):
    jv, js = _j_probe(visited, ids)
    tv, ts = tcagra._hash_probe(torch.from_numpy(visited),
                                torch.from_numpy(ids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    return tv.numpy(), ts.numpy()


@pytest.mark.parametrize("V,C,id_hi", [(256, 32, 2000), (512, 64, 10**6),
                                       (64, 48, 300)])
def test_hash_probe_bit_equal(V, C, id_hi):
    rng = np.random.default_rng(V + C)
    B = 8
    visited = np.full((B, V), -1, np.int32)
    for step in range(4):  # repeated probes into a filling table
        ids = rng.integers(-1, id_hi, size=(B, C)).astype(np.int32)
        ids[:, ::5] = ids[:, :1]  # within-batch duplicates
        visited, _ = _probe_both(visited, ids)


def test_hash_probe_slot_conflicts():
    """Ids whose probe windows collide in a tiny table: the scatter-min
    winner is the lowest candidate index, and full windows stay
    uninserted, exactly as in JAX."""
    V = 16
    # ids congruent mod 2^32 / MULT spacing are irrelevant at V=16: pick
    # many ids that hash to the same first slot
    mult = 2654435761
    first = [(i * mult) % 2**32 % V for i in range(5000)]
    same = [i for i in range(5000) if first[i] == first[7]][:12]
    ids = np.asarray([same + [-1] * 4], np.int32)
    visited = np.full((1, V), -1, np.int32)
    tv, seen = _probe_both(visited, ids)
    assert not seen[0, :12].any()
    assert (tv != -1).sum() <= V
    # a second probe of the same ids: inserted ones are now seen
    _probe_both(tv, ids)


def test_hash_probe_extreme_ids():
    """Large ids (near 2^31) hash like JAX's uint32 wraparound."""
    ids = np.asarray([[2**31 - 1, 2**31 - 2, 123456789, 2**30, -1, 0,
                       2**31 - 1, 17]], np.int32)
    _probe_both(np.full((1, 128), -1, np.int32), ids)


def _merge_both(top_ids, top_d, exp, cand_ids, cand_d):
    j = _j_merge(top_ids, top_d, exp, cand_ids, cand_d)
    t = tcagra._merge_topm(*(torch.from_numpy(a) for a in
                             (top_ids, top_d, exp, cand_ids, cand_d)))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("M,C", [(16, 16), (32, 32), (16, 48)])
def test_merge_topm_bit_equal(M, C):
    rng = np.random.default_rng(M * C)
    B = 8
    top_ids = rng.integers(-1, 500, size=(B, M)).astype(np.int32)
    top_d = np.where(top_ids >= 0, rng.random((B, M)), 1e30).astype(np.float32)
    exp = rng.random((B, M)) < 0.3
    cand_ids = rng.integers(-1, 500, size=(B, C)).astype(np.int32)
    cand_ids[:, 1::4] = top_ids[:, :1]  # duplicates of existing entries
    cand_ids[:, 2::6] = cand_ids[:, :1]  # duplicates of earlier candidates
    cand_d = np.where(cand_ids >= 0, rng.random((B, C)), 1e30).astype(np.float32)
    _merge_both(top_ids, top_d, exp, cand_ids, cand_d)


def test_merge_topm_ties():
    """Equal distances and INF padding everywhere: the winners and their
    order must follow the lower index, as jax.lax.top_k orders them."""
    B, M, C = 4, 16, 32
    rng = np.random.default_rng(0)
    top_ids = np.full((B, M), -1, np.int32)
    top_ids[:, :6] = rng.permutation(100)[:6]
    top_d = np.full((B, M), 1e30, np.float32)
    top_d[:, :6] = np.float32(2.5)
    exp = np.zeros((B, M), bool)
    exp[:, ::2] = True
    cand_ids = (200 + np.arange(C) % 20).astype(np.int32)[None].repeat(B, 0)
    cand_ids[:, 25:] = -1
    cand_d = np.where(cand_ids >= 0, np.float32(2.5), np.float32(1e30))
    cand_d[:, 3:9] = np.float32(1.0)
    _merge_both(top_ids, top_d, exp, cand_ids, cand_d.astype(np.float32))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_smallest_k_matches_lax_top_k(k):
    """Parent selection's tie rule: ties to the lower index."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 4, size=(16, 32)).astype(np.float32)
    x[:, ::3] = 1e30
    neg, idx = jax.lax.top_k(-x, k)
    vals, tidx = tcagra.smallest_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


@pytest.fixture(scope="module", params=[64, 128])
def corpus(request):
    """(db, graph, queries) numpy arrays at width 64 or 128."""
    db, q = make_dataset(3000, request.param, seed=request.param,
                         num_queries=48)
    return db, np.asarray(make_cagra_graph(db, 16, seed=0)), q


def test_init_state_bit_equal(corpus):
    """Entry points from ``randint(PRNGKey(seed), (Q, E), 0, N)`` (one flat
    draw through ``prng``), their distances and the visited tables."""
    db, graph, q = corpus
    for seed, E in ((0, 8), (5, 3)):
        j = jcagra.init_state(jnp.asarray(db), jnp.asarray(graph),
                              jnp.asarray(q), 32, 512, E, seed)
        t = tcagra.init_state(torch.from_numpy(db), torch.from_numpy(graph),
                              torch.from_numpy(q), 32, 512, E, seed)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_extend_one_bit_equal(corpus):
    """Three extend steps of every query from the same state."""
    db, graph, q = corpus
    J = [jnp.asarray(a) for a in (db, graph, q)]
    T = [torch.from_numpy(a) for a in (db, graph, q)]
    js = jcagra.init_state(*J, 32, 512)
    ts = tcagra.init_state(*T, 32, 512)
    jstate, tstate = tuple(js[:4]), tuple(ts[:4])
    step = jax.jit(jax.vmap(lambda qq, *s: jcagra._extend_one(
        J[0], J[1], qq, s, 2)))
    for _ in range(3):
        jstate, jdid = step(J[2], *jstate)
        tstate, tdid = tcagra._extend_one(*T, tstate, 2)
        for a, b in zip(tstate, jstate):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tdid.numpy(), np.asarray(jdid))


@pytest.mark.parametrize("top_m,p,max_iters", [(32, 2, 48), (16, 1, 48),
                                               (64, 4, 5)])
def test_search_batch_bit_equal(corpus, top_m, p, max_iters):
    """ids, distances, extends and iterations equal the JAX package's; a
    converged query's lane is frozen, and max_iters cuts the lockstep."""
    db, graph, q = corpus
    j = jcagra.search_batch(jnp.asarray(db), jnp.asarray(graph), jnp.asarray(q),
                            top_m=top_m, p=p, max_iters=max_iters,
                            visited_slots=512)
    t = tcagra.search_batch(db, graph, q, top_m=top_m, p=p,
                            max_iters=max_iters, visited_slots=512,
                            device="cpu")
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t[3] == int(j[3]) <= max_iters
    assert int(t[2].max()) == t[3]  # the slowest query holds the batch
