"""``_hash_probe`` and ``_merge_topm`` of the port are bit-equal to the JAX
package's (vmapped over slots), including hash-slot conflicts, duplicate
candidates, and distance ties (``jax.lax.top_k`` breaks ties to the lower
index; the port's stable sort must too)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.vector import cagra as jcagra  # noqa: E402
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
