"""Graph search batched over queries: the visited-table probe, the topM
merge, one extend step, and the per-request lockstep search that Trinity
§3.2 improves on (the JAX package's ``vector/cagra.py``, which vmaps its
per-query versions; here the query dimension is written out).

Semantics (shared with the engine in ``core/continuous_batching.py``):
  · per-query state: topM (ids, dists), expanded flags, visited hash table
  · one *extend* = pick ≤ p best unexpanded topM entries, fetch their D
    neighbours, drop visited, compute distances, merge into topM
  · converge when no unexpanded entry remains in topM

"Per-request batching" (``search_batch``) = a batch of queries steps in
lockstep and returns only when EVERY query has converged (or
``max_iters``): the stragglers hold the whole batch. Its distances are
torch ops, as the reference computes them outside Pallas.

Bit-parity with the JAX package rests on two points:
  · the Knuth hash multiplies in uint32 and wraps mod 2^32; here it runs in
    int64 masked with 0xFFFFFFFF (ids < 2^31 cannot overflow int64, and the
    low 32 bits of −1·MULT are the uint32 product JAX computes);
  · ``jax.lax.top_k`` breaks ties to the lower index and ``torch.topk``
    promises no order, so selection is a stable ascending sort, sliced.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.device import resolve_device

INF = 1e30
HASH_MULT = 2654435761  # Knuth multiplicative hash


def smallest_k(values, k: int):
    """(values, indices) of the k smallest entries along the last dim,
    ascending, ties to the lower index — ``jax.lax.top_k(-values, k)``
    with its values negated back."""
    vals, idx = torch.sort(values, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _earlier_duplicate(ids):
    """(B, C) bool: ids[b, i] equals some ids[b, j] with j < i."""
    C = ids.shape[-1]
    eq = ids[..., None, :] == ids[..., :, None]  # [b, i, j]
    lower = torch.ones(C, C, dtype=torch.bool, device=ids.device).tril(-1)
    return (eq & lower).any(-1)


def _hash_probe(visited, ids, num_probes: int = 4):
    """Lookup+insert ids into per-slot open-addressing tables.

    visited: (B, V) int32; ids: (B, C) int32 (-1 = inactive).
    Returns (new_visited, was_seen (B, C) bool).

    "Seen" = present in the table OR duplicate of an earlier candidate in
    the same batch; first occurrences insert into the first empty slot of
    their probe window, with slot conflicts resolved to the lowest
    candidate index via a scatter-min. A losing candidate simply stays
    uninserted (recomputed later, never wrong).
    """
    B, V = visited.shape
    C = ids.shape[1]
    dev = ids.device
    valid = ids >= 0
    probe = torch.arange(num_probes, dtype=torch.int64, device=dev)
    slots = ((ids.long()[..., None] * HASH_MULT + probe) & 0xFFFFFFFF) % V
    cur = visited.gather(1, slots.reshape(B, -1)).reshape(B, C, num_probes)
    hit_table = (cur == ids[..., None]).any(-1)
    seen = (hit_table | _earlier_duplicate(ids)) & valid

    # insert first occurrences at their first empty probe slot
    empty = cur == -1
    want = valid & ~seen & empty.any(-1)
    first_empty = empty.to(torch.uint8).argmax(-1, keepdim=True)
    slot_of = slots.gather(-1, first_empty)[..., 0]  # (B, C)
    proposed = torch.where(want, slot_of, V)  # V = the dropped extra column
    arange_c = torch.arange(C, dtype=torch.int64, device=dev).expand(B, C)
    winner = torch.full((B, V + 1), C, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(1, proposed, arange_c, "amin")
    ins = want & (winner.gather(1, slot_of) == arange_c)
    new_visited = torch.cat(
        [visited, visited.new_full((B, 1), -1)], dim=1)
    new_visited.scatter_(1, torch.where(ins, slot_of, V), ids)
    return new_visited[:, :V], seen


def _merge_topm(top_ids, top_dists, expanded, cand_ids, cand_dists):
    """Merge candidates into topM with exact id-dedup (existing entry wins).

    top_*: (B, M) state; cand_*: (B, C). Returns new (ids, dists, expanded).
    Distances are pure functions of the id, so dropping a duplicate
    candidate is exactly 'existing entry wins'; the M smallest of the M+C
    pool are kept, ties to the lower index (existing entries first).
    """
    M = top_ids.shape[1]
    dup_top = (cand_ids[..., :, None] == top_ids[..., None, :]).any(-1)
    keep = (cand_ids >= 0) & ~dup_top & ~_earlier_duplicate(cand_ids)
    ids = torch.cat([top_ids, torch.where(keep, cand_ids, -1)], dim=1)
    dists = torch.cat([top_dists, torch.where(keep, cand_dists, INF)], dim=1)
    exp = torch.cat([expanded, torch.zeros_like(keep)], dim=1)
    best, order = smallest_k(dists, M)
    return ids.gather(1, order), best, exp.gather(1, order)


class SearchState(NamedTuple):
    top_ids: torch.Tensor  # (Q, M) int32, -1 empty
    top_dists: torch.Tensor  # (Q, M) float32
    expanded: torch.Tensor  # (Q, M) bool
    visited: torch.Tensor  # (Q, V) int32 hash table, -1 empty
    done: torch.Tensor  # (Q,) bool
    extends: torch.Tensor  # (Q,) int32, extend steps consumed


def _l2_to(db, ids, queries):
    """(Q, C) squared L2 distances from db rows ``ids`` (clamped into
    [0, N)) to each row's query, in float32, summed in the order of the
    reference's ``jnp.sum`` on the CPU for widths a multiple of 32 from 64
    up: squares summed one by one within each 32-wide chunk, then the
    chunks' sums one by one (bit-equal there; other widths differ in the
    last bits)."""
    x = db[ids.long().clamp(0, db.shape[0] - 1)].float()  # (Q, C, d)
    t = x - queries[:, None].float()
    d = t.shape[-1]
    sq = torch.nn.functional.pad(t * t, (0, -d % 32))  # + 0.0 changes no sum
    chunks = sq.unflatten(-1, (-1, 32))  # (Q, C, d / 32, 32)
    part = chunks[..., 0]
    for i in range(1, 32):
        part = part + chunks[..., i]
    total = part[..., 0]
    for c in range(1, part.shape[-1]):
        total = total + part[..., c]
    return total


def _extend_one(db, graph, queries, state_q, p: int):
    """One extend step for every query (the reference's ``_extend_one``
    vmapped). state_q: (top_ids, top_dists, expanded, visited), each with a
    leading query dim. Returns (new state_q, did_work (Q,) bool)."""
    top_ids, top_dists, expanded, visited = state_q
    Q = top_ids.shape[0]
    # pick <= p best unexpanded parents, ties to the lower index
    cand_rank = torch.where(expanded | (top_ids < 0), INF, top_dists)
    best, parent_ix = smallest_k(cand_rank, p)  # (Q, p)
    parent_ok = best < INF
    parents = torch.where(parent_ok, top_ids.gather(1, parent_ix), -1)
    expanded = expanded.scatter(1, parent_ix,
                                expanded.gather(1, parent_ix) | parent_ok)
    # gather neighbours, drop visited
    nbrs = torch.where(parents[..., None] >= 0,
                       graph[parents.long().clamp(min=0)], -1).reshape(Q, -1)
    visited, seen = _hash_probe(visited, nbrs)
    nbrs = torch.where(seen, -1, nbrs)
    dist = torch.where(nbrs >= 0, _l2_to(db, nbrs, queries), INF)
    top_ids, top_dists, expanded = _merge_topm(top_ids, top_dists, expanded,
                                               nbrs, dist)
    return (top_ids, top_dists, expanded, visited), parent_ok.any(1)


def init_state(db, graph, queries, top_m: int, visited_slots: int,
               num_entries: int = 8, seed: int = 0):
    """Seed each query's topM with random entry points:
    ``jax.random.randint(PRNGKey(seed), (Q, num_entries), 0, N)``, whose bits
    are those of one flat draw of Q * num_entries."""
    Q, N = queries.shape[0], db.shape[0]
    dev = db.device
    entries = prng.randint(prng.prng_key(seed)[None], Q * num_entries, 0, N)
    entries = torch.as_tensor(entries.reshape(Q, num_entries), device=dev)
    pad = top_m - num_entries
    top_ids = torch.cat([entries, entries.new_full((Q, pad), -1)], dim=1)
    top_dists = torch.cat([_l2_to(db, entries, queries),
                           torch.full((Q, pad), INF, device=dev)], dim=1)
    visited, _ = _hash_probe(entries.new_full((Q, visited_slots), -1), entries)
    return SearchState(top_ids, top_dists,
                       torch.zeros((Q, top_m), dtype=torch.bool, device=dev),
                       visited, torch.zeros(Q, dtype=torch.bool, device=dev),
                       torch.zeros(Q, dtype=torch.int32, device=dev))


def search_batch(db, graph, queries, *, top_m: int = 32, p: int = 2,
                 max_iters: int = 48, visited_slots: int = 512,
                 num_entries: int = 8, device="cuda"):
    """Per-request batched search: lockstep extends until ALL queries have
    converged (a converged query's state is frozen) or ``max_iters``.

    db (N, d), graph (N, D), queries (Q, d): arrays or tensors, moved to
    ``device``. Returns (top_ids (Q, M), top_dists (Q, M), extends (Q,),
    iters_run) with tensors on ``device`` and ``iters_run`` an int."""
    dev = resolve_device(device)
    db, graph, queries = (torch.as_tensor(a, device=dev)
                          for a in (db, graph, queries))
    state = init_state(db, graph, queries, top_m, visited_slots, num_entries)
    it = 0
    while it < max_iters and not bool(state.done.all()):
        new, did = _extend_one(db, graph, queries, state[:4], p)
        frozen = state.done[:, None]
        tid, td, ex, vis = (torch.where(frozen, old, cur)
                            for old, cur in zip(state[:4], new))
        state = SearchState(tid, td, ex, vis, state.done | ~did,
                            state.extends + (~state.done).int())
        it += 1
    return state.top_ids, state.top_dists, state.extends, it
