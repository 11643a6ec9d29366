"""Visited-table probe and topM merge of the graph search, batched over
request slots (the JAX package vmaps its per-slot versions; here the slot
dimension is written out).

Semantics (shared with the engine in ``core/continuous_batching.py``):
  · per-slot state: topM (ids, dists), expanded flags, visited hash table
  · one *extend* = pick ≤ p best unexpanded topM entries, fetch their D
    neighbours, drop visited, compute distances, merge into topM

Bit-parity with the JAX package rests on two points:
  · the Knuth hash multiplies in uint32 and wraps mod 2^32; here it runs in
    int64 masked with 0xFFFFFFFF (ids < 2^31 cannot overflow int64, and the
    low 32 bits of −1·MULT are the uint32 product JAX computes);
  · ``jax.lax.top_k`` breaks ties to the lower index and ``torch.topk``
    promises no order, so selection is a stable ascending sort, sliced.
"""
from __future__ import annotations

import torch

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
