"""Trinity §3.2: continuous batching for graph vector search.

One *extend* step on the graph is the scheduling unit. The engine keeps a
fixed array of request slots with compact device-side state (topM ids +
dists, expanded flags, visited hash table). Every engine iteration:

  1. per active slot: select ≤ p unexpanded parents from topM,
  2. read D neighbours per parent, filter via the visited table,
  3. emit survivors into ONE global cross-request task array (fixed shape
     ``task_batch``; short batches are rounded up with masked dummies),
  4. evaluate all tasks with a single fixed-shape distance operator — the
     Hopper kernel (``kernels/distance.py``) on the card, its plain-PyTorch
     version on the CPU,
  5. scatter (id, dist) back per slot, merge into topM, mark parents
     expanded,
  6. slots whose topM gained no unexpanded candidate are *converged*: they
     exit immediately and free their slot; new arrivals join the very next
     distance batch.

Port notes (against the JAX package's ``core/continuous_batching.py``):

  · every step is a fixed sequence of tensor ops over all R slots (the
    slot dimension written out where JAX vmapped) and updates the engine
    state tensors in place where JAX donated them; ``snapshot_slots``
    gathers copies and leaves the state untouched;
  · the fused chunk (``extend_multi``, a ``lax.scan`` in JAX) is a Python
    loop of K fixed-shape steps with no host sync inside a step; the host
    syncs ONCE per chunk, pulling the stacked (K, R) completion masks, the
    (K,) task counts and the slot results together;
  · entry points come from the bit-exact threefry port (``prng.py``) on
    the host, keyed by the request id, so a request's result is a pure
    function of (qvec, rid) as in the JAX package: independent of
    admission order and of preemption;
  · parent selection and the topM merge break ties to the lower index, as
    ``jax.lax.top_k`` does (``vector/cagra.py::smallest_k``).

Megabatched dispatch (``GroupEngine``, ``GroupMember``): the engines of a
sharded pool's replicas become lanes of one stacked state, and one grouped
chunk advances the whole cohort, its distance stage one lane launch of the
kernel a step (see the section at the end of this module).

Stage-aware preemption: a running slot can be evicted between chunks — its
full search state is pulled into a host-side ``SlotCheckpoint`` — and later
restored bit-identically into any free slot of this or another engine over
the same index (one extend step is a pure per-slot state → state map).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert, prng
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.vector.cagra import INF, _hash_probe, _merge_topm, smallest_k


@dataclasses.dataclass
class EngineState:
    query_vecs: torch.Tensor  # (R, d) float32
    top_ids: torch.Tensor  # (R, M) int32
    top_dists: torch.Tensor  # (R, M) float32
    expanded: torch.Tensor  # (R, M) bool
    visited: torch.Tensor  # (R, V) int32
    active: torch.Tensor  # (R,) bool
    extends: torch.Tensor  # (R,) int32
    budget: torch.Tensor  # (R,) int32 — forced-completion extend budget, 0=off


# the per-slot rows a checkpoint holds, in ``SlotCheckpoint`` field order
_ROW_FIELDS = ("query_vecs", "top_ids", "top_dists", "expanded", "visited",
               "extends", "budget")


def init_engine_state(cfg, device) -> EngineState:
    R, M, V = cfg.max_requests, cfg.top_m, cfg.visited_slots
    dev = resolve_device(device)
    return EngineState(
        query_vecs=torch.zeros((R, cfg.dim), dtype=torch.float32, device=dev),
        top_ids=torch.full((R, M), -1, dtype=torch.int32, device=dev),
        top_dists=torch.full((R, M), INF, dtype=torch.float32, device=dev),
        expanded=torch.zeros((R, M), dtype=torch.bool, device=dev),
        visited=torch.full((R, V), -1, dtype=torch.int32, device=dev),
        active=torch.zeros((R,), dtype=torch.bool, device=dev),
        extends=torch.zeros((R,), dtype=torch.int32, device=dev),
        budget=torch.zeros((R,), dtype=torch.int32, device=dev),
    )


@dataclasses.dataclass(frozen=True)
class SlotParams:
    """Per-slot search parameters, derived from a request's retrieval
    class by the pool. ``entry_hi = 0`` means "the engine's corpus rows"
    (resolved host-side at admission)."""

    top_k: Optional[int] = None  # result truncation (None = cfg.top_k)
    budget: int = 0  # forced completion after this many extends (0 = off)
    entry_lo: int = 0  # entry-point sampling range [lo, hi)
    entry_hi: int = 0


DEFAULT_PARAMS = SlotParams()


@dataclasses.dataclass
class SlotCheckpoint:
    """Host-side snapshot of one slot's full search state. Restoring it
    into any free slot resumes the search bit-identically (slot identity
    never enters the math; the PRNG is only consumed at admission)."""

    query_vec: np.ndarray  # (d,)
    top_ids: np.ndarray  # (M,)
    top_dists: np.ndarray  # (M,)
    expanded: np.ndarray  # (M,) bool
    visited: np.ndarray  # (V,) int32
    extends: int
    budget: int = 0  # per-slot forced-completion budget (0 = off)
    top_k: Optional[int] = None  # per-slot result truncation


# ---------------------------------------------------------------------------
# slot admission / eviction / restore (in place on the state tensors)
# ---------------------------------------------------------------------------


def _seed_requests(db, qvecs, entries, *, top_m: int, visited_slots: int,
                   metric: str, lanes=None):
    """Seed a batch of B requests from their entry points ``entries``
    (B, E) int32: exact distances (metric-aware), padded to topM, entries
    inserted into fresh visited rows. Returns (ids, dists, visited).
    With ``lanes`` (B,) int64, ``db`` is the stacked (G, N, d) index and
    request b reads lane ``lanes[b]`` (only the sampled rows are
    gathered)."""
    B, E = entries.shape
    rows = entries.long().clamp(0, db.shape[-2] - 1)
    x = (db[rows] if lanes is None
         else db[lanes[:, None], rows]).float()  # (B, E, d)
    q = qvecs[:, None].float()
    if metric == "l2":
        d = ((x - q) ** 2).sum(-1)
    elif metric == "ip":
        d = -(x * q).sum(-1)
    else:
        raise ValueError(f"unknown metric: {metric!r}")
    pad = top_m - E
    ids = torch.cat([entries, entries.new_full((B, pad), -1)], dim=1)
    dists = torch.cat([d, d.new_full((B, pad), INF)], dim=1)
    visited = entries.new_full((B, visited_slots), -1)
    visited, _ = _hash_probe(visited, entries)
    return ids, dists, visited


def admit_many(state: EngineState, db, slots, qvecs, entries, budgets,
               metric: str = "l2") -> None:
    """Seat a batch of requests into ``slots`` (B,) int64: reset the slot
    state, seed topM with the entry points ``entries`` (B, E) int32 and
    their exact distances, insert them into visited, arm the extend
    budgets (B,) int32. Updates ``state`` in place."""
    ids, dists, visited = _seed_requests(
        db, qvecs, entries, top_m=state.top_ids.shape[1],
        visited_slots=state.visited.shape[1], metric=metric)
    state.query_vecs[slots] = qvecs
    state.top_ids[slots] = ids
    state.top_dists[slots] = dists
    state.expanded[slots] = False
    state.visited[slots] = visited
    state.active[slots] = True
    state.extends[slots] = 0
    state.budget[slots] = budgets


def snapshot_slots(state: EngineState, slots):
    """Copies of the full per-slot state rows for ``slots`` (ordered like
    ``SlotCheckpoint`` fields); the state is left untouched and the
    searches keep running."""
    return tuple(getattr(state, f)[slots] for f in _ROW_FIELDS)


def evict_slots(state: EngineState, slots):
    """``snapshot_slots`` + deactivate the slots (in place)."""
    rows = snapshot_slots(state, slots)
    state.active[slots] = False
    return rows


def restore_slots(state: EngineState, slots, rows) -> None:
    """Scatter checkpointed ``rows`` back into ``slots`` and reactivate
    them — the exact inverse of ``evict_slots`` (in place)."""
    for f, r in zip(_ROW_FIELDS, rows):
        getattr(state, f)[slots] = r
    state.active[slots] = True


# ---------------------------------------------------------------------------
# the extend step (fixed shapes end to end, no host sync)
# ---------------------------------------------------------------------------


def _build_tasks(state: EngineState, graph, p: int, lanes=None):
    """Stages 1–3: parent selection, neighbour gather, visited filter,
    global task emission. Returns (task_ids, task_slot (R*p*D,) int32,
    updated expanded/visited, parent_ok (R, p)). With ``lanes`` (R,)
    int64, ``graph`` is the stacked (G, N, D) graph and slot r reads lane
    ``lanes[r]``."""
    R, M = state.top_ids.shape
    D = graph.shape[-1]
    rank = torch.where(state.expanded | (state.top_ids < 0), INF,
                       state.top_dists)
    best, parent_ix = smallest_k(rank, p)  # (R, p), ties to lower index
    ok = (best < INF) & state.active[:, None]
    parents = torch.where(ok, state.top_ids.gather(1, parent_ix), -1)
    expanded = state.expanded.scatter(
        1, parent_ix, state.expanded.gather(1, parent_ix) | ok)
    safe = parents.long().clamp(0, graph.shape[-2] - 1)
    rows = graph[safe] if lanes is None \
        else graph[lanes[:, None], safe]  # (R, p, D)
    nbrs = torch.where(parents[..., None] >= 0, rows, -1).reshape(R, p * D)
    visited, seen = _hash_probe(state.visited, nbrs)
    nbrs = torch.where(seen, -1, nbrs)
    task_ids = nbrs.reshape(-1)
    task_slot = torch.arange(R, dtype=torch.int32,
                             device=nbrs.device).repeat_interleave(p * D)
    return task_ids, task_slot, expanded, visited, ok


def _extend_impl(state: EngineState, db, graph, *, p: int, task_batch: int,
                 metric: str = "l2", distance_mode: str = "slot_gather"):
    """One engine iteration, updating ``state`` in place.

    Returns (completed (R,) bool, tasks_emitted scalar tensor)."""
    R = state.top_ids.shape[0]
    D = graph.shape[1]
    task_ids, task_slot, expanded, visited, parent_ok = _build_tasks(
        state, graph, p)

    n_emit = task_ids.shape[0]
    if n_emit > task_batch:
        raise ValueError(f"R*p*D = {n_emit} tasks exceed task_batch="
                         f"{task_batch}")
    pad = task_batch - n_emit
    task_ids_p = torch.cat([task_ids, task_ids.new_full((pad,), -1)])
    task_slot_p = torch.cat([task_slot, task_slot.new_zeros((pad,))])

    # ---- stage 4: ONE fixed-shape distance operator ----------------------
    dists = kernel_ops.distance_tasks(db, state.query_vecs, task_ids_p,
                                      task_slot_p, metric=metric,
                                      mode=distance_mode)
    dists = dists[:n_emit].reshape(R, p * D)
    cand_ids = task_ids.reshape(R, p * D)

    # ---- stage 5: scatter back + per-slot topM merge ---------------------
    top_ids, top_dists, expanded = _merge_topm(
        state.top_ids, state.top_dists, expanded, cand_ids, dists)

    # ---- stage 6: convergence = no parent was expandable, OR the slot's
    # extend budget is exhausted (the budgeted extend still merges) --------
    did_work = parent_ok.any(1)
    extends = state.extends + (state.active & did_work).to(torch.int32)
    over_budget = (state.budget > 0) & (extends >= state.budget)
    completed = state.active & (~did_work | over_budget)
    new_active = state.active & did_work & ~over_budget
    tasks_emitted = (task_ids >= 0).sum()

    state.top_ids.copy_(top_ids)
    state.top_dists.copy_(top_dists)
    state.expanded.copy_(expanded)
    state.visited.copy_(visited)
    state.active.copy_(new_active)
    state.extends.copy_(extends)
    return completed, tasks_emitted


def extend_multi(state: EngineState, db, graph, *, num_steps: int, p: int,
                 task_batch: int, metric: str = "l2",
                 distance_mode: str = "slot_gather"):
    """K engine iterations back to back, no host sync between them.
    Requests that complete at sub-step i stay inactive (their slot state
    untouched) for the remaining sub-steps.

    Returns (completed (K, R) bool, tasks_emitted (K,)) device tensors."""
    completed, tasks = [], []
    for _ in range(num_steps):
        c, t = _extend_impl(state, db, graph, p=p, task_batch=task_batch,
                            metric=metric, distance_mode=distance_mode)
        completed.append(c)
        tasks.append(t)
    return torch.stack(completed), torch.stack(tasks)


def _to_host(tensors, device) -> List[np.ndarray]:
    """numpy copies of device tensors with ONE host sync for all of them."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return [h.numpy() for h in host]


# ---------------------------------------------------------------------------
# host-side engine wrapper (slot freelist, admission, completion collection)
# ---------------------------------------------------------------------------


class ContinuousBatchingEngine:
    """Host wrapper owning the device state + the slot freelist.

    ``db``/``graph`` are the index's tensors (numpy arrays are placed on
    ``device``); the engine never copies them. Hot-path discipline:
    ``num_active`` is tracked host-side, admissions go through one batched
    ``admit_many`` per scheduler batch (``admit_batch``), and
    ``step_multi`` runs K extend steps with a single host sync.
    """

    def __init__(self, cfg, db, graph, device="cuda", seed: int = 0,
                 corpus_rows: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.db, self.graph = convert.index_from_numpy(db, graph, self.device)
        # rows [0, corpus_n) are the frozen corpus segment; rows beyond are
        # a growable segment that default admissions must not sample from
        self.corpus_n = self.db.shape[0] if corpus_rows is None else corpus_rows
        self.state = init_engine_state(cfg, self.device)
        self.free_slots = list(range(cfg.max_requests))[::-1]
        self.slot_request = {}  # slot -> request id
        self.slot_topk = {}  # slot -> per-slot top-k truncation (optional)
        self.distance_mode = cfg.distance_mode
        self.extend_chunk = max(1, cfg.extend_chunk)
        self._key = prng.prng_key(seed)
        # metrics
        self.total_tasks = 0
        self.total_capacity = 0
        self.total_live_slots = 0
        self.steps = 0

    @property
    def num_active(self) -> int:
        # the host already knows which slots are in flight — no device sync
        return len(self.slot_request)

    @property
    def num_free(self) -> int:
        return len(self.free_slots)

    def _slots(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64), device=self.device)

    def _resolve_params(self, params: Optional[SlotParams]):
        """(entry_lo, entry_hi, budget, top_k) with segment defaulting to
        the frozen corpus rows."""
        p = params or DEFAULT_PARAMS
        hi = p.entry_hi if p.entry_hi > 0 else self.corpus_n
        return p.entry_lo, hi, p.budget, p.top_k

    def admit_batch(self, requests) -> List[int]:
        """Admit ``[(request_id, qvec), ...]`` — optionally
        ``(request_id, qvec, SlotParams)`` — in one batched admission.

        Each request's entry points come from a key folded from its id
        (``rid & 0x7FFFFFFF``) into the engine key, so results are
        identical in any admission order."""
        if not requests:
            return []
        requests = [r if len(r) == 3 else (r[0], r[1], None)
                    for r in requests]
        B = len(requests)
        assert B <= len(self.free_slots), (B, len(self.free_slots))
        slots = [self.free_slots.pop() for _ in range(B)]
        resolved = [self._resolve_params(p) for _, _, p in requests]
        pcols = np.asarray([r[:3] for r in resolved], np.int64)
        keys = prng.fold_in(self._key, [int(rid) & 0x7FFFFFFF
                                        for rid, _, _ in requests])
        entries = prng.randint(keys, min(16, self.cfg.top_m // 2),
                               pcols[:, 0], pcols[:, 1])
        qvecs = np.stack([np.asarray(q, np.float32) for _, q, _ in requests])
        dev = self.device
        admit_many(self.state, self.db, self._slots(slots),
                   torch.as_tensor(qvecs, device=dev),
                   torch.as_tensor(entries, device=dev),
                   torch.as_tensor(pcols[:, 2].astype(np.int32), device=dev),
                   metric=self.cfg.metric)
        for slot, (rid, _, _), (_, _, _, top_k) in zip(slots, requests,
                                                       resolved):
            self.slot_request[slot] = rid
            if top_k is not None:
                self.slot_topk[slot] = top_k
        return slots

    def admit(self, request_id, qvec,
              params: Optional[SlotParams] = None) -> int:
        """Admit one request; returns its slot."""
        return self.admit_batch([(request_id, qvec, params)])[0]

    def set_index(self, db, graph, corpus_rows: Optional[int] = None,
                  rows=None):
        """Swap in grown index tensors (online inserts): a pointer swap,
        the engine keeps aliasing its index. In-flight searches see the
        new rows on their next extend. ``rows`` (the rows the insert
        wrote) matters only to a lane of a stacked group
        (``GroupMember``)."""
        self.db, self.graph = convert.index_from_numpy(db, graph, self.device)
        if corpus_rows is not None:
            self.corpus_n = corpus_rows

    def _checkpoints(self, request_ids, rows, slots, pop_topk: bool):
        qv, ids, dists, exp, vis, ext, bud = _to_host(rows, self.device)
        topk = self.slot_topk.pop if pop_topk else self.slot_topk.get
        return [(rid, SlotCheckpoint(
            query_vec=qv[i].copy(), top_ids=ids[i].copy(),
            top_dists=dists[i].copy(), expanded=exp[i].copy(),
            visited=vis[i].copy(), extends=int(ext[i]), budget=int(bud[i]),
            top_k=topk(slot, None)))
            for i, (rid, slot) in enumerate(zip(request_ids, slots))]

    def preempt(self, request_ids) -> List[Tuple[int, SlotCheckpoint]]:
        """Evict the slots running ``request_ids``: one gather + one host
        sync pulls their full search state into host-side
        ``SlotCheckpoint``s and frees the slots. Restoring a checkpoint
        (here or on another engine over the same index) resumes the search
        bit-identically."""
        if not request_ids:
            return []
        slot_of = {rid: slot for slot, rid in self.slot_request.items()}
        slots = [slot_of[rid] for rid in request_ids]
        rows = evict_slots(self.state, self._slots(slots))
        out = self._checkpoints(request_ids, rows, slots, pop_topk=True)
        for slot in slots:
            del self.slot_request[slot]
            self.free_slots.append(slot)
        return out

    def snapshot(self, request_ids) -> List[Tuple[int, SlotCheckpoint]]:
        """Host-side checkpoints of the slots running ``request_ids``
        WITHOUT evicting them (the searches keep running). A snapshot taken
        between chunks IS the exact state at any failure before the next
        chunk (checkpoint rescue on replica death)."""
        if not request_ids:
            return []
        slot_of = {rid: slot for slot, rid in self.slot_request.items()}
        slots = [slot_of[rid] for rid in request_ids]
        rows = snapshot_slots(self.state, self._slots(slots))
        return self._checkpoints(request_ids, rows, slots, pop_topk=False)

    def resume_batch(self, items) -> List[int]:
        """Re-seat ``[(request_id, SlotCheckpoint), ...]`` into free slots
        in one scatter. Returns the slots used."""
        if not items:
            return []
        B = len(items)
        assert B <= len(self.free_slots), (B, len(self.free_slots))
        slots = [self.free_slots.pop() for _ in range(B)]
        cols = [
            np.stack([np.asarray(c.query_vec, np.float32) for _, c in items]),
            np.stack([np.asarray(c.top_ids, np.int32) for _, c in items]),
            np.stack([np.asarray(c.top_dists, np.float32) for _, c in items]),
            np.stack([np.asarray(c.expanded, bool) for _, c in items]),
            np.stack([np.asarray(c.visited, np.int32) for _, c in items]),
            np.asarray([c.extends for _, c in items], np.int32),
            np.asarray([c.budget for _, c in items], np.int32)]
        restore_slots(self.state, self._slots(slots),
                      [torch.as_tensor(c, device=self.device) for c in cols])
        for slot, (rid, ckpt) in zip(slots, items):
            self.slot_request[slot] = rid
            if ckpt.top_k is not None:
                self.slot_topk[slot] = ckpt.top_k
        return slots

    def step_multi(self, num_steps: Optional[int] = None):
        """K extends over all active slots — one host sync.

        Returns (completions, tasks_per_step (K,) int); completions are
        (request_id, topk_ids, topk_dists, extends_used, substep) with
        ``substep`` ∈ [0, K) the extend at which the request converged (for
        exact completion-time attribution in the pool)."""
        k = self.extend_chunk if num_steps is None else num_steps
        live = self.num_active
        completed_k, tasks_k = extend_multi(
            self.state, self.db, self.graph, num_steps=k,
            p=self.cfg.parents_per_step, task_batch=self.cfg.task_batch,
            metric=self.cfg.metric, distance_mode=self.distance_mode)
        # the ONE host-device sync for this chunk
        completed_k, tasks_k, top_ids, top_dists, extends = _to_host(
            (completed_k, tasks_k, self.state.top_ids, self.state.top_dists,
             self.state.extends), self.device)
        self.total_tasks += int(tasks_k.sum())
        self.total_capacity += k * self.cfg.task_batch
        self.steps += k
        # per-substep live-slot accounting, derived host-side: completions
        # are the only active→inactive transitions and no admissions happen
        # mid-chunk
        per_step_completions = completed_k.sum(axis=1)
        for i in range(k):
            self.total_live_slots += live
            live -= int(per_step_completions[i])

        out = []
        for i in range(k):
            for slot in np.nonzero(completed_k[i])[0]:
                rid = self.slot_request.pop(int(slot))
                # per-slot top-k truncation (retrieval-class heterogeneity)
                kk = self.slot_topk.pop(int(slot), self.cfg.top_k)
                out.append((rid, top_ids[slot, :kk].copy(),
                            top_dists[slot, :kk].copy(),
                            int(extends[slot]), i))
                self.free_slots.append(int(slot))
        return out, tasks_k

    def step(self) -> Tuple[List[Tuple[int, np.ndarray, np.ndarray, int]], int]:
        """One extend over all active slots.

        Returns (completions, tasks_emitted); completions are
        (request_id, topk_ids, topk_dists, extends_used)."""
        comps, tasks_k = self.step_multi(1)
        return [(rid, ids, dists, ext) for rid, ids, dists, ext, _ in comps], \
            int(tasks_k[0])

    def run_to_completion(self, max_steps: int = 256):
        """Drain all active requests (used by tests/benchmarks). Chunk
        sizes are {1, extend_chunk}, as in the JAX package, so both step
        the same number of extends."""
        done = []
        steps = 0
        while steps < max_steps:
            if self.num_active == 0:
                break
            chunk = self.extend_chunk \
                if max_steps - steps >= self.extend_chunk else 1
            c, _ = self.step_multi(chunk)
            done.extend((rid, ids, dists, ext) for rid, ids, dists, ext, _ in c)
            steps += chunk
        return done

    @property
    def slot_occupancy(self) -> float:
        """Fraction of the fixed-shape distance kernel doing real work."""
        return self.total_tasks / max(self.total_capacity, 1)

    @property
    def slot_liveness(self) -> float:
        """Mean fraction of request slots active per launch (comparable to
        the lockstep baseline's live-query fraction)."""
        return self.total_live_slots / max(self.steps * self.cfg.max_requests, 1)


# ---------------------------------------------------------------------------
# megabatched cross-shard dispatch: grouped (lane-stacked) engine state
# ---------------------------------------------------------------------------
#
# Every shard's frozen segment is padded to one common shape, so the
# engines of all shard replicas stack into a (G, R, …) state over stacked
# (G, N, d) / (G, N, D) index tensors, and ONE grouped extend advances
# every lane: the slot dimension runs over G·R slots, each reading its own
# lane's graph and rows, and the distance stage of all lanes is one
# ``kernels/ops.distance_tasks_group`` launch (B1's lane kernel on the
# card). Per-lane math is the per-engine math: lane g of a grouped step
# equals ``_extend_impl`` on lane g's tensors. Lanes outside the stepping
# cohort are frozen bit for bit.


def _init_group_state(cfg, lanes: int, device) -> EngineState:
    one = init_engine_state(cfg, device)
    return EngineState(**{
        f.name: getattr(one, f.name)[None].repeat(
            (lanes,) + (1,) * getattr(one, f.name).dim())
        for f in dataclasses.fields(EngineState)})


def _flat(state: EngineState) -> EngineState:
    """(G·R, …) views of a grouped state (writes go through)."""
    return EngineState(**{
        f.name: getattr(state, f.name).flatten(0, 1)
        for f in dataclasses.fields(EngineState)})


def admit_many_group(state: EngineState, dbs, g_idx, slots, qvecs, entries,
                     budgets, metric: str = "l2") -> None:
    """``admit_many`` at (lane, slot) pairs of the grouped state: each
    request is seeded from its own lane's rows (``_seed_requests`` on the
    same rows, so the seeded values equal the per-engine ones). In
    place."""
    ids, dists, visited = _seed_requests(
        dbs, qvecs, entries, top_m=state.top_ids.shape[2],
        visited_slots=state.visited.shape[2], metric=metric, lanes=g_idx)
    state.query_vecs[g_idx, slots] = qvecs
    state.top_ids[g_idx, slots] = ids
    state.top_dists[g_idx, slots] = dists
    state.expanded[g_idx, slots] = False
    state.visited[g_idx, slots] = visited
    state.active[g_idx, slots] = True
    state.extends[g_idx, slots] = 0
    state.budget[g_idx, slots] = budgets


def snapshot_slots_group(state: EngineState, g_idx, slots):
    """Copies of the full rows at (lane, slot) pairs, ordered like
    ``SlotCheckpoint`` fields; the state is untouched."""
    return tuple(getattr(state, f)[g_idx, slots] for f in _ROW_FIELDS)


def evict_slots_group(state: EngineState, g_idx, slots):
    """``snapshot_slots_group`` + deactivate the pairs (in place)."""
    rows = snapshot_slots_group(state, g_idx, slots)
    state.active[g_idx, slots] = False
    return rows


def restore_slots_group(state: EngineState, g_idx, slots, rows) -> None:
    """Scatter checkpointed rows back into (lane, slot) pairs and
    reactivate them (in place)."""
    for f, r in zip(_ROW_FIELDS, rows):
        getattr(state, f)[g_idx, slots] = r
    state.active[g_idx, slots] = True


def collect_slots_group(state: EngineState, g_idx, slots):
    """The result columns (top ids, top dists, extends) of finishing
    (lane, slot) pairs."""
    return (state.top_ids[g_idx, slots], state.top_dists[g_idx, slots],
            state.extends[g_idx, slots])


def collect_extends_group(state: EngineState, g_idx, slots):
    """Extend counts only: with the device merge a child's ids and dists
    never leave the card; the host needs its extends (fan-out
    accounting)."""
    return state.extends[g_idx, slots]


def _extend_impl_group(state: EngineState, dbs, graphs, group_active, *,
                       p: int, task_batch: int, metric: str = "l2",
                       distance_mode: str = "slot_gather"):
    """One grouped engine iteration over every lane, updating ``state``
    in place.

    The launch covers all G lanes: a lane outside ``group_active`` gets
    only dummy tasks (id −1), so the kernel reads none of its rows, and
    its state is written back unchanged — frozen bit for bit, as the JAX
    package's ``jnp.where`` over the group-active mask freezes it.

    Returns (completed (G, R) bool, tasks_emitted (G,) int64)."""
    G, R = state.top_ids.shape[:2]
    D = graphs.shape[-1]
    dev = state.top_ids.device
    flat = _flat(state)
    lanes = torch.arange(G, device=dev).repeat_interleave(R)  # slot → lane
    task_ids, _, expanded, visited, parent_ok = _build_tasks(
        flat, graphs, p, lanes=lanes)
    n_emit = R * p * D  # per lane
    if n_emit > task_batch:
        raise ValueError(f"R*p*D = {n_emit} tasks exceed task_batch="
                         f"{task_batch}")
    task_ids = torch.where(group_active[:, None], task_ids.view(G, n_emit),
                           -1)
    task_slot = torch.arange(R, dtype=torch.int32, device=dev) \
        .repeat_interleave(p * D).expand(G, n_emit)
    pad = task_batch - n_emit
    task_ids_p = torch.cat([task_ids, task_ids.new_full((G, pad), -1)], 1)
    task_slot_p = torch.cat([task_slot, task_slot.new_zeros((G, pad))], 1)

    # ---- stage 4: ONE launch over every lane ------------------------------
    dists = kernel_ops.distance_tasks_group(
        dbs, state.query_vecs, task_ids_p, task_slot_p, metric=metric,
        mode=distance_mode)
    dists = dists[:, :n_emit].reshape(G * R, p * D)
    cand_ids = task_ids.reshape(G * R, p * D)

    # ---- stage 5/6: per-slot merge and convergence (as _extend_impl) ------
    top_ids, top_dists, expanded = _merge_topm(
        flat.top_ids, flat.top_dists, expanded, cand_ids, dists)
    did_work = parent_ok.any(1)
    extends = flat.extends + (flat.active & did_work).to(torch.int32)
    over_budget = (flat.budget > 0) & (extends >= flat.budget)
    live = group_active.repeat_interleave(R)  # slots of stepping lanes
    completed = flat.active & (~did_work | over_budget) & live
    new_active = flat.active & did_work & ~over_budget
    tasks_emitted = (task_ids >= 0).sum(1)

    def keep(new, old):
        return torch.where(live.view((-1,) + (1,) * (new.dim() - 1)), new,
                           old)

    flat.top_ids.copy_(keep(top_ids, flat.top_ids))
    flat.top_dists.copy_(keep(top_dists, flat.top_dists))
    flat.expanded.copy_(keep(expanded, flat.expanded))
    flat.visited.copy_(keep(visited, flat.visited))
    flat.active.copy_(keep(new_active, flat.active))
    flat.extends.copy_(keep(extends, flat.extends))
    return completed.view(G, R), tasks_emitted


def extend_multi_group(state: EngineState, dbs, graphs, group_active, *,
                       num_steps: int, p: int, task_batch: int,
                       metric: str = "l2",
                       distance_mode: str = "slot_gather"):
    """K grouped extend steps back to back, no host sync between them (the
    counterpart of the JAX package's ``lax.scan`` over a vmapped
    ``_extend_impl``): one distance launch over all G lanes a step.

    Returns (completed (K, G, R) bool, tasks (K, G) int64) device
    tensors."""
    completed, tasks = [], []
    for _ in range(num_steps):
        c, t = _extend_impl_group(state, dbs, graphs, group_active, p=p,
                                  task_batch=task_batch, metric=metric,
                                  distance_mode=distance_mode)
        completed.append(c)
        tasks.append(t)
    return torch.stack(completed), torch.stack(tasks)


class PendingChunk:
    """The completion masks of a grouped chunk still running on the card.

    On a CUDA device the (K, G, R) masks and (K, G) task counts are copied
    by a non-blocking copy into pinned host memory behind an event, so the
    host goes on with its own work; ``wait`` blocks on that event alone.
    On the CPU the tensors are already on the host."""

    def __init__(self, completed, tasks):
        self._event = None
        if completed.device.type == "cuda":
            host = []
            for t in (completed, tasks):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(completed.device))
            completed, tasks = host
        self._host = (completed, tasks)

    def wait(self):
        """(completed (K, G, R), tasks (K, G)) as numpy arrays."""
        if self._event is not None:
            self._event.synchronize()
        return tuple(h.numpy() for h in self._host)


def _pow2_pad(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class GroupEngine:
    """Owner of the stacked per-lane device state for megabatched
    dispatch: a lane-stacked ``EngineState`` (G, R, …) plus stacked index
    tensors (G, N, d) / (G, N, D) on ``device``. Lanes have a free-list
    lifecycle — removing a member deactivates its lane, adding one reuses
    a free lane (admission resets slot state) — and capacity doubles
    O(log) times along the lane axis and the row axis (a shard's cache
    growing past the common row count keeps every lane's rows and state)."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state: Optional[EngineState] = None
        self.dbs = None
        self.graphs = None
        self.g_cap = 0
        self.n_max = 0
        self._free_lanes: List[int] = []
        self._lane_rows: dict = {}  # lane -> rows of its last full write
        self.last_write_bytes = 0  # bytes of the last add_member's copy

    # ------------------------------------------------------ lane lifecycle
    def _grow_lanes(self, want: int):
        new_cap = max(4, self.g_cap)
        while new_cap < want:
            new_cap *= 2
        add = new_cap - self.g_cap
        if add <= 0:
            return
        fresh = _init_group_state(self.cfg, add, self.device)
        n = max(self.n_max, 1)
        dbs = torch.zeros((add, n, self.cfg.dim), dtype=torch.float32,
                          device=self.device)
        graphs = torch.full((add, n, self.cfg.graph_degree), -1,
                            dtype=torch.int32, device=self.device)
        if self.state is None:
            self.state, self.dbs, self.graphs = fresh, dbs, graphs
            self.n_max = n
        else:
            self.state = EngineState(**{
                f.name: torch.cat([getattr(self.state, f.name),
                                   getattr(fresh, f.name)])
                for f in dataclasses.fields(EngineState)})
            self.dbs = torch.cat([self.dbs, dbs])
            self.graphs = torch.cat([self.graphs, graphs])
        self._free_lanes = list(range(new_cap - 1, self.g_cap - 1, -1)) \
            + self._free_lanes
        self.g_cap = new_cap

    def _ensure_rows(self, n: int):
        if n <= self.n_max:
            return
        new_n = max(self.n_max, 1)
        while new_n < n:
            new_n *= 2
        pad = new_n - self.n_max
        self.dbs = torch.cat([self.dbs, self.dbs.new_zeros(
            (self.g_cap, pad, self.cfg.dim))], 1)
        self.graphs = torch.cat([self.graphs, self.graphs.new_full(
            (self.g_cap, pad, self.cfg.graph_degree), -1)], 1)
        self.n_max = new_n

    def add_member(self, index, seed: int) -> "GroupMember":
        if not self._free_lanes:
            self._grow_lanes(self.g_cap + 1)
        lane = self._free_lanes.pop()
        # a new member's lane takes the whole index (its bytes are kept
        # for the pool's record of lane copies)
        self.last_write_bytes = self.write_lane_index(lane, index.db,
                                                      index.graph)
        return GroupMember(self, lane, index, seed)

    def free_lane(self, lane: int):
        self._lane_rows.pop(lane, None)
        self.state.active[lane] = False
        self._free_lanes.append(lane)

    def write_lane_index(self, lane: int, db, graph, rows=None) -> int:
        """Copy a member's index into lane ``lane`` of the stacked tensors:
        all of its rows, or only ``rows`` (sorted global rows an insert
        wrote) when the lane already holds the rest — the other rows are
        unchanged, so the lane ends equal either way. Returns the bytes
        written."""
        n = db.shape[0]
        self._ensure_rows(n)
        db = db.to(self.device)
        graph = graph.to(self.device)
        if rows is None or self._lane_rows.get(lane) != n:
            self.dbs[lane, :n] = db
            self.graphs[lane, :n] = graph
            self._lane_rows[lane] = n
            written = n
        elif len(rows):
            idx = torch.as_tensor(np.asarray(rows, np.int64),
                                  device=self.device)
            self.dbs[lane, idx] = db[idx]
            self.graphs[lane, idx] = graph[idx]
            written = len(rows)
        else:
            written = 0
        return written * (db.shape[1] * db.element_size()
                          + graph.shape[1] * graph.element_size())

    # --------------------------------------------------------- device ops
    def _pad_pairs(self, entries):
        """(lane, slot) pairs → power-of-two padded int64 index tensors
        (padding repeats entry 0: duplicate gathers/scatters are safe)."""
        B = len(entries)
        padded = list(entries) + [entries[0]] * (_pow2_pad(B) - B)
        pairs = torch.as_tensor(np.asarray(padded, np.int64).reshape(-1, 2),
                                device=self.device)
        return pairs[:, 0], pairs[:, 1]

    def dispatch_admits(self, staged: List[dict]):
        """ONE grouped admission covering every staged member flush (see
        ``GroupMember.stage_admit_batch``)."""
        staged = [s for s in staged if len(s["slots"])]
        if not staged:
            return
        entries = [(s["g"], slot) for s in staged for slot in s["slots"]]
        g_idx, slots = self._pad_pairs(entries)
        pad = len(g_idx) - len(entries)

        def cat(key):
            x = np.concatenate([s[key] for s in staged])
            return torch.as_tensor(np.concatenate([x, x[:1].repeat(pad, 0)])
                                   if pad else x, device=self.device)

        admit_many_group(self.state, self.dbs, g_idx, slots, cat("qvecs"),
                         cat("entries"), cat("buds"), metric=self.cfg.metric)

    def dispatch_restores(self, staged: List[dict]):
        """ONE grouped restore for every staged member resume batch (see
        ``GroupMember.stage_resume_batch``)."""
        staged = [s for s in staged if len(s["slots"])]
        if not staged:
            return
        entries = [(s["g"], slot) for s in staged for slot in s["slots"]]
        g_idx, slots = self._pad_pairs(entries)
        pad = len(g_idx) - len(entries)

        def cat(key):
            x = np.concatenate([s[key] for s in staged])
            return torch.as_tensor(np.concatenate([x, x[:1].repeat(pad, 0)])
                                   if pad else x, device=self.device)

        restore_slots_group(self.state, g_idx, slots,
                            [cat(k) for k in ("qv", "ids", "dists", "exp",
                                              "vis", "ext", "bud")])

    def _launch(self, lanes: List[int], num_steps: int):
        mask = np.zeros((self.g_cap,), bool)
        mask[lanes] = True
        cfgv = self.cfg
        return extend_multi_group(
            self.state, self.dbs, self.graphs,
            torch.as_tensor(mask, device=self.device), num_steps=num_steps,
            p=cfgv.parents_per_step, task_batch=cfgv.task_batch,
            metric=cfgv.metric, distance_mode=cfgv.distance_mode)

    def step_lanes(self, lanes: List[int], num_steps: int):
        """K grouped extend steps for the cohort ``lanes``, one sync.
        Returns host (completed (K, G, R), tasks (K, G)); lanes outside the
        cohort are frozen bit for bit."""
        return PendingChunk(*self._launch(lanes, num_steps)).wait()

    def step_lanes_async(self, lanes: List[int], num_steps: int):
        """Double-buffered variant: launch the cohort's chunk and return a
        :class:`PendingChunk` without waiting — the caller does its host
        work before ``wait()``."""
        return PendingChunk(*self._launch(lanes, num_steps))

    def collect_rows(self, entries):
        """Host (top_ids (B, M), top_dists (B, M), extends (B,)) of
        finishing (lane, slot) pairs — one gather and one sync."""
        if not entries:
            return (np.zeros((0, self.cfg.top_m), np.int32),
                    np.zeros((0, self.cfg.top_m), np.float32),
                    np.zeros((0,), np.int32))
        g_idx, slots = self._pad_pairs(entries)
        B = len(entries)
        return tuple(x[:B] for x in _to_host(
            collect_slots_group(self.state, g_idx, slots), self.device))

    def gather_checkpoint_rows(self, entries):
        """Full-row snapshot of (lane, slot) pairs as host arrays ordered
        like ``SlotCheckpoint`` fields — one sync for the whole cohort."""
        g_idx, slots = self._pad_pairs(entries)
        B = len(entries)
        return tuple(x[:B] for x in _to_host(
            snapshot_slots_group(self.state, g_idx, slots), self.device))


class GroupMember(ContinuousBatchingEngine):
    """Engine facade over one lane of a :class:`GroupEngine`: the
    ``ContinuousBatchingEngine`` host bookkeeping (freelist, slot→rid maps,
    per-request PRNG keys, metrics) with every device op routed through the
    shared stacked state, so pool code (cancel, hedging, kill rescue) works
    unchanged against it."""

    def __init__(self, group: GroupEngine, lane: int, index, seed: int):
        # deliberately NOT calling super().__init__: the lane owns no
        # private device tensors — state and index live in the group stacks
        self.group = group
        self.lane = lane
        self.cfg = group.cfg
        self.device = group.device
        self.corpus_n = index.corpus_n
        self.free_slots = list(range(group.cfg.max_requests))[::-1]
        self.slot_request = {}
        self.slot_topk = {}
        self.distance_mode = group.cfg.distance_mode
        self.extend_chunk = max(1, group.cfg.extend_chunk)
        self._key = prng.prng_key(seed)
        self.total_tasks = 0
        self.total_capacity = 0
        self.total_live_slots = 0
        self.steps = 0

    # ------------------------------------------------------- admission
    def stage_admit_batch(self, requests) -> dict:
        """Host half of ``admit_batch``: pop slots, draw each request's
        entry points from its id-folded key, resolve per-slot params — the
        staged arguments of ONE grouped admission over the whole cohort."""
        requests = [r if len(r) == 3 else (r[0], r[1], None)
                    for r in requests]
        B = len(requests)
        assert B <= len(self.free_slots), (B, len(self.free_slots))
        slots = [self.free_slots.pop() for _ in range(B)]
        resolved = [self._resolve_params(p) for _, _, p in requests]
        for slot, (rid, _, _), (_, _, _, top_k) in zip(slots, requests,
                                                       resolved):
            self.slot_request[slot] = rid
            if top_k is not None:
                self.slot_topk[slot] = top_k
        E = min(16, self.cfg.top_m // 2)
        pcols = np.asarray([r[:3] for r in resolved], np.int64) \
            if resolved else np.zeros((0, 3), np.int64)
        if requests:
            keys = prng.fold_in(self._key, [int(rid) & 0x7FFFFFFF
                                            for rid, _, _ in requests])
            entries = prng.randint(keys, E, pcols[:, 0], pcols[:, 1])
        else:
            entries = np.zeros((0, E), np.int32)
        return {
            "g": self.lane,
            "slots": slots,
            "qvecs": (np.stack([np.asarray(q, np.float32)
                                for _, q, _ in requests]) if requests
                      else np.zeros((0, self.cfg.dim), np.float32)),
            "entries": entries,
            "buds": pcols[:, 2].astype(np.int32),
        }

    def admit_batch(self, requests) -> List[int]:
        if not requests:
            return []
        staged = self.stage_admit_batch(requests)
        self.group.dispatch_admits([staged])
        return staged["slots"]

    def stage_resume_batch(self, items) -> dict:
        """Host half of ``resume_batch``: pop slots and stack the
        checkpoint rows; the scatter is the group's."""
        B = len(items)
        assert B <= len(self.free_slots), (B, len(self.free_slots))
        slots = [self.free_slots.pop() for _ in range(B)]
        for slot, (rid, ckpt) in zip(slots, items):
            self.slot_request[slot] = rid
            if ckpt.top_k is not None:
                self.slot_topk[slot] = ckpt.top_k

        def stack(f):
            return np.stack([f(c) for _, c in items])

        return {
            "g": self.lane, "slots": slots,
            "qv": stack(lambda c: np.asarray(c.query_vec, np.float32)),
            "ids": stack(lambda c: np.asarray(c.top_ids, np.int32)),
            "dists": stack(lambda c: np.asarray(c.top_dists, np.float32)),
            "exp": stack(lambda c: np.asarray(c.expanded, bool)),
            "vis": stack(lambda c: np.asarray(c.visited, np.int32)),
            "ext": stack(lambda c: np.int32(c.extends)),
            "bud": stack(lambda c: np.int32(c.budget)),
        }

    def resume_batch(self, items) -> List[int]:
        if not items:
            return []
        staged = self.stage_resume_batch(items)
        self.group.dispatch_restores([staged])
        return staged["slots"]

    # ------------------------------------------------------ index updates
    def set_index(self, db, graph, corpus_rows: Optional[int] = None,
                  rows=None):
        """Copy the member's grown index into its lane (only ``rows`` when
        given and the lane's row count is unchanged). Returns the bytes
        copied."""
        nbytes = self.group.write_lane_index(self.lane, db, graph, rows)
        if corpus_rows is not None:
            self.corpus_n = corpus_rows
        return nbytes

    # ------------------------------------------- preemption / checkpoints
    def preempt(self, request_ids) -> List[Tuple[int, SlotCheckpoint]]:
        if not request_ids:
            return []
        slot_of = {rid: slot for slot, rid in self.slot_request.items()}
        slots = [slot_of[rid] for rid in request_ids]
        g_idx, slots_t = self.group._pad_pairs([(self.lane, s)
                                                for s in slots])
        rows = evict_slots_group(self.group.state, g_idx, slots_t)
        out = self._checkpoints(request_ids, rows, slots, pop_topk=True)
        for slot in slots:
            del self.slot_request[slot]
            self.free_slots.append(slot)
        return out

    def snapshot(self, request_ids) -> List[Tuple[int, SlotCheckpoint]]:
        if not request_ids:
            return []
        slot_of = {rid: slot for slot, rid in self.slot_request.items()}
        slots = [slot_of[rid] for rid in request_ids]
        g_idx, slots_t = self.group._pad_pairs([(self.lane, s)
                                                for s in slots])
        rows = snapshot_slots_group(self.group.state, g_idx, slots_t)
        return self._checkpoints(request_ids, rows, slots, pop_topk=False)

    # ----------------------------------------------------------- stepping
    def collect_completions(self, completed_k: np.ndarray):
        """Turn this lane's (K, R) completion masks into ``step_multi``'s
        tuples, with one gather of the finishing slots' results."""
        entries = [(i, int(slot)) for i in range(completed_k.shape[0])
                   for slot in np.nonzero(completed_k[i])[0]]
        ids, dists, ext = self.group.collect_rows(
            [(self.lane, s) for _, s in entries])
        out = []
        for j, (i, slot) in enumerate(entries):
            rid = self.slot_request.pop(slot)
            kk = self.slot_topk.pop(slot, self.cfg.top_k)
            out.append((rid, ids[j, :kk].copy(), dists[j, :kk].copy(),
                        int(ext[j]), i))
            self.free_slots.append(slot)
        return out

    def step_multi(self, num_steps: Optional[int] = None):
        k = self.extend_chunk if num_steps is None else num_steps
        live = self.num_active
        completed_k, tasks_k = self.group.step_lanes([self.lane], k)
        ck = completed_k[:, self.lane]
        tk = np.ascontiguousarray(tasks_k[:, self.lane])
        self.total_tasks += int(tk.sum())
        self.total_capacity += k * self.cfg.task_batch
        self.steps += k
        per_step_completions = ck.sum(axis=1)
        for i in range(k):
            self.total_live_slots += live
            live -= int(per_step_completions[i])
        out = self.collect_completions(ck) if ck.any() else []
        return out, tk
