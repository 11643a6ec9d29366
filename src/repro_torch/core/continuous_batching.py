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
                   metric: str):
    """Seed a batch of B requests from their entry points ``entries``
    (B, E) int32: exact distances (metric-aware), padded to topM, entries
    inserted into fresh visited rows. Returns (ids, dists, visited)."""
    B, E = entries.shape
    x = db[entries.long().clamp(0, db.shape[0] - 1)].float()  # (B, E, d)
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


def _build_tasks(state: EngineState, graph, p: int):
    """Stages 1–3: parent selection, neighbour gather, visited filter,
    global task emission. Returns (task_ids, task_slot (R*p*D,) int32,
    updated expanded/visited, parent_ok (R, p))."""
    R, M = state.top_ids.shape
    D = graph.shape[1]
    rank = torch.where(state.expanded | (state.top_ids < 0), INF,
                       state.top_dists)
    best, parent_ix = smallest_k(rank, p)  # (R, p), ties to lower index
    ok = (best < INF) & state.active[:, None]
    parents = torch.where(ok, state.top_ids.gather(1, parent_ix), -1)
    expanded = state.expanded.scatter(
        1, parent_ix, state.expanded.gather(1, parent_ix) | ok)
    rows = graph[parents.long().clamp(0, graph.shape[0] - 1)]  # (R, p, D)
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
