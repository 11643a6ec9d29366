"""The shared vector-search pool: engine replicas × multi-lane scheduler ×
adaptive controller, advanced in simulated time.

The JAX package's ``core/trinity_pool.py`` on PyTorch: the monolithic
:class:`VectorPool` (one index on ``device`` shared by every replica's
engine) and the sharded :class:`ShardedVectorPool`.

Retrieval classes: requests carry a class name resolved against the
scheduler's registry (``core/scheduler.py``); the pool derives per-slot
engine search params (entry segment, extend budget, top-k truncation) from
the class.

Online index growth and the answer cache: the pool owns the authoritative
``vector.online.OnlineIndex``. An insert rides the scheduler as a
deadline-less background-class request whose engine search (restricted to
the cache segment) selects the neighbours; on completion the pool patches
the index (``insert_batch``) and broadcasts it to the owning replicas'
engines (``engine.set_index``). ``meta_at`` serves an answer's metadata
under the slot-reuse and TTL guards.

Sharded scatter–gather (:class:`ShardedVectorPool`): the corpus is
partitioned into balanced-k-means shards (``vector/shards.ShardedIndex``),
each owned by ``replicas_per_shard`` replicas with their own scheduler. A
request becomes per-shard children; the parent completes when every child
has merged (``kernels/ops.py``'s partial top-k). Inserts route to the
owning shard only. With ``cfg.megabatch_enabled`` (the default) the
replicas are lanes of one ``GroupEngine`` and the whole clock-frontier
cohort steps through ONE grouped chunk (its distance stage one lane launch
of the kernel a step); ``device_merge_enabled`` folds the children's
partial lists into per-parent buffers on the device, and
``double_buffer_enabled`` releases the next arrivals while the chunk runs.

Workload-adaptive rebalancing (``cfg.rebalance_enabled``) moves a cold
shard's replica onto a hot shard and migrates cache entries off a
capacity-pressed shard; ``lose_shard`` kills a whole shard and wipes its
cache segment, re-homing the entries from host-side peer copies under
``cfg.cache_backup_enabled``. A moved or re-homed replica takes a fresh
lane, copied whole from its shard's index (``lane_copies`` records each
copy); every later write to a shard reaches its lanes through the rows
the index recorded (``OnlineIndex.drain_touched``).

The clock is simulated: a chunk of K extends advances a replica by
K·``roofline_model.extend_time(cfg)`` (``extend_time_group`` in a
megabatched cohort), the JAX package's V5E-model price, so completion
times match it; a request converging at sub-step i is stamped
``t + (i+1)·T_ext``. These are model times, not card times.

``cfg.sanitizer_enabled`` wraps the pool's seams with the record-only
invariant checks of ``serving/sanitizer.py``; with the knob off nothing is
wrapped.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.core import roofline_model
from repro_torch.core.continuous_batching import (ContinuousBatchingEngine,
                                                  GroupEngine, SlotCheckpoint,
                                                  SlotParams, _pow2_pad,
                                                  _to_host,
                                                  collect_extends_group,
                                                  collect_slots_group)
from repro_torch.core.scheduler import (ControllerFeedback, TwoQueueScheduler,
                                        VectorRequest)
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (finalize_partial_topk, fold_partial_topk,
                                     merge_partial_topk)
# CapacityError is raised at construction (frozen rows over budget) and at
# cache growth (insert load pushing a replica past its modeled HBM)
from repro_torch.vector.online import CapacityError, OnlineIndex  # noqa: F401
from repro_torch.vector.shards import ShardedIndex


@dataclasses.dataclass
class PoolMetrics:
    completed: List[VectorRequest] = dataclasses.field(default_factory=list)
    extend_steps: int = 0
    tasks_emitted: int = 0
    tasks_capacity: int = 0
    # stage-aware preemption
    preemptions: int = 0  # slot evictions
    resumes: int = 0  # checkpointed requests re-seated
    preempt_time: float = 0.0  # total evicted time across completed reqs
    # online index growth
    inserts: int = 0  # cache-segment nodes added
    cache_evictions: int = 0  # cache entries retired (TTL / capacity cap)
    broadcasts: int = 0  # engine.set_index calls (per-replica, per-insert)
    # sharded scatter–gather
    sub_searches: int = 0  # per-shard children dispatched
    merges: int = 0  # parent fan-outs merged to completion
    shard_reassignments: int = 0  # orphaned shards re-homed after a kill
    # workload-adaptive rebalancing
    rebalances: int = 0  # replicas moved cold shard → hot shard
    migrated_entries: int = 0  # cache entries re-homed between shards
    drains: int = 0  # replicas retired by a planned scale-down
    # failure handling
    replica_deaths: int = 0  # kill_replica fail-stops
    shard_losses: int = 0  # whole-shard (replicas + cache segment) losses
    rescued: int = 0  # in-flight requests resumed from a death snapshot
    retries: int = 0  # from-scratch restarts after a replica death
    retries_exhausted: int = 0  # requests failed at the max_retries cap
    hedges: int = 0  # duplicate twins dispatched for stuck children
    hedges_won: int = 0  # the twin finished first
    hedges_wasted: int = 0  # duplicate work cancelled/dropped post-winner
    probes_cancelled: int = 0  # requests cancelled by their upstream owner
    cache_recovered: int = 0  # lost cache entries re-homed from backup
    cache_lost: int = 0  # cache entries lost with a dead shard (no backup)
    # recent per-shard child admission waits (bounded window, newest last)
    shard_waits: Dict[int, List[float]] = dataclasses.field(
        default_factory=dict)

    def shard_p95_wait(self, s: int) -> float:
        """p95 of shard ``s``'s recent child admission waits (0.0 with no
        completed children)."""
        xs = self.shard_waits.get(s)
        return float(np.percentile(xs, 95)) if xs else 0.0

    def latencies(self, kind: Optional[str] = None) -> np.ndarray:
        xs = [r.t_completed - r.t_arrival for r in self.completed
              if r.t_completed is not None and (kind is None or r.kind == kind)]
        return np.asarray(xs, np.float64) if xs else np.zeros(0, np.float64)

    def p(self, q: float, kind: Optional[str] = None) -> float:
        lat = self.latencies(kind)
        return float(np.percentile(lat, q)) if lat.size else 0.0

    @property
    def occupancy(self) -> float:
        return self.tasks_emitted / max(self.tasks_capacity, 1)


@dataclasses.dataclass
class ShardLoad:
    """Decayed per-shard demand counters (probe children dispatched,
    cache inserts routed) over the ``rebalance_window_s`` horizon."""

    probe_ewma: float = 0.0  # decayed child-dispatch count
    insert_ewma: float = 0.0  # decayed cache-insert count
    t_last: float = 0.0

    def _decay(self, t: float, window: float) -> float:
        return math.exp(-max(t - self.t_last, 0.0) / max(window, 1e-9))

    def observe(self, t: float, window: float, probes: int = 0,
                inserts: int = 0):
        d = self._decay(t, window)
        self.probe_ewma = self.probe_ewma * d + probes
        self.insert_ewma = self.insert_ewma * d + inserts
        self.t_last = max(self.t_last, t)

    def decayed(self, t: float, window: float) -> float:
        """Demand events still 'alive' in the window at time ``t``."""
        return (self.probe_ewma + self.insert_ewma) * self._decay(t, window)

    def probe_qps(self, t: float, window: float) -> float:
        return self.probe_ewma * self._decay(t, window) / max(window, 1e-9)

    def insert_qps(self, t: float, window: float) -> float:
        return self.insert_ewma * self._decay(t, window) / max(window, 1e-9)


class _Replica:
    def __init__(self, rid: int, cfg, index: OnlineIndex, seed: int,
                 engine: Optional[ContinuousBatchingEngine] = None):
        self.rid = rid
        # megabatched pools inject a GroupMember (a lane of the shared
        # stacked state) instead of a private engine
        self.engine = engine if engine is not None else \
            ContinuousBatchingEngine(cfg, index.db, index.graph,
                                     device=index.device, seed=seed,
                                     corpus_rows=index.corpus_n)
        self.shard = -1  # owning shard (sharded pools; −1 = monolithic)
        self.clock = 0.0
        self.ext_latency_ewma = roofline_model.extend_time(cfg)
        self.slowdown = 1.0  # >1 = straggling hardware
        self.quarantined = False
        self.in_flight: Dict[int, VectorRequest] = {}
        # checkpoint-rescue (cfg.rescue_enabled): host-side SlotCheckpoint
        # per in-flight rid, refreshed after every fused chunk
        self.snapshots: Dict[int, object] = {}


class _Fanout:
    """Host-side state of one logical request split into per-shard
    children: pending shard set + per-shard partial results."""

    __slots__ = ("parent", "pending", "ids", "dists", "extends", "t_done",
                 "t_admitted", "buf_row", "kk", "host")

    def __init__(self, parent: VectorRequest, targets: Set[int]):
        self.parent = parent
        self.pending = set(targets)
        self.ids: List[np.ndarray] = []
        self.dists: List[np.ndarray] = []
        self.extends = 0
        self.t_done = -np.inf
        self.t_admitted: Optional[float] = None
        # device merge: the merge-buffer row this fan's children fold into
        # (None = host path), the per-child top-k truncation, and the
        # sticky buffer-overflow fallback flag (a fan merges EITHER fully
        # on the device or fully on the host)
        self.buf_row: Optional[int] = None
        self.kk: Optional[int] = None
        self.host = False


class VectorPool:
    def __init__(self, cfg, db, graph, *, replicas: int = 1,
                 policy: str = "trinity", device="cuda",
                 min_replicas: int = 1, max_replicas: int = 8,
                 straggler_factor: float = 2.5, elastic: bool = False,
                 classes=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        # frozen corpus as a host numpy view (the JAX pool's ``db``; the
        # device copy lives in the index)
        self.db = db if isinstance(db, np.ndarray) or db is None \
            else db.detach().cpu().numpy()
        self.graph = graph
        self.metrics = PoolMetrics()
        # online inserts: pool-internal rid space + answer-cache metadata
        self._insert_rid = 1 << 28
        self._insert_meta: Dict[int, object] = {}
        self.cache_meta: Dict[int, object] = {}  # filled row id -> payload
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.straggler_factor = straggler_factor
        self.elastic = elastic
        self.feedback = ControllerFeedback()
        self._seed = seed
        self._pending: list = []  # (t_arrival, seq, request) heap
        self._pending_seq = 0  # deterministic tiebreak (id() varies by run)
        self._build(db, graph, replicas, policy, classes)
        self.peak_replicas = len(self.replicas)
        # opt-in runtime invariant layer; None = nothing wrapped
        self.sanitizer = None
        if cfg.sanitizer_enabled:
            from repro_torch.serving.sanitizer import attach
            self.sanitizer = attach(self)

    # -------------------------------------------------- construction hooks
    def _build(self, db, graph, replicas: int, policy: str, classes):
        """Index + scheduler + replica construction (the sharded pool
        overrides this with per-shard indexes/schedulers/replicas)."""
        cfg = self.cfg
        self.index = OnlineIndex(
            db, graph, metric=cfg.metric,
            cache_capacity=(cfg.cache_capacity
                            if cfg.semantic_cache_enabled else 0),
            ttl=cfg.cache_ttl_s, max_entries=cfg.cache_max_entries,
            max_rows=cfg.replica_max_rows, device=self.device)
        self._check_capacity(self.index)
        self.scheduler = TwoQueueScheduler(cfg, policy=policy,
                                           classes=classes)
        self.schedulers = [self.scheduler]
        self.replicas: List[_Replica] = [
            _Replica(i, cfg, self.index, self._seed + i)
            for i in range(replicas)]
        self._next_rid = replicas

    def _check_capacity(self, index: OnlineIndex):
        cap = self.cfg.replica_max_rows
        rows = index.db.shape[0]
        if cap and rows > cap:
            raise CapacityError(
                f"replica index needs {rows} rows but replica_max_rows="
                f"{cap}; shard the corpus (VectorPoolConfig.num_shards > 1)")

    # ------------------------------------------------------ routing hooks
    def _sched_for(self, rep: _Replica):
        """The scheduler feeding this replica (per-shard when sharded)."""
        return self.scheduler

    def _index_for(self, rep: _Replica) -> OnlineIndex:
        """The index this replica's engine serves."""
        return self.index

    def _dispatch(self, req: VectorRequest):
        """Hand a released request to scheduling (the sharded pool splits
        it into per-shard children here)."""
        self.scheduler.submit(req)

    # ------------------------------------------------------------------ API
    def submit(self, req: VectorRequest):
        """Requests become visible to the scheduler at their arrival time
        (event-driven semantics)."""
        heapq.heappush(self._pending, (req.t_arrival, self._pending_seq, req))
        self._pending_seq += 1

    @property
    def cache_size(self) -> int:
        """Live answer-cache entries (tombstoned/evicted slots excluded)."""
        return self.index.cache_size

    def submit_insert(self, vec, meta=None, t_now: float = 0.0):
        """Insert ``vec`` into the growable cache segment.

        With an empty segment there is nothing to search, so the node is
        placed synchronously; otherwise the insert rides the scheduler as
        a deadline-less background-class request whose search performs the
        neighbour selection. Returns the row id for a synchronous insert,
        None when queued (``cache_meta`` maps row → ``meta`` once filled).
        """
        vec = np.asarray(vec, np.float32)
        if self.index.cache_size == 0:
            return self._apply_insert(vec, None, meta, t_now=t_now)
        rid = self._insert_rid
        self._insert_rid += 1
        self._insert_meta[rid] = meta
        self.submit(VectorRequest(rid, "insert", vec, t_now, None))
        return None

    def _apply_insert(self, vec, neighbor_ids, meta, t_now: float = 0.0):
        """Patch the index and broadcast it to every replica (at once:
        engines alias the index tensors). TTL/capacity evictions retired by
        this insert drop their answer metadata so an expired entry can
        never serve a hit."""
        row = self.index.insert(vec, neighbor_ids, t_now=t_now)
        for gone in self.index.drain_evicted():
            self.cache_meta.pop(gone, None)
            self.metrics.cache_evictions += 1
        if meta is not None:
            self.cache_meta[row] = meta
        self.metrics.inserts += 1
        rows = self.index.drain_touched()
        for rep in self.replicas:
            rep.engine.set_index(self.index.db, self.index.graph, rows=rows)
        self.metrics.broadcasts += len(self.replicas)
        return row

    def _born_at(self, row: int) -> Optional[float]:
        """Insert time of the row's current occupant (hook: the sharded
        pool resolves through its gid map)."""
        return self.index.born_at(row)

    def meta_at(self, row: int, t_lookup: float):
        """Answer metadata for a result row, guarded two ways: (a) slot
        reuse — the occupant must already have been inserted when the
        lookup finished; (b) TTL at serve time — index eviction is lazy,
        so expiry is judged here too."""
        meta = self.cache_meta.get(row)
        if meta is None:
            return None
        born = self._born_at(row)
        if born is None or born > t_lookup + 1e-12:
            return None
        ttl = self.cfg.cache_ttl_s
        if ttl > 0 and t_lookup > born + ttl + 1e-12:
            return None
        return meta

    def _params_for(self, req: VectorRequest,
                    rep: Optional[_Replica] = None) -> Optional[SlotParams]:
        """Per-slot engine search params derived from the request's
        retrieval class; None (engine defaults) for plain corpus classes."""
        rc = req.rclass
        if rc is None or (rc.segment == "corpus" and rc.extend_budget == 0
                          and rc.top_k is None):
            return None
        lo, hi = self._index_for(rep).entry_range(rc.segment)
        return SlotParams(top_k=rc.top_k, budget=rc.extend_budget,
                          entry_lo=lo, entry_hi=hi)

    def _release_pending(self, t_now: float):
        while self._pending and self._pending[0][0] <= t_now:
            _, _, req = heapq.heappop(self._pending)
            self._dispatch(req)

    def run_until(self, t_end: float):
        """Advance every replica's clock to t_end, stepping engines whenever
        the scheduler decides to flush admissions or work is active."""
        while True:
            rep = min((r for r in self.replicas), key=lambda r: r.clock)
            if rep.clock >= t_end:
                break
            self._release_pending(rep.clock)
            self._step_replica(rep, t_end)
        self._maybe_scale(t_end)

    def kill_replica(self, idx: int):
        """Fail-stop: the replica's device state is gone. Each in-flight
        request either RESUMES from its last host-side snapshot on a
        surviving replica (``cfg.rescue_enabled``) or restarts from
        scratch: immediately, or after a deadline-aware backoff
        (``cfg.retry_backoff_ms``), up to ``cfg.max_retries`` restarts
        after which it completes FAILED (empty results, counted)."""
        rep = self.replicas.pop(idx)
        self.metrics.replica_deaths += 1
        # the kill lands at the pool's clock frontier, not at the victim's
        # own (possibly chunk-ahead) clock
        t = min([rep.clock] + [r.clock for r in self.replicas])
        sched = self._sched_for(rep)
        for req in rep.in_flight.values():
            req.t_admitted = None
            ckpt = rep.snapshots.get(req.rid) \
                if self.cfg.rescue_enabled else None
            if ckpt is not None:
                sched.requeue_rescued(req, ckpt, t)
                self.metrics.rescued += 1
                continue
            # device state is gone: restart from scratch on re-admission
            req.checkpoint = None
            req.extends_done = 0
            if self.cfg.max_retries > 0 \
                    and req.retries >= self.cfg.max_retries:
                self.metrics.retries_exhausted += 1
                self._fail_request(req, t)
                continue
            req.retries += 1
            self.metrics.retries += 1
            backoff = self.cfg.retry_backoff_ms / 1e3
            if backoff > 0:
                # deadline-aware: never sleep past half the remaining slack
                if req.deadline is not None:
                    backoff = min(backoff, max(req.deadline - t, 0.0) * 0.5)
                self._resubmit_at(req, t + backoff)
            else:
                sched.submit(req)

    def _fail_request(self, req: VectorRequest, t: float):
        """Complete a request as FAILED (empty results) — the retry cap
        is exhausted. The request still completes exactly once."""
        req.failed = True
        req.result_ids = None
        req.result_dists = None
        req.t_completed = t
        if req.kind == "insert":
            self._insert_meta.pop(req.rid, None)
        self.metrics.completed.append(req)

    def _resubmit_at(self, req: VectorRequest, t: float):
        """Re-enter the arrival heap at a future release time."""
        heapq.heappush(self._pending, (t, self._pending_seq, req))
        self._pending_seq += 1

    def _remove_pending(self, rid: int) -> Optional[VectorRequest]:
        for i, (_, _, r) in enumerate(self._pending):
            if r.rid == rid:
                self._pending.pop(i)
                heapq.heapify(self._pending)
                return r
        return None

    def cancel(self, rid: int) -> bool:
        """Cancel a submitted request wherever it currently lives — the
        arrival heap, a scheduler lane, or an engine slot (evicted, state
        discarded). Returns True when found."""
        found = self._remove_pending(rid) is not None
        if not found:
            for sched in self.schedulers:
                if sched.cancel(rid) is not None:
                    found = True
                    break
        if not found:
            for rep in self.replicas:
                if rid in rep.in_flight \
                        and rid in rep.engine.slot_request.values():
                    rep.engine.preempt([rid])  # discard the checkpoint
                    rep.in_flight.pop(rid)
                    rep.snapshots.pop(rid, None)
                    found = True
                    break
        if found:
            self._insert_meta.pop(rid, None)
            self.metrics.probes_cancelled += 1
        return found

    def _maybe_hedge(self, rep: _Replica, t: float):
        """Hedged-dispatch hook, invoked between fused chunks like
        preemption. No-op for monolithic pools; the sharded pool overrides
        it."""

    def spawn_replica(self, shard: Optional[int] = None):
        """Bring a replacement replica online (monolithic pools ignore
        ``shard`` — there is one shared index)."""
        self.add_replica()

    def add_replica(self):
        """Elastic scale-up: a fresh replica over the shared index joins
        at the clock frontier (the MIN of the live clocks — ``run_until``
        always steps the min-clock replica, so that is the pool's "now")."""
        self.replicas.append(_Replica(self._next_rid, self.cfg, self.index,
                                      self._seed + self._next_rid))
        self.replicas[-1].clock = min(r.clock for r in self.replicas[:-1])
        self._next_rid += 1

    def set_slowdown(self, idx: int, factor: float):
        """Model straggling hardware: replica ``idx``'s extends take
        ``factor``× the model time from now on."""
        self.replicas[idx].slowdown = factor

    def drain_floor(self) -> int:
        """Minimum replica count a planned drain must leave serving."""
        return max(1, self.min_replicas)

    def drain_replica(self, shard: Optional[int] = None) -> bool:
        """Planned scale-down: checkpoint the least-loaded replica's
        in-flight work through ONE ``preempt``, re-queue it
        checkpoint-intact (not charged to the starvation cap) and retire
        the replica. Returns False rather than drain below
        :meth:`drain_floor`. ``shard`` is ignored for monolithic pools."""
        if len(self.replicas) <= self.drain_floor():
            return False
        donor = min(self.replicas, key=lambda r: (len(r.in_flight), r.rid))
        t = min(r.clock for r in self.replicas)
        self._drain_one(donor, t)
        return True

    def _drain_one(self, donor: "_Replica", t: float):
        """Retire ``donor``: preempt + checkpoint-intact re-queue of its
        in-flight work on its scheduler, then remove it from the pool."""
        sched = self._sched_for(donor)
        if donor.in_flight:
            pairs = donor.engine.preempt(list(donor.in_flight.keys()))
            for rid, ckpt in pairs:
                req = donor.in_flight.pop(rid)
                sched.requeue_preempted(req, ckpt, t)
                # planned drain, not a deadline rescue: keep the request
                # evictable for truly urgent work
                req.preemptions -= 1
        self.replicas.remove(donor)
        self.metrics.drains += 1

    # -------------------------------------------------------------- internals
    def _healthy(self, rep: _Replica) -> bool:
        med = np.median([r.ext_latency_ewma for r in self.replicas])
        rep.quarantined = rep.ext_latency_ewma > self.straggler_factor * med
        return not rep.quarantined

    def _admit(self, rep: _Replica, batch: List[VectorRequest]):
        """Seat a scheduler flush: fresh requests through one batched
        ``admit_batch``, checkpointed ones through one ``resume_batch``."""
        fresh = [r for r in batch if r.checkpoint is None]
        resumed = [r for r in batch if r.checkpoint is not None]
        if fresh:
            rep.engine.admit_batch([(r.rid, r.qvec, self._params_for(r, rep))
                                    for r in fresh])
        if resumed:
            rep.engine.resume_batch([(r.rid, r.checkpoint) for r in resumed])
            for req in resumed:
                req.checkpoint = None
            self.metrics.resumes += len(resumed)
        for req in batch:
            rep.in_flight[req.rid] = req

    def _maybe_rebalance(self, rep: _Replica, t: float):
        """Workload-adaptive rebalancing hook, invoked between fused
        chunks like preemption. No-op for monolithic pools (one shared
        queue); the sharded pool overrides it."""

    def _maybe_preempt(self, rep: _Replica, t: float):
        """Between fused chunks: full engine + urgent queued work => evict
        the scheduler's victims, checkpoint them, re-queue boosted, and
        seat the urgent probes straight into the freed slots."""
        if not self.cfg.preemption_enabled or rep.engine.num_free > 0:
            return
        sched = self._sched_for(rep)
        victims = sched.plan_preemption(t, list(rep.in_flight.values()))
        if not victims:
            return
        for rid, ckpt in rep.engine.preempt([v.rid for v in victims]):
            req = rep.in_flight.pop(rid)
            sched.requeue_preempted(req, ckpt, t)
        self.metrics.preemptions += len(victims)
        urgent = sched.take_urgent(rep.engine.num_free, t)
        if urgent:
            self._admit(rep, urgent)

    def _on_complete(self, req: VectorRequest, rep: _Replica):
        """Completion hook (request already stamped with results/times)."""
        if req.kind == "insert":
            # the finished background search IS the neighbour selection
            self._apply_insert(req.qvec, req.result_ids,
                               self._insert_meta.pop(req.rid, None),
                               t_now=req.t_completed)
        self.metrics.preempt_time += req.resume_wait
        self.metrics.completed.append(req)

    def _step_replica(self, rep: _Replica, t_end: float):
        t = rep.clock
        sched = self._sched_for(rep)
        sched.controller.maybe_update(t, self.feedback)
        self._maybe_scale(t)

        healthy = self._healthy(rep)
        self._maybe_hedge(rep, t)
        if healthy:
            self._maybe_rebalance(rep, t)
            self._maybe_preempt(rep, t)
        free = rep.engine.num_free
        if healthy and \
                sched.should_flush(t, free, rep.engine.num_active):
            batch = sched.select(free, t)
            if batch:
                self._admit(rep, batch)

        if rep.engine.num_active == 0:
            # idle: jump to the next arrival (or a small quantum / t_end)
            if sched.queued() > 0:
                rep.clock = t + sched.controller.tau_pre
            elif self._pending:
                rep.clock = max(t + 1e-9, min(self._pending[0][0], t_end))
            else:
                rep.clock = t_end
            return

        # ONE fused chunk: K extend steps, one completion-mask sync
        k = rep.engine.extend_chunk
        completions, tasks_k = rep.engine.step_multi(k)
        dt = roofline_model.extend_time(self.cfg) * rep.slowdown
        rep.clock = t + k * dt
        rep.ext_latency_ewma = 0.9 * rep.ext_latency_ewma + 0.1 * dt
        sched.observe_extend_latency(dt)
        self.metrics.extend_steps += k
        self.metrics.tasks_emitted += int(tasks_k.sum())
        self.metrics.tasks_capacity += k * self.cfg.task_batch

        for rid, ids, dists, extends, substep in completions:
            req = rep.in_flight.pop(rid)
            # attribute completion to its exact sub-step, not the chunk end
            req.t_completed = t + (substep + 1) * dt
            req.extends_used = extends
            req.result_ids = ids
            req.result_dists = dists
            self._on_complete(req, rep)

        if self.cfg.rescue_enabled:
            # refresh the death-rescue snapshots: one non-destructive
            # gather + sync per chunk; a kill can only land between chunks
            rep.snapshots = dict(rep.engine.snapshot(
                sorted(rep.in_flight))) if rep.in_flight else {}

    def _maybe_scale(self, t_now: float):
        if not self.elastic:
            return
        depth = self.scheduler.queued()
        cap = sum(r.engine.cfg.max_requests for r in self.replicas)
        if depth > 2 * cap and len(self.replicas) < self.max_replicas:
            self.add_replica()
            self.peak_replicas = max(self.peak_replicas, len(self.replicas))
        elif depth == 0 and len(self.replicas) > self.min_replicas:
            idle = [i for i, r in enumerate(self.replicas)
                    if r.engine.num_active == 0]
            if idle:
                self.replicas.pop(idle[-1])


class ShardedVectorPool(VectorPool):
    """Scatter–gather router over S balanced-k-means shards.

    Each shard is a self-contained ``OnlineIndex`` (padded to a common
    frozen-segment shape) on ``device``, served by its own replicas and
    scheduler. ``submit`` fans a logical request out into per-shard
    children (all shards, or the ``nprobe_shards`` nearest centroids); the
    parent completes when every child has merged. Inserts route to the
    owning (nearest-centroid) shard only and broadcast to that shard's
    replicas alone.

    Megabatched dispatch (``cfg.megabatch_enabled``, the default): every
    replica is a lane of one ``GroupEngine``; the clock-frontier cohort
    steps through one grouped chunk, whose distance stage is one
    ``distance_tasks_group`` launch over all lanes a step. With the knob off
    the pool runs the legacy serial per-replica path.

    Workload-adaptive rebalancing (``cfg.rebalance_enabled``), between
    fused chunks (``_maybe_rebalance``):

      · **replica reassignment** — when one shard's per-replica load
        clears ``rebalance_hot_factor``× the mean AND a donor sits below
        ``rebalance_cold_factor``×, one cold replica is re-homed onto the
        hot shard; the donor's children re-queue checkpoint-intact. With
        the knob on, all replicas of a shard share ONE engine seed, so a
        child's results are a pure function of (rid, qvec, shard).
      · **cache-entry migration** — a shard whose live cache occupancy
        crosses ``rebalance_migrate_watermark`` of its budget sheds its
        oldest entries to the least-occupied shard
        (``ShardedIndex.migrate_entries``), keeping gids and timestamps.

    Both are paced by ``rebalance_cooldown_s``; with the knob off every
    path is the static pool's.
    """

    MAX_SHARDS = 64  # child rid encoding: (parent_rid << 6) | shard
    # hedge twins carry the base child rid with this bit set: a distinct
    # rid keeps the twin out of the base child's in_flight/slot keys (and
    # gives it a distinct engine PRNG entry key)
    HEDGE_BIT = 1 << 48

    def __init__(self, cfg, db, *, replicas_per_shard: Optional[int] = None,
                 policy: str = "trinity", device="cuda",
                 straggler_factor: float = 2.5, classes=None, seed: int = 0,
                 shard_index: Optional[ShardedIndex] = None,
                 exact_threshold: int = 20000):
        rps = replicas_per_shard or cfg.replicas_per_shard
        # a prebuilt partition (``shard_index``) is only safe to share
        # across pools for search-only workloads (inserts mutate shards)
        self._prebuilt_index = shard_index
        self._exact_threshold = exact_threshold
        super().__init__(cfg, db, None, replicas=rps, policy=policy,
                         device=device, straggler_factor=straggler_factor,
                         elastic=False, classes=classes, seed=seed)

    # -------------------------------------------------------- construction
    def _build(self, db, graph, replicas_per_shard: int, policy: str,
               classes):
        cfg = self.cfg
        S = cfg.num_shards
        assert 1 <= S <= self.MAX_SHARDS, S
        if self._prebuilt_index is not None:
            assert self._prebuilt_index.num_shards == S
            assert self._prebuilt_index.device.type == self.device.type
            self.shards = self._prebuilt_index
        else:
            self.shards = ShardedIndex(
                self.db, num_shards=S, degree=cfg.graph_degree,
                metric=cfg.metric,
                cache_capacity=(cfg.cache_capacity
                                if cfg.semantic_cache_enabled else 0),
                kmeans_iters=cfg.shard_kmeans_iters, seed=self._seed,
                ttl=cfg.cache_ttl_s, max_entries=cfg.cache_max_entries,
                max_rows=cfg.replica_max_rows,
                route_centroids=cfg.shard_route_centroids,
                exact_threshold=self._exact_threshold, device=self.device)
        for sh in self.shards.shards:
            self._check_capacity(sh)
        self.index = None  # no monolithic index exists
        self.schedulers = [TwoQueueScheduler(cfg, policy=policy,
                                             classes=classes)
                           for _ in range(S)]
        self.scheduler = self.schedulers[0]  # primary (class registry)
        for sch in self.schedulers[1:]:
            # ONE shared registry: a class registered on the primary is
            # visible to every shard's resolve()
            sch.classes = self.scheduler.classes
        self._mega = bool(cfg.megabatch_enabled)
        self._device_merge = self._mega and bool(cfg.device_merge_enabled)
        self._double_buffer = self._mega and bool(cfg.double_buffer_enabled)
        self._group = GroupEngine(cfg, self.device) if self._mega else None
        # device-side shard-local→global id translation table (S, T),
        # rebuilt lazily before a fold whenever a shard's gid map mutated
        self._trans = None
        self._trans_cap = 0
        self._trans_dirty: Set[int] = set(range(S))
        self._buf_free: List[int] = []  # clean merge-buffer rows
        self._buf_dirty: List[int] = []  # rows parked by failed/cancelled fans
        if self._device_merge:
            P = max(1, int(cfg.merge_buffer_rows))
            self._buf_ids = torch.full((P, S, cfg.top_m), -1,
                                       dtype=torch.int32, device=self.device)
            self._buf_dists = torch.full((P, S, cfg.top_m), 1e30,
                                         dtype=torch.float32,
                                         device=self.device)
            self._buf_free = list(range(P - 1, -1, -1))
        self.replicas: List[_Replica] = []
        self._next_rid = 0
        # bytes written into lanes: by insert broadcasts (the touched rows)
        # and by whole-lane copies, one (reason, shard, bytes) a new lane
        self.broadcast_bytes = 0
        self.lane_copies: List[tuple] = []
        for s in range(S):
            for _ in range(replicas_per_shard):
                self._add_shard_replica(s)
        self._fanout: Dict[int, _Fanout] = {}  # parent rid → fan-out state
        self._insert_shard: Dict[int, int] = {}  # insert rid → owning shard
        # workload-adaptive rebalancing state
        self._shard_load = [ShardLoad() for _ in range(S)]
        self._last_move = -math.inf  # last replica reassignment
        self._last_migrate = -math.inf  # last cache-entry migration
        # hedged dispatch: base child rid → outstanding twin rid
        self._hedged: Dict[int, int] = {}
        # cache-entry backup (cfg.cache_backup_enabled): gid → (vec, born),
        # host-side peer copies a whole-shard loss re-homes from
        self._cache_backup: Dict[int, tuple] = {}

    def _add_shard_replica(self, s: int, reason: str = "build") -> _Replica:
        # with rebalancing ON, every replica of a shard shares one engine
        # seed: a child's results are a pure function of (rid, qvec,
        # shard), so reassignment and kill re-homing are result-neutral.
        # With the knob OFF, the static pool's seeds
        eng_seed = self._seed + (s if self.cfg.rebalance_enabled
                                 else self._next_rid)
        eng = None
        if self._mega:
            eng = self._group.add_member(self.shards.shards[s], eng_seed)
            # a fresh lane is a whole copy of the shard's index
            self.lane_copies.append((reason, s,
                                     self._group.last_write_bytes))
        rep = _Replica(self._next_rid, self.cfg, self.shards.shards[s],
                       eng_seed, engine=eng)
        rep.shard = s
        # join at the clock frontier (min), not the busiest replica's
        # horizon
        rep.clock = min((r.clock for r in self.replicas), default=0.0)
        self._next_rid += 1
        self.replicas.append(rep)
        self.peak_replicas = max(getattr(self, "peak_replicas", 0),
                                 len(self.replicas))
        return rep

    def shard_replicas(self, s: int) -> List[_Replica]:
        """The replicas currently serving shard ``s`` (≥ 1 always)."""
        return [r for r in self.replicas if r.shard == s]

    # ------------------------------------------------------ routing hooks
    def _sched_for(self, rep: _Replica):
        return self.schedulers[rep.shard]

    def _index_for(self, rep: _Replica) -> OnlineIndex:
        return self.shards.shards[rep.shard]

    @staticmethod
    def _child_rid(parent_rid: int, s: int) -> int:
        return (parent_rid << 6) | s

    def _dispatch(self, parent: VectorRequest):
        """Split a released logical request into per-shard children.

        Target shards: the owning shard for inserts, every cache-holding
        shard for cache-segment classes, and the ``nprobe_shards`` nearest
        centroids (0 = all) for corpus classes. Host work only (routing
        runs on CPU tensors): it may run while a grouped chunk is in
        flight."""
        if parent.parent_rid is not None:
            # a death-retried CHILD released from the backoff heap: it is
            # already shard-routed — straight back onto its shard's
            # scheduler, never re-split
            self.schedulers[parent.shard].submit(parent)
            return
        rc = self.scheduler.resolve(parent)
        if parent.kind == "insert":
            targets = [self._insert_shard.pop(parent.rid)]
        elif rc.segment == "cache":
            targets = self.shards.cache_shards()
            if not targets:  # nothing cached anywhere: immediate miss
                parent.t_completed = parent.t_arrival
                self.metrics.completed.append(parent)
                return
        else:
            nprobe = self.cfg.nprobe_shards or self.shards.num_shards
            targets = [int(s) for s in self.shards.route(parent.qvec,
                                                         nprobe)[0]]
        self._fanout[parent.rid] = _Fanout(parent, set(targets))
        w = self.cfg.rebalance_window_s
        for s in targets:
            if parent.kind != "insert":  # inserts observed at submit
                self._shard_load[s].observe(parent.t_arrival, w, probes=1)
            self.schedulers[s].submit(VectorRequest(
                self._child_rid(parent.rid, s), parent.kind, parent.qvec,
                parent.t_arrival, parent.deadline,
                est_extends=parent.est_extends, parent_rid=parent.rid,
                shard=s))
        self.metrics.sub_searches += len(targets)

    # ------------------------------------------------------------ inserts
    def _broadcast_shard(self, s: int):
        """Hand shard ``s``'s index to its replicas' engines: a pointer
        swap on the legacy path, a copy of the rows the insert wrote into
        each replica's lane on the megabatched one."""
        shard = self.shards.shards[s]
        rows = shard.drain_touched()
        reps = self.shard_replicas(s)
        for rep in reps:
            nbytes = rep.engine.set_index(shard.db, shard.graph, rows=rows)
            self.broadcast_bytes += nbytes or 0
        self.metrics.broadcasts += len(reps)

    def _apply_shard_insert(self, s: int, vec, neighbor_local_ids, meta,
                            t_now: float):
        gid, evicted = self.shards.insert_local(s, vec, neighbor_local_ids,
                                                t_now=t_now)
        for gone in evicted:
            self.cache_meta.pop(gone, None)
            self._cache_backup.pop(gone, None)
            self.metrics.cache_evictions += 1
        if meta is not None:
            self.cache_meta[gid] = meta
        if self.cfg.cache_backup_enabled:
            # host-side peer copy: whole-shard loss re-homes from here
            self._cache_backup[gid] = (np.array(vec, np.float32, copy=True),
                                       float(t_now))
        self.metrics.inserts += 1
        self._trans_dirty.add(s)  # gid map mutated: device trans row stale
        self._broadcast_shard(s)
        return gid

    def _ensure_cache_replication(self, s: int):
        """Cache-holding shards keep ≥ ``cfg.cache_replication`` replicas:
        a single kill must never leave the answer cache unservable."""
        want = max(self.cfg.cache_replication, 1)
        while len(self.shard_replicas(s)) < want:
            self._add_shard_replica(s, "replicate")

    def submit_insert(self, vec, meta=None, t_now: float = 0.0):
        """Insert ``vec`` into the owning (nearest-centroid) shard's cache
        segment. Empty owning segment => synchronous placement (returns
        the new global cache id); otherwise the insert rides that shard's
        scheduler as a background-class request and returns None. Either
        way the broadcast touches ONLY the owning shard's replicas."""
        vec = np.asarray(vec, np.float32)
        s = self.shards.owning_shard(vec)
        self._shard_load[s].observe(t_now, self.cfg.rebalance_window_s,
                                    inserts=1)
        self._ensure_cache_replication(s)
        if self.shards.shards[s].cache_size == 0:
            # empty owning-shard segment: nothing to search — place now
            return self._apply_shard_insert(s, vec, None, meta, t_now)
        rid = self._insert_rid
        self._insert_rid += 1
        self._insert_meta[rid] = meta
        self._insert_shard[rid] = s
        self.submit(VectorRequest(rid, "insert", vec, t_now, None))
        return None

    # ------------------------------------------------------- completions
    def _resolve_twin(self, req: VectorRequest, s: int):
        """Hedge bookkeeping of a child that won its shard: chase down the
        other copy of its pair, if one is outstanding."""
        base_rid = (req.rid & ~self.HEDGE_BIT) if req.hedge else req.rid
        twin_rid = self._hedged.pop(base_rid, None)
        if twin_rid is not None:
            if req.hedge:
                self.metrics.hedges_won += 1
            loser = base_rid if req.hedge else twin_rid
            if self._cancel_child(loser, s):
                self.metrics.hedges_wasted += 1
            # else: the loser completed in this same fused chunk — its
            # completion hits the drop branch of _on_complete
        waits = self.metrics.shard_waits.setdefault(s, [])
        waits.append(req.wait)
        del waits[:-256]  # bounded window: recent waits only

    def _on_complete(self, req: VectorRequest, rep: _Replica):
        """A child finished on its shard: translate local→global ids,
        fold into the parent's fan-out state, merge when all shards are
        in. With hedging on, the FIRST copy of a pair to land wins the
        shard; each shard folds into the parent exactly once."""
        self.metrics.preempt_time += req.resume_wait
        s = req.shard
        fan = self._fanout.get(req.parent_rid)
        if fan is None or s not in fan.pending:
            # the twin already resolved this shard (hedged dispatch only)
            assert self.cfg.hedge_enabled or req.hedge, \
                f"orphan child completion rid={req.rid}"
            self.metrics.hedges_wasted += 1
            return
        self._resolve_twin(req, s)
        parent = fan.parent
        if req.kind == "insert":
            # single child; its shard-local result IS the neighbour list
            self._apply_shard_insert(s, parent.qvec, req.result_ids,
                                     self._insert_meta.pop(parent.rid, None),
                                     t_now=req.t_completed)
        else:
            fan.ids.append(np.asarray(
                self.shards.to_global(s, req.result_ids), np.int64))
            fan.dists.append(np.asarray(req.result_dists, np.float32))
        self._fold_bookkeeping(fan, req, s)
        if fan.pending:
            return
        self._fanout.pop(req.parent_rid)
        self._finalize(fan)

    @staticmethod
    def _fold_bookkeeping(fan: _Fanout, req: VectorRequest, s: int):
        fan.extends += req.extends_used
        fan.t_done = max(fan.t_done, req.t_completed)
        if req.t_admitted is not None:
            fan.t_admitted = (req.t_admitted if fan.t_admitted is None
                              else min(fan.t_admitted, req.t_admitted))
        fan.pending.discard(s)

    def _fail_request(self, req: VectorRequest, t: float):
        """Child retry-cap exhaustion. If the child's hedge twin is still
        outstanding the shard stays pending — the survivor carries it.
        Otherwise the whole parent completes FAILED exactly once."""
        if req.parent_rid is None:
            super()._fail_request(req, t)
            return
        fan = self._fanout.get(req.parent_rid)
        if fan is None or req.shard not in fan.pending:
            return  # shard already resolved by the twin: drop quietly
        base_rid = (req.rid & ~self.HEDGE_BIT) if req.hedge else req.rid
        if self._hedged.pop(base_rid, None) is not None:
            return  # the other copy of the pair becomes the sole owner
        parent = fan.parent
        parent.failed = True
        fan.t_done = max(fan.t_done, t)
        fan.pending.discard(req.shard)
        if not fan.pending:
            self._fanout.pop(req.parent_rid)
            self._finalize(fan)

    def _complete_parent(self, fan: _Fanout):
        parent = fan.parent
        parent.t_completed = fan.t_done
        parent.extends_used = fan.extends
        parent.t_admitted = fan.t_admitted  # earliest child seating (wait)
        self.metrics.completed.append(parent)

    def _finalize(self, fan: _Fanout):
        """The host merge of a complete fan (and a failed parent's empty
        completion)."""
        if fan.buf_row is not None:
            # a device-merging fan diverted to the host finalize path
            # (failed parent): its buffer row holds partial folds — park
            # it dirty; the next grouped finalize clears it
            self._buf_dirty.append(fan.buf_row)
            fan.buf_row = None
        parent = fan.parent
        if parent.failed:
            parent.result_ids = None
            parent.result_dists = None
            if parent.kind == "insert":
                self._insert_meta.pop(parent.rid, None)
            self._complete_parent(fan)
            return
        if fan.ids:
            k = max(len(a) for a in fan.ids)
            S_t = len(fan.ids)
            ids = np.full((S_t, k), -1, np.int64)
            dists = np.full((S_t, k), np.inf, np.float32)
            for i, (a, d) in enumerate(zip(fan.ids, fan.dists)):
                ids[i, :len(a)] = a
                dists[i, :len(d)] = d
            m_ids, m_d = merge_partial_topk(ids.astype(np.int32), dists, k=k)
            parent.result_ids = m_ids.numpy()
            parent.result_dists = m_d.numpy()
            self.metrics.merges += 1
        self._complete_parent(fan)

    # ----------------------------------------------------- hedged dispatch
    def _cancel_child(self, rid: int, s: int) -> bool:
        """Evict the losing copy of a hedged pair from wherever it lives:
        shard ``s``'s scheduler, the backoff heap, or an engine slot. False
        when its completion already materialised in the same chunk."""
        if self.schedulers[s].cancel(rid) is not None:
            return True
        if self._remove_pending(rid) is not None:
            return True
        for rep in self.shard_replicas(s):
            if rid in rep.in_flight \
                    and rid in rep.engine.slot_request.values():
                rep.engine.preempt([rid])  # discard the checkpoint
                rep.in_flight.pop(rid)
                rep.snapshots.pop(rid, None)
                return True
        return False

    def _maybe_hedge(self, rep: _Replica, t: float):
        """Hedged duplicate dispatch (``cfg.hedge_enabled``): a child stuck
        in a slot well past its expected service time — or seated on a
        quarantined straggler — gets a TWIN on the same shard's scheduler
        for another replica to pick up. At most one twin per child, never
        for inserts or background classes."""
        cfg = self.cfg
        if not cfg.hedge_enabled:
            return
        for prid, fan in list(self._fanout.items()):
            if fan.parent.kind == "insert" \
                    or fan.parent.rclass is not None \
                    and fan.parent.rclass.lane == "background":
                continue
            for s in sorted(fan.pending):
                crid = self._child_rid(prid, s)
                if crid in self._hedged:
                    continue  # one twin max per child
                host = child = None
                for r in self.shard_replicas(s):
                    c = r.in_flight.get(crid)
                    if c is not None and c.t_admitted is not None:
                        host, child = r, c
                        break
                if child is None or child.hedge:
                    continue  # queued/backoff (not stuck in a slot)
                peers = [r for r in self.shard_replicas(s)
                         if r is not host and not r.quarantined]
                if not peers:
                    continue  # a twin would land back on the straggler
                # baseline: the pool-wide MEDIAN per-replica extend latency
                med = float(np.median(
                    [r.ext_latency_ewma for r in self.replicas]))
                expect = max(child.est_extends, 1.0) * max(med, 1e-9)
                if not (host.quarantined
                        or t - child.t_admitted > cfg.hedge_factor * expect):
                    continue
                twin = VectorRequest(
                    crid | self.HEDGE_BIT, child.rclass or child.kind,
                    child.qvec, child.t_arrival, child.deadline,
                    est_extends=child.est_extends, parent_rid=prid, shard=s)
                twin.hedge = True
                self._hedged[crid] = twin.rid
                self.schedulers[s].submit(twin)
                self.metrics.hedges += 1

    # ------------------------------------------------ megabatched stepping
    def run_until(self, t_end: float):
        """Megabatched run loop: the whole clock-frontier COHORT — every
        replica at the min clock — advances through one grouped chunk.
        Knob off: the inherited serial per-replica loop."""
        if not self._mega:
            return super().run_until(t_end)
        while True:
            t_min = min(r.clock for r in self.replicas)
            if t_min >= t_end:
                break
            self._release_pending(t_min)
            cohort = [r for r in self.replicas if r.clock == t_min]
            self._step_group(cohort, t_end)
        self._maybe_scale(t_end)

    def _step_group(self, cohort: List[_Replica], t_end: float):
        """Advance every frontier replica one fused chunk. Per-member host
        scheduling mirrors ``_step_replica`` in the same replica order;
        then ONE grouped admission, ONE restore, ONE K-step grouped extend
        (a lane launch of the distance kernel a step) and one bundled
        completion sync. The chunk's masks come back by a non-blocking
        copy behind an event: with double buffering the next arrivals are
        released before the host waits on it."""
        t = cohort[0].clock
        cfg = self.cfg
        # pass 1: per-member bookkeeping (controller, health, hedging,
        # preemption) — preemption's urgent re-admit dispatches at once
        healthy = {}
        for rep in cohort:
            self._sched_for(rep).controller.maybe_update(t, self.feedback)
            healthy[id(rep)] = self._healthy(rep)
            self._maybe_hedge(rep, t)
            if healthy[id(rep)]:
                self._maybe_rebalance(rep, t)
                self._maybe_preempt(rep, t)
        cohort = [r for r in cohort if r in self.replicas]
        # pass 2: scheduler flushes, STAGED (host half only) so every
        # member's admissions fold into one grouped scatter
        admit_stages, resume_stages = [], []
        for rep in cohort:
            sched = self._sched_for(rep)
            free = rep.engine.num_free
            if not healthy[id(rep)] or \
                    not sched.should_flush(t, free, rep.engine.num_active):
                continue
            batch = sched.select(free, t)
            if not batch:
                continue
            fresh = [r for r in batch if r.checkpoint is None]
            resumed = [r for r in batch if r.checkpoint is not None]
            if fresh:
                admit_stages.append(rep.engine.stage_admit_batch(
                    [(r.rid, r.qvec, self._params_for(r, rep))
                     for r in fresh]))
            if resumed:
                resume_stages.append(rep.engine.stage_resume_batch(
                    [(r.rid, r.checkpoint) for r in resumed]))
                for req in resumed:
                    req.checkpoint = None
                self.metrics.resumes += len(resumed)
            for req in batch:
                rep.in_flight[req.rid] = req
        self._group.dispatch_admits(admit_stages)
        self._group.dispatch_restores(resume_stages)
        # idle members jump their clocks exactly like the serial path
        lanes = []
        for rep in cohort:
            if rep.engine.num_active > 0:
                lanes.append(rep)
                continue
            sched = self._sched_for(rep)
            if sched.queued() > 0:
                rep.clock = t + sched.controller.tau_pre
            elif self._pending:
                rep.clock = max(t + 1e-9, min(self._pending[0][0], t_end))
            else:
                rep.clock = t_end
        if not lanes:
            return
        # ONE grouped chunk: K extend steps over the whole cohort
        k = lanes[0].engine.extend_chunk
        pending = self._group.step_lanes_async(
            [rep.engine.lane for rep in lanes], k)
        dt_base = roofline_model.extend_time_group(cfg, len(lanes),
                                                   self._double_buffer)
        dt_of = {}
        for rep in lanes:
            dt = dt_base * rep.slowdown
            dt_of[id(rep)] = dt
            rep.clock = t + k * dt
            rep.ext_latency_ewma = 0.9 * rep.ext_latency_ewma + 0.1 * dt
            self._sched_for(rep).observe_extend_latency(dt)
            self.metrics.extend_steps += k
            self.metrics.tasks_capacity += k * cfg.task_batch
        if self._double_buffer:
            # the chunk is in flight on the card: release the next round's
            # arrivals (host work only) BEFORE waiting on its masks
            self._release_pending(min(r.clock for r in self.replicas))
        completed_k, tasks_k = pending.wait()
        # per-member engine/pool counters (mirrors step_multi exactly)
        records = []
        for rep in lanes:
            eng = rep.engine
            ck = completed_k[:, eng.lane]
            tk = tasks_k[:, eng.lane]
            self.metrics.tasks_emitted += int(tk.sum())
            eng.total_tasks += int(tk.sum())
            eng.total_capacity += k * cfg.task_batch
            eng.steps += k
            live = eng.num_active
            per_step = ck.sum(axis=1)
            for i in range(k):
                eng.total_live_slots += live
                live -= int(per_step[i])
            if not ck.any():
                continue
            for i in range(k):
                for slot in np.nonzero(ck[i])[0]:
                    slot = int(slot)
                    rid = eng.slot_request.pop(slot)
                    kk = eng.slot_topk.pop(slot, cfg.top_k)
                    eng.free_slots.append(slot)
                    records.append([rep, rid, kk, i, slot, "host"])
        if records and self._device_merge:
            # a completing insert REWRITES its shard's gid map, and the
            # legacy serial loop translates every later sibling against
            # the post-insert map — split the chunk at insert boundaries
            seg = []
            for rec in records:
                seg.append(rec)
                if rec[0].in_flight[rec[1]].kind == "insert":
                    self._scan_chunk_completions(seg, t, dt_of)
                    seg = []
            records = seg
        if records:
            self._scan_chunk_completions(records, t, dt_of)
        if cfg.rescue_enabled:
            self._refresh_snapshots(lanes)

    def _pad1(self, xs):
        pad = _pow2_pad(len(xs)) - len(xs)
        return torch.as_tensor(np.asarray(xs + xs[:1] * pad, np.int64),
                               device=self.device)

    def _scan_chunk_completions(self, records, t: float, dt_of):
        """Completion processing for one grouped chunk, in three phases.

        Phase A (host) routes each completion: device fold (search child
        of a live fan, device merge on, buffer row available), host
        collect (inserts, buffer overflow, device merge off), or drop
        (hedge-loser duplicates); and predicts which merge rows finalize
        this chunk. Phase B runs ONE fold scatter, ONE finalize merge, the
        host-route row gather and the extends gather, then syncs ONCE.
        Phase C runs the legacy bookkeeping per completion in serial
        order; device-merged parents take their results from the finalize
        output."""
        cfg = self.cfg
        group = self._group
        fold_entries, fold_rows, fold_cols = [], [], []
        host_pos = {}  # record index -> host gather row
        claimed: Set[tuple] = set()
        accepted: Dict[int, Set[int]] = {}
        for ridx, rec in enumerate(records):
            rep, rid, kk, _i, slot, _route = rec
            req = rep.in_flight[rid]
            if not self._device_merge or req.kind == "insert":
                host_pos[ridx] = len(host_pos)
                continue
            fan = self._fanout.get(req.parent_rid) \
                if req.parent_rid is not None else None
            s = req.shard
            if fan is None or s not in fan.pending \
                    or (req.parent_rid, s) in claimed:
                rec[5] = "drop"
                continue
            claimed.add((req.parent_rid, s))
            if fan.buf_row is None and not fan.host:
                if self._buf_free:
                    fan.buf_row = self._buf_free.pop()
                else:
                    fan.host = True  # buffer exhausted: sticky host path
            if fan.buf_row is None:
                host_pos[ridx] = len(host_pos)
                continue
            rec[5] = "dev"
            if fan.kk is None:
                fan.kk = kk
            fold_entries.append((rep.engine.lane, slot))
            fold_rows.append(fan.buf_row)
            fold_cols.append(s)
            accepted.setdefault(req.parent_rid, set()).add(s)
        finalize = [self._fanout[prid] for prid, accs in accepted.items()
                    if not (self._fanout[prid].pending - accs)
                    and not self._fanout[prid].parent.failed]

        if fold_entries:
            self._refresh_trans()
            g_idx, slots_t = group._pad_pairs(fold_entries)
            fold_partial_topk(self._buf_ids, self._buf_dists,
                              group.state.top_ids, group.state.top_dists,
                              self._trans, g_idx, slots_t,
                              self._pad1(fold_rows), self._pad1(fold_cols))
        dev = []
        if host_pos:
            g_idx, slots_t = group._pad_pairs(
                [(records[j][0].engine.lane, records[j][4])
                 for j in host_pos])
            dev.extend(collect_slots_group(group.state, g_idx, slots_t))
        if len(host_pos) < len(records):
            g_idx, slots_t = group._pad_pairs(
                [(rec[0].engine.lane, rec[4]) for rec in records])
            dev.append(collect_extends_group(group.state, g_idx, slots_t))
        rows_f = [fan.buf_row for fan in finalize] + self._buf_dirty
        if rows_f:
            _, _, fin_ids, fin_d = finalize_partial_topk(
                self._buf_ids, self._buf_dists, self._pad1(rows_f),
                k=cfg.top_m)
            dev.extend((fin_ids, fin_d))
            self._buf_dirty = []
        # the ONE bundled host-device sync for this chunk's results
        host = _to_host(dev, self.device)
        host_rows = host[:3] if host_pos else None
        host = host[3:] if host_pos else host
        ext_all = host[0] if len(host_pos) < len(records) else None
        fin_out = host[-2:] if rows_f else None
        fin_index = {fan.buf_row: i for i, fan in enumerate(finalize)}
        for ridx, rec in enumerate(records):
            rep, rid, kk, i, slot, route = rec
            req = rep.in_flight.pop(rid)
            req.t_completed = t + (i + 1) * dt_of[id(rep)]
            if route == "host":
                pos = host_pos[ridx]
                ids, dists, ext = host_rows
                req.extends_used = int(ext[pos])
                req.result_ids = ids[pos, :kk].copy()
                req.result_dists = dists[pos, :kk].copy()
                self._on_complete(req, rep)
                continue
            req.extends_used = int(ext_all[ridx])
            if route == "drop":
                self._on_complete(req, rep)  # legacy hedge-drop branch
                continue
            fan = self._fold_child_device(req, kk)
            if fan is None or fan.pending:
                continue
            self._fanout.pop(req.parent_rid)
            parent = fan.parent
            if parent.failed or fan.buf_row is None:
                self._finalize(fan)
                continue
            pos = fin_index[fan.buf_row]
            parent.result_ids = fin_out[0][pos, :fan.kk].copy()
            parent.result_dists = fin_out[1][pos, :fan.kk].copy()
            self.metrics.merges += 1
            self._complete_parent(fan)
            self._buf_free.append(fan.buf_row)
            fan.buf_row = None

    def _fold_child_device(self, req: VectorRequest, kk: int):
        """Host half of a device-folded child completion: the hedge
        dedup/cancel and fan-out bookkeeping of ``_on_complete``, minus the
        result fold (already scattered into the fan's buffer row on the
        device). Returns the fan (None on the defensive orphan branch)."""
        self.metrics.preempt_time += req.resume_wait
        s = req.shard
        fan = self._fanout.get(req.parent_rid)
        if fan is None or s not in fan.pending:  # pragma: no cover
            self.metrics.hedges_wasted += 1
            return None
        self._resolve_twin(req, s)
        if fan.kk is None:
            fan.kk = kk
        self._fold_bookkeeping(fan, req, s)
        return fan

    def _refresh_trans(self):
        """(Re)build the device (S, T) shard-local→global id table for the
        fold. Row width is power-of-two padded with ≥ 1 trailing −1
        sentinel column; rebuilt only when some shard's gid map mutated."""
        if self._trans is not None and not self._trans_dirty:
            return
        S = self.shards.num_shards
        need = max(max((len(self.shards.global_map(s)) for s in range(S)),
                       default=1), 1)
        cap = max(self._trans_cap, 1)
        while cap < need + 1:
            cap *= 2
        self._trans_cap = cap
        tbl = np.full((S, cap), -1, np.int32)
        for s in range(S):
            g = np.asarray(self.shards.global_map(s))
            tbl[s, :len(g)] = g.astype(np.int32)
        self._trans = torch.as_tensor(tbl, device=self.device)
        self._trans_dirty.clear()

    def _refresh_snapshots(self, lanes: List[_Replica]):
        """Grouped death-rescue snapshot refresh: ONE full-row gather +
        sync covers every cohort member's in-flight slots."""
        entries, keys = [], []
        for rep in lanes:
            rep.snapshots = {}
            if not rep.in_flight:
                continue
            slot_of = {r: s for s, r in rep.engine.slot_request.items()}
            for rid in sorted(rep.in_flight):
                entries.append((rep.engine.lane, slot_of[rid]))
                keys.append((rep, rid, slot_of[rid]))
        if not entries:
            return
        qv, ids, dists, exp, vis, ext, bud = \
            self._group.gather_checkpoint_rows(entries)
        for j, (rep, rid, slot) in enumerate(keys):
            rep.snapshots[rid] = SlotCheckpoint(
                query_vec=qv[j].copy(), top_ids=ids[j].copy(),
                top_dists=dists[j].copy(), expanded=exp[j].copy(),
                visited=vis[j].copy(), extends=int(ext[j]),
                budget=int(bud[j]),
                top_k=rep.engine.slot_topk.get(slot))

    # --------------------------------------------------------- membership
    def _born_at(self, row: int) -> Optional[float]:
        return self.shards.born_at(row)

    def _healthy(self, rep: _Replica) -> bool:
        """A shard's sole unquarantined replica keeps serving (slowly):
        quarantining it would starve that shard's private scheduler."""
        healthy = super()._healthy(rep)
        if not healthy and not any(
                r is not rep and not r.quarantined
                for r in self.shard_replicas(rep.shard)):
            rep.quarantined = False
            return True
        return healthy

    @property
    def cache_size(self) -> int:
        return self.shards.cache_size

    def kill_replica(self, idx: int):
        """Fail-stop one replica. In-flight children re-queue on the
        shard's scheduler; a shard left with NO replica is immediately
        re-homed on a fresh one."""
        victim = self.replicas[idx]
        s = victim.shard
        super().kill_replica(idx)
        if self._mega:
            self._group.free_lane(victim.engine.lane)
        if not self.shard_replicas(s):
            self._add_shard_replica(s, "rehome")
            self.metrics.shard_reassignments += 1

    def add_replica(self):
        raise NotImplementedError(
            "sharded pools add replicas per shard (spawn_replica)")

    def spawn_replica(self, shard: Optional[int] = None):
        assert shard is not None, "sharded pools spawn replicas per shard"
        self._add_shard_replica(shard, "spawn")

    def shard_floor(self, s: int) -> int:
        """Serving minimum for shard ``s``: ≥ 1 replica always, and
        ≥ ``cfg.cache_replication`` while the shard holds cache rows."""
        if self.shards.shards[s].cache_size > 0:
            return max(1, self.cfg.cache_replication)
        return 1

    def drain_replica(self, shard: Optional[int] = None) -> bool:
        """Planned per-shard scale-down: pick the coldest shard with
        replicas above its :meth:`shard_floor` (or the given ``shard``),
        re-queue the least-loaded replica's children checkpoint-intact,
        free its lane and retire it. Returns False when no shard can
        shrink."""
        t = min((r.clock for r in self.replicas), default=0.0)
        if shard is None:
            cands = [s for s in range(self.shards.num_shards)
                     if len(self.shard_replicas(s)) > self.shard_floor(s)]
            if not cands:
                return False
            shard = min(cands, key=lambda s: (self.shard_load_score(s, t), s))
        elif len(self.shard_replicas(shard)) <= self.shard_floor(shard):
            return False
        donor = min(self.shard_replicas(shard),
                    key=lambda r: (len(r.in_flight), r.rid))
        self._drain_one(donor, t)
        if self._mega:
            self._group.free_lane(donor.engine.lane)
        return True

    def cancel(self, rid: int) -> bool:
        """Cancel a logical request: tear down its whole fan-out — every
        pending child AND its hedge twin — wherever each copy lives."""
        req = self._remove_pending(rid)
        if req is not None:  # not yet split into children
            if req.kind == "insert":
                self._insert_shard.pop(rid, None)
                self._insert_meta.pop(rid, None)
            self.metrics.probes_cancelled += 1
            return True
        fan = self._fanout.pop(rid, None)
        if fan is None:
            return False
        if fan.buf_row is not None:  # cancelled mid-merge: row is dirty
            self._buf_dirty.append(fan.buf_row)
            fan.buf_row = None
        for s in sorted(fan.pending):
            crid = self._child_rid(rid, s)
            self._cancel_child(crid, s)
            twin_rid = self._hedged.pop(crid, None)
            if twin_rid is not None:
                self._cancel_child(twin_rid, s)
        if fan.parent.kind == "insert":
            self._insert_meta.pop(rid, None)
        self.metrics.probes_cancelled += 1
        return True

    def lose_shard(self, s: int):
        """Catastrophic whole-shard failure: every replica of shard ``s``
        dies at once and the shard's answer-cache segment is wiped. The
        shard is re-homed on a fresh replica at once (its frozen rows come
        back from the partition), but its cache entries are LOST (counted
        ``cache_lost``) unless ``cfg.cache_backup_enabled``: then every
        lost entry is re-homed from its host-side peer copy onto the
        least-occupied surviving shard (``cache_recovered``), keeping its
        gid, answer metadata and insert timestamp."""
        self.metrics.shard_losses += 1
        victims = self.shard_replicas(s)
        # loss time = the clock frontier (see kill_replica)
        t = min((r.clock for r in self.replicas), default=0.0)
        # snapshots AND queued checkpoints reference the wiped cache rows:
        # a resume would score against the wrong vectors, so every rescue
        # path restarts from scratch instead
        for rep in victims:
            rep.snapshots = {}
        for req in self.schedulers[s].queued_requests():
            if req.checkpoint is not None:
                req.checkpoint = None
                req.extends_done = 0
        lost = self.shards.drop_shard_cache(s)
        self._trans_dirty.add(s)
        # kill by identity: kill_replica re-homes a fresh replica when the
        # shard empties (a whole copy of the wiped index), and that
        # replacement must survive
        for rep in victims:
            self.kill_replica(self.replicas.index(rep))
        for gid in list(lost):
            if not self.cfg.cache_backup_enabled \
                    or gid not in self._cache_backup:
                self.cache_meta.pop(gid, None)
                self._cache_backup.pop(gid, None)
                self.metrics.cache_lost += 1
                lost.remove(gid)
        if not lost:
            return
        # re-home the backed-up entries onto the least-occupied OTHER
        # shard (a sole-shard pool re-homes in place)
        cands = [d for d in range(self.shards.num_shards) if d != s] or [s]
        dst = min(cands, key=lambda d: (self.shards.shards[d].cache_size, d))
        vecs = np.stack([self._cache_backup[g][0] for g in lost])
        born = [self._cache_backup[g][1] for g in lost]
        evicted = self.shards.restore_entries(dst, lost, vecs, born, t_now=t)
        self._trans_dirty.add(dst)
        for gone in evicted:
            self.cache_meta.pop(gone, None)
            self._cache_backup.pop(gone, None)
            self.metrics.cache_evictions += 1
        self.metrics.cache_recovered += len(lost)
        self._broadcast_shard(dst)
        self._ensure_cache_replication(dst)

    # ------------------------------------------------------ load signals
    def shard_load_score(self, s: int, t: float) -> float:
        """Per-replica demand pressure on shard ``s`` at time ``t``:
        (queued foreground + queued background + in-flight + decayed
        recent arrivals) / replica count."""
        sched = self.schedulers[s]
        reps = self.shard_replicas(s)
        inflight = sum(len(r.in_flight) for r in reps)
        demand = (sched.queued() + sched.queued_background() + inflight
                  + self._shard_load[s].decayed(
                      t, self.cfg.rebalance_window_s))
        return demand / max(len(reps), 1)

    def shard_load_summary(self, t: float) -> List[dict]:
        """One observability row per shard: replicas, queue depth,
        in-flight, decayed probe/insert QPS, live cache entries, recent
        child wait p95."""
        w = self.cfg.rebalance_window_s
        out = []
        for s in range(self.shards.num_shards):
            reps = self.shard_replicas(s)
            ld = self._shard_load[s]
            out.append({
                "shard": s,
                "replicas": len(reps),
                "queued": self.schedulers[s].queued(),
                "queued_background": self.schedulers[s].queued_background(),
                "in_flight": sum(len(r.in_flight) for r in reps),
                "probe_qps": ld.probe_qps(t, w),
                "insert_qps": ld.insert_qps(t, w),
                "cache_entries": self.shards.shards[s].cache_size,
                "p95_wait": self.metrics.shard_p95_wait(s),
                "load_score": self.shard_load_score(s, t),
            })
        return out

    # ------------------------------------------ workload-adaptive rebalance
    def _maybe_rebalance(self, rep: _Replica, t: float):
        """Between fused chunks: migrate cache entries off a
        capacity-pressed shard, then move one replica cold → hot when the
        load imbalance clears the hysteresis band. ``rep`` is the stepping
        replica, never the donor. Cooldown-paced; a no-op with the knob
        off or one shard."""
        cfg = self.cfg
        if not cfg.rebalance_enabled or self.shards.num_shards < 2:
            return
        if t - self._last_migrate >= cfg.rebalance_cooldown_s:
            if self._maybe_migrate(t):
                self._last_migrate = t
        if t - self._last_move < cfg.rebalance_cooldown_s:
            return
        S = self.shards.num_shards
        scores = [self.shard_load_score(s, t) for s in range(S)]
        mean = sum(scores) / S
        if mean <= 1e-12:
            return
        hot = min(range(S), key=lambda s: (-scores[s], s))
        if scores[hot] < cfg.rebalance_hot_factor * mean:
            return
        donors = []
        for s in range(S):
            if s == hot or scores[s] > cfg.rebalance_cold_factor * mean:
                continue
            reps = self.shard_replicas(s)
            movable = [r for r in reps if r is not rep]
            # the donor keeps a serving path: ≥ 1 replica always, and
            # ≥ cache_replication while it holds live cache entries
            keep = max(1, cfg.cache_replication
                       if self.shards.shards[s].cache_size > 0 else 1)
            if len(reps) - 1 < keep or not movable:
                continue
            donors.append((scores[s], s))
        if not donors:
            return
        _, cold = min(donors)
        self._move_replica(cold, hot, t, exclude=rep)
        self._last_move = t

    def _move_replica(self, src: int, dst: int, t: float,
                      exclude: Optional[_Replica] = None):
        """Re-home one replica of shard ``src`` onto shard ``dst``. The
        donor's in-flight children are checkpointed (one ``preempt``, on
        the megabatched path an ``evict_slots_group`` over its lane) and
        re-queued on shard ``src``'s scheduler checkpoint-intact; its lane
        is freed and the replacement takes a fresh lane, a whole copy of
        shard ``dst``'s index."""
        cands = [r for r in self.shard_replicas(src) if r is not exclude]
        donor = min(cands, key=lambda r: (len(r.in_flight), r.rid))
        sched = self.schedulers[src]
        if donor.in_flight:
            pairs = donor.engine.preempt(list(donor.in_flight.keys()))
            for rid, ckpt in pairs:
                req = donor.in_flight.pop(rid)
                sched.requeue_preempted(req, ckpt, t)
                # a planned move is load balancing, not a deadline rescue:
                # it does not burn the starvation cap (max_preemptions)
                req.preemptions -= 1
        self.replicas.remove(donor)
        if self._mega:
            self._group.free_lane(donor.engine.lane)
        new = self._add_shard_replica(dst, "move")
        new.clock = max(new.clock, donor.clock)
        self.metrics.rebalances += 1

    def _cache_entry_budget(self, s: int) -> float:
        """Live-entry budget of shard ``s``'s cache segment: the tighter
        of ``cache_max_entries`` and the row headroom under
        ``replica_max_rows`` (inf when both are off)."""
        budget = math.inf
        if self.cfg.cache_max_entries > 0:
            budget = float(self.cfg.cache_max_entries)
        if self.cfg.replica_max_rows > 0:
            budget = min(budget, float(self.cfg.replica_max_rows
                                       - self.shards.shards[s].base_n))
        return budget

    def _maybe_migrate(self, t: float) -> bool:
        """Shed the oldest cache entries of the most capacity-pressed
        shard to the least-occupied one BEFORE the entry/row cap forces a
        real eviction. Returns True when entries moved."""
        cfg = self.cfg
        S = self.shards.num_shards
        occ = []
        for s in range(S):
            b = self._cache_entry_budget(s)
            # b == 0 (frozen rows fill replica_max_rows): no cache entries
            # fit at all, so no pressure to shed
            occ.append(self.shards.shards[s].cache_size / b
                       if math.isfinite(b) and b > 0 else 0.0)
        donor = min(range(S), key=lambda s: (-occ[s], s))
        if occ[donor] < cfg.rebalance_migrate_watermark:
            return False
        batch = min(cfg.rebalance_migrate_batch,
                    self.shards.shards[donor].cache_size)
        if batch <= 0:
            return False
        recips = [s for s in range(S) if s != donor
                  and occ[s] < occ[donor]
                  and (self.shards.shards[s].cache_size + batch
                       <= cfg.rebalance_migrate_watermark
                       * self._cache_entry_budget(s))]
        if not recips:
            return False
        dst = min(recips, key=lambda s: (occ[s], s))
        moved, evicted = self.shards.migrate_entries(donor, dst, batch,
                                                     t_now=t)
        self._trans_dirty.update((donor, dst))
        for gone in evicted:
            self.cache_meta.pop(gone, None)
            self._cache_backup.pop(gone, None)
            self.metrics.cache_evictions += 1
        # the donor's rows changed even when nothing moved (extraction
        # TTL-tombstones expired rows): its lanes must take them
        self._broadcast_shard(donor)
        if not moved:
            return False
        self.metrics.migrated_entries += len(moved)
        self._broadcast_shard(dst)
        self._ensure_cache_replication(dst)
        return True
