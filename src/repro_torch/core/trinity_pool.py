"""The shared vector-search pool: engine replicas × multi-lane scheduler ×
adaptive controller, advanced in simulated time.

The monolithic pool of the JAX package's ``core/trinity_pool.py``: one
index on ``device`` shared by every replica's engine (no per-replica copy
of ``db``), the lane scheduler, stage-aware preemption, straggler
quarantine, elastic scaling, replica failure (``kill_replica``, with
checkpoint rescue), cancellation and planned drains.

Requests carry a retrieval-class name resolved against the scheduler's
registry (``core/scheduler.py``); the pool derives per-slot engine search
params (entry segment, extend budget, top-k truncation) from the class.

The clock is simulated: each fused chunk of K extends advances a replica
by K·``roofline_model.extend_time(cfg)``, the JAX package's V5E-model price
(so completion times match it); a request converging at sub-step i is
stamped ``t + (i+1)·T_ext``. These are model times, not card times.

Not ported yet (ROADMAP): online inserts and the answer cache
(``submit_insert`` raises), the sharded pool, the runtime sanitizer
(``cfg.sanitizer_enabled`` raises).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import roofline_model
from repro_torch.core.continuous_batching import (ContinuousBatchingEngine,
                                                  SlotParams)
from repro_torch.core.scheduler import (ControllerFeedback, TwoQueueScheduler,
                                        VectorRequest)
from repro_torch.device import resolve_device
from repro_torch.vector.online import OnlineIndex


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
    drains: int = 0  # replicas retired by a planned scale-down
    # failure handling
    replica_deaths: int = 0  # kill_replica fail-stops
    rescued: int = 0  # in-flight requests resumed from a death snapshot
    retries: int = 0  # from-scratch restarts after a replica death
    retries_exhausted: int = 0  # requests failed at the max_retries cap
    probes_cancelled: int = 0  # requests cancelled by their upstream owner

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


class _Replica:
    def __init__(self, rid: int, cfg, index: OnlineIndex, seed: int):
        self.rid = rid
        self.engine = ContinuousBatchingEngine(
            cfg, index.db, index.graph, device=index.device, seed=seed,
            corpus_rows=index.corpus_n)
        self.clock = 0.0
        self.ext_latency_ewma = roofline_model.extend_time(cfg)
        self.slowdown = 1.0  # >1 = straggling hardware
        self.quarantined = False
        self.in_flight: Dict[int, VectorRequest] = {}
        # checkpoint-rescue (cfg.rescue_enabled): host-side SlotCheckpoint
        # per in-flight rid, refreshed after every fused chunk — the state
        # a kill_replica resumes from instead of restarting
        self.snapshots: Dict[int, object] = {}


class VectorPool:
    def __init__(self, cfg, db, graph, *, replicas: int = 1,
                 policy: str = "trinity", device="cuda",
                 min_replicas: int = 1, max_replicas: int = 8,
                 straggler_factor: float = 2.5, elastic: bool = False,
                 classes=None, seed: int = 0):
        if cfg.sanitizer_enabled:
            raise NotImplementedError(
                "the runtime sanitizer is not ported yet (it lives in "
                "serving/: ROADMAP Queue A item 11)")
        if cfg.semantic_cache_enabled:
            raise NotImplementedError(
                "the answer cache needs online inserts, not ported yet: "
                "ROADMAP Queue A item 7")
        self.cfg = cfg
        self.device = resolve_device(device)
        # frozen corpus as a host numpy view (the JAX pool's ``db``; the
        # device copy lives in ``index``)
        self.db = db if isinstance(db, np.ndarray) else db.detach().cpu().numpy()
        self.metrics = PoolMetrics()
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.straggler_factor = straggler_factor
        self.elastic = elastic
        self.feedback = ControllerFeedback()
        self._seed = seed
        self._pending: list = []  # (t_arrival, seq, request) heap
        self._pending_seq = 0  # deterministic tiebreak (id() varies by run)
        self.index = OnlineIndex(db, graph, metric=cfg.metric,
                                 max_rows=cfg.replica_max_rows,
                                 device=self.device)
        self.scheduler = TwoQueueScheduler(cfg, policy=policy,
                                           classes=classes)
        self.replicas: List[_Replica] = [
            _Replica(i, cfg, self.index, self._seed + i)
            for i in range(replicas)]
        self._next_rid = replicas
        self.peak_replicas = len(self.replicas)

    # ------------------------------------------------------------------ API
    def submit(self, req: VectorRequest):
        """Requests become visible to the scheduler at their arrival time
        (event-driven semantics)."""
        heapq.heappush(self._pending, (req.t_arrival, self._pending_seq, req))
        self._pending_seq += 1

    def submit_insert(self, vec, meta=None, t_now: float = 0.0):
        """Insert ``vec`` into the growable cache segment (not ported)."""
        raise NotImplementedError(
            "online inserts (OnlineIndex.insert_batch) are not ported yet: "
            "ROADMAP Queue A item 7")

    def _params_for(self, req: VectorRequest) -> Optional[SlotParams]:
        """Per-slot engine search params derived from the request's
        retrieval class; None (engine defaults) for plain corpus classes."""
        rc = req.rclass
        if rc is None or (rc.segment == "corpus" and rc.extend_budget == 0
                          and rc.top_k is None):
            return None
        lo, hi = self.index.entry_range(rc.segment)
        return SlotParams(top_k=rc.top_k, budget=rc.extend_budget,
                          entry_lo=lo, entry_hi=hi)

    def _release_pending(self, t_now: float):
        while self._pending and self._pending[0][0] <= t_now:
            _, _, req = heapq.heappop(self._pending)
            self.scheduler.submit(req)

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
        sched = self.scheduler
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
            found = self.scheduler.cancel(rid) is not None
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
            self.metrics.probes_cancelled += 1
        return found

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

    def drain_replica(self) -> bool:
        """Planned scale-down: checkpoint the least-loaded replica's
        in-flight work through ONE ``preempt``, re-queue it
        checkpoint-intact (not charged to the starvation cap) and retire
        the replica. Returns False rather than leave fewer than
        ``max(1, min_replicas)`` replicas serving."""
        if len(self.replicas) <= max(1, self.min_replicas):
            return False
        donor = min(self.replicas, key=lambda r: (len(r.in_flight), r.rid))
        t = min(r.clock for r in self.replicas)
        if donor.in_flight:
            pairs = donor.engine.preempt(list(donor.in_flight.keys()))
            for rid, ckpt in pairs:
                req = donor.in_flight.pop(rid)
                self.scheduler.requeue_preempted(req, ckpt, t)
                req.preemptions -= 1
        self.replicas.remove(donor)
        self.metrics.drains += 1
        return True

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
            rep.engine.admit_batch([(r.rid, r.qvec, self._params_for(r))
                                    for r in fresh])
        if resumed:
            rep.engine.resume_batch([(r.rid, r.checkpoint) for r in resumed])
            for req in resumed:
                req.checkpoint = None
            self.metrics.resumes += len(resumed)
        for req in batch:
            rep.in_flight[req.rid] = req

    def _maybe_preempt(self, rep: _Replica, t: float):
        """Between fused chunks: full engine + urgent queued work => evict
        the scheduler's victims, checkpoint them, re-queue boosted, and
        seat the urgent probes straight into the freed slots."""
        if not self.cfg.preemption_enabled or rep.engine.num_free > 0:
            return
        sched = self.scheduler
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

    def _on_complete(self, req: VectorRequest):
        """Completion hook (request already stamped with results/times)."""
        if req.kind == "insert":
            raise NotImplementedError(
                "insert-class requests need online inserts, not ported "
                "yet: ROADMAP Queue A item 7")
        self.metrics.preempt_time += req.resume_wait
        self.metrics.completed.append(req)

    def _step_replica(self, rep: _Replica, t_end: float):
        t = rep.clock
        sched = self.scheduler
        sched.controller.maybe_update(t, self.feedback)
        self._maybe_scale(t)

        healthy = self._healthy(rep)
        if healthy:
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
            self._on_complete(req)

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

