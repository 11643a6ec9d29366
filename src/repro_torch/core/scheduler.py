"""Trinity §3.3: latency-aware multi-lane scheduling for the vector pool.

A copy of the JAX package's ``core/scheduler.py`` (numpy only). Its
acceptance test is the recorded decision trace
``tests/data/scheduler_trace.json`` (tests/test_torch_scheduler.py).

Retrieval-class abstraction: the paper's motivating workload is
heterogeneous — prefill context retrievals, decode RAG probes, semantic
answer-cache lookups, online index inserts — all sharing one vector pool.
Each workload is described by a :class:`RetrievalClass` (scheduling lane,
default deadline, extend budget, per-class top-k, score threshold, index
segment) instead of a hard-coded ``"prefill"``/``"decode"`` string. The
scheduler owns a registry of classes and multiplexes three lanes:

  · EDF lane        — slack-ordered  ddl − (t_now + Ẽ·T_ext), short flush
    timeout τ_pre, first-class latency protection (TTFT). Default class:
    ``prefill``.
  · FIFO lane       — arrival order, absorbs remaining capacity. Default
    class: ``decode``.
  · background lane — deadline-less work (online index inserts) that only
    fills slots left free by both foreground lanes and is preemptible by
    ANY queued foreground work, not just urgent work.

  · Batch builder: N = free engine slots; reserve ⌈r·N⌉ for the EDF lane
    with unused share immediately donated to the FIFO lane; still-free
    slots backfill EDF, then the background lane; engine pads the
    remainder with masked dummies (fixed kernel shape).
  · Adaptive control loop (every control_interval): steer r and τ_pre from
    real-time feedback — KV-link utilisation u_kv vs target, prefill P95
    wait (TTFT proxy), decode RAG-stall fraction.
  · Stage-aware preemption (paper contribution 3): when the engine is full
    and queued work is *urgent* (slack below ``preempt_slack_ms``),
    ``plan_preemption`` picks victims among the running requests by
    LARGEST remaining slack (they can best afford the round trip),
    skipping any already preempted ``max_preemptions`` times (starvation
    cap) and any whose own slack is within 2× the urgency threshold.
    Background-lane requests are victims of first resort: they are
    evicted for any queued foreground request (deadline-less work has
    infinite slack and is exempt from the starvation cap). Victims are
    re-queued via ``requeue_preempted`` with their engine checkpoint
    attached at boosted priority so they re-enter on the next flush.

With the default two-class table (``prefill``→EDF, ``decode``→FIFO) and
no background submissions, every decision — ``select`` order,
``plan_preemption`` victims, ``take_urgent`` picks, ``should_flush`` —
is bit-identical to the pre-refactor two-queue scheduler; pinned against
a recorded decision trace in tests/test_torch_scheduler.py.

Knobs (configs/base.py VectorPoolConfig): ``preemption_enabled``,
``preempt_slack_ms``, ``max_preemptions``, and the semantic-cache class
parameters (``cache_*``, ``insert_budget``).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# retrieval classes
# ---------------------------------------------------------------------------

LANES = ("edf", "fifo", "background")


@dataclasses.dataclass(frozen=True)
class RetrievalClass:
    """One heterogeneous vector-search workload class.

    The class replaces the raw ``kind`` string end-to-end: the scheduler
    keys lane placement and urgency off it, the pool derives per-slot
    engine search params (entry segment, extend budget, top-k truncation)
    from it, and the cluster uses ``deadline_ms``/``score_threshold`` when
    building probes.
    """

    name: str
    lane: str  # "edf" | "fifo" | "background"
    deadline_ms: Optional[float] = None  # None => deadline-less (background)
    est_extends: float = 16.0  # Ẽ default for slack estimation
    top_k: Optional[int] = None  # per-class result truncation (None = cfg)
    extend_budget: int = 0  # forced completion after B extends (0 = off)
    score_threshold: Optional[float] = None  # semantic-cache hit distance
    segment: str = "corpus"  # entry-point segment: "corpus" | "cache"

    def __post_init__(self):
        if self.lane not in LANES:
            raise ValueError(f"unknown lane {self.lane!r} (want one of "
                             f"{LANES})")


def build_registry(cfg) -> Dict[str, RetrievalClass]:
    """Default retrieval-class table for a :class:`VectorPoolConfig`.

    ``prefill``/``decode`` reproduce the two-queue trinity policy
    bit-identically; ``cache_lookup``/``insert`` carry the semantic
    answer-cache workload (lookup before prefill, online insert of the
    answer embedding at completion).
    """
    return {c.name: c for c in (
        RetrievalClass("prefill", "edf", cfg.prefill_deadline_ms),
        RetrievalClass("decode", "fifo", cfg.decode_deadline_ms),
        RetrievalClass("cache_lookup", "edf", cfg.prefill_deadline_ms,
                       est_extends=float(cfg.cache_lookup_budget or 16),
                       top_k=cfg.cache_top_k,
                       extend_budget=cfg.cache_lookup_budget,
                       score_threshold=cfg.cache_hit_threshold,
                       segment="cache"),
        RetrievalClass("insert", "background", None,
                       est_extends=float(cfg.insert_budget or 16),
                       top_k=cfg.graph_degree,
                       extend_budget=cfg.insert_budget,
                       segment="cache"),
    )}


@dataclasses.dataclass
class VectorRequest:
    rid: int
    kind: str  # retrieval-class name; a RetrievalClass is also accepted
    qvec: np.ndarray
    t_arrival: float
    deadline: Optional[float]  # None => deadline-less (background classes)
    est_extends: float = 16.0  # Ẽ
    t_admitted: Optional[float] = None
    t_completed: Optional[float] = None
    extends_used: int = 0
    result_ids: Optional[np.ndarray] = None
    result_dists: Optional[np.ndarray] = None
    # resolved retrieval class (stamped by the scheduler at submit when a
    # plain class-name string was passed)
    rclass: Optional[RetrievalClass] = dataclasses.field(
        default=None, repr=False)
    # scatter–gather fan-out: a sharded pool splits one logical request
    # into per-shard sub-searches (children). A child carries its parent's
    # rid and its target shard; it inherits the parent's deadline (single
    # deadline — every lane/urgency decision sees the logical request's
    # slack) and its checkpoint stays shard-portable (any replica of the
    # same shard can resume it). Parent completion = all children merged.
    parent_rid: Optional[int] = dataclasses.field(default=None, repr=False)
    shard: Optional[int] = dataclasses.field(default=None, repr=False)
    # stage-aware preemption bookkeeping
    preemptions: int = 0  # times evicted so far (capped by max_preemptions)
    checkpoint: Optional[object] = None  # engine SlotCheckpoint while queued
    extends_done: int = 0  # extends already executed (stamped at eviction)
    t_preempted: Optional[float] = None
    resume_wait: float = 0.0  # total evicted time (preempt -> re-admission)
    # failure-recovery bookkeeping (chaos / high-availability serving)
    retries: int = 0  # from-scratch restarts after replica deaths
    rescues: int = 0  # checkpoint-rescued resumes after replica deaths
    hedge: bool = dataclasses.field(default=False, repr=False)  # duplicate twin
    failed: bool = dataclasses.field(default=False, repr=False)  # retry cap hit

    def __post_init__(self):
        if isinstance(self.kind, RetrievalClass):
            self.rclass = self.kind
            self.kind = self.rclass.name

    @property
    def lane(self) -> str:
        return self.rclass.lane if self.rclass is not None else (
            "fifo" if self.kind == "decode" else "edf")

    @property
    def wait(self) -> float:
        # explicit None check: t_admitted == 0.0 is a valid admission time
        # and must not fall back to t_arrival (falsy-zero bug)
        if self.t_admitted is None:
            return 0.0
        return self.t_admitted - self.t_arrival


# ---------------------------------------------------------------------------
# lane queues (public iterate/remove APIs — no private reach-ins)
# ---------------------------------------------------------------------------


class EDFQueue:
    """Slack-ordered (EDF) lane: exact O(n log n) over a short queue."""

    def __init__(self):
        self._items: List[VectorRequest] = []

    def push(self, r: VectorRequest):
        self._items.append(r)

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[VectorRequest]:
        return iter(list(self._items))

    def remove(self, reqs: Iterable[VectorRequest]) -> None:
        drop = set(map(id, reqs))
        self._items = [r for r in self._items if id(r) not in drop]

    def oldest_arrival(self) -> Optional[float]:
        return min((r.t_arrival for r in self._items), default=None)

    def pop_by_slack(self, n: int, t_now: float, t_ext: float) -> List[VectorRequest]:
        if n <= 0 or not self._items:
            return []
        # preempted (checkpointed) requests sort ahead of fresh ones at equal
        # footing (boosted priority); within each class, EDF slack with the
        # already-executed extends credited
        self._items.sort(key=lambda r: (
            r.checkpoint is None,
            r.deadline - (t_now + max(r.est_extends - r.extends_done, 1.0)
                          * t_ext)))
        out, self._items = self._items[:n], self._items[n:]
        return out


class FIFOQueue:
    """Arrival-ordered lane (also used for the background insert lane and
    the ``fifo_shared`` baseline's single shared queue)."""

    def __init__(self):
        self._q: deque[VectorRequest] = deque()

    def push(self, r: VectorRequest):
        self._q.append(r)

    def push_front(self, r: VectorRequest):
        """Boosted re-queue for preempted requests: next pop wins."""
        self._q.appendleft(r)

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self) -> Iterator[VectorRequest]:
        return iter(list(self._q))

    def remove(self, reqs: Iterable[VectorRequest]) -> None:
        drop = set(map(id, reqs))
        self._q = deque(r for r in self._q if id(r) not in drop)

    def pop_fifo(self, n: int) -> List[VectorRequest]:
        return [self._q.popleft() for _ in range(min(n, len(self._q)))]


@dataclasses.dataclass
class ControllerFeedback:
    u_kv: float = 1.0  # KV-link utilisation (vs its target)
    u_kv_target: float = 0.9
    prefill_p95_wait: float = 0.0
    prefill_wait_budget: float = 0.005
    decode_stall_frac: float = 0.0
    decode_stall_budget: float = 0.15


class AdaptiveController:
    """Paper: 'increases r or shortens τ_pre when u_kv < u_kv*; rising
    decode stalls decrease r so Q_dec occupies more of N'."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.r = cfg.r_init
        self.tau_pre = cfg.tau_pre_ms / 1e3
        self.last_update = 0.0
        self.history: List[Tuple[float, float, float]] = []

    def maybe_update(self, t_now: float, fb: ControllerFeedback):
        if t_now - self.last_update < self.cfg.control_interval_ms / 1e3:
            return
        self.last_update = t_now
        r_step = 0.05
        starved_prefill = (fb.u_kv < fb.u_kv_target
                           or fb.prefill_p95_wait > fb.prefill_wait_budget)
        stalled_decode = fb.decode_stall_frac > fb.decode_stall_budget
        if starved_prefill and not stalled_decode:
            self.r = min(self.cfg.r_max, self.r + r_step)
            self.tau_pre = max(self.tau_pre * 0.8, 1e-4)
        elif stalled_decode and not starved_prefill:
            self.r = max(self.cfg.r_min, self.r - r_step)
            self.tau_pre = min(self.tau_pre * 1.25, self.cfg.tau_global_ms / 1e3)
        # both or neither pressured: hold (hysteresis)
        self.history.append((t_now, self.r, self.tau_pre))


class LaneScheduler:
    """Class-driven multi-lane scheduler: builds admission batches for the
    engine from the EDF, FIFO and background lanes."""

    def __init__(self, cfg, policy: str = "trinity",
                 classes: Optional[Dict[str, RetrievalClass]] = None):
        assert policy in ("trinity", "prefill_first", "decode_first",
                          "fifo_shared")
        self.cfg = cfg
        self.policy = policy
        self.classes = dict(classes) if classes is not None \
            else build_registry(cfg)
        self.q_edf = EDFQueue()
        self.q_fifo = FIFOQueue()
        self.q_bg = FIFOQueue()
        self.controller = AdaptiveController(cfg)
        self.t_ext_ewma = 20e-6  # measured mean extend latency T_ext
        self._shared_fifo = FIFOQueue()

    # -- queue ops ---------------------------------------------------------
    def register(self, rclass: RetrievalClass):
        """Add (or replace) a retrieval class in the registry."""
        self.classes[rclass.name] = rclass

    def resolve(self, req: VectorRequest) -> RetrievalClass:
        """Stamp (and return) the request's :class:`RetrievalClass`,
        looked up by ``req.kind`` when not already attached. Raises
        ``KeyError`` naming the registered classes for an unknown kind.
        Idempotent: an already-resolved request keeps its class even if
        the registry entry was later replaced."""
        if req.rclass is None:
            try:
                req.rclass = self.classes[req.kind]
            except KeyError:
                raise KeyError(
                    f"unknown retrieval class {req.kind!r}; registered: "
                    f"{sorted(self.classes)}") from None
        return req.rclass

    def submit(self, r: VectorRequest):
        """Queue a request on its class's lane. Background-class work
        always lands on the background queue (it must stay strictly
        behind foreground under EVERY policy, including the
        ``fifo_shared`` baseline's single shared queue)."""
        rclass = self.resolve(r)
        if rclass.lane == "background":
            # background work never rides the shared baseline queue: it
            # must stay strictly behind foreground under every policy
            self.q_bg.push(r)
        elif self.policy == "fifo_shared":
            self._shared_fifo.push(r)
        elif rclass.lane == "edf":
            self.q_edf.push(r)
        else:
            self.q_fifo.push(r)

    def queued(self) -> int:
        """Foreground depth (the background lane is spare-capacity filler
        and must not drive flush urgency or elastic scaling)."""
        return len(self.q_edf) + len(self.q_fifo) + len(self._shared_fifo)

    def queued_background(self) -> int:
        """Depth of the background (deadline-less insert) lane."""
        return len(self.q_bg)

    def observe_extend_latency(self, t: float):
        """Fold one measured extend latency into the T_ext EWMA that
        every slack computation uses (the pool reports it per chunk)."""
        self.t_ext_ewma = 0.9 * self.t_ext_ewma + 0.1 * t

    # -- batch builder (paper Fig. 4) ---------------------------------------
    def select(self, n_slots: int, t_now: float) -> List[VectorRequest]:
        """Build one admission batch for ``n_slots`` free engine slots.

        Trinity policy: reserve ⌈r·n⌉ slots for the EDF lane
        (slack-ordered), donate the unused share to FIFO, backfill EDF,
        then let the background lane fill whatever every foreground lane
        left free. Dequeued requests are stamped ``t_admitted = t_now``
        (and their preemption wait closed). Invariant: never returns more
        than ``n_slots`` requests; background work is only ever admitted
        into slots no foreground lane wanted this flush."""
        if n_slots <= 0:
            return []
        if self.policy == "fifo_shared":
            out = self._shared_fifo.pop_fifo(n_slots)
        elif self.policy == "prefill_first":
            out = self.q_edf.pop_by_slack(n_slots, t_now, self.t_ext_ewma)
            out += self.q_fifo.pop_fifo(n_slots - len(out))
        elif self.policy == "decode_first":
            out = self.q_fifo.pop_fifo(n_slots)
            out += self.q_edf.pop_by_slack(n_slots - len(out), t_now,
                                           self.t_ext_ewma)
        else:  # trinity
            r = self.controller.r
            n_edf_res = min(math.ceil(r * n_slots), n_slots)
            pre = self.q_edf.pop_by_slack(n_edf_res, t_now, self.t_ext_ewma)
            # unused EDF share is immediately given to the FIFO lane
            dec = self.q_fifo.pop_fifo(n_slots - len(pre))
            # any still-free slots go back to the EDF backlog
            pre += self.q_edf.pop_by_slack(n_slots - len(pre) - len(dec),
                                           t_now, self.t_ext_ewma)
            out = pre + dec
        # background fills whatever every foreground lane left free
        out += self.q_bg.pop_fifo(n_slots - len(out))
        self._stamp_admitted(out, t_now)
        return out

    def _stamp_admitted(self, reqs: List[VectorRequest], t_now: float):
        for req in reqs:
            if req.t_preempted is not None:
                req.resume_wait += t_now - req.t_preempted
                req.t_preempted = None
            req.t_admitted = t_now

    # -- stage-aware preemption (paper contribution 3) ----------------------
    def _slack(self, r: VectorRequest, t_now: float,
               running: bool = False) -> float:
        """Deadline slack: ddl − (t_now + remaining·T_ext). Extends already
        executed are credited — exactly for checkpointed requests (stamped
        at eviction), elapsed-time estimated for running ones. Deadline-less
        (background-class) requests have infinite slack: never urgent,
        always the first preemption victims."""
        if r.deadline is None:
            return math.inf
        done = float(r.extends_done)
        if running and r.t_admitted is not None:
            done += (t_now - r.t_admitted) / max(self.t_ext_ewma, 1e-9)
        rem = max(r.est_extends - done, 1.0)
        return r.deadline - (t_now + rem * self.t_ext_ewma)

    def _foreground_queued(self) -> List[VectorRequest]:
        return (list(self.q_edf) + list(self.q_fifo)
                + list(self._shared_fifo))

    def urgent_queued(self, t_now: float) -> List[VectorRequest]:
        """Queued foreground requests whose slack is below the urgency
        threshold but still rescuable (slack > −threshold): a request
        already doomed to miss by more than the estimation margin gains
        nothing from an eviction, so sustained overload must not churn
        healthy running work on its behalf."""
        thr = self.cfg.preempt_slack_ms / 1e3
        return [r for r in self._foreground_queued()
                if -thr < self._slack(r, t_now) < thr]

    def plan_preemption(self, t_now: float, in_flight) -> List[VectorRequest]:
        """Victim selection when the engine is full.

        Background-lane requests in flight are evicted first — one per
        queued foreground request of any slack ("preemptible by
        everything", no starvation cap: deadline-less work can always
        wait). Beyond that, one foreground victim per *urgent* queued
        request, chosen by LARGEST running slack, skipping requests at the
        ``max_preemptions`` cap (starvation guard) and requests whose own
        slack is within 2× the urgency threshold. Returns [] when
        preemption is disabled or nothing justifies an eviction."""
        if not self.cfg.preemption_enabled:
            return []
        bg_running = sorted(
            (r for r in in_flight if r.lane == "background"),
            key=lambda r: (r.extends_done, r.rid))
        victims = bg_running[:self.queued()]
        urgent = self.urgent_queued(t_now)
        n_more = len(urgent) - len(victims)
        if n_more <= 0:
            return victims
        thr = self.cfg.preempt_slack_ms / 1e3
        taken = set(map(id, victims))
        cands = []
        for r in in_flight:
            if id(r) in taken or r.lane == "background":
                continue
            if r.preemptions >= self.cfg.max_preemptions:
                continue
            s = self._slack(r, t_now, running=True)
            if s <= 2 * thr:
                continue
            cands.append((s, r))
        cands.sort(key=lambda x: -x[0])
        return victims + [r for _, r in cands[:n_more]]

    def take_urgent(self, n: int, t_now: float) -> List[VectorRequest]:
        """Dequeue the ≤ n most-urgent queued requests (smallest slack below
        the threshold) across the foreground lanes, bypassing the
        r-reservation — used to seat urgent probes directly into
        preemption-freed slots, so a boosted victim can never win its own
        slot back ahead of the work it was evicted for."""
        if n <= 0:
            return []
        urgent = sorted(((self._slack(r, t_now), r.rid, r)
                         for r in self.urgent_queued(t_now)))
        picked = [r for _, _, r in urgent[:n]]
        for lane in (self.q_edf, self.q_fifo, self._shared_fifo):
            lane.remove(picked)
        self._stamp_admitted(picked, t_now)
        return picked

    def requeue_preempted(self, req: VectorRequest, ckpt, t_now: float):
        """Re-queue an evicted request with its checkpoint attached at
        boosted priority (front of the FIFO / ahead of fresh EDF work)."""
        req.checkpoint = ckpt
        req.extends_done = int(ckpt.extends)
        req.preemptions += 1
        req.t_preempted = t_now
        req.t_admitted = None
        if req.lane == "background":
            self.q_bg.push_front(req)  # resumes ahead of fresh inserts
        elif self.policy == "fifo_shared":
            self._shared_fifo.push_front(req)
        elif req.lane == "edf":
            self.q_edf.push(req)  # pop_by_slack boosts checkpointed items
        else:
            self.q_fifo.push_front(req)

    def requeue_rescued(self, req: VectorRequest, ckpt, t_now: float):
        """Re-queue a request rescued from a DEAD replica with its last
        host-side checkpoint snapshot attached (same boosted-priority path
        as a preemption re-queue). A death is not a scheduler eviction:
        the starvation cap (``max_preemptions``) is not charged, so a
        rescued request stays evictable for truly urgent work."""
        self.requeue_preempted(req, ckpt, t_now)
        req.preemptions -= 1
        req.rescues += 1

    def cancel(self, rid: int) -> Optional[VectorRequest]:
        """Remove (and return) the queued request with ``rid`` from
        whichever lane holds it; None when not queued here. Used by the
        pool to cancel orphaned probes (upstream instance death) and
        hedge losers — an in-flight request is the pool's job to evict."""
        for lane in (self.q_edf, self.q_fifo, self.q_bg, self._shared_fifo):
            for r in lane:
                if r.rid == rid:
                    lane.remove([r])
                    return r
        return None

    def queued_requests(self) -> List[VectorRequest]:
        """Every request currently queued on any lane (public snapshot —
        no private reach-ins). Used by whole-shard loss recovery to scrub
        checkpoints that reference wiped device state."""
        out: List[VectorRequest] = []
        for lane in (self.q_edf, self.q_fifo, self.q_bg, self._shared_fifo):
            out.extend(lane)
        return out

    def should_flush(self, t_now: float, free_slots: int, active: int) -> bool:
        """Launch/admit decision: full batch, τ_pre for urgent EDF work, the
        global flush timeout — or spare slots with background work queued
        (inserts are pure capacity filler and admit greedily)."""
        if free_slots == 0:
            return False
        if self.queued() >= free_slots:
            return True
        oldest_edf = self.q_edf.oldest_arrival()
        if oldest_edf is not None and \
                t_now - oldest_edf >= self.controller.tau_pre:
            return True
        oldest = [r.t_arrival for r in self._foreground_queued()]
        if oldest and t_now - min(oldest) >= self.cfg.tau_global_ms / 1e3:
            return True
        if len(self.q_bg) > 0:
            return True
        # keep the engine busy rather than idle if it has spare slots
        return active == 0 and self.queued() > 0


# The pre-refactor name: the two-queue scheduler is the lane scheduler with
# the default two-class table.
TwoQueueScheduler = LaneScheduler
