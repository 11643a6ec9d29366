"""Generation request lifecycle + SLO accounting."""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class GenRequest:
    rid: int
    prompt_len: int
    max_new_tokens: int
    t_arrival: float
    rag_interval: int = 0  # Δ: decode RAG probe every Δ tokens (0 = off)
    prefill_rag: bool = True
    # semantic answer cache: requests sharing a prompt_id are repeats of
    # the same prompt (identical embedding); None => unique (rid)
    prompt_id: Optional[int] = None
    cache_hit: bool = False  # served from the answer cache (no PD pipeline)
    # lifecycle timestamps
    t_cache_done: Optional[float] = None  # answer-cache lookup returned
    t_retrieval_done: Optional[float] = None
    t_prefill_start: Optional[float] = None
    t_prefill_done: Optional[float] = None
    t_kv_arrived: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    tokens_out: int = 0
    token_times: List[float] = dataclasses.field(default_factory=list)
    stall_time: float = 0.0  # decode time spent waiting on RAG
    stalled_until: float = 0.0
    re_prefills: int = 0  # failure recoveries

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrival

    @property
    def tpot(self) -> Optional[float]:
        if len(self.token_times) < 2:
            return None
        ts = np.diff(np.asarray(self.token_times))
        return float(np.mean(ts))


def percentile(xs, q):
    xs = [x for x in xs if x is not None]
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def slo_good(req: GenRequest, ttft_slo_s: float, tpot_slo_s: float) -> bool:
    """Did this finished request land inside the SLO? Goodput counts only
    these (DistServe framing): TTFT within budget AND — when the request
    actually decoded — TPOT within budget. Cache hits carry no TPOT and
    are judged on TTFT alone."""
    if req.ttft is None or req.ttft > ttft_slo_s:
        return False
    tpot = req.tpot
    return tpot is None or tpot <= tpot_slo_s


class RollingWindow:
    """Incremental time-ordered sample window.

    Samples arrive in nondecreasing sim time via :meth:`add`; accessors
    prune anything older than ``window_s`` behind ``t_now`` and answer
    percentiles/rates over what remains — O(1) amortized per sample, so
    a controller can read it every epoch instead of re-scanning the full
    run. ``window_s <= 0`` keeps every sample (full-run mode), which is
    how the end-of-run ``summary()`` and the windowed accessors share
    one code path (and one ``percentile`` definition)."""

    def __init__(self, window_s: float = 0.0):
        self.window_s = window_s
        self._samples: deque = deque()  # (t, value), t nondecreasing

    def add(self, t: float, value):
        self._samples.append((t, value))

    def _prune(self, t_now: float):
        if self.window_s <= 0:
            return
        lo = t_now - self.window_s
        while self._samples and self._samples[0][0] < lo:
            self._samples.popleft()

    def values(self, t_now: float) -> list:
        self._prune(t_now)
        return [v for _, v in self._samples]

    def count(self, t_now: float) -> int:
        self._prune(t_now)
        return len(self._samples)

    def rate(self, t_now: float) -> float:
        """Samples per second over the window (full-run mode: over the
        span from the first sample to ``t_now``)."""
        n = self.count(t_now)
        if self.window_s > 0:
            return n / self.window_s
        if not self._samples:
            return 0.0
        return n / max(t_now - self._samples[0][0], 1e-9)

    def percentile(self, q: float, t_now: float) -> float:
        return percentile(self.values(t_now), q)

    def mean(self, t_now: float) -> float:
        xs = [v for v in self.values(t_now) if v is not None]
        return float(np.mean(xs)) if xs else 0.0


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One audited scaling decision: every replica/instance the cluster
    adds or drains records when, which pool, which direction and the
    signal that triggered it — fire-and-forget scale-ups are banned."""

    t: float
    pool: str  # "prefill" | "decode" | "vector"
    delta: int  # +1 (add) | -1 (drain initiated)
    reason: str  # triggering signal name, e.g. "decode_queue_depth"
    signal: float = 0.0  # the signal's value at decision time


@dataclasses.dataclass
class ClusterMetrics:
    finished: List[GenRequest] = dataclasses.field(default_factory=list)
    # rolling-window horizon for the incremental accessors below (sim
    # seconds); reconfigure via set_window() BEFORE the run starts
    window_s: float = 0.25
    # audited scaling decisions (elastic decode + autoscaler actuators)
    scale_events: List[ScaleEvent] = dataclasses.field(default_factory=list)
    # vector-pool stage-aware preemption (stamped by ClusterSim)
    pool_preemptions: int = 0
    pool_resumes: int = 0
    # semantic answer cache
    cache_hits: int = 0
    saved_prefill_tokens: int = 0  # prompt tokens never prefilled (hits)
    # workload-adaptive shard rebalancing (stamped by ClusterSim; all zero
    # for monolithic pools or with rebalance_enabled=False)
    pool_rebalances: int = 0  # replicas moved cold shard → hot shard
    pool_migrations: int = 0  # cache entries re-homed between shards
    pool_shard_p95_wait: Dict[int, float] = dataclasses.field(
        default_factory=dict)  # per-shard recent child wait p95
    # failure injection / high-availability serving (stamped by ClusterSim)
    prefill_deaths: int = 0  # prefill instances fail-stopped
    decode_deaths: int = 0  # decode instances fail-stopped
    probes_cancelled: int = 0  # orphaned pool probes torn down on death
    pool_replica_deaths: int = 0
    pool_shard_losses: int = 0  # whole cache-holding shards lost
    pool_shard_reassignments: int = 0  # orphaned shards re-homed
    pool_rescued: int = 0  # in-flight probes resumed from snapshots
    pool_retries: int = 0  # probes restarted from scratch after a death
    pool_retries_exhausted: int = 0  # probes that hit the retry cap
    pool_hedges: int = 0  # duplicate twins dispatched
    pool_hedges_won: int = 0  # twins that beat the original
    pool_hedges_wasted: int = 0  # losing copies cancelled/dropped
    cache_entries_recovered: int = 0  # re-homed from backup on shard loss
    cache_entries_lost: int = 0  # unrecoverable (no backup copy)

    def __post_init__(self):
        self._make_windows()

    def _make_windows(self):
        self._w_ttft = RollingWindow(self.window_s)
        self._w_tpot = RollingWindow(self.window_s)
        self._w_done = RollingWindow(self.window_s)  # holds GenRequest refs

    def set_window(self, window_s: float):
        """Reconfigure the rolling horizon (drops buffered samples —
        call before the run starts)."""
        self.window_s = window_s
        self._make_windows()

    def record_finish(self, req: GenRequest):
        """The single completion seam: appends to ``finished`` AND feeds
        the incremental windows, so the controller's rolling view and
        the end-of-run ``summary()`` see the same stream."""
        self.finished.append(req)
        t = req.t_done if req.t_done is not None else req.t_arrival
        if req.ttft is not None:
            self._w_ttft.add(t, req.ttft)
        tpot = req.tpot
        if tpot is not None:
            self._w_tpot.add(t, tpot)
        self._w_done.add(t, req)

    # ---- incremental rolling-window accessors (controller-facing) ----
    def window_ttft_p(self, q: float, t_now: float) -> float:
        return self._w_ttft.percentile(q, t_now)

    def window_tpot_p(self, q: float, t_now: float) -> float:
        return self._w_tpot.percentile(q, t_now)

    def window_finish_rate(self, t_now: float) -> float:
        """Completions per second over the window."""
        return self._w_done.rate(t_now)

    def window_goodput(self, t_now: float, ttft_slo_s: float,
                       tpot_slo_s: float) -> float:
        """SLO-good completions per second over the window."""
        reqs = self._w_done.values(t_now)
        good = sum(1 for r in reqs if slo_good(r, ttft_slo_s, tpot_slo_s))
        if self._w_done.window_s > 0:
            return good / self._w_done.window_s
        if not reqs:
            return 0.0
        return good / max(t_now - self._w_done._samples[0][0], 1e-9)

    def goodput(self, t_elapsed: float, ttft_slo_s: float,
                tpot_slo_s: float, gpu_units: int = 1) -> float:
        """Full-run goodput per GPU-second: SLO-good completions /
        (gpu_units × t_elapsed) — the bench's cross-arm objective."""
        good = sum(1 for r in self.finished
                   if slo_good(r, ttft_slo_s, tpot_slo_s))
        return good / max(gpu_units * t_elapsed, 1e-9)

    # full-run percentile accessors: same ``percentile`` primitive as the
    # windowed path (window vs full-run agreement is tested)
    def ttft_p(self, q: float) -> float:
        return percentile([r.ttft for r in self.finished], q)

    def tpot_p(self, q: float) -> float:
        return percentile([r.tpot for r in self.finished], q)

    def summary(self, t_elapsed: float) -> dict:
        fin = self.finished
        toks = sum(r.tokens_out for r in fin)
        # only requests that actually decoded contribute decode time: a
        # request may carry t_done without t_first_token (cache hits served
        # without a decode pass, failure edge cases) and (t_done or 0) −
        # (t_first_token or 0) would go negative and skew decode_stall_frac
        decode_time = sum(r.t_done - r.t_first_token for r in fin
                          if r.t_done is not None
                          and r.t_first_token is not None)
        stall = sum(r.stall_time for r in fin)
        return {
            "requests": len(fin),
            "throughput_tok_s": toks / max(t_elapsed, 1e-9),
            "ttft_p50": self.ttft_p(50),
            "ttft_p95": self.ttft_p(95),
            "tpot_p50": self.tpot_p(50),
            "tpot_p95": self.tpot_p(95),
            "decode_stall_frac": stall / max(decode_time, 1e-9),
            "re_prefills": sum(r.re_prefills for r in fin),
            "prefill_deaths": self.prefill_deaths,
            "decode_deaths": self.decode_deaths,
            "probes_cancelled": self.probes_cancelled,
            "pool_replica_deaths": self.pool_replica_deaths,
            "pool_shard_losses": self.pool_shard_losses,
            "pool_shard_reassignments": self.pool_shard_reassignments,
            "pool_rescued": self.pool_rescued,
            "pool_retries": self.pool_retries,
            "pool_retries_exhausted": self.pool_retries_exhausted,
            "pool_hedges": self.pool_hedges,
            "pool_hedges_won": self.pool_hedges_won,
            "pool_hedges_wasted": self.pool_hedges_wasted,
            "cache_entries_recovered": self.cache_entries_recovered,
            "cache_entries_lost": self.cache_entries_lost,
            "pool_preemptions": self.pool_preemptions,
            "pool_resumes": self.pool_resumes,
            "pool_rebalances": self.pool_rebalances,
            "pool_migrations": self.pool_migrations,
            "pool_shard_p95_wait": dict(self.pool_shard_p95_wait),
            "cache_hits": self.cache_hits,
            "cache_hit_rate": self.cache_hits / max(len(fin), 1),
            "saved_prefill_tokens": self.saved_prefill_tokens,
            "scale_events": len(self.scale_events),
            "scale_ups": sum(1 for e in self.scale_events if e.delta > 0),
            "scale_downs": sum(1 for e in self.scale_events if e.delta < 0),
        }
