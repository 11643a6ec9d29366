"""Closed-loop SLO autoscaler: the goodput control plane over ClusterSim.

Trinity's premise is that a shared vector pool can coexist with
prefill–decode disaggregation *without violating SLOs* as the retrieval
mix drifts; DistServe frames the allocation question as goodput per GPU
rather than raw throughput. The cluster sim has every actuator (instance
add/drain, replica spawn/checkpoint-intact drain) and every sensor
(TTFT/ITL windows, probe deadline misses, queue depths) — this module
closes the loop:

Signal plane
    Each control epoch the :class:`Autoscaler` publishes a
    :class:`ControlSignals` snapshot: rolling-window TTFT/ITL p95 (the
    incremental ``ClusterMetrics`` windows — the same stream the
    end-of-run ``summary()`` reads), the windowed probe deadline-miss
    rate ingested from the vector pool's completion log, per-pool queue
    depths, and goodput = requests completing inside SLO per GPU-second.

Controller
    A KEDA-style target tracker under a FIXED total-GPU budget: each
    pool's *pressure* is its queued work per serving instance divided by
    its setpoint (SLO overshoot terms fold in — decode ITL overshoot is
    attributed to the VECTOR pool when RAG stalls dominate it, because
    adding decode instances cannot fix tokens that are waiting on
    probes). Pressure above ``hot_factor`` makes a pool hungry; a unit
    comes from free budget or from a donor sitting below ``cold_factor``
    — two-sided hysteresis plus per-pool cooldowns (the PR-5
    rebalancer's anti-thrash idiom), at most one scale action per epoch.
    Scale-down is a SAFE DRAIN: vector replicas re-queue their in-flight
    children checkpoint-intact (``drain_replica``, the ``_move_replica``
    machinery), LLM instances stop admitting and finish their in-flight
    work (device KV never drops, zero re-prefills); serving minimums
    always hold. Stage-aware priority: decode deficits are served first,
    and a vector deficit may only take a decode unit while the windowed
    ITL p95 is inside ``itl_protect_factor`` × the TPOT SLO — a starved
    vector pool cannot starve decode ITL in turn.

Every decision lands in ``ClusterMetrics.scale_events`` (timestamp,
pool, delta, triggering signal) so benches and tests audit the full
trajectory. Knobs-off (``ClusterSim(autoscaler=None)``, the default):
nothing here is constructed and cluster behavior is bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import AutoscalerConfig
from repro_torch.serving.request import RollingWindow

# ITL-overshoot attribution: when at least this fraction of decode time
# is RAG-stall wait, long token gaps are the vector pool's deficit, not
# decode's (more decode instances cannot speed up a stalled token)
_STALL_ATTRIBUTION = 0.5
# fraction of the TTFT budget prefill may spend clearing its token
# backlog before the pool reads hot (the rest is queueing + handoff)
_TTFT_HEADROOM = 0.5

_POOLS = ("decode", "prefill", "vector")  # stage-aware service order


@dataclasses.dataclass(frozen=True)
class ControlSignals:
    """One epoch's published signal snapshot (the controller's whole
    world view — also the bench's audit trail)."""

    t: float
    # rolling-window SLO attainment
    ttft_p95: float
    itl_p95: float
    probe_miss_rate: float  # windowed probe deadline-miss fraction
    decode_stall_frac: float  # RAG-stall share of decode time (feedback)
    # per-pool queue depths / capacity
    prefill_queue: int
    prefill_backlog_tokens: int  # queued + in-batch prompt tokens
    decode_queue: int
    vector_queue: int
    prefill_instances: int  # serving (alive, not draining/retired)
    decode_instances: int
    vector_replicas: int
    gpu_units: int
    # goodput objective
    finish_rate: float  # windowed completions / s
    goodput_rps: float  # windowed SLO-good completions / s
    slo_attainment: float  # goodput_rps / finish_rate (1.0 when idle)
    goodput_per_gpu: float  # goodput_rps / gpu_units
    # normalized target-tracking pressures (1.0 = at setpoint)
    prefill_pressure: float
    decode_pressure: float
    vector_pressure: float

    def pressure(self, pool: str) -> float:
        return getattr(self, f"{pool}_pressure")


class Autoscaler:
    """KEDA-style goodput reconciler bound to one :class:`ClusterSim`.

    The sim calls :meth:`epoch` on its event heap every
    ``cfg.epoch_s``; everything else is driven from there.
    """

    def __init__(self, sim, cfg: AutoscalerConfig):
        self.sim = sim
        self.cfg = cfg
        self.signals_log: List[ControlSignals] = []
        self.budget = int(cfg.gpu_budget) or sim.gpu_units()
        self._w_miss = RollingWindow(cfg.window_s)
        self._vcursor = 0  # cursor into vector_pool.metrics.completed
        self._last_up: Dict[str, float] = {p: -1e18 for p in _POOLS}
        self._last_down: Dict[str, float] = {p: -1e18 for p in _POOLS}
        # one in-flight LLM drain at a time: (recipient, reason, signal)
        # granted when the drained instance retires
        self._pending_grant: Optional[Tuple[str, str, float]] = None

    # ------------------------------------------------------- signal plane
    def _ingest_pool_completions(self, t: float):
        """Fold new vector-pool completions into the deadline-miss
        window (observation-time stamped: 'misses seen in the last
        window')."""
        comp = self.sim.vector_pool.metrics.completed
        while self._vcursor < len(comp):
            v = comp[self._vcursor]
            self._vcursor += 1
            if v.kind == "insert" or v.deadline is None \
                    or v.t_completed is None:
                continue
            miss = v.failed or v.t_completed > v.deadline
            self._w_miss.add(t, 1.0 if miss else 0.0)

    def _serving(self, pool) -> int:
        return sum(1 for i in pool if i.health.serving)

    def _prefill_tok_rate(self) -> float:
        """Per-instance prefill token throughput, profiled from a live
        instance's own timing model (its chips / contention / slowdown),
        the way a real controller profiles measured service rates."""
        insts = [i for i in self.sim.prefill_pool if i.health.serving] \
            or self.sim.prefill_pool
        return 4096.0 / max(insts[0].batch_time(4096), 1e-12)

    def snapshot(self, t: float) -> ControlSignals:
        sim, cfg = self.sim, self.cfg
        m = sim.metrics
        vpool = sim.vector_pool
        scheds = getattr(vpool, "schedulers", None) or [vpool.scheduler]

        ttft_p95 = m.window_ttft_p(95, t)
        itl_p95 = m.window_tpot_p(95, t)
        miss_rate = self._w_miss.mean(t)
        stall_frac = float(vpool.feedback.decode_stall_frac)
        q_pre = len(sim.prefill_queue)
        q_dec = len(sim.decode_queue)
        q_vec = sum(s.queued() for s in scheds)
        n_pre = self._serving(sim.prefill_pool)
        n_dec = self._serving(sim.decode_pool)
        n_vec = len(vpool.replicas)
        finish_rate = m.window_finish_rate(t)
        goodput = m.window_goodput(t, cfg.ttft_slo_s, cfg.tpot_slo_s)
        units = sim.gpu_units()
        # prefill backlog in TOKENS, queued + in-batch: prefill gulps its
        # whole queue into giant batches, so queue DEPTH goes blind the
        # moment a batch starts — clear-time of the token backlog is the
        # live signal
        backlog_tok = sum(r.prompt_len for r in sim.prefill_queue) \
            + sum(r.prompt_len for i in sim.prefill_pool
                  if i.health.serving for r in i.current)

        # target tracking: queued work per serving instance vs setpoint
        p_pre = q_pre / max(n_pre, 1) / cfg.queue_target
        p_dec = q_dec / max(n_dec, 1) / cfg.queue_target
        p_vec = max(q_vec / max(n_vec, 1) / cfg.queue_target_vector,
                    miss_rate / max(cfg.probe_miss_budget, 1e-9))
        # live prefill clear-time vs the TTFT headroom: how long the
        # current token backlog takes the serving instances to chew
        # through, against the slice of the TTFT budget prefill may spend
        clear_s = backlog_tok / max(n_pre * self._prefill_tok_rate(),
                                    1e-9)
        p_pre = max(p_pre,
                    clear_s / (_TTFT_HEADROOM * cfg.ttft_slo_s))
        # Windowed-TTFT overshoot folds in only while backlog exists:
        # the window lags (it sees finishes, not arrivals), and chasing
        # a stale overshoot after the backlog cleared would pin the pool
        # hot forever.
        if backlog_tok > 0 and ttft_p95 > 0:
            p_pre = max(p_pre, ttft_p95 / cfg.ttft_slo_s)
        # ITL overshoot goes to decode — unless RAG stalls dominate the
        # gaps, in which case the deficit is the vector pool's.
        if itl_p95 > 0:
            itl_term = itl_p95 / cfg.tpot_slo_s
            if stall_frac >= _STALL_ATTRIBUTION:
                p_vec = max(p_vec, itl_term)
            else:
                p_dec = max(p_dec, itl_term)

        return ControlSignals(
            t=t, ttft_p95=ttft_p95, itl_p95=itl_p95,
            probe_miss_rate=miss_rate, decode_stall_frac=stall_frac,
            prefill_queue=q_pre, prefill_backlog_tokens=backlog_tok,
            decode_queue=q_dec, vector_queue=q_vec,
            prefill_instances=n_pre, decode_instances=n_dec,
            vector_replicas=n_vec, gpu_units=units,
            finish_rate=finish_rate, goodput_rps=goodput,
            slo_attainment=(goodput / finish_rate if finish_rate > 0
                            else 1.0),
            goodput_per_gpu=goodput / max(units, 1),
            prefill_pressure=p_pre, decode_pressure=p_dec,
            vector_pressure=p_vec)

    # -------------------------------------------------------- controller
    def epoch(self):
        """One control epoch: publish signals, then reconcile (at most
        one scale action)."""
        t = self.sim.t_now
        self._ingest_pool_completions(t)
        sig = self.snapshot(t)
        self.signals_log.append(sig)
        self._reconcile(t, sig)

    def _reconcile(self, t: float, sig: ControlSignals):
        cfg = self.cfg
        for pool in _POOLS:  # decode ITL outranks prefill outranks vector
            if sig.pressure(pool) <= cfg.hot_factor:
                continue
            if t - self._last_up[pool] < cfg.cooldown_up_s:
                continue
            if self._try_grow(pool, t, sig):
                return  # one action per epoch (anti-thrash)

    def _try_grow(self, pool: str, t: float, sig: ControlSignals) -> bool:
        cfg = self.cfg
        if self._pending_grant is not None:
            return False  # a donated unit is already in flight
        reason = f"pressure:{pool}"
        signal = sig.pressure(pool)
        if self.sim.gpu_units() < self.budget:
            self._grant(pool, t, reason, signal)
            return True
        donors = []
        for q in _POOLS:
            if q == pool or sig.pressure(q) >= cfg.cold_factor:
                continue
            # pace donations AND never strip a pool that was itself
            # grown within the down-cooldown (up→down flapping)
            if t - self._last_down[q] < cfg.cooldown_down_s or \
                    t - self._last_up[q] < cfg.cooldown_down_s:
                continue
            if not self._can_shrink(q):
                continue
            if pool == "vector" and q == "decode" and \
                    sig.itl_p95 > cfg.itl_protect_factor * cfg.tpot_slo_s:
                continue  # a vector deficit must not starve decode ITL
            donors.append((sig.pressure(q), q))
        if not donors:
            return False
        _, donor = min(donors)
        return self._shrink(donor, pool, t, sig)

    def _can_shrink(self, pool: str) -> bool:
        sim, cfg = self.sim, self.cfg
        if pool == "prefill":
            return self._serving(sim.prefill_pool) > max(cfg.min_prefill, 1)
        if pool == "decode":
            return self._serving(sim.decode_pool) > max(cfg.min_decode, 1)
        return self._vector_drain_shard() is not False

    def _vector_drain_shard(self):
        """The shard a vector drain should come from: the coldest one
        above its serving floor (``cfg.min_vector`` raises the pool
        floors). None = monolithic pool with headroom; False = no
        replica can be drained anywhere."""
        pool = self.sim.vector_pool
        if hasattr(pool, "shards"):
            t = self.sim.t_now
            cands = [
                s for s in range(pool.shards.num_shards)
                if len(pool.shard_replicas(s)) > max(pool.shard_floor(s),
                                                     self.cfg.min_vector)]
            if not cands:
                return False
            return min(cands, key=lambda s: (pool.shard_load_score(s, t), s))
        if len(pool.replicas) > max(pool.drain_floor(),
                                    self.cfg.min_vector):
            return None
        return False

    def _shrink(self, donor: str, recipient: str, t: float,
                sig: ControlSignals) -> bool:
        reason = f"donate:{donor}->{recipient}"
        signal = sig.pressure(donor)
        if donor == "vector":
            shard = self._vector_drain_shard()
            if shard is False:
                return False
            if not self.sim.drain_vector_replica(shard=shard, reason=reason,
                                                 signal=signal):
                return False
            self._last_down["vector"] = t
            # checkpoint-intact drain frees the unit immediately
            self._grant(recipient, t, f"pressure:{recipient}",
                        sig.pressure(recipient))
            return True
        drain = (self.sim.drain_prefill_instance if donor == "prefill"
                 else self.sim.drain_decode_instance)
        inst = drain(reason=reason, signal=signal)
        if inst is None:
            return False
        self._last_down[donor] = t
        if inst.health.retired:
            # the donor was idle: retired on the spot, grant now
            self._grant(recipient, t, f"pressure:{recipient}",
                        sig.pressure(recipient))
        else:
            self._pending_grant = (recipient, f"pressure:{recipient}",
                                   sig.pressure(recipient))
        return True

    def _grant(self, pool: str, t: float, reason: str, signal: float):
        if pool == "prefill":
            self.sim.add_prefill_instance(reason=reason, signal=signal,
                                          kick=True)
        elif pool == "decode":
            self.sim.add_decode_instance(reason=reason, signal=signal,
                                         kick=True)
        else:
            self.sim.add_vector_replica(reason=reason, signal=signal)
        self._last_up[pool] = t

    # ---------------------------------------------------------- callbacks
    def on_drain_complete(self, pool_name: str, t: float):
        """A drained LLM instance emptied and retired — hand its freed
        unit to the waiting recipient (no-op for drains the controller
        did not initiate)."""
        if self._pending_grant is None:
            return
        recipient, reason, signal = self._pending_grant
        self._pending_grant = None
        self._grant(recipient, t, reason, signal)
