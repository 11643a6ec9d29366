"""Deterministic fault injection for the vector pool and the cluster sim.

A chaos run is fully described by a ``(seed, schedule)`` pair: the
schedule is a sorted list of :class:`FaultEvent` drawn from per-kind
Poisson processes (``make_schedule``), and every state-dependent choice
the injector makes at fire time (which replica to straggle, which shard
to lose) comes either from pool/cluster state — itself deterministic —
or from a generator seeded by the injector seed. Re-running the same
pair against the same workload replays the exact failure sequence,
which is what makes the regression tests and the degradation-frontier
benchmark possible.

Two drive modes:

- ``run_pool(pool, t_end)`` — standalone ``VectorPool`` /
  ``ShardedVectorPool``: the injector owns the clock, interleaving
  ``pool.run_until`` with fault applications and their follow-ups
  (straggler restore, replacement-replica spawn after downtime).
- ``arm(sim)`` — a :class:`ClusterSim`: every event (and follow-up) is
  registered on the sim's own event heap; the sim clock drives firing.

Fault kinds
-----------
``kill_replica``      fail-stop the busiest pool replica (in-flight work
                      re-queues per the recovery knobs); a replacement
                      spawns after ``duration`` of downtime.
``lose_shard``        kill EVERY replica of the fullest cache-holding
                      shard and wipe its cache segment (sharded pools).
``straggle_replica``  a random replica slows by ``factor``× for
                      ``duration`` (straggler, not a failure).
``kill_prefill`` / ``kill_decode``
                      fail-stop one instance (never the last alive one);
                      victims re-queue for re-prefill, their in-flight
                      pool probes are cancelled; revives after
                      ``duration``.
``straggle_decode``   one decode instance slows by ``factor``×.
``kv_degrade``        the prefill→decode KV link loses ``factor``× of
                      its bandwidth for ``duration``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, List, Optional, Tuple

import numpy as np

# fault kinds applicable to a bare vector pool vs a full cluster sim
POOL_KINDS = ("kill_replica", "lose_shard", "straggle_replica")
CLUSTER_KINDS = ("kill_prefill", "kill_decode", "straggle_decode",
                 "kv_degrade")

_SCHED_SALT = 0xC7A05  # schedule PRNG domain
_PICK_SALT = 0x1A57  # fire-time target-pick PRNG domain


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    t: float
    kind: str
    target: int = -1  # -1 => auto-pick at fire time
    factor: float = 1.0  # slowdown / bandwidth-division factor
    duration: float = 0.0  # straggle/degrade length, or kill downtime


def make_schedule(seed: int, t_start: float, t_end: float,
                  rates: dict, *, slow_factor: float = 8.0,
                  slow_duration: float = 0.05,
                  downtime: float = 0.1) -> List[FaultEvent]:
    """Draw a fault schedule over ``[t_start, t_end)``.

    ``rates`` maps fault kind → events/second; each kind is an
    independent Poisson process seeded by ``(seed, kind)``, so adding a
    kind (or changing its rate) never perturbs the arrival times of the
    others. Deterministic: same arguments, same schedule.
    """
    events: List[FaultEvent] = []
    for kind in sorted(rates):
        rate = rates[kind]
        if rate <= 0:
            continue
        assert kind in POOL_KINDS + CLUSTER_KINDS, kind
        salt = POOL_KINDS.index(kind) if kind in POOL_KINDS \
            else len(POOL_KINDS) + CLUSTER_KINDS.index(kind)
        rng = np.random.default_rng(
            np.random.SeedSequence([_SCHED_SALT, seed, salt]))
        slow = kind.startswith("straggle") or kind == "kv_degrade"
        t = t_start
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= t_end:
                break
            events.append(FaultEvent(
                t=float(t), kind=kind,
                factor=slow_factor if slow else 1.0,
                duration=slow_duration if slow else downtime))
    events.sort(key=lambda e: (e.t, e.kind))
    return events


class ChaosInjector:
    """Replay a fault schedule against a pool or a cluster sim."""

    def __init__(self, schedule: List[FaultEvent], seed: int = 0):
        self.schedule = list(schedule)
        self._rng = np.random.default_rng(
            np.random.SeedSequence([_PICK_SALT, seed]))
        self.log: List[dict] = []  # one row per event: applied or skipped
        self.injected = 0

    def _note(self, ev: FaultEvent, target, applied: bool):
        self.log.append({"t": ev.t, "kind": ev.kind, "target": target,
                         "applied": applied})
        if applied:
            self.injected += 1

    # ------------------------------------------------------ pool targets
    def _apply_pool(self, pool, ev: FaultEvent,
                    t: float) -> List[Tuple[float, Callable]]:
        """Apply one pool-kind event; returns (time, fn) follow-ups."""
        if ev.kind == "kill_replica":
            sharded = getattr(pool, "shards", None) is not None
            if not sharded and len(pool.replicas) <= 1:
                # a monolithic pool's last replica has no re-home path
                self._note(ev, None, False)
                return []
            victim = pool.replicas[ev.target] if ev.target >= 0 else max(
                pool.replicas, key=lambda r: (len(r.in_flight), -r.rid))
            shard = victim.shard
            group = (lambda: pool.shard_replicas(shard)) if sharded \
                else (lambda: pool.replicas)
            n_before = len(group())
            pool.kill_replica(pool.replicas.index(victim))
            self._note(ev, victim.rid, True)

            def _respawn():
                # restore the PRE-KILL count only: an orphaned shard may
                # already have been auto-re-homed at kill time
                if len(group()) < n_before:
                    pool.spawn_replica(shard if sharded else None)
            return [(t + ev.duration, _respawn)]

        if ev.kind == "straggle_replica":
            i = ev.target if ev.target >= 0 \
                else int(self._rng.integers(len(pool.replicas)))
            rep = pool.replicas[i]
            rep.slowdown = ev.factor
            self._note(ev, rep.rid, True)
            # restore by identity: indices shift as replicas die/spawn,
            # and restoring a dead replica is a harmless no-op
            return [(t + ev.duration,
                     lambda: setattr(rep, "slowdown", 1.0))]

        if ev.kind == "lose_shard":
            if getattr(pool, "shards", None) is None:
                self._note(ev, None, False)  # monolithic: no shards
                return []
            cached = pool.shards.cache_shards()
            if ev.target >= 0:
                s = ev.target
            elif cached:  # the fullest cache-holding shard hurts most
                s = max(cached,
                        key=lambda c: (pool.shards.shards[c].cache_size, -c))
            else:
                s = int(self._rng.integers(pool.shards.num_shards))
            n_before = len(pool.shard_replicas(s))
            pool.lose_shard(s)
            self._note(ev, s, True)

            def _respawn(pool=pool, s=s, n=n_before):
                for _ in range(max(0, n - len(pool.shard_replicas(s)))):
                    pool.spawn_replica(s)
            return [(t + ev.duration, _respawn)]

        raise ValueError(f"not a pool fault kind: {ev.kind}")

    # ------------------------------------------------------ drive: pool
    def run_pool(self, pool, t_end: float):
        """Advance ``pool`` to ``t_end``, firing every pool-kind event
        (and its follow-ups) at its scheduled time."""
        heap: List[Tuple[float, int, Optional[FaultEvent],
                         Optional[Callable]]] = []
        seq = 0
        for ev in self.schedule:
            if ev.t < t_end and ev.kind in POOL_KINDS:
                heap.append((ev.t, seq, ev, None))
                seq += 1
        heapq.heapify(heap)
        while heap:
            t, _, ev, fn = heapq.heappop(heap)
            pool.run_until(t)
            followups = self._apply_pool(pool, ev, t) if ev is not None \
                else (fn() or [])
            for tf, f in followups:
                if tf < t_end:
                    heapq.heappush(heap, (tf, seq, None, f))
                    seq += 1
        pool.run_until(t_end)

    # --------------------------------------------------- drive: cluster
    def arm(self, sim):
        """Register every scheduled event on ``sim``'s event heap.

        Pool-kind events first advance the vector pool to the sim clock
        (pool time is polled lazily) so the fault lands at the right
        simulated instant; their follow-ups are scheduled back onto the
        sim heap too.
        """
        for ev in self.schedule:
            sim.schedule(ev.t, self._cluster_closure(sim, ev))

    def _cluster_closure(self, sim, ev: FaultEvent) -> Callable:
        def _fire():
            if ev.kind in POOL_KINDS:
                sim.vector_pool.run_until(sim.t_now)
                for tf, f in self._apply_pool(sim.vector_pool, ev,
                                              sim.t_now):
                    sim.schedule(tf, f)
                return
            self._apply_cluster(sim, ev)
        return _fire

    def _apply_cluster(self, sim, ev: FaultEvent):
        if ev.kind in ("kill_prefill", "kill_decode"):
            prefill = ev.kind == "kill_prefill"
            pool = sim.prefill_pool if prefill else sim.decode_pool
            load = (lambda i: len(i.current)) if prefill \
                else (lambda i: len(i.active))
            alive = [i for i, inst in enumerate(pool)
                     if inst.health.alive]
            if len(alive) <= 1:  # never kill the last serving path
                self._note(ev, None, False)
                return
            idx = ev.target if ev.target >= 0 \
                else max(alive, key=lambda i: (load(pool[i]), -i))
            (sim.kill_prefill(idx) if prefill else sim.kill_decode(idx))()
            revive = sim.revive_prefill(idx) if prefill \
                else sim.revive_decode(idx)
            sim.schedule(sim.t_now + ev.duration, revive)
            self._note(ev, idx, True)
        elif ev.kind == "straggle_decode":
            alive = [i for i, inst in enumerate(sim.decode_pool)
                     if inst.health.alive]
            if not alive:
                self._note(ev, None, False)
                return
            idx = ev.target if ev.target >= 0 \
                else int(self._rng.choice(alive))
            sim.set_decode_slowdown(idx, ev.factor)()
            sim.schedule(sim.t_now + ev.duration,
                         sim.set_decode_slowdown(idx, 1.0))
            self._note(ev, idx, True)
        elif ev.kind == "kv_degrade":
            sim.set_kv_bandwidth(1.0 / ev.factor)()
            sim.schedule(sim.t_now + ev.duration,
                         sim.set_kv_bandwidth(ev.factor))
            self._note(ev, None, True)
        else:  # pragma: no cover - schedule validated in make_schedule
            raise ValueError(f"unknown fault kind: {ev.kind}")
