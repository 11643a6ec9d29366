"""Runtime invariant sanitizer for the simulated serving stack.

The JAX package's ``serving/sanitizer.py`` over the port's pool: the
invariants only an executing pool can witness. It wraps the seams of a
live :class:`~repro_torch.core.trinity_pool.VectorPool` /
``ShardedVectorPool`` (and optionally a
:class:`~repro_torch.serving.cluster.ClusterSim`) with record-only checks:

``clock``       per-replica clock monotonicity — a replica's sim clock
                never moves backwards across engine steps.
``completion``  exactly-once completion per rid — no request (parent,
                probe or insert) ever lands in ``metrics.completed``
                twice.
``checkpoint``  checkpoint conservation across moves/rescues — a
                planned ``_move_replica`` re-queues every donor child
                checkpoint-intact, and a ``kill_replica`` rescue
                re-queues with the snapshot attached; nothing in flight
                is silently dropped.
``gid``         cache gid uniqueness across eviction + migration — the
                sharded index's ``_gid_loc`` and per-shard
                ``_global_of`` maps stay exact inverses, every live
                cache gid lives on exactly one shard.
``probe``       no orphaned probes after kills — every callback the
                cluster still holds in ``_probe_cb`` references a
                request that is still live inside the pool.
``replica``     replica-count conservation across scaling actions — a
                ``drain_replica`` changes the count by exactly −1 (or 0
                when refused) and never lands any shard below its
                serving floor; a spawn changes it by exactly +1; and a
                drain re-queues every donor in-flight request
                checkpoint-intact (the autoscaler's scale-down must be
                invisible to request outcomes).

Knobs-off-free: the sanitizer only exists when
``VectorPoolConfig.sanitizer_enabled`` is set. With the knob off
nothing is wrapped, no check runs, and pool behavior is bit-identical
to a build without this module.

The gid check scans each shard's id map with numpy where the JAX
package loops over every row in Python: the same records, at a cost that
grows with the cache entries rather than with the corpus rows (it runs
after every ``run_until``, and a cluster polls the pool every 200
simulated microseconds).

Violations are *recorded*, never raised mid-sim — a chaos arm must keep
running so the run reports every violation, and the clean case asserts
``assert_clean()`` at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

__all__ = ["Violation", "PoolSanitizer", "attach"]


@dataclasses.dataclass(frozen=True)
class Violation:
    kind: str  # clock | completion | checkpoint | gid | probe | replica
    detail: str

    def __str__(self) -> str:
        return f"[{self.kind}] {self.detail}"


def attach(pool) -> "PoolSanitizer":
    """Wrap ``pool``'s seams and return the attached sanitizer."""
    return PoolSanitizer(pool)


class PoolSanitizer:
    """Record-only invariant checks wrapped around one pool instance."""

    def __init__(self, pool):
        self.pool = pool
        self.violations: List[Violation] = []
        # id(rep) → (rep, high-water clock). Holding the replica ref
        # keeps ids stable (a gc'd dead replica could otherwise recycle
        # its id onto a fresh one and inherit its high-water mark).
        self._clock_high: Dict[int, Tuple[object, float]] = {}
        self._completed_rids: Set[int] = set()
        self._completed_cursor = 0
        self._wrap_pool()

    # ------------------------------------------------------------ helpers
    def _violate(self, kind: str, detail: str):
        self.violations.append(Violation(kind, detail))

    def assert_clean(self):
        if self.violations:
            lines = "\n".join(str(v) for v in self.violations[:20])
            raise AssertionError(
                f"sanitizer recorded {len(self.violations)} violation(s):\n"
                f"{lines}")

    def report(self) -> List[str]:
        return [str(v) for v in self.violations]

    # ------------------------------------------------------- seam wiring
    def _wrap_pool(self):
        pool = self.pool
        self._wrap(pool, "_step_replica", self._around_step)
        if hasattr(pool, "_step_group"):
            # megabatched cohort stepping (ShardedVectorPool):
            # the clock/completion checks land per cohort member
            self._wrap(pool, "_step_group", self._around_step_group)
        self._wrap(pool, "kill_replica", self._around_kill)
        self._wrap(pool, "run_until", self._around_run_until)
        if hasattr(pool, "drain_replica"):
            self._wrap(pool, "drain_replica", self._around_drain)
        for name in ("add_replica", "spawn_replica"):
            if hasattr(pool, name):
                self._wrap(pool, name, self._around_spawn)
        if hasattr(pool, "_move_replica"):
            self._wrap(pool, "_move_replica", self._around_move)
        if hasattr(pool, "shards"):
            for name in ("insert_local", "migrate_entries",
                         "drop_shard_cache", "restore_entries"):
                self._wrap(pool.shards, name, self._around_index_mutation)

    @staticmethod
    def _wrap(obj, name: str, around: Callable):
        inner = getattr(obj, name)

        def wrapped(*args, __inner=inner, __around=around, **kwargs):
            return __around(__inner, *args, **kwargs)

        setattr(obj, name, wrapped)

    # ----------------------------------------------------------- checks
    def _around_step(self, inner, rep, t_end):
        before = rep.clock
        out = inner(rep, t_end)
        _, high = self._clock_high.get(id(rep), (rep, before))
        high = max(high, before)
        if rep.clock < high - 1e-12:
            self._violate(
                "clock",
                f"replica rid={rep.rid} clock moved backwards: "
                f"{high:.9f} -> {rep.clock:.9f}")
        self._clock_high[id(rep)] = (rep, max(high, rep.clock))
        self._scan_completions()
        return out

    def _around_step_group(self, inner, cohort, t_end):
        before = [(rep, rep.clock) for rep in cohort]
        out = inner(cohort, t_end)
        for rep, b in before:
            _, high = self._clock_high.get(id(rep), (rep, b))
            high = max(high, b)
            if rep.clock < high - 1e-12:
                self._violate(
                    "clock",
                    f"replica rid={rep.rid} clock moved backwards in a "
                    f"grouped step: {high:.9f} -> {rep.clock:.9f}")
            self._clock_high[id(rep)] = (rep, max(high, rep.clock))
        self._scan_completions()
        return out

    def _scan_completions(self):
        comp = self.pool.metrics.completed
        while self._completed_cursor < len(comp):
            req = comp[self._completed_cursor]
            self._completed_cursor += 1
            if req.rid in self._completed_rids:
                self._violate(
                    "completion",
                    f"rid={req.rid} kind={req.kind} completed twice")
            self._completed_rids.add(req.rid)
            if req.t_completed is None:
                self._violate(
                    "completion",
                    f"rid={req.rid} landed in metrics.completed without "
                    "a completion time")

    # --- kill: nothing in flight on the victim is silently dropped ------
    def _around_kill(self, inner, idx):
        pool = self.pool
        victim = pool.replicas[idx]
        in_flight = dict(victim.in_flight)
        snapshots = dict(victim.snapshots)
        rescue = bool(getattr(pool.cfg, "rescue_enabled", False))
        out = inner(idx)
        self._scan_completions()
        queued = self._queued_rids()
        pending = {r.rid for _, _, r in pool._pending}
        for rid, req in in_flight.items():
            if rid in queued or rid in pending:
                if rescue and snapshots.get(rid) is not None \
                        and req.checkpoint is None:
                    self._violate(
                        "checkpoint",
                        f"rid={rid} had a rescue snapshot but re-queued "
                        "with no checkpoint attached")
                continue
            if self._resolved_elsewhere(req):
                continue
            self._violate(
                "checkpoint",
                f"rid={rid} kind={req.kind} was in flight on killed "
                f"replica rid={victim.rid} and is nowhere afterwards "
                "(not queued, not pending, not completed)")
        self._check_gids()
        return out

    def _resolved_elsewhere(self, req) -> bool:
        """A victim's in-flight request that is neither queued nor
        pending must have completed — as itself, or (sharded children)
        through its parent's fan-out resolving without it."""
        if req.t_completed is not None or req.rid in self._completed_rids:
            return True
        parent_rid = getattr(req, "parent_rid", None)
        if parent_rid is None:
            return False
        fan = getattr(self.pool, "_fanout", {}).get(parent_rid)
        if fan is None:
            # parent already finalized (or cancelled) — the child's
            # obligation is discharged
            return True
        # hedge pair: the twin still owns the shard
        return req.shard not in fan.pending

    def _queued_rids(self) -> Set[int]:
        pool = self.pool
        scheds = getattr(pool, "schedulers", None) or [pool.scheduler]
        out: Set[int] = set()
        for sched in scheds:
            for req in sched.queued_requests():
                out.add(req.rid)
        return out

    # --- planned move: conservation, checkpoint-intact ------------------
    def _around_move(self, inner, src, dst, t, exclude=None):
        pool = self.pool
        before_flight: Dict[int, object] = {}
        for rep in pool.shard_replicas(src):
            if rep is not exclude:
                before_flight.update(rep.in_flight)
        before_queued = self._queued_rids()
        out = inner(src, dst, t, exclude=exclude)
        after_queued = self._queued_rids()
        after_flight: Set[int] = set()
        for rep in pool.replicas:
            after_flight.update(rep.in_flight)
        for rid, req in before_flight.items():
            if rid in after_flight:
                continue  # stayed on a non-donor replica
            if rid not in after_queued:
                self._violate(
                    "checkpoint",
                    f"rid={rid} was in flight on shard {src} before a "
                    "planned move and is neither in flight nor queued "
                    "afterwards")
            elif rid not in before_queued and req.checkpoint is None:
                self._violate(
                    "checkpoint",
                    f"rid={rid} re-queued by a planned move WITHOUT its "
                    "checkpoint — moves must preserve progress")
        self._check_gids()
        return out

    # --- scaling actions: replica-count conservation --------------------
    def _around_drain(self, inner, *args, **kwargs):
        """A drain removes EXACTLY one replica (or none, when refused),
        never breaches a serving floor, and every request that was in
        flight on the donor is re-queued checkpoint-intact (or pending /
        already completed) — an autoscaler scale-down must be invisible
        to request outcomes."""
        pool = self.pool
        n_before = len(pool.replicas)
        before_flight: Dict[int, object] = {}
        for rep in pool.replicas:
            before_flight.update(rep.in_flight)
        before_queued = self._queued_rids()
        out = inner(*args, **kwargs)
        self._scan_completions()
        n_after = len(pool.replicas)
        delta = n_after - n_before
        if delta != (-1 if out else 0):
            self._violate(
                "replica",
                f"drain_replica returned {out!r} but replica count moved "
                f"{n_before} -> {n_after}")
        if out:
            self._check_floors()
            after_queued = self._queued_rids()
            pending = {r.rid for _, _, r in pool._pending}
            after_flight: Set[int] = set()
            for rep in pool.replicas:
                after_flight.update(rep.in_flight)
            for rid, req in before_flight.items():
                if rid in after_flight:
                    continue  # survived on a non-donor replica
                if rid not in after_queued and rid not in pending \
                        and not self._resolved_elsewhere(req):
                    self._violate(
                        "replica",
                        f"rid={rid} kind={req.kind} was in flight before "
                        "a drain and is nowhere afterwards (not queued, "
                        "not pending, not completed)")
                elif rid in after_queued and rid not in before_queued \
                        and req.checkpoint is None:
                    self._violate(
                        "replica",
                        f"rid={rid} re-queued by a drain WITHOUT its "
                        "checkpoint — drains must preserve progress")
        self._check_gids()
        return out

    def _around_spawn(self, inner, *args, **kwargs):
        pool = self.pool
        n_before = len(pool.replicas)
        out = inner(*args, **kwargs)
        n_after = len(pool.replicas)
        if n_after != n_before + 1:
            self._violate(
                "replica",
                f"spawn moved replica count {n_before} -> {n_after} "
                "(want exactly +1)")
        return out

    def _check_floors(self):
        pool = self.pool
        if hasattr(pool, "shards"):
            for s in range(pool.shards.num_shards):
                n = len(pool.shard_replicas(s))
                if n < pool.shard_floor(s):
                    self._violate(
                        "replica",
                        f"shard {s} at {n} replicas, below its serving "
                        f"floor {pool.shard_floor(s)}")
        elif len(pool.replicas) < pool.drain_floor():
            self._violate(
                "replica",
                f"pool at {len(pool.replicas)} replicas, below its "
                f"serving floor {pool.drain_floor()}")

    # --- cache gid uniqueness -------------------------------------------
    def _around_index_mutation(self, inner, *args, **kwargs):
        out = inner(*args, **kwargs)
        self._check_gids()
        return out

    def _check_gids(self):
        shards = getattr(self.pool, "shards", None)
        if shards is None:
            return
        seen: Dict[int, Tuple[int, int]] = {}
        for s, gmap in enumerate(shards._global_of):
            # cache gids only: tombstones (-1) and frozen corpus rows
            # (< n) are skipped, in one pass over the map
            gmap = np.asarray(gmap)
            for local in np.flatnonzero(gmap >= shards.n).tolist():
                gid = int(gmap[local])
                if gid in seen:
                    self._violate(
                        "gid",
                        f"cache gid {gid} live on two locations: "
                        f"{seen[gid]} and {(s, local)}")
                    continue
                seen[gid] = (s, local)
                if shards._gid_loc.get(gid) != (s, local):
                    self._violate(
                        "gid",
                        f"cache gid {gid} at {(s, local)} but _gid_loc "
                        f"says {shards._gid_loc.get(gid)}")
        for gid, loc in shards._gid_loc.items():
            if seen.get(gid) != loc:
                self._violate(
                    "gid",
                    f"_gid_loc maps gid {gid} to {loc} but the shard map "
                    f"holds {seen.get(gid)}")
        for gid in seen:
            if gid >= shards._next_cache_gid:
                self._violate(
                    "gid",
                    f"live cache gid {gid} >= next allocation counter "
                    f"{shards._next_cache_gid} (id reuse ahead)")

    def _around_run_until(self, inner, t_end):
        out = inner(t_end)
        self._scan_completions()
        self._check_gids()
        self._check_cache_meta()
        return out

    def _check_cache_meta(self):
        """At a quiescent point (end of ``run_until``) every answer-cache
        payload must reference a live gid — metadata for an evicted or
        lost entry is a stale-serving hazard."""
        shards = getattr(self.pool, "shards", None)
        if shards is None:
            return
        backup = getattr(self.pool, "_cache_backup", {})
        for gid in self.pool.cache_meta:
            if gid not in shards._gid_loc and gid not in backup:
                self._violate(
                    "gid",
                    f"cache_meta holds payload for gid {gid} which is "
                    "neither live on any shard nor host-backed")

    # ------------------------------------------------ cluster-level hook
    def attach_cluster(self, sim):
        """Additionally wrap a :class:`ClusterSim` that owns this pool:
        after every completion sweep, each callback still registered in
        ``_probe_cb`` must reference a probe that is live inside the
        pool — an entry whose probe vanished (killed instance whose
        teardown missed it) would wait forever."""
        self._wrap(sim, "_collect_pool_completions",
                   lambda inner: self._after_collect(inner, sim))

    def _after_collect(self, inner, sim):
        out = inner()
        live = self._live_probe_rids()
        for rid in sim._probe_cb:
            if rid not in live:
                self._violate(
                    "probe",
                    f"orphaned probe callback: rid={rid} is registered "
                    "in _probe_cb but no live pool request carries it")
        return out

    def _live_probe_rids(self) -> Set[int]:
        pool = self.pool
        live = {r.rid for _, _, r in pool._pending}
        live |= self._queued_rids()
        if hasattr(pool, "_fanout"):
            live |= set(pool._fanout.keys())
        for rep in pool.replicas:
            live |= set(rep.in_flight.keys())
        # completions scanned this sweep have already had their
        # callbacks popped; anything still completing this instant is
        # in metrics.completed and no longer in _probe_cb
        live |= self._completed_rids
        live |= {r.rid for r in pool.metrics.completed}
        return live
