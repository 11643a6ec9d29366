"""Event-driven cluster simulator: PD-disaggregated LLM pools + the Trinity
vector pool, wired per a Fig. 2 placement.

The vector pool is the port's real pool on ``device`` (its engines run
the distance kernel on the card); queueing, links, failures and the closed
control loop (u_kv, prefill P95 wait, decode stalls → adaptive r/τ_pre)
evolve in simulated time, with prefill, decode and extend latencies from
the roofline timing model priced on ``hw`` (``V5E``, as in the JAX
package). Those latencies are model outputs, not times of any card.

Differences from the JAX package's ``ClusterSim``: the constructor takes
``device`` (default ``"cuda"``) in place of ``use_pallas`` and hands it to
the pool it builds; for a sharded pool it also forwards the port-only
``shard_index`` (a prebuilt ``ShardedIndex``, e.g. a ``clone()`` whose
graphs need not be built again) and ``exact_threshold`` (the shard row
count up to which the shard graphs are exact kNN, as the card builds
them).

Semantic answer cache (``pool_cfg.semantic_cache_enabled``): arrivals
first probe the vector pool with a ``cache_lookup``-class request over the
prompt embedding. A hit under the class score threshold serves the cached
answer immediately — no prefill, no KV transfer, no decode (TTFT = lookup
round trip; ``cache_hits``/``saved_prefill_tokens`` count the win). A miss
takes the normal PD path and, at completion, asynchronously inserts the
(prompt embedding → answer) pair into the pool's growable cache segment as
a deadline-less background-class request. Requests sharing a
``prompt_id`` embed identically, so repeated prompts hit.

Fault tolerance at pool level:
  · kill_prefill/kill_decode at time t — in-flight work re-queues; decode
    victims lose device KV and re-prefill (counted),
  · stragglers: slowdown factors; the dispatcher routes new work away from
    instances whose step EWMA exceeds ``straggler_factor``× the pool median,
  · elastic decode scaling on queue depth (optional).
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import AutoscalerConfig
from repro_torch.core.architectures import make_placements
from repro_torch.core.roofline_model import V5E, Hardware
from repro_torch.core.scheduler import VectorRequest
from repro_torch.core.trinity_pool import ShardedVectorPool, VectorPool
from repro_torch.serving.autoscaler import Autoscaler
from repro_torch.serving.engine import DecodeInstance, PrefillInstance
from repro_torch.serving.kv_cache import kv_bytes_per_token
from repro_torch.serving.kv_link import KVLink
from repro_torch.serving.request import (ClusterMetrics, GenRequest, ScaleEvent,
                                   percentile)


class ClusterSim:
    def __init__(self, model_cfg, pool_cfg, db, graph, *,
                 placement: str = "disaggregated", policy: str = "trinity",
                 n_prefill: int = 2, n_decode: int = 4,
                 vector_replicas: int = 1, chips_per_instance: int = 8,
                 decode_batch: int = 32, kv_link_bw: float = 40e9,
                 hw: Hardware = V5E, poll_dt: float = 2e-4,
                 straggler_factor: float = 2.5, elastic_decode: bool = False,
                 autoscaler: Optional[AutoscalerConfig] = None,
                 device="cuda", seed: int = 0, shard_index=None,
                 exact_threshold: int = 20000):
        self.cfg = model_cfg
        self.pool_cfg = pool_cfg
        self.hw = hw
        self.poll_dt = poll_dt
        self.placement = make_placements(hw, chips_per_instance)[placement]
        pl = self.placement

        self.prefill_pool = [
            PrefillInstance(i, model_cfg, chips_per_instance, hw=hw,
                            capacity_factor=pl.llm_capacity_factor_prefill,
                            contention=(pl.hbm_contention_factor
                                        if pl.llm_capacity_factor_prefill < 1
                                        else 1.0))
            for i in range(n_prefill)]
        self.decode_pool = [
            DecodeInstance(i, model_cfg, chips_per_instance,
                           max_batch=decode_batch, hw=hw,
                           capacity_factor=pl.llm_capacity_factor_decode,
                           contention=(pl.hbm_contention_factor
                                       if pl.llm_capacity_factor_decode < 1
                                       else 1.0),
                           ep_penalty=pl.ep_dispatch_penalty)
            for i in range(n_decode)]
        if pool_cfg is not None and pool_cfg.num_shards > 1:
            # sharded scatter–gather pool: the corpus is partitioned into
            # balanced-k-means shards (it may exceed one replica's
            # replica_max_rows capacity); ``vector_replicas`` becomes the
            # per-shard replica count and ``graph`` is unused (each shard
            # builds its own)
            self.vector_pool = ShardedVectorPool(
                pool_cfg, db, replicas_per_shard=vector_replicas,
                policy=policy, device=device, seed=seed,
                shard_index=shard_index, exact_threshold=exact_threshold)
        else:
            self.vector_pool = VectorPool(pool_cfg, db, graph,
                                          replicas=vector_replicas,
                                          policy=policy, device=device,
                                          seed=seed)
        self.kv_link = KVLink(bandwidth=kv_link_bw)

        self.prefill_queue: deque[GenRequest] = deque()
        self.decode_queue: deque[GenRequest] = deque()
        self.metrics = ClusterMetrics()
        self.straggler_factor = straggler_factor
        self.elastic_decode = elastic_decode
        self.max_decode_instances = n_decode * 2
        self._events: list = []
        self._eseq = itertools.count()
        self._probe_cb: Dict[int, Callable] = {}
        self._pool_cursor = 0
        self._recent_stalls: deque = deque(maxlen=256)
        self.t_now = 0.0
        self._chips = chips_per_instance
        # closed-loop SLO autoscaler (goodput control plane). None (the
        # default) schedules nothing and changes no seam — bit-identical
        # to a build without the subsystem
        self.autoscaler: Optional[Autoscaler] = None
        self._autoscale_scheduled = False
        if autoscaler is not None:
            self.metrics.set_window(autoscaler.window_s)
            self.autoscaler = Autoscaler(self, autoscaler)
        if self.vector_pool.sanitizer is not None:
            # extend the pool's invariant layer with the cluster-level
            # orphaned-probe check (no-op when sanitizer_enabled is off)
            self.vector_pool.sanitizer.attach_cluster(self)

    # ------------------------------------------------------------- events
    def schedule(self, t: float, fn: Callable):
        heapq.heappush(self._events, (max(t, self.t_now), next(self._eseq), fn))

    def run(self, until: float):
        self.schedule(self.t_now, self._poll_pool)
        if self.autoscaler is not None and not self._autoscale_scheduled:
            self._autoscale_scheduled = True
            self.schedule(self.t_now + self.autoscaler.cfg.epoch_s,
                          self._autoscale_epoch)
        while self._events and self._events[0][0] <= until:
            t, _, fn = heapq.heappop(self._events)
            self.t_now = t
            fn()
        self.t_now = until
        self.vector_pool.run_until(until)
        self._collect_pool_completions()

    # ------------------------------------------------------------ arrival
    @property
    def _cache_enabled(self) -> bool:
        return (self.pool_cfg is not None
                and self.pool_cfg.semantic_cache_enabled)

    def arrive(self, req: GenRequest):
        def _on_arrival():
            # answer-cache lookup gates the whole PD pipeline; an empty
            # cache segment is a guaranteed (and free) miss
            if self._cache_enabled and self.vector_pool.cache_size > 0:
                self._submit_probe(req, "cache_lookup",
                                   self._after_cache_lookup)
            else:
                self._start_miss_path(req)

        self.schedule(req.t_arrival, _on_arrival)

    def _start_miss_path(self, req: GenRequest):
        """The pre-cache arrival path: prefill RAG probe, then prefill."""
        if req.prefill_rag and self.pool_cfg is not None:
            self._submit_probe(req, "prefill", self._after_prefill_rag)
        else:
            self._enqueue_prefill(req)

    def _after_prefill_rag(self, req: GenRequest, vreq: VectorRequest):
        req.t_retrieval_done = self.t_now
        self._enqueue_prefill(req)

    # ----------------------------------------------------- semantic cache
    def _after_cache_lookup(self, req: GenRequest, vreq: VectorRequest):
        req.t_cache_done = self.t_now
        thr = self.vector_pool.scheduler.classes["cache_lookup"] \
            .score_threshold
        meta = None
        if vreq.result_ids is not None and vreq.result_dists is not None:
            t_fixed = (vreq.t_completed if vreq.t_completed is not None
                       else self.t_now)
            for row, dist in zip(vreq.result_ids, vreq.result_dists):
                if float(dist) <= thr:
                    # meta_at guards slot reuse: a row evicted and
                    # re-filled after this lookup completed must not serve
                    # the new occupant's answer for the old query
                    meta = self.vector_pool.meta_at(int(row), t_fixed)
                    if meta is not None:
                        break
        if meta is None:
            self._start_miss_path(req)
            return
        # hit: serve the cached answer — the entire prefill→KV→decode
        # pipeline is skipped. The answer itself is NOT free: its tokens
        # ship over the shared KV link (answer_bytes_per_token each), so a
        # hit landing while a multi-MB prefill KV transfer is in flight
        # queues behind it — TTFT = lookup round trip + transfer
        req.cache_hit = True
        req.tokens_out = int(meta["tokens"])
        self.metrics.cache_hits += 1
        self.metrics.saved_prefill_tokens += req.prompt_len
        nbytes = req.tokens_out * self.pool_cfg.answer_bytes_per_token
        t_ready = self.kv_link.transfer(self.t_now, nbytes) \
            if nbytes else self.t_now

        def _serve(r=req):
            r.t_first_token = self.t_now
            r.t_done = self.t_now
            self.metrics.record_finish(r)

        self.schedule(t_ready, _serve)

    def _finish_generation(self, req: GenRequest):
        """Completion hook: async-insert the (prompt embedding → answer)
        pair as a background-class request (cache misses only)."""
        req.t_done = self.t_now
        self.metrics.record_finish(req)
        if self._cache_enabled:
            self.vector_pool.submit_insert(
                self._prompt_embedding(req),
                meta={"tokens": req.tokens_out,
                      "prompt_id": req.prompt_id
                      if req.prompt_id is not None else req.rid},
                t_now=self.t_now)

    # ------------------------------------------------------------ prefill
    def _enqueue_prefill(self, req: GenRequest):
        self.prefill_queue.append(req)
        self._try_start_prefill()

    def _healthy(self, pool):
        # "serving" = alive and not draining/retired: a draining instance
        # finishes its in-flight work but takes no NEW admissions (both
        # flags are always False outside an autoscaler drain)
        ew = [i.health.step_ewma for i in pool if i.health.serving]
        med = np.median([e for e in ew if e > 0]) if any(e > 0 for e in ew) else 0
        out = []
        for inst in pool:
            if not inst.health.serving:
                continue
            if med and inst.health.step_ewma > self.straggler_factor * med:
                continue  # straggler: route around it
            out.append(inst)
        return out or [i for i in pool if i.health.serving]

    def _try_start_prefill(self):
        for inst in self._healthy(self.prefill_pool):
            if inst.busy_until > self.t_now or not self.prefill_queue:
                continue
            batch, tokens = [], 0
            while self.prefill_queue and tokens < inst.max_batch_tokens:
                r = self.prefill_queue[0]
                if batch and tokens + r.prompt_len > inst.max_batch_tokens:
                    break
                batch.append(self.prefill_queue.popleft())
                tokens += r.prompt_len
            if not batch:
                continue
            t_done = inst.start_batch(self.t_now, batch)
            self.schedule(t_done, lambda i=inst, b=batch: self._finish_prefill(i, b))

    def _finish_prefill(self, inst: PrefillInstance, batch: List[GenRequest]):
        inst.current = []
        if inst.health.draining:
            self._retire_instance("prefill", inst)
        for req in batch:
            req.t_prefill_done = self.t_now
            nbytes = req.prompt_len * kv_bytes_per_token(self.cfg)
            t_kv = self.kv_link.transfer(self.t_now, nbytes) \
                if nbytes else self.t_now
            self.schedule(t_kv, lambda r=req: self._kv_arrived(r))
        self._try_start_prefill()

    # ------------------------------------------------------------- decode
    def _kv_arrived(self, req: GenRequest):
        req.t_kv_arrived = self.t_now
        self.decode_queue.append(req)
        self._try_admit_decode()

    def _try_admit_decode(self):
        for inst in self._healthy(self.decode_pool):
            while self.decode_queue and inst.can_admit(self.decode_queue[0]):
                inst.admit(self.decode_queue.popleft())
            if inst.active and not inst.stepping:
                inst.stepping = True
                self.schedule(self.t_now + inst.step_time(self.t_now),
                              lambda i=inst: self._decode_step(i))
        if self.elastic_decode and len(self.decode_queue) > 4 * max(
                1, len(self.decode_pool)) and \
                len(self.decode_pool) < self.max_decode_instances:
            # audited (no fire-and-forget scaling): the ScaleEvent records
            # the queue depth that triggered this add
            self.add_decode_instance(reason="elastic_decode_queue",
                                     signal=float(len(self.decode_queue)))

    def _decode_step(self, inst: DecodeInstance):
        if not inst.health.alive:
            return
        done = []
        for req in list(inst.active.values()):
            if self.t_now < req.stalled_until:
                continue  # stalled on a RAG probe: no token this step
            req.tokens_out += 1
            inst.tokens_emitted += 1
            req.token_times.append(self.t_now)
            if req.t_first_token is None:
                req.t_first_token = self.t_now
            if req.rag_interval and req.tokens_out < req.max_new_tokens and \
                    req.tokens_out % req.rag_interval == 0:
                req.stalled_until = float("inf")
                self._submit_probe(req, "decode", self._after_decode_rag)
            if req.tokens_out >= req.max_new_tokens:
                done.append(req)
        for req in done:
            inst.release(req)
            self._finish_generation(req)
        if inst.active:
            self.schedule(self.t_now + inst.step_time(self.t_now),
                          lambda: self._decode_step(inst))
        else:
            inst.stepping = False
            if inst.health.draining:
                self._retire_instance("decode", inst)
        self._try_admit_decode()

    def _after_decode_rag(self, req: GenRequest, vreq: VectorRequest):
        stall = self.t_now - (vreq.t_arrival)
        req.stall_time += stall
        req.stalled_until = self.t_now
        self._recent_stalls.append(stall)

    # ------------------------------------------------------- vector pool
    # probe rid spaces per retrieval class: rids derive from the GENERATION
    # request identity, so probe streams (and the engine entry keys folded
    # from them) are reproducible across runs/arms even when another class
    # (cache lookups) adds or removes probes in between. Windows are sized
    # so classes can never collide with each other or with the pool's
    # insert rid space (1 << 28): base + rid·4096 + tokens_out < base + 2³²
    _PROBE_RID_BASE = {"prefill": 1 << 32, "decode": 2 << 32,
                       "cache_lookup": 3 << 32}

    def _probe_rid(self, req: GenRequest, kind: str) -> int:
        if req.rid >= (1 << 20) or req.tokens_out >= 4096:
            raise ValueError(
                f"probe rid window exceeded (rid={req.rid}, "
                f"tokens_out={req.tokens_out}); widen _PROBE_RID_BASE")
        return self._PROBE_RID_BASE[kind] + req.rid * 4096 + req.tokens_out

    def _submit_probe(self, req: GenRequest, kind: str, cb: Callable):
        rclass = self.vector_pool.scheduler.classes[kind]
        # cache lookups are issued from the request front-end, prefill-side
        rtt = (self.placement.decode_rtt if kind == "decode"
               else self.placement.prefill_rtt)
        rid = self._probe_rid(req, kind)
        ddl = self.t_now + rclass.deadline_ms / 1e3
        qvec = (self._prompt_embedding(req) if kind == "cache_lookup"
                else self._query_for(req))
        vreq = VectorRequest(rid, kind, qvec, self.t_now + rtt / 2, ddl,
                             est_extends=rclass.est_extends)
        self._probe_cb[rid] = (req, cb, rtt)
        self.vector_pool.submit(vreq)

    def _query_for(self, req: GenRequest) -> np.ndarray:
        rng = np.random.default_rng(req.rid * 7919 + req.tokens_out)
        n = self.vector_pool.db.shape[0]
        base = self.vector_pool.db[rng.integers(0, n)]
        return np.asarray(base) + rng.normal(0, 0.1, size=base.shape).astype(
            np.float32)

    def _prompt_embedding(self, req: GenRequest) -> np.ndarray:
        """Deterministic per-prompt embedding: requests sharing a
        ``prompt_id`` embed identically (repeats of one prompt), so a
        cached answer's embedding is bit-equal to its repeat lookups."""
        pid = req.prompt_id if req.prompt_id is not None else req.rid
        rng = np.random.default_rng(0xC0FFEE + pid * 7919)
        n = self.vector_pool.db.shape[0]
        base = self.vector_pool.db[rng.integers(0, n)]
        return (np.asarray(base, np.float32)
                + rng.normal(0, 0.05, size=base.shape)).astype(np.float32)

    def _poll_pool(self):
        self.vector_pool.run_until(self.t_now)
        self._collect_pool_completions()
        self._update_feedback()
        self.schedule(self.t_now + self.poll_dt, self._poll_pool)

    def _collect_pool_completions(self):
        comp = self.vector_pool.metrics.completed
        while self._pool_cursor < len(comp):
            vreq = comp[self._pool_cursor]
            self._pool_cursor += 1
            entry = self._probe_cb.pop(vreq.rid, None)
            if entry is None:
                continue
            req, cb, rtt = entry
            self.schedule(max(self.t_now, vreq.t_completed + rtt / 2),
                          lambda r=req, v=vreq, c=cb: c(r, v))

    def _update_feedback(self):
        fb = self.vector_pool.feedback
        fb.u_kv = self.kv_link.utilization(self.t_now)
        pre_waits = [v.wait for v in self.vector_pool.metrics.completed[-128:]
                     if v.kind == "prefill"]
        fb.prefill_p95_wait = percentile(pre_waits, 95) if pre_waits else 0.0
        if self._recent_stalls:
            # stall fraction proxy: stall per Δ tokens of decode time.
            # Median step EWMA over ALIVE decode instances — instance 0 may
            # be dead (kill_decode(0)) or a straggler, and its stale EWMA
            # would skew the stall fraction for the whole control loop.
            avg_stall = float(np.mean(self._recent_stalls))
            ew = [i.health.step_ewma for i in self.decode_pool
                  if i.health.alive and not i.health.retired
                  and i.health.step_ewma > 0]
            step = float(np.median(ew)) if ew else 1e-3
            delta = max(1, next((r.rag_interval for i in self.decode_pool
                                 for r in i.active.values()), 64))
            fb.decode_stall_frac = avg_stall / max(avg_stall + step * delta,
                                                   1e-9)
        # surface pool-level preemption + rebalance counters for cluster
        # summaries (per-shard p95 wait keys exist only for sharded pools)
        pm = self.vector_pool.metrics
        self.metrics.pool_preemptions = pm.preemptions
        self.metrics.pool_resumes = pm.resumes
        self.metrics.pool_rebalances = pm.rebalances
        self.metrics.pool_migrations = pm.migrated_entries
        self.metrics.pool_shard_p95_wait = {
            s: pm.shard_p95_wait(s) for s in sorted(pm.shard_waits)}
        # failure-recovery counters (chaos / high-availability serving).
        # probes_cancelled adds the pool's own count (hedge losers are
        # counted separately as hedges_wasted) to cluster-side teardowns.
        self.metrics.pool_replica_deaths = pm.replica_deaths
        self.metrics.pool_shard_losses = pm.shard_losses
        self.metrics.pool_shard_reassignments = pm.shard_reassignments
        self.metrics.pool_rescued = pm.rescued
        self.metrics.pool_retries = pm.retries
        self.metrics.pool_retries_exhausted = pm.retries_exhausted
        self.metrics.pool_hedges = pm.hedges
        self.metrics.pool_hedges_won = pm.hedges_won
        self.metrics.pool_hedges_wasted = pm.hedges_wasted
        self.metrics.probes_cancelled = pm.probes_cancelled
        self.metrics.cache_entries_recovered = pm.cache_recovered
        self.metrics.cache_entries_lost = pm.cache_lost

    # ------------------------------------------- autoscaler control plane
    def _autoscale_epoch(self):
        self.autoscaler.epoch()
        self.schedule(self.t_now + self.autoscaler.cfg.epoch_s,
                      self._autoscale_epoch)

    def gpu_units(self) -> int:
        """Instance-unit GPU accounting for the fixed autoscaler budget
        (1 unit = one prefill/decode instance or one vector replica).
        Draining instances still hold their unit until retired; dead and
        retired instances hold nothing."""
        llm = sum(1 for i in self.prefill_pool + self.decode_pool
                  if i.health.alive and not i.health.retired)
        return llm + len(self.vector_pool.replicas)

    def _scale_event(self, pool: str, delta: int, reason: str,
                     signal: float):
        self.metrics.scale_events.append(
            ScaleEvent(self.t_now, pool, delta, reason, float(signal)))

    def _retire_instance(self, pool_name: str, inst):
        """A drained instance emptied: it stops counting against the GPU
        budget (it stays in the pool list so chaos closures keep stable
        indices) and the autoscaler may re-grant the freed unit."""
        inst.health.draining = False
        inst.health.retired = True
        if self.autoscaler is not None:
            self.autoscaler.on_drain_complete(pool_name, self.t_now)

    def add_prefill_instance(self, *, reason: str = "manual",
                             signal: float = 0.0,
                             kick: bool = False) -> PrefillInstance:
        """Scale-up actuator: a fresh prefill instance with the SAME
        placement-derived capacity/contention as the initial pool."""
        pl = self.placement
        inst = PrefillInstance(
            len(self.prefill_pool), self.cfg, self._chips, hw=self.hw,
            capacity_factor=pl.llm_capacity_factor_prefill,
            contention=(pl.hbm_contention_factor
                        if pl.llm_capacity_factor_prefill < 1 else 1.0))
        self.prefill_pool.append(inst)
        self._scale_event("prefill", +1, reason, signal)
        if kick:
            self._try_start_prefill()
        return inst

    def add_decode_instance(self, *, reason: str = "manual",
                            signal: float = 0.0,
                            kick: bool = False) -> DecodeInstance:
        """Scale-up actuator (also the elastic-decode path): scaled-up
        instances get the SAME placement-derived capacity loss / HBM
        contention / EP penalty as the initial pool — colocated
        placements must not gain anomalously fast replicas."""
        pl = self.placement
        inst = DecodeInstance(
            len(self.decode_pool), self.cfg, self._chips,
            max_batch=self.decode_pool[0].max_batch, hw=self.hw,
            capacity_factor=pl.llm_capacity_factor_decode,
            contention=(pl.hbm_contention_factor
                        if pl.llm_capacity_factor_decode < 1 else 1.0),
            ep_penalty=pl.ep_dispatch_penalty)
        self.decode_pool.append(inst)
        self._scale_event("decode", +1, reason, signal)
        if kick:
            self._try_admit_decode()
        return inst

    def drain_prefill_instance(self, *, reason: str = "manual",
                               signal: float = 0.0
                               ) -> Optional[PrefillInstance]:
        """Graceful scale-down: the least-loaded serving prefill instance
        stops taking admissions, finishes its running batch, then
        retires. Refuses (None) rather than drain the last one."""
        cands = [i for i in self.prefill_pool if i.health.serving]
        if len(cands) <= 1:
            return None
        inst = min(cands, key=lambda i: (len(i.current), i.iid))
        inst.health.draining = True
        self._scale_event("prefill", -1, reason, signal)
        if not inst.current and inst.busy_until <= self.t_now:
            self._retire_instance("prefill", inst)
        return inst

    def drain_decode_instance(self, *, reason: str = "manual",
                              signal: float = 0.0
                              ) -> Optional[DecodeInstance]:
        """Graceful scale-down: the least-loaded serving decode instance
        stops admitting but keeps stepping its active requests to
        completion — device KV is per-instance, so a drain (unlike a
        kill) forces zero re-prefills and loses nothing. Refuses (None)
        rather than drain the last serving instance."""
        cands = [i for i in self.decode_pool if i.health.serving]
        if len(cands) <= 1:
            return None
        inst = min(cands, key=lambda i: (len(i.active), i.iid))
        inst.health.draining = True
        self._scale_event("decode", -1, reason, signal)
        if not inst.active:
            self._retire_instance("decode", inst)
        return inst

    def add_vector_replica(self, *, reason: str = "manual",
                           signal: float = 0.0):
        """Scale-up actuator: sharded pools spawn on the hottest shard
        (max load score — where the deficit is), monolithic pools join
        the shared index at the clock frontier."""
        pool = self.vector_pool
        if hasattr(pool, "shards"):
            t = self.t_now
            s = max(range(pool.shards.num_shards),
                    key=lambda i: (pool.shard_load_score(i, t), -i))
            pool.spawn_replica(s)
        else:
            pool.add_replica()
        self._scale_event("vector", +1, reason, signal)

    def drain_vector_replica(self, *, shard: Optional[int] = None,
                             reason: str = "manual",
                             signal: float = 0.0) -> bool:
        """Safe scale-down through the pool's checkpoint-intact drain
        (``drain_replica``): in-flight work re-queues with its progress,
        serving minimums hold. False when no replica can be drained.
        ``shard`` pins the donor shard (sharded pools; monolithic pools
        ignore it)."""
        ok = self.vector_pool.drain_replica(shard)
        if ok:
            self._scale_event("vector", -1, reason, signal)
        return ok

    # ----------------------------------------------------------- failures
    def _cancel_probes(self, req: GenRequest):
        """Tear down every in-flight vector-pool probe issued for ``req``:
        its instance died, nobody will consume the answers, and leaked
        probes burn extend budget competing against live traffic. (The
        re-prefill path re-issues what the retry actually needs.)"""
        for rid in [r for r, (g, _, _) in self._probe_cb.items() if g is req]:
            self._probe_cb.pop(rid)
            self.vector_pool.cancel(rid)

    def kill_prefill(self, idx: int):
        def _kill(inst=self.prefill_pool[idx]):
            inst.health.alive = False
            self.metrics.prefill_deaths += 1
            for req in inst.current:
                req.re_prefills += 1
                self._cancel_probes(req)
                self.prefill_queue.appendleft(req)
            inst.current = []
            if inst.health.draining:
                # a killed draining instance can never empty gracefully —
                # complete the drain now so a pending grant isn't stranded
                self._retire_instance("prefill", inst)
            self._try_start_prefill()
        return _kill

    def kill_decode(self, idx: int):
        def _kill(inst=self.decode_pool[idx]):
            inst.health.alive = False
            self.metrics.decode_deaths += 1
            for req in list(inst.active.values()):
                inst.release(req)
                req.re_prefills += 1
                req.stalled_until = 0.0
                self._cancel_probes(req)
                self.prefill_queue.append(req)  # device KV lost: re-prefill
            if inst.health.draining:
                self._retire_instance("decode", inst)
            self._try_start_prefill()
        return _kill

    def revive_prefill(self, idx: int):
        """Bring a killed prefill instance back (chaos downtime expiry)."""
        def _revive(inst=self.prefill_pool[idx]):
            inst.health.alive = True
            self._try_start_prefill()
        return _revive

    def revive_decode(self, idx: int):
        """Bring a killed decode instance back (chaos downtime expiry)."""
        def _revive(inst=self.decode_pool[idx]):
            inst.health.alive = True
            self._try_admit_decode()
        return _revive

    def set_decode_slowdown(self, idx: int, factor: float):
        def _slow(inst=self.decode_pool[idx]):
            inst.health.slowdown = factor
        return _slow

    def set_kv_bandwidth(self, factor: float):
        """Scale the prefill→decode KV link bandwidth by ``factor``
        (transient link degradation; factor > 1 restores)."""
        def _set():
            self.kv_link.bandwidth *= factor
        return _set


def make_sharded_pool_sim(model_cfg=None, *, num_vectors: int = 6000,
                          dim: int = 64, num_shards: int = 4,
                          replica_max_rows: int = 2600,
                          nprobe_shards: int = 0, seed: int = 11,
                          pool_overrides: Optional[dict] = None,
                          **cluster_kw):
    """The ``sharded_pool`` scenario: a ClusterSim whose retrieval corpus is
    deliberately sized PAST one replica's modeled HBM capacity
    (``replica_max_rows < num_vectors``) — a monolithic ``VectorPool``
    over it raises ``CapacityError``; the sharded scatter–gather pool
    serves it with per-shard inserts and zero global broadcasts.

    Returns (sim, db, queries). ``model_cfg=None`` uses the
    phi3-medium-14b smoke config. ``cluster_kw`` goes to ``ClusterSim``
    (``device`` among them, default ``"cuda"``).
    """
    import dataclasses as _dc

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import VectorPoolConfig
    from repro_torch.vector.dataset import make_dataset

    assert replica_max_rows < num_vectors, \
        "the scenario exists to exceed one replica's capacity"
    if model_cfg is None:
        model_cfg = get_smoke_config("phi3-medium-14b")
    pool_cfg = VectorPoolConfig(
        num_vectors=num_vectors, dim=dim, graph_degree=16, max_requests=16,
        top_m=32, parents_per_step=2, task_batch=2048, visited_slots=512,
        top_k=10, semantic_cache_enabled=True, cache_capacity=128,
        num_shards=num_shards, nprobe_shards=nprobe_shards,
        replica_max_rows=replica_max_rows)
    if pool_overrides:
        pool_cfg = _dc.replace(pool_cfg, **pool_overrides)
    db, queries = make_dataset(num_vectors, dim, num_clusters=32,
                               num_queries=256, seed=seed)
    defaults = dict(placement="disaggregated", policy="trinity",
                    n_prefill=2, n_decode=2, decode_batch=8, seed=seed)
    defaults.update(cluster_kw)
    sim = ClusterSim(model_cfg, pool_cfg, db, None, **defaults)
    return sim, db, queries
