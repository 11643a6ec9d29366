"""Trinity's shared vector-search pool at deployment scale: the port's
``core/trinity_pool.py::VectorPool`` over the configuration's corpus and
its exact-kNN graph, driven by a closed loop of clients.

Each client holds one retrieval outstanding and sends the next as soon
as the harness sees the last one complete; clients of the ``prefill``
class are the first ``clients.prefill``. A request is stamped on the
pool's own (simulated) clock, as the pool's deadlines and preemption
expect, and advanced one fused chunk at a time with ``run_until``; its
latency is read on the host's clock, from when it was due (its
predecessor seen complete) to when the harness sees it complete.

The window's throughput counts what completed inside it; its latencies
are those of every request due inside it, drained after the close.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import answers
from bench.check import Check
from bench.data import device_corpus, device_queries, subseeds

STEP = 1e-9  # run_until one chunk past the replica's clock


class Run:
    def __init__(self, config, traffic, limits, seed, device, tracer):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device, self.tracer = seed, torch.device(device), tracer
        self.record = {}

    # ------------------------------------------------------------ set-up
    def setup(self):
        from repro_torch.configs.base import VectorPoolConfig
        from repro_torch.core.scheduler import VectorRequest
        from repro_torch.core.trinity_pool import VectorPool
        from repro_torch.vector.graph import make_cagra_graph

        c, t = self.config, self.traffic
        # the corpus and its index are the deployment's, one data set for
        # every run; the queries, the engine's entry points and the sample
        # judged come from the run's seed
        s_data, s_graph = subseeds(c["corpus_seed"], 2)
        s_pool, s_query, self.s_check = subseeds(self.seed, 3)
        n, d = c["num_vectors"], c["dim"]
        centres, db = device_corpus(n, d, c["num_clusters"],
                                    c["cluster_noise"], s_data, self.device)
        self.db = db.cpu().numpy()
        del db
        self.graph = make_cagra_graph(self.db, c["pool"]["graph_degree"],
                                      exact_threshold=n, seed=s_graph,
                                      device=self.device)
        self.pcfg = VectorPoolConfig(num_vectors=n, dim=d, metric=c["metric"],
                                     **c["pool"])
        self.pool = VectorPool(self.pcfg, self.db, self.graph,
                               device=self.device, seed=s_pool)
        self.bank = device_queries(centres, t["query_bank"],
                                   c["cluster_noise"], s_query)
        self.VectorRequest = VectorRequest
        self.rep = self.pool.replicas[0]
        self.classes = (["prefill"] * t["clients"]["prefill"]
                        + ["decode"] * t["clients"]["decode"])
        self.ddl = {"prefill": self.pcfg.prefill_deadline_ms / 1e3,
                    "decode": self.pcfg.decode_deadline_ms / 1e3}
        self._wrap_chunks()
        if self.tracer.enabled:
            self._instrument()
        self.next_rid, self.next_q = 0, 0
        self.out = {}  # rid -> (client, t_due)
        self.seen = 0
        self.window_open = False
        self.win = None  # (start, end) of the window once it opens
        now = time.perf_counter()
        for client in range(len(self.classes)):
            self._submit(client, now)
        self._loop(t["warmup_s"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _wrap_chunks(self):
        eng = self.rep.engine
        step, tracer, chunks = eng.step_multi, self.tracer, []

        def timed(*a, **kw):
            t0 = time.perf_counter()
            with tracer.note("pool.step_multi"):
                out = step(*a, **kw)  # ends in the chunk's one host sync
            if self.window_open:
                chunks.append(time.perf_counter() - t0)
            return out

        eng.step_multi = timed
        self.chunks = chunks

    def _instrument(self):
        """The traced run only: keep each distance launch's task ids and
        slots while a segment is traced (two small copies on the card), to
        count its bytes after the window."""
        from repro_torch.kernels import ops

        tracer, kept, dist = self.tracer, [], ops.distance_tasks

        def distance_tasks(db, queries, task_ids, task_slot, *a, **kw):
            if tracer.recording:
                kept.append((task_ids.clone(), task_slot.clone()))
            return dist(db, queries, task_ids, task_slot, *a, **kw)

        ops.distance_tasks = distance_tasks
        self.distance_launches = kept

    def _submit(self, client, t_due):
        rid = self.next_rid
        self.next_rid += 1
        q = self.bank[self.next_q % len(self.bank)]
        self.next_q += 1
        kind = self.classes[client]
        clock = self.rep.clock
        self.pool.submit(self.VectorRequest(rid, kind, q, clock,
                                            clock + self.ddl[kind]))
        self.out[rid] = (client, t_due)

    def _collect(self, now, resubmit: bool):
        """Take the completions since the last look: a request due inside
        the window (``self.win``) gets its latency, whenever it completes;
        its client sends the next one with ``resubmit``."""
        done = self.pool.metrics.completed
        for req in done[self.seen:]:
            entry = self.out.pop(req.rid, None)
            if entry is None:  # answered twice: judged in check()
                continue
            client, t_due = entry
            if self.win and self.win[0] <= t_due <= self.win[1]:
                self.latency[req.kind].append(now - t_due)
                self.due_rids.append(req.rid)
            if resubmit:
                self._submit(client, now)
        n = len(done) - self.seen
        self.seen = len(done)
        return n

    def _loop(self, seconds):
        """Run the closed loop for ``seconds``: one fused chunk a step,
        then the completions. Returns (start, end) and the completions."""
        t0 = time.perf_counter()
        completed = 0
        while True:
            self.tracer.poll()
            with self.tracer.note("pool.run_until"):
                self.pool.run_until(self.rep.clock + STEP)
            now = time.perf_counter()
            with self.tracer.note("pool.clients"):
                completed += self._collect(now, resubmit=True)
            if now - t0 >= seconds:
                return t0, now, completed

    # ------------------------------------------------------------ window
    def window(self, seconds):
        m = self.pool.metrics
        base = (m.extend_steps, m.tasks_emitted, m.tasks_capacity,
                m.preemptions)
        self.latency = {"prefill": [], "decode": []}
        self.due_rids = []
        self.window_open = True
        self.win = (time.perf_counter(), float("inf"))
        t0, t1, completed = self._loop(seconds)
        self.window_open = False
        self.win = (self.win[0], t1)
        r = self.record
        r["window_s"] = t1 - self.win[0]
        r["completed"] = completed
        r["chunk_s"] = list(self.chunks)
        r["extend_steps"] = m.extend_steps - base[0]
        r["tasks_emitted"] = m.tasks_emitted - base[1]
        r["tasks_capacity"] = m.tasks_capacity - base[2]
        r["preemptions"] = m.preemptions - base[3]
        if self.tracer.enabled:
            self._traced_tail()
        self._drain(t1)
        r["latency_s"] = self.latency
        r["attempted"] = len(self.due_rids) + self.undrained
        r["failed"] = self.undrained

    def _traced_tail(self):
        """The traced run: after the window, the closed loop goes on for
        ``trace.tail_s`` under the profiler, the distance launches' task
        ids kept; only the window's requests are judged."""
        from bench.ops.distance_bytes import launch_bytes

        self.tracer.start()
        self._loop(self.traffic["trace"]["tail_s"])
        self.tracer.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.record["distance_launch_bytes"] = [
            launch_bytes(i, s, self.pcfg.dim)
            for i, s in self.distance_launches]
        self.distance_launches.clear()

    def _drain(self, t1):
        """Wait for every request due in the window (no new ones): a late
        answer is late, not wrong; one that never comes is a failure."""
        due = {rid for rid, (_, t_due) in self.out.items()
               if self.win[0] <= t_due <= self.win[1]}
        limit = t1 + self.traffic["drain_s"]
        while due & set(self.out) and time.perf_counter() < limit:
            self.pool.run_until(self.rep.clock + STEP)
            self._collect(time.perf_counter(), resubmit=False)
        self.undrained = len(due & set(self.out))

    # ------------------------------------------------------------ check
    def close(self):
        """Keep the answers to judge; free the program's state."""
        by_rid = {}
        counts = {}
        for req in self.pool.metrics.completed:
            counts[req.rid] = counts.get(req.rid, 0) + 1
            by_rid[req.rid] = req
        self.twice = sum(1 for rid in self.due_rids if counts.get(rid, 0) != 1)
        rng = np.random.default_rng(self.s_check)
        n = min(self.traffic["check"]["answers"], len(self.due_rids))
        pick = rng.choice(len(self.due_rids), size=n, replace=False)
        reqs = [by_rid[self.due_rids[i]] for i in sorted(pick)]
        self.answers = None if not reqs else (
            np.stack([r.qvec for r in reqs]),
            np.stack([r.result_ids for r in reqs]),
            np.stack([r.result_dists for r in reqs]))
        del self.pool, self.rep, by_rid, reqs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, control=False) -> dict:
        if self.answers is None:  # nothing answered: nothing judged sound
            return {"dist_err": float("nan"), "recall": float("nan"),
                    "malformed": 0}
        q, ids, dists = self.answers
        db = torch.as_tensor(self.db, device=self.device)
        qt = torch.as_tensor(q, device=self.device)
        k = self.pcfg.top_k
        if control:
            ids, dists = answers.control_answers(db, qt, k)
        return answers.judge(db, qt, ids, dists, k)

    def readings(self, control=False) -> dict:
        out = {"program": self.judge()}
        if control:
            out["control"] = self.judge(control=True)
        return out

    def check(self):
        j = self.readings()["program"]
        lim = self.limits["numbers"]
        return [Check("dist_err", j["dist_err"], lim["dist_err"]),
                Check("recall", j["recall"], lim["recall"], ">="),
                Check("malformed", j["malformed"], 0),
                Check("not_once", self.twice, 0),
                Check("never_answered", self.record["failed"], 0)]
