"""Prefill / decode pool instances (timing-model driven; the real-compute
path for small models lives in launch/serve.py and examples/).

Each instance owns its paged-KV budget; decode runs continuous batching at
token granularity (admit on any step boundary, free on completion) — the
LLM-side mirror of the vector engine's extend-granularity batching.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core import roofline_model
from repro_torch.core.roofline_model import V5E, Hardware
from repro_torch.serving.kv_cache import PagedKVManager, kv_bytes_per_token
from repro_torch.serving.request import GenRequest


@dataclasses.dataclass
class InstanceHealth:
    slowdown: float = 1.0
    step_ewma: float = 0.0
    alive: bool = True
    # graceful scale-down (autoscaler): a draining instance stops taking
    # new admissions but finishes its in-flight work (device KV is
    # per-instance — a kill would force re-prefills, a drain loses
    # nothing); once empty it is retired and stops counting against the
    # GPU budget. Both always False outside an autoscaler drain.
    draining: bool = False
    retired: bool = False

    @property
    def serving(self) -> bool:
        """Eligible for NEW admissions (alive, not draining/retired)."""
        return self.alive and not self.draining and not self.retired


class PrefillInstance:
    def __init__(self, iid: int, model_cfg, chips: int,
                 max_batch_tokens: int = 65536, hw: Hardware = V5E,
                 capacity_factor: float = 1.0, contention: float = 1.0):
        self.iid = iid
        self.cfg = model_cfg
        self.chips = max(1, int(chips * capacity_factor))
        self.max_batch_tokens = max_batch_tokens
        self.hw = hw
        self.contention = contention
        self.health = InstanceHealth()
        self.busy_until = 0.0
        self.current: List[GenRequest] = []

    def batch_time(self, tokens: int) -> float:
        t = roofline_model.prefill_time(self.cfg, tokens, self.chips, self.hw)
        return t * self.contention * self.health.slowdown

    def start_batch(self, t_now: float, reqs: List[GenRequest]) -> float:
        tokens = sum(r.prompt_len for r in reqs)
        dt = self.batch_time(tokens)
        self.current = reqs
        self.busy_until = t_now + dt
        for r in reqs:
            r.t_prefill_start = t_now
        self.health.step_ewma = (0.8 * self.health.step_ewma + 0.2 * dt
                                 if self.health.step_ewma else dt)
        return self.busy_until


class DecodeInstance:
    def __init__(self, iid: int, model_cfg, chips: int, max_batch: int = 64,
                 kv_capacity_bytes: float = 16e9 * 8 * 0.5, hw: Hardware = V5E,
                 capacity_factor: float = 1.0, contention: float = 1.0,
                 ep_penalty: float = 0.0):
        self.iid = iid
        self.cfg = model_cfg
        self.chips = max(1, int(chips * capacity_factor))
        self.max_batch = max_batch
        self.hw = hw
        self.contention = contention
        self.ep_penalty = ep_penalty
        self.health = InstanceHealth()
        self.pager = PagedKVManager(kv_capacity_bytes, model_cfg)
        self.active: Dict[int, GenRequest] = {}
        self.stepping = False  # a step event is scheduled
        self.tokens_emitted = 0

    @property
    def free_slots(self) -> int:
        return self.max_batch - len(self.active)

    def can_admit(self, req: GenRequest) -> bool:
        return (self.free_slots > 0
                and self.pager.can_admit(req.prompt_len + req.max_new_tokens))

    def admit(self, req: GenRequest):
        assert self.pager.allocate(req.rid, req.prompt_len + req.max_new_tokens)
        self.active[req.rid] = req

    def release(self, req: GenRequest):
        self.pager.free(req.rid)
        self.active.pop(req.rid, None)

    def step_time(self, t_now: float) -> float:
        if not self.active:
            return 0.0
        ctxs = [r.prompt_len + r.tokens_out for r in self.active.values()]
        dt = roofline_model.decode_step_time(
            self.cfg, len(self.active), int(sum(ctxs) / len(ctxs)),
            self.chips, self.hw)
        dt = dt * self.contention * self.health.slowdown + self.ep_penalty
        self.health.step_ewma = (0.8 * self.health.step_ewma + 0.2 * dt
                                 if self.health.step_ewma else dt)
        return dt
