"""Composable million-user-scale traffic generators for ClusterSim.

The autoscaler bench needs traffic that *drifts*: Trinity's argument is
that the prefill/decode/vector demand ratio moves with the workload mix
(RAG-heavy chat vs. bulk summarization vs. repeat-heavy assistants), so
any static GPU split is wrong for part of the day. This module builds
those traces deterministically:

Rate plane
    A rate function ``t -> requests/s`` shaped from composable parts:
    :func:`constant`, :func:`diurnal` (sinusoidal day/night compressed
    into sim seconds), :func:`flash_crowd` (trapezoid burst), summed
    with :func:`compose`. Arrivals are drawn from the resulting
    inhomogeneous Poisson process by thinning against the trace's peak
    rate — seeded ``np.random.default_rng`` end to end, so a trace is a
    pure function of (rate_fn, tenants, seed).

Tenant plane
    A :class:`TenantSpec` maps a user population onto the request shape
    the RetrievalClass registry prices: prompt/output length ranges
    (prefill vs. decode weight), ``rag_interval``/``prefill_rag`` (how
    hard the tenant leans on the ``prefill``/``decode`` probe classes)
    and ``repeat_p``/``prompt_pool`` (how much lands on
    ``cache_lookup``/``insert`` via shared ``prompt_id``\\ s). Tenant
    weights may themselves be a function of time (``weights_fn``) —
    that is the drifting mix.

``drifting_mix_trace`` is the canonical trace used by
``benchmarks/bench_autoscale.py``: three tenant archetypes whose shares
rotate through three phases under a diurnal envelope with a flash crowd,
so the best static allocation differs per phase and only a controller
can hold goodput across the whole trace.

Everything here runs *before* the sim starts and is stamped in sim time;
the single wall-clock read lives in :func:`generate_timed`, a reporting
helper that times real host generation work (the DET002 allowlist entry
for this file exists for that helper alone).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import GenRequest

# ClusterSim reserves rids at and above _PROBE_RID_BASE (1 << 20) for
# internally-issued pool probes; generated traffic must stay below it
RID_LIMIT = 1 << 20

# requests/s as a function of sim time
RateFn = Callable[[float], float]


# --------------------------------------------------------------- rate plane
def constant(rps: float) -> RateFn:
    """Flat offered load."""
    return lambda t: float(rps)


def diurnal(base_rps: float, amplitude: float = 0.5,
            period_s: float = 4.0, phase: float = 0.0) -> RateFn:
    """Sinusoidal day/night cycle compressed into sim seconds:
    ``base · (1 + amplitude·sin(2π(t/period + phase)))``, floored at 0."""

    def fn(t: float) -> float:
        return max(0.0, base_rps * (1.0 + amplitude * math.sin(
            2.0 * math.pi * (t / period_s + phase))))

    return fn


def flash_crowd(peak_rps: float, t_start: float, ramp_s: float = 0.1,
                hold_s: float = 0.2, decay_s: float = 0.3) -> RateFn:
    """Trapezoid burst ADDED on top of a baseline: linear ramp to
    ``peak_rps``, hold, linear decay back to zero."""

    def fn(t: float) -> float:
        dt = t - t_start
        if dt < 0:
            return 0.0
        if dt < ramp_s:
            return peak_rps * dt / max(ramp_s, 1e-9)
        dt -= ramp_s
        if dt < hold_s:
            return peak_rps
        dt -= hold_s
        if dt < decay_s:
            return peak_rps * (1.0 - dt / max(decay_s, 1e-9))
        return 0.0

    return fn


def compose(*fns: RateFn) -> RateFn:
    """Sum of rate shapes (superposition of Poisson processes)."""
    return lambda t: sum(fn(t) for fn in fns)


# ------------------------------------------------------------- tenant plane
@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant archetype: a user population and the request shape it
    offers. The shape decides which RetrievalClass traffic the cluster
    turns it into — ``prefill_rag`` → ``prefill`` probes,
    ``rag_interval`` → ``decode`` probes every Δ tokens, and repeats of
    a pooled ``prompt_id`` → ``cache_lookup`` hits plus ``insert``
    writebacks."""

    name: str
    weight: float = 1.0  # relative share of arrivals (may be overridden
    # per-time by TrafficGenerator.weights_fn)
    users: int = 1_000_000  # nominal population behind the tenant
    # (reporting scale: offered load per user)
    prompt_len: Tuple[int, int] = (64, 512)  # uniform [lo, hi)
    max_new_tokens: Tuple[int, int] = (8, 64)  # uniform [lo, hi)
    rag_interval: int = 0  # decode RAG probe every Δ tokens (0 = none)
    prefill_rag: bool = True  # issue the prefill-side retrieval probe
    repeat_p: float = 0.0  # P[request repeats a pooled hot prompt]
    prompt_pool: int = 64  # hot prompts shared by this tenant's repeats


class TrafficGenerator:
    """Deterministic inhomogeneous-Poisson request source.

    ``generate(t_end)`` materializes the full arrival list for one
    trace: arrival times by thinning a homogeneous process at the
    trace's scanned peak rate, tenant choice from (possibly
    time-varying) weights, request shape from the tenant spec. Same
    (rate_fn, tenants, seed, weights_fn) ⇒ bit-identical trace.
    """

    def __init__(self, rate_fn: RateFn, tenants: Sequence[TenantSpec],
                 seed: int = 0,
                 weights_fn: Optional[Callable[[float], Sequence[float]]]
                 = None):
        if not tenants:
            raise ValueError("need at least one TenantSpec")
        self.rate_fn = rate_fn
        self.tenants = tuple(tenants)
        self.seed = seed
        self.weights_fn = weights_fn

    def peak_rate(self, t_end: float, grid: int = 2048) -> float:
        """Deterministic thinning majorant: max of ``rate_fn`` over a
        fine grid, padded 5% (rate shapes here are smooth at grid
        scale)."""
        ts = np.linspace(0.0, t_end, grid + 1)
        return max(float(self.rate_fn(t)) for t in ts) * 1.05 + 1e-9

    def _weights(self, t: float) -> np.ndarray:
        if self.weights_fn is not None:
            w = np.asarray(self.weights_fn(t), dtype=np.float64)
            if len(w) != len(self.tenants):
                raise ValueError("weights_fn arity != tenant count")
        else:
            w = np.asarray([sp.weight for sp in self.tenants],
                           dtype=np.float64)
        s = float(w.sum())
        if s <= 0:
            raise ValueError("tenant weights sum to zero")
        return w / s

    def generate(self, t_end: float, rid_base: int = 0
                 ) -> List[GenRequest]:
        rng = np.random.default_rng(self.seed)
        rmax = self.peak_rate(t_end)
        reqs: List[GenRequest] = []
        rid = rid_base
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rmax))
            if t >= t_end:
                break
            if float(rng.random()) * rmax > float(self.rate_fn(t)):
                continue  # thinned
            ti = int(rng.choice(len(self.tenants), p=self._weights(t)))
            sp = self.tenants[ti]
            prompt_id = None
            if sp.repeat_p > 0 and float(rng.random()) < sp.repeat_p:
                # tenants get disjoint hot-prompt id spaces
                prompt_id = (ti + 1) * RID_LIMIT \
                    + int(rng.integers(sp.prompt_pool))
            reqs.append(GenRequest(
                rid, prompt_len=int(rng.integers(*sp.prompt_len)),
                max_new_tokens=int(rng.integers(*sp.max_new_tokens)),
                t_arrival=t, rag_interval=sp.rag_interval,
                prefill_rag=sp.prefill_rag, prompt_id=prompt_id))
            rid += 1
            if rid >= RID_LIMIT:
                raise ValueError(
                    f"trace overflows the rid window ({RID_LIMIT}): "
                    "shorten the trace or lower the rate")
        return reqs


# ------------------------------------------------------- canonical traces
# the three archetypes whose resource deficits point at DIFFERENT pools
# (shapes calibrated against the full-config roofline: one GPU unit ≈
# 54k prefill tok/s ≈ 1.7k decode tok/s ≈ 1.5k probes/s):
# bulk summarization is prefill-bound (multi-thousand-token prompts, a
# handful of output tokens), per-token RAG hammers the vector pool from
# the decode loop, and long-form chat is decode-slot-bound with repeats
# that land on the semantic cache (cache_lookup/insert classes)
BULK_PREFILL = TenantSpec(
    "bulk_prefill", users=2_000_000, prompt_len=(3072, 6144),
    max_new_tokens=(4, 8), rag_interval=0, prefill_rag=True)
RAG_DECODE = TenantSpec(
    "rag_decode", users=5_000_000, prompt_len=(128, 256),
    max_new_tokens=(48, 96), rag_interval=1, prefill_rag=True)
REPEAT_CHAT = TenantSpec(
    "repeat_chat", users=10_000_000, prompt_len=(64, 192),
    max_new_tokens=(64, 128), rag_interval=0, prefill_rag=True,
    repeat_p=0.5, prompt_pool=24)

_DRIFT_TENANTS = (BULK_PREFILL, RAG_DECODE, REPEAT_CHAT)
# phase anchors: tenant shares at the start/third points of the trace;
# shares interpolate linearly between anchors, so the mix drifts
# continuously from prefill-bound through vector-bound to cache-bound
_DRIFT_ANCHORS = ((0.70, 0.15, 0.15),
                  (0.15, 0.70, 0.15),
                  (0.15, 0.15, 0.70),
                  (0.15, 0.15, 0.70))


def drifting_mix_weights(t_end: float) -> Callable[[float], Tuple[float,
                                                                  ...]]:
    """Piecewise-linear tenant-share schedule over ``_DRIFT_ANCHORS``."""

    def fn(t: float) -> Tuple[float, ...]:
        x = min(max(t / t_end, 0.0), 1.0) * (len(_DRIFT_ANCHORS) - 1)
        i = min(int(x), len(_DRIFT_ANCHORS) - 2)
        f = x - i
        lo, hi = _DRIFT_ANCHORS[i], _DRIFT_ANCHORS[i + 1]
        return tuple((1 - f) * a + f * b for a, b in zip(lo, hi))

    return fn


def drifting_mix_trace(t_end: float, base_rps: float,
                       seed: int = 0) -> TrafficGenerator:
    """The bench's canonical trace: three tenant archetypes rotating
    dominance across thirds of the trace, under a diurnal envelope with
    a flash crowd landing in the vector-bound middle phase. No static
    allocation is right for all three phases."""
    rate = compose(
        diurnal(base_rps, amplitude=0.35, period_s=t_end),
        flash_crowd(0.8 * base_rps, t_start=0.45 * t_end,
                    ramp_s=0.05 * t_end, hold_s=0.10 * t_end,
                    decay_s=0.10 * t_end))
    return TrafficGenerator(rate, _DRIFT_TENANTS, seed=seed,
                            weights_fn=drifting_mix_weights(t_end))


def generate_timed(gen: TrafficGenerator, t_end: float,
                   rid_base: int = 0) -> Tuple[List[GenRequest], dict]:
    """Reporting wrapper: generate a trace and time the real host work.

    This is the file's one wall-clock seam (its two reads carry a DET002
    pragma with the reason): it
    times how fast the generator materializes arrivals on THIS host —
    pure reporting on real work, never fed into sim time — so benches
    can state e.g. 'synthesized 1M-user trace at N req/s of host
    throughput'. The returned trace is byte-identical to
    ``gen.generate(...)``."""
    t0 = time.perf_counter()  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
    reqs = gen.generate(t_end, rid_base)
    wall_s = time.perf_counter() - t0  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
    users = sum(sp.users for sp in gen.tenants)
    report = {
        "requests": len(reqs),
        "trace_s": t_end,
        "offered_rps": len(reqs) / max(t_end, 1e-9),
        "tenant_users": users,
        "gen_wall_s": wall_s,
        "gen_req_per_wall_s": len(reqs) / max(wall_s, 1e-9),
    }
    return reqs, report
