"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over
segments of a traced tail that follows the window, reduced in memory to
what the per-layer metrics and the ``breakdown`` read.

The tail runs after the measured window because the profiler, once
started, leaves every kernel launch slower for the rest of the process
(~35% on a host-bound loop on the H100 machine): the window's host-clock
spans are taken before it. The tail is cut into periods of ``period_s``;
the last ``active_s`` of each is traced (CPU and CUDA activity), so a
trace never holds more than one segment's events. ``poll()`` is called by the harness between calls into the
program; it moves the profiler's schedule at the wall-clock boundaries.
``recording`` is true while a segment is traced: launch recorders count
bytes only then. ``busy_us`` is a copy of the port's
``tools/profile_torch_pool.py`` helper.
"""
from __future__ import annotations

import time
from collections import Counter, defaultdict

PREFIX = "bench."  # the harness's own annotations (record_function)


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _kind(e) -> str:
    """The event's kind: "device" for work on the card (kernels, copies,
    sets), "note" for the harness's host annotations, "" otherwise. The
    profiler mirrors each annotation (ours and its own ``ProfilerStep#``)
    onto the card's timeline; those spans are not work."""
    name = e.name()
    on_card = "cuda" in str(e.device_type()).lower()
    user = getattr(e, "is_user_annotation", None)
    annotation = (name.startswith((PREFIX, "ProfilerStep#"))
                  or (callable(user) and user()))
    if on_card:
        return "" if annotation else "device"
    return "note" if name.startswith(PREFIX) else ""


class Summary:
    """What the traced segments held, summed."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.segments = 0
        self.op_s = Counter()  # device op name -> seconds
        self.op_n = Counter()  # device op name -> events
        self.gap_s = defaultdict(float)  # host annotation -> idle seconds

    def kernel(self, needle: str):
        """(seconds, events) of the device ops whose name holds
        ``needle``."""
        s = sum(v for k, v in self.op_s.items() if needle in k)
        n = sum(v for k, v in self.op_n.items() if needle in k)
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = [[k[:160], v] for k, v in self.op_s.most_common(top)]
        gaps = sorted(self.gap_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": ops, "idle_gaps": [[k, v] for k, v in gaps]}


def reduce_events(events, window_s: float, summary: Summary) -> None:
    """Add one segment's kineto events to ``summary``."""
    dev, notes = [], []
    for e in events:
        kind = _kind(e)
        name = e.name()
        if kind == "device":
            a = e.start_ns()
            b = a + e.duration_ns()
            dev.append((a, b))
            summary.op_s[name] += e.duration_ns() * 1e-9
            summary.op_n[name] += 1
        elif kind == "note":
            notes.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    summary.segments += 1
    summary.window_s += window_s
    if not dev:
        return
    summary.busy_s += busy_us(dev) * 1e-9
    spans = merged(dev)
    starts = [a for a, _, _ in notes] + [spans[0][0]]
    ends = [b for _, b, _ in notes] + [spans[-1][1]]
    lo, hi = min(starts), max(ends)
    gaps = [(lo, spans[0][0])] + [(spans[i][1], spans[i + 1][0])
                                  for i in range(len(spans) - 1)]
    gaps.append((spans[-1][1], hi))
    notes.sort(key=lambda n: n[1] - n[0])  # innermost first
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = next((n for s, e, n in notes if s <= mid <= e), "other")
        summary.gap_s[label] += (b - a) * 1e-9


class Tracer:
    """Segments of the window under ``torch.profiler``; a no-op when
    ``enabled`` is false."""

    WARM_S = 0.05  # the profiler's warm-up before each traced segment

    def __init__(self, enabled: bool, period_s: float = 5.0,
                 active_s: float = 0.5, cuda: bool = True):
        self.enabled = enabled
        self.cuda = cuda
        self.period_s = period_s
        self.active_s = active_s
        self.summary = Summary()
        self.recording = False
        self._prof = None

    def warm(self):
        """One short profile before the segments: the profiler's first
        start in a process (CUPTI's set-up, its imports) takes seconds."""
        import torch
        from torch.profiler import profile

        dev = "cuda" if self.cuda else "cpu"
        with profile(activities=self._activities()):
            torch.zeros(1, device=dev).add_(1)
            if self.cuda:
                torch.cuda.synchronize()

    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])

    def start(self):
        """Warm the profiler, then start the segments' clock."""
        if not self.enabled:
            return
        from torch.profiler import profile, schedule

        self.warm()
        self._t0 = time.perf_counter()
        self._period = 0
        self._phase = 0  # 0 wait, 1 warm-up, 2 traced
        self._prof = profile(
            activities=self._activities(),
            schedule=schedule(wait=1, warmup=1, active=1, repeat=0),
            on_trace_ready=self._ready)
        self._prof.start()

    def poll(self):
        if self._prof is None:
            return
        now = time.perf_counter()
        if self._phase == 2:
            if now - self._seg_t0 >= self.active_s:
                self._seg_s = now - self._seg_t0
                self.recording = False
                self._prof.step()  # trace ready: _ready reduces it
                self._phase, self._period = 0, self._period + 1
            return
        end = self._t0 + (self._period + 1) * self.period_s
        if self._phase == 0 and now >= end - self.active_s - self.WARM_S:
            if now >= end:  # a long call passed this period's segment
                self._period = int((now - self._t0) // self.period_s)
                return
            self._prof.step()
            self._phase = 1
        if self._phase == 1 and now >= end - self.active_s:
            self._prof.step()
            self._phase = 2
            self.recording = True
            self._seg_t0 = time.perf_counter()

    def _ready(self, prof):
        reduce_events(prof.profiler.kineto_results.events(), self._seg_s,
                      self.summary)

    def stop(self):
        """Close the window: a segment being traced ends here."""
        if self._prof is None:
            return
        if self._phase == 2:
            self._seg_s = time.perf_counter() - self._seg_t0
            self.recording = False
        self._prof.stop()
        self._prof = None

    def note(self, name: str):
        """A host annotation for the idle gaps' labels (a no-op context
        when tracing is off)."""
        if not self.enabled:
            return _NULL
        from torch.profiler import record_function

        return record_function(PREFIX + name)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
