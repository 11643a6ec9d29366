"""Mooncake-style KV transfer link between the prefill and decode pools.

FIFO store-and-forward at ``bandwidth`` bytes/s; utilisation u_kv is
measured over a sliding window — the signal the Trinity adaptive scheduler
steers toward its target (paper §3.3).
"""
from __future__ import annotations

from collections import deque


class KVLink:
    def __init__(self, bandwidth: float = 40e9, window: float = 0.25):
        self.bandwidth = bandwidth
        self.window = window
        self.busy_until = 0.0
        self._busy_intervals: deque = deque()  # (start, end)

    def transfer(self, t_now: float, nbytes: float) -> float:
        """Enqueue a transfer; returns its completion time."""
        start = max(t_now, self.busy_until)
        dur = nbytes / self.bandwidth
        end = start + dur
        self.busy_until = end
        self._busy_intervals.append((start, end))
        return end

    def utilization(self, t_now: float) -> float:
        """Busy fraction over [t_now - window, t_now]."""
        lo = t_now - self.window
        while self._busy_intervals and self._busy_intervals[0][1] < lo:
            self._busy_intervals.popleft()
        busy = sum(min(e, t_now) - max(s, lo)
                   for s, e in self._busy_intervals if s < t_now)
        return min(1.0, busy / self.window) if self.window > 0 else 0.0
