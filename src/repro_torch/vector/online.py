"""The read side of the online (growable) index.

The index owns the ONE device copy of the corpus ``db`` (N, d) float32 and
its ``graph`` (N, D) int32; every pool replica's engine searches those same
tensors (no per-replica copy). Rows ``[0, base_n)`` are the frozen corpus
segment, ``[corpus_n, base_n)`` shard padding (none in a monolithic pool),
and rows past ``base_n`` the growable answer-cache segment.

Growth (``insert_batch``, cache-segment doubling, TTL/capacity eviction and
entry migration) is not ported yet (ROADMAP Queue A item 7): an index with
a cache segment raises ``NotImplementedError``, and the read-side views
below describe an empty cache segment.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch import convert
from repro_torch.device import resolve_device


class CapacityError(RuntimeError):
    """The index does not fit its owner's modeled HBM row budget
    (``max_rows`` / ``VectorPoolConfig.replica_max_rows``)."""


class OnlineIndex:
    """Capacity-segmented index shared by its owning replicas (read side).

    ``db``/``graph`` are numpy arrays or tensors; they are placed on
    ``device`` once (tensors already there are used as they are)."""

    def __init__(self, db, graph, *, cache_capacity: int = 0,
                 metric: str = "l2", corpus_rows: Optional[int] = None,
                 max_rows: int = 0, device="cuda"):
        if cache_capacity > 0:
            raise NotImplementedError(
                "the growable cache segment (online inserts) is not ported "
                "yet: ROADMAP Queue A item 7")
        self.device = resolve_device(device)
        self.db, self.graph = convert.index_from_numpy(db, graph, self.device)
        self.base_n, self.dim = self.db.shape
        # real corpus rows; rows [corpus_n, base_n) are shard padding
        self.corpus_n = self.base_n if corpus_rows is None else corpus_rows
        assert 0 <= self.corpus_n <= self.base_n
        self.degree = self.graph.shape[1]
        self.metric = metric
        self.max_rows = max_rows
        if max_rows and self.base_n > max_rows:
            raise CapacityError(
                f"index needs {self.base_n} frozen rows but max_rows="
                f"{max_rows}; shard the corpus "
                f"(VectorPoolConfig.num_shards > 1)")
        self.cache_size = 0  # LIVE cache entries
        self.cache_rows = 0  # high-water rows ever used
        self._cap = 0
        self._t_insert = np.zeros(0, np.float64)  # per-local-slot timestamps
        self._live = np.zeros(0, bool)
        self._evicted: List[int] = []  # global rows evicted since last drain

    @property
    def cache_capacity(self) -> int:
        return self._cap

    @property
    def total_rows(self) -> int:
        return self.base_n + self.cache_rows

    def entry_range(self, segment: str):
        """Entry-point sampling range [lo, hi) for a retrieval-class
        segment. The cache range covers rows ever used; corpus excludes
        shard-padding rows."""
        if segment == "cache":
            return self.base_n, self.base_n + self.cache_rows
        return 0, self.corpus_n

    def is_live(self, global_row: int) -> bool:
        """Whether ``global_row`` is a currently-live cache entry (False
        for corpus rows, tombstoned slots and out-of-range rows)."""
        loc = global_row - self.base_n
        return 0 <= loc < self.cache_rows and bool(self._live[loc])

    def born_at(self, global_row: int) -> Optional[float]:
        """Insert timestamp of the row's CURRENT occupant (None if not a
        live cache row)."""
        loc = global_row - self.base_n
        if 0 <= loc < self.cache_rows and self._live[loc]:
            return float(self._t_insert[loc])
        return None

    def drain_evicted(self) -> List[int]:
        """Global row ids evicted since the last drain."""
        out, self._evicted = self._evicted, []
        return out
