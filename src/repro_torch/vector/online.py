"""Online index growth: the capacity-segmented index and its insert path.

The index owns the ONE device copy of its ``db`` (rows, float32) and
``graph`` (out-edges, int32); every pool replica's engine over it searches
those same tensors (no per-replica copy). Rows ``[0, base_n)`` are the
frozen corpus segment (never written), ``[corpus_n, base_n)`` shard padding
(none in a monolithic pool), and rows from ``base_n`` on the growable
answer-cache segment. The cache segment doubles when full (``_grow``), so
only O(log growth) shapes ever exist, under the ``max_rows`` budget.

``insert_batch`` places B new nodes: it scatters the vectors, sets the
forward adjacency from the search-selected neighbours, then patches the
*reverse* edges — each neighbour replaces its worst (largest-distance;
an empty slot counts as +INF, so empty slots fill first) adjacency entry
with the new node iff the new edge is shorter (column 0 unconditionally),
keeping the out-degree D. The patches run in order, as the JAX package's
``lax.fori_loop`` runs them: a later patch reads the graph an earlier one
wrote. Each patch is a few tensor ops on the index's device with no host
sync; a patch the host already knows to be a no-op (a padding row, an
empty neighbour slot) is skipped, which writes nothing the JAX package's
value-level no-op would change.

Bounded growth: with a TTL, entries older than ``ttl`` seconds are evicted
lazily at the next insert; with ``max_entries``, the oldest live entries
make room. An evicted row is tombstoned (db row set far away, l2 only; own
adjacency cleared; in-segment incoming edges cut), its slot freed and
reused lowest-first, and its global row handed out by ``drain_evicted``.

Host bookkeeping (timestamps, liveness, the free list, the long-edge RNG)
is numpy, as in the JAX package, so the same insert stream gives the same
rows, graph and eviction log. Writes only ever touch rows from ``base_n``
on, which exist only in tensors ``_grow`` allocated: an index built on a
caller's array or tensor never writes into it.

``drain_touched`` hands the pool the rows any write changed since the last
drain, so a stacked copy of the index (a megabatched lane) can be brought
up to date by copying those rows alone.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.device import resolve_device
from repro_torch.vector.cagra import INF

# l2 tombstone: any real vector is closer than this to any real query, so
# an evicted row entry-sampled before its edges were cut still ranks dead
# last and can never reach a top-k
_TOMBSTONE = 1e6


class CapacityError(RuntimeError):
    """The index does not fit its owner's modeled HBM row budget
    (``max_rows`` / ``VectorPoolConfig.replica_max_rows``)."""


def _dist(x, q, metric: str):
    if metric == "l2":
        return ((x - q) ** 2).sum(-1)
    if metric == "ip":
        return -(x * q).sum(-1)
    raise ValueError(f"unknown metric: {metric!r}")


def insert_batch(db, graph, rows, vecs, nbrs, *, metric: str = "l2"):
    """Insert B new nodes into ``db``/``graph`` in place.

    db (Ncap, d) float32 · graph (Ncap, D) int32 tensors · rows (B,) int
    (−1 = padding, dropped) · vecs (B, d) float32 · nbrs (B, D) int (−1 =
    empty slot). ``rows`` and ``nbrs`` are host arrays (numpy, or tensors
    read once); ``vecs`` may be either. Returns (db, graph) and the sorted
    global rows the call wrote.

    Forward edges are the search-selected neighbours; reverse edges patch
    each neighbour's worst slot under the degree cap, B·D patches in order
    (see the module doc)."""
    rows = np.asarray(rows.cpu() if torch.is_tensor(rows) else rows, np.int64)
    nbrs = np.asarray(nbrs.cpu() if torch.is_tensor(nbrs) else nbrs, np.int64)
    B, D = nbrs.shape
    dev = db.device
    vecs_t = torch.as_tensor(np.asarray(vecs, np.float32)
                             if not torch.is_tensor(vecs) else vecs,
                             dtype=torch.float32, device=dev)
    valid = np.flatnonzero(rows >= 0)
    if len(valid):
        sel = torch.as_tensor(valid, device=dev)
        tgt = torch.as_tensor(rows[valid], device=dev)
        db[tgt] = vecs_t[sel]
        graph[tgt] = torch.as_tensor(nbrs[valid], dtype=torch.int32,
                                     device=dev)
    touched = set(rows[valid].tolist())
    for b in valid:
        row = int(rows[b])
        vec = vecs_t[b]
        for jix in range(D):
            j = int(nbrs[b, jix])
            if j < 0:
                continue  # ok = False: the JAX patch writes the value back
            touched.add(j)
            adj = graph[j]  # (D,) view: the neighbour's current out-edges
            j_vec = db[j]
            adj_d = torch.where(
                adj >= 0, _dist(db[adj.long().clamp(min=0)], j_vec, metric),
                INF)
            worst = adj_d.argmax()  # the first maximum: empty slots first
            d_new = _dist(vec, j_vec, metric)
            # column 0 is the new node's NEAREST neighbour: patch it
            # unconditionally (orphan rescue); others only improve the edge
            better = torch.ones((), dtype=torch.bool, device=dev) if jix == 0 \
                else d_new < adj_d[worst]
            replace = ~(adj == row).any() & better
            newval = torch.where(replace, row, adj[worst])
            adj.scatter_(0, worst.view(1), newval.view(1).to(adj.dtype))
    return db, graph, sorted(touched)


def _gather_rows(db, rows):
    """One gather of ``rows`` (power-of-two padded, −1 = padding clamped to
    row 0 and dropped by the caller) — the device half of
    :meth:`OnlineIndex.extract_entries`."""
    return db[rows.long().clamp(0, db.shape[0] - 1)]


class OnlineIndex:
    """Capacity-segmented growable index shared by its owning replicas.

    ``db``/``graph`` are numpy arrays or tensors; they are placed on
    ``device`` once (tensors already there are used as they are, and never
    written: see the module doc). After a growth the pool broadcasts the new
    tensors to the owning engines (``engine.set_index``)."""

    def __init__(self, db, graph, *, cache_capacity: int = 0,
                 metric: str = "l2", long_edges: int = 6, seed: int = 0,
                 corpus_rows: Optional[int] = None, ttl: float = 0.0,
                 max_entries: int = 0, max_rows: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.db, self.graph = convert.index_from_numpy(db, graph, self.device)
        self.base_n, self.dim = self.db.shape
        # real corpus rows; rows [corpus_n, base_n) are shard padding
        self.corpus_n = self.base_n if corpus_rows is None else corpus_rows
        assert 0 <= self.corpus_n <= self.base_n
        self.degree = self.graph.shape[1]
        self.metric = metric
        self.ttl = ttl
        self.max_entries = max_entries
        # total (frozen + cache) row budget — the owning replica's modeled
        # HBM, enforced at construction AND at every cache growth
        self.max_rows = max_rows
        if max_rows and self.base_n > max_rows:
            raise CapacityError(
                f"index needs {self.base_n} frozen rows but max_rows="
                f"{max_rows}; shard the corpus "
                f"(VectorPoolConfig.num_shards > 1)")
        if (ttl > 0 or max_entries > 0) and metric != "l2":
            # the db tombstone relies on l2 monotonicity (a far row is a
            # bad row); ip has no universally-worst vector
            raise ValueError("cache eviction requires metric='l2'")
        self.cache_size = 0  # LIVE cache entries
        self.cache_rows = 0  # high-water rows ever used (reuse keeps ≤ cap)
        self._cap = 0
        self._free: List[int] = []  # evicted local slots available for reuse
        self._t_insert = np.zeros(0, np.float64)  # per-local-slot timestamps
        self._live = np.zeros(0, bool)
        self._evicted: List[int] = []  # global rows evicted since last drain
        self._touched: set = set()  # global rows written since last drain
        # NSW-style random long-range slots per inserted node (the JAX
        # package's navigability fix for an incrementally built graph)
        self.long_edges = min(long_edges, max(self.degree - 1, 0))
        self._rng = np.random.default_rng(seed + 0x5EED)
        if cache_capacity > 0:
            self._grow(cache_capacity)

    # ------------------------------------------------------------- views
    @property
    def cache_capacity(self) -> int:
        return self._cap

    @property
    def total_rows(self) -> int:
        return self.base_n + self.cache_rows

    def entry_range(self, segment: str):
        """Entry-point sampling range [lo, hi) for a retrieval-class
        segment. The cache range covers rows ever used (tombstoned rows in
        it rank dead last); corpus excludes shard-padding rows."""
        if segment == "cache":
            return self.base_n, self.base_n + self.cache_rows
        return 0, self.corpus_n

    def cache_vectors(self) -> np.ndarray:
        """Host copy of the cache segment's rows-ever-used (tombstoned
        slots included — callers filter by :meth:`is_live`)."""
        return self.db[self.base_n:self.base_n + self.cache_rows].cpu().numpy()

    def is_live(self, global_row: int) -> bool:
        """Whether ``global_row`` is a currently-live cache entry (False
        for corpus rows, tombstoned slots and out-of-range rows)."""
        loc = global_row - self.base_n
        return 0 <= loc < self.cache_rows and bool(self._live[loc])

    def born_at(self, global_row: int) -> Optional[float]:
        """Insert timestamp of the row's CURRENT occupant (None if not a
        live cache row) — lets callers reject results that resolved a row
        before its slot was evicted and re-filled."""
        loc = global_row - self.base_n
        if 0 <= loc < self.cache_rows and self._live[loc]:
            return float(self._t_insert[loc])
        return None

    def drain_evicted(self) -> List[int]:
        """Global row ids evicted since the last drain (the pool drops
        their answer metadata so an expired entry can never serve)."""
        out, self._evicted = self._evicted, []
        return out

    def drain_touched(self) -> List[int]:
        """Sorted global rows of ``db``/``graph`` written since the last
        drain (inserts, reverse-edge patches, tombstones, cut edges)."""
        out, self._touched = sorted(self._touched), set()
        return out

    # ----------------------------------------------------------- growth
    def _budget_error(self, rows_needed: int) -> "CapacityError":
        return CapacityError(
            f"cache growth to {rows_needed} rows exceeds the replica row "
            f"budget ({self.max_rows} total, {self.max_rows - self.base_n} "
            f"for the cache); bound the segment "
            f"(cache_max_entries/cache_ttl_s) or re-shard")

    def _grow(self, min_extra: int):
        """Double the cache segment into fresh tensors (O(log N) distinct
        shapes); rows past the old capacity are zeros / −1."""
        new_cap = max(64, 2 * self._cap)
        while new_cap < self.cache_rows + min_extra:
            new_cap *= 2
        if self.max_rows:
            allowed = self.max_rows - self.base_n
            if self.cache_rows + min_extra > allowed:
                raise self._budget_error(self.cache_rows + min_extra)
            new_cap = min(new_cap, allowed)
        total = self.base_n + new_cap
        old_rows = self.base_n + self._cap
        db = torch.zeros((total, self.dim), dtype=torch.float32,
                         device=self.device)
        graph = torch.full((total, self.degree), -1, dtype=torch.int32,
                           device=self.device)
        db[:old_rows] = self.db
        graph[:old_rows] = self.graph
        self._cap = new_cap
        self._t_insert = np.concatenate(
            [self._t_insert, np.zeros(new_cap - len(self._t_insert))])
        self._live = np.concatenate(
            [self._live, np.zeros(new_cap - len(self._live), bool)])
        self.db, self.graph = db, graph

    # --------------------------------------------------------- eviction
    def _evict_locals(self, locals_: Sequence[int]):
        """Tombstone cache rows: db far away, own adjacency cleared,
        in-segment incoming edges cut; slots return to the free list."""
        if not len(locals_):
            return
        g = [self.base_n + int(x) for x in locals_]
        g_t = torch.as_tensor(g, dtype=torch.int64, device=self.device)
        self.db[g_t] = _TOMBSTONE
        self.graph[g_t] = -1
        seg = self.graph[self.base_n:]
        if seg.shape[0]:
            seg.masked_fill_(torch.isin(seg, g_t.to(torch.int32)), -1)
            # the cut may touch any row of the segment
            self._touched.update(range(self.base_n,
                                       self.base_n + self.cache_rows))
        self._touched.update(g)
        for loc in locals_:
            loc = int(loc)
            self._live[loc] = False
            self._free.append(loc)
        self._free.sort()  # deterministic reuse order (lowest slot first)
        self._evicted.extend(g)
        self.cache_size -= len(locals_)

    def _evict_for(self, batch: int, t_now: float):
        """Lazy eviction ahead of an insert batch: expired entries first
        (TTL), then oldest live entries until the batch fits under the
        ``max_entries`` cap."""
        if self.ttl > 0:
            expired = np.flatnonzero(
                self._live[:self.cache_rows]
                & (self._t_insert[:self.cache_rows] + self.ttl <= t_now))
            self._evict_locals(expired.tolist())
        if self.max_entries > 0:
            over = self.cache_size + batch - self.max_entries
            if over > 0:
                live = np.flatnonzero(self._live[:self.cache_rows])
                order = np.argsort(self._t_insert[live], kind="stable")
                self._evict_locals(live[order][:over].tolist())

    def wipe_cache(self) -> None:
        """Loss of the whole cache segment: every live entry is tombstoned
        through the normal eviction path, and the lost rows land in
        ``drain_evicted()`` for the caller to retire."""
        live = np.flatnonzero(self._live[:self.cache_rows])
        self._evict_locals(live.tolist())

    # ------------------------------------------------------- migration
    def extract_entries(self, n: int, t_now: float = 0.0):
        """Remove up to ``n`` of the OLDEST live cache entries for
        migration to another index; expired entries (``t_now``) are
        TTL-evicted first, never migrated.

        Returns ``(rows, vecs, born)``: the extracted entries' global row
        ids, their vectors (one power-of-two padded gather) and their
        original insert timestamps. The donor slots are tombstoned through
        the eviction path, so the rows land in ``drain_evicted()``."""
        if self.ttl > 0:
            self._evict_for(0, t_now)
        live = np.flatnonzero(self._live[:self.cache_rows])
        order = np.argsort(self._t_insert[live], kind="stable")
        take = live[order][:n]
        m = len(take)
        if m == 0:
            return (np.zeros(0, np.int64),
                    np.zeros((0, self.dim), np.float32),
                    np.zeros(0, np.float64))
        rows = (self.base_n + take).astype(np.int64)
        pad = (1 << max(m - 1, 0).bit_length()) - m
        rows_p = np.concatenate([rows, np.full(pad, -1, np.int64)])
        vecs = _gather_rows(self.db, torch.as_tensor(
            rows_p, device=self.device)).cpu().numpy()[:m]
        born = self._t_insert[take].copy()
        self._evict_locals(take.tolist())
        return rows, vecs.copy(), born

    def adopt_entries(self, vecs, born, neighbor_lists=None,
                      t_now: float = 0.0) -> List[int]:
        """Adopt entries extracted from another index (the recipient half
        of a migration) in one ``insert_batch``, keeping their ORIGINAL
        insert timestamps ``born``. Returns the adopted row ids here."""
        if neighbor_lists is None:
            neighbor_lists = [None] * len(vecs)
        return self.insert_many(vecs, neighbor_lists, t_now=t_now,
                                t_each=born)

    # ---------------------------------------------------------- inserts
    def insert(self, vec: np.ndarray,
               neighbor_ids: Optional[Sequence[int]] = None,
               t_now: float = 0.0) -> int:
        """Insert one vector; returns its global row id."""
        return self.insert_many([vec], [neighbor_ids], t_now=t_now)[0]

    def insert_many(self, vecs, neighbor_lists,
                    t_now: float = 0.0,
                    t_each: Optional[Sequence[float]] = None) -> List[int]:
        """Insert B vectors in one ``insert_batch``.

        ``neighbor_lists[i]`` holds the search-selected candidate ids for
        vector i (global ids; anything outside the live cache segment is
        filtered host-side; at most ``degree`` survive). ``t_each``
        (migration adoption) overrides the per-entry insert timestamp;
        TTL/capacity eviction ahead of the batch still uses ``t_now``."""
        B = len(vecs)
        self._evict_for(B, t_now)
        # allocate local slots: reuse evicted slots first, then high-water;
        # the row-budget check runs before any allocation state commits
        reuse = self._free[:B]
        new_high = self.cache_rows + (B - len(reuse))
        if self.max_rows and self.base_n + new_high > self.max_rows:
            raise self._budget_error(new_high)
        locs = reuse + list(range(self.cache_rows, new_high))
        del self._free[:len(reuse)]
        self.cache_rows = new_high
        if self.cache_rows > self._cap:
            self._grow(0)
        rows = [self.base_n + loc for loc in locs]
        nbrs = np.full((B, self.degree), -1, np.int32)
        lo = self.base_n
        hi = self.base_n + self.cache_rows
        live_locs = np.flatnonzero(self._live[:self.cache_rows])
        n_live = len(live_locs)
        for i, cand in enumerate(neighbor_lists):
            keep = []
            if cand is not None:
                seen = set()
                for c in cand:
                    c = int(c)
                    if lo <= c < hi and c not in seen \
                            and self._live[c - lo]:
                        keep.append(c)
                        seen.add(c)
                keep = keep[:self.degree - self.long_edges]
            # random in-segment long-range edges in the reserved tail
            # slots, drawn over LIVE rows only, deduped against the short
            # edges and each other
            n_long = min(self.long_edges, n_live)
            if n_long:
                for x in self._rng.integers(0, n_live, size=n_long):
                    x = lo + int(live_locs[int(x)])
                    if x not in keep:
                        keep.append(x)
            nbrs[i, :len(keep)] = keep[:self.degree]
        pad = (1 << max(B - 1, 0).bit_length()) - B
        rows_p = np.asarray(rows + [-1] * pad, np.int32)
        vecs_np = np.stack([np.asarray(v, np.float32) for v in vecs])
        vecs_p = np.concatenate([vecs_np] + [vecs_np[:1]] * pad) \
            if pad else vecs_np
        nbrs_p = np.concatenate([nbrs] + [nbrs[:1]] * pad) if pad else nbrs
        self.db, self.graph, touched = insert_batch(
            self.db, self.graph, rows_p, vecs_p, nbrs_p, metric=self.metric)
        self._touched.update(touched)
        for i, loc in enumerate(locs):
            self._live[loc] = True
            self._t_insert[loc] = t_now if t_each is None \
                else float(t_each[i])
        self.cache_size += B
        return rows

    # ------------------------------------------------------------ oracle
    def rebuilt_cache_graph(self, seed: int = 0) -> np.ndarray:
        """Oracle adjacency: the cache segment's graph rebuilt FROM SCRATCH
        by the offline graph construction over the inserted vectors
        (global id space), on the index's device. Returns a host array."""
        from repro_torch.vector.graph import make_cagra_graph

        if self.cache_rows < self.degree:
            raise ValueError(
                f"cache segment too small to rebuild "
                f"({self.cache_rows} < degree {self.degree})")
        seg = make_cagra_graph(self.cache_vectors(), self.degree, seed=seed,
                               id_offset=self.base_n, device=self.device)
        graph = self.graph.cpu().numpy().copy()
        graph[self.base_n:self.base_n + self.cache_rows] = seg
        return graph
