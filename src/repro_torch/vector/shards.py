"""Sharded vector index: grow the pool past one device's memory.

The corpus is partitioned into S shards by balanced k-means (``ivf``'s
centroid machinery), each a self-contained :class:`OnlineIndex` — frozen
segment + growable cache segment — owned by one or more pool replicas
(``core/trinity_pool.ShardedVectorPool`` is the scatter–gather router).

Shape discipline: every shard's frozen segment is padded to the LARGEST
shard's row count (``pad_n``), so all shards stack into one (G, N, d)
layout for the megabatched engine. Padding rows have no out-edges, are
never entry-sampled (``OnlineIndex.corpus_rows``) and no real row points at
them.

Id spaces: engines and ``OnlineIndex`` operate in shard-LOCAL row ids;
results are translated to GLOBAL ids (``to_global``) before the merge.
Frozen local rows map to their corpus row; cache rows get globally-unique
ids at insert time (``[n, n + total inserts)``), never reused, so a stale
result can never alias a newer answer's id.

Routing is a coarse-quantizer pass over each shard's fine sub-centroids
(``route``). It runs on the host (CPU tensors: at most S · 4 centroids),
so the router never syncs with the card — the megabatched pool releases
arrivals while a chunk is in flight. Inserts route to the owning shard
only (nearest centroid).

The partition, the routing centroids and the id maps are numpy, the JAX
package's code, so they are bit-equal to it. One difference: the shard
graphs come from the port's ``make_cagra_graph``, which on a CUDA device
refuses NN-descent above ``exact_threshold`` (``vector/graph.py``).
``ShardedIndex`` therefore takes ``exact_threshold`` (default 20000, the
JAX value) and passes it on to the graph construction: a caller building
large shards on the card passes the shard's row count to get each shard's
exact kNN graph.
Below 20000 rows a shard, both packages build the exact graph.

Shard rebalancing moves cache entries between shards with their global ids
and insert timestamps (``migrate_entries``); a whole-shard loss wipes a
shard's cache segment (``drop_shard_cache``) and its entries may be
re-homed from peer copies (``restore_entries``). Adopted entries are wired
to their exact nearest live cache rows, found on the host with numpy, so
the wiring is the same whatever the index's device.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.vector.ivf import centroid_distances, kmeans
from repro_torch.vector.online import OnlineIndex
from repro_torch.vector.ref import exact_knn


def balanced_partition(db: np.ndarray, num_shards: int, *, iters: int = 8,
                       seed: int = 0):
    """Capacity-constrained k-means partition of ``db`` into ``num_shards``
    near-equal shards.

    Lloyd's centroids first (``ivf.kmeans``); then points are assigned in
    ascending best-distance order, each to its nearest centroid with
    remaining capacity (cap = ⌈N/S⌉). Deterministic; every point is
    assigned exactly once. Returns (centroids (S, d) f32, parts: list of S
    sorted global-row-id arrays).
    """
    N = db.shape[0]
    S = num_shards
    assert S >= 1
    if S == 1:
        return (db.astype(np.float32).mean(0, keepdims=True),
                [np.arange(N, dtype=np.int64)])
    centroids, _ = kmeans(db, S, iters=iters, seed=seed)
    dbf = db.astype(np.float32)
    d2 = (np.sum(dbf ** 2, 1)[:, None] - 2 * dbf @ centroids.T
          + np.sum(centroids ** 2, 1)[None])  # (N, S)
    cap = math.ceil(N / S)
    order = np.argsort(d2.min(1), kind="stable")
    pref = np.argsort(d2, 1, kind="stable")
    counts = np.zeros(S, np.int64)
    assign = np.full(N, -1, np.int64)
    for i in order:
        for c in pref[i]:
            if counts[c] < cap:
                assign[i] = c
                counts[c] += 1
                break
    parts = [np.flatnonzero(assign == s).astype(np.int64) for s in range(S)]
    return centroids, parts


class ShardedIndex:
    """S self-contained shard indexes on ``device`` + centroid router + id
    translation.

    ``build_graphs=False`` skips the per-shard graph builds (and the
    ``OnlineIndex`` construction): only the partition, the router and
    ``exact_search`` work."""

    def __init__(self, db: np.ndarray, *, num_shards: int, degree: int = 16,
                 metric: str = "l2", cache_capacity: int = 0,
                 kmeans_iters: int = 8, long_edges: int = 6, seed: int = 0,
                 ttl: float = 0.0, max_entries: int = 0, max_rows: int = 0,
                 route_centroids: int = 4, build_graphs: bool = True,
                 exact_threshold: int = 20000, device="cuda"):
        self.device = resolve_device(device)
        db = np.asarray(db, np.float32)
        self.db = db  # full corpus (host view; device arrays live per shard)
        self.n, self.dim = db.shape
        self.num_shards = num_shards
        self.metric = metric
        self.degree = degree
        self._shard_kw = dict(cache_capacity=cache_capacity, metric=metric,
                              long_edges=long_edges, ttl=ttl,
                              max_entries=max_entries, max_rows=max_rows)
        self._seed = seed
        centroids, parts = balanced_partition(db, num_shards,
                                              iters=kmeans_iters, seed=seed)
        self.centroids = centroids
        self.shard_rows: List[np.ndarray] = parts  # frozen local → global
        self.pad_n = max(len(p) for p in parts)  # common frozen-segment rows
        self.shards: List[Optional[OnlineIndex]] = []
        self.graphs: List[np.ndarray] = []  # host copies of the built graphs
        for s, rows in enumerate(parts):
            if not build_graphs:
                self.shards.append(None)
                continue
            g = make_shard_graph(db[rows], degree, seed=seed + s,
                                 exact_threshold=exact_threshold,
                                 device=self.device) if len(rows) \
                else np.zeros((0, degree), np.int32)
            self.graphs.append(g)
            self.shards.append(self._make_shard(s, g))
        self._reset_ids()
        # fine routing centroids: the balanced partition SPLITS popular
        # k-means cells across shards, so each shard contributes ≤
        # route_centroids sub-centroids and scores by their MIN distance
        fine, fine_shards, fine_counts = [], [], []
        for s, rows in enumerate(parts):
            f = min(route_centroids, len(rows))
            if f == 0:
                continue
            if f < 2:
                c = db[rows].mean(0, keepdims=True)
            else:
                c, _ = kmeans(db[rows], f, iters=max(kmeans_iters // 2, 2),
                              seed=seed + 101 + s)
            fine.append(c)
            fine_shards.append(s)
            fine_counts.append(len(c))
        self._fine_centroids = np.concatenate(fine).astype(np.float32)
        self._fine_t = torch.as_tensor(self._fine_centroids)  # host tensor
        # reduceat segment starts: fine blocks are contiguous per shard
        self._fine_starts = np.concatenate(
            [[0], np.cumsum(fine_counts)[:-1]]).astype(np.int64)
        self._fine_shards = np.asarray(fine_shards, np.int64)

    def _make_shard(self, s: int, graph: np.ndarray) -> OnlineIndex:
        rows = self.shard_rows[s]
        sdb = np.zeros((self.pad_n, self.dim), np.float32)
        sdb[:len(rows)] = self.db[rows]
        sgraph = np.full((self.pad_n, self.degree), -1, np.int32)
        sgraph[:len(rows)] = graph
        return OnlineIndex(sdb, sgraph, seed=self._seed + s,
                           corpus_rows=len(rows), device=self.device,
                           **self._shard_kw)

    def _reset_ids(self):
        """Id maps of the frozen segments alone (no cache entry yet)."""
        self._global_of: List[np.ndarray] = []  # per-shard local → global id
        for rows in self.shard_rows:
            gmap = np.full(self.pad_n, -1, np.int64)
            gmap[:len(rows)] = rows
            self._global_of.append(gmap)
        # globally-unique cache ids: [n, n + total inserts), never reused
        self._next_cache_gid = self.n
        self._gid_loc: Dict[int, Tuple[int, int]] = {}  # gid → (shard, local)

    def clone(self, device=None) -> "ShardedIndex":
        """A fresh index over the same partition, routing centroids and
        shard graphs (no k-means, no graph build), its cache segments
        empty, on ``device`` (default: this index's). Methods wrapped on
        this instance are not carried over."""
        if len(self.graphs) != self.num_shards:
            raise ValueError("clone needs the shard graphs (build_graphs)")
        new = copy.copy(self)
        # methods wrapped on this instance (the sanitizer's seams, a
        # caller's timers) act on this index: the clone keeps its own
        for name in [k for k, v in vars(new).items() if callable(v)]:
            del vars(new)[name]
        new.device = self.device if device is None else resolve_device(device)
        new.shards = [new._make_shard(s, g) for s, g in enumerate(self.graphs)]
        new._reset_ids()
        return new

    # ------------------------------------------------------------ routing
    def route(self, queries: np.ndarray, nprobe: int) -> np.ndarray:
        """The ``nprobe`` best shards per query, best-first — one batched
        centroid-distance pass over the fine sub-centroids (on the host)
        and a per-shard segment-min."""
        nprobe = max(1, min(nprobe, self.num_shards))
        q = np.atleast_2d(np.asarray(queries, np.float32))
        d2 = centroid_distances(self._fine_t, torch.as_tensor(q)).numpy()
        score = np.full((q.shape[0], self.num_shards), np.inf, np.float32)
        score[:, self._fine_shards] = np.minimum.reduceat(
            d2, self._fine_starts, axis=1)
        return np.argsort(score, 1, kind="stable")[:, :nprobe]

    def owning_shard(self, vec: np.ndarray) -> int:
        """The shard that owns an inserted vector (nearest centroid)."""
        return int(self.route(vec, 1)[0, 0])

    def cache_shards(self) -> List[int]:
        """Shards currently holding live cache entries."""
        return [s for s, sh in enumerate(self.shards)
                if sh is not None and sh.cache_size > 0]

    # ---------------------------------------------------- id translation
    def global_map(self, s: int) -> np.ndarray:
        """Read-only view of shard ``s``'s local-row → global-id map
        (−1 = tombstoned/never-filled); the megabatched pool mirrors these
        rows into its device translation table."""
        return self._global_of[s]

    def to_global(self, s: int, local_ids: np.ndarray) -> np.ndarray:
        """Shard-local result rows → global ids (−1 stays −1; tombstoned
        slots map to −1 too — their gid died with the eviction)."""
        gmap = self._global_of[s]
        ids = np.asarray(local_ids, np.int64)
        safe = np.clip(ids, 0, len(gmap) - 1)
        out = gmap[safe]
        return np.where((ids >= 0) & (ids < len(gmap)), out, -1)

    def _ensure_map(self, s: int, rows_needed: int):
        gmap = self._global_of[s]
        if rows_needed > len(gmap):
            self._global_of[s] = np.concatenate(
                [gmap, np.full(rows_needed - len(gmap), -1, np.int64)])

    # ------------------------------------------------------------ inserts
    def insert_local(self, s: int, vec: np.ndarray,
                     neighbor_local_ids: Optional[Sequence[int]],
                     t_now: float = 0.0) -> Tuple[int, List[int]]:
        """Insert into shard ``s`` (neighbours in shard-local ids, straight
        from a sub-search on that shard's engine). Returns (gid,
        evicted_gids)."""
        shard = self.shards[s]
        local_row = shard.insert(vec, neighbor_local_ids, t_now=t_now)
        evicted = self._retire(s, shard.drain_evicted())
        gid = self._next_cache_gid
        self._next_cache_gid += 1
        self._ensure_map(s, local_row + 1)
        self._global_of[s][local_row] = gid
        self._gid_loc[gid] = (s, local_row)
        return gid, evicted

    def _retire(self, s: int, drained) -> List[int]:
        """Retire the gids of shard ``s``'s drained local rows (evicted or
        lost entries); returns them."""
        out: List[int] = []
        gmap = self._global_of[s]
        for loc in drained:
            if loc < len(gmap) and gmap[loc] >= 0:
                gid = int(gmap[loc])
                out.append(gid)
                self._gid_loc.pop(gid, None)
                gmap[loc] = -1
        return out

    def _adopt(self, dst: int, gids, vecs, born, t_now: float) -> List[int]:
        """Adopt entries onto shard ``dst`` under the given gids, wired to
        their exact nearest live cache rows there. Returns the gids the
        recipient's own capacity/TTL pass evicted during adoption."""
        recip = self.shards[dst]
        vecs = np.asarray(vecs, np.float32)
        nbr_lists = self._exact_cache_neighbors(recip, vecs)
        new_rows = recip.adopt_entries(vecs, np.asarray(born, np.float64),
                                       nbr_lists, t_now=t_now)
        evicted = self._retire(dst, recip.drain_evicted())
        self._ensure_map(dst, max(new_rows) + 1)
        dst_map = self._global_of[dst]
        for gid, r in zip(gids, new_rows):
            dst_map[r] = int(gid)
            self._gid_loc[int(gid)] = (dst, int(r))
        return evicted

    # ------------------------------------------- rebalancing and shard loss
    def migrate_entries(self, src: int, dst: int, n: int,
                        t_now: float = 0.0):
        """Move up to ``n`` of shard ``src``'s oldest live cache entries to
        shard ``dst`` (load/capacity rebalancing).

        Global cache ids are STABLE across the move: a migrated gid keeps
        serving with its original insert timestamp, so TTL staleness
        guards are unaffected. The donor slots are tombstoned through the
        eviction path; only entries genuinely retired by the move
        (TTL-expired at extraction, or the recipient's own capacity
        eviction during adoption) are reported back.

        Returns ``(moved_gids, evicted_gids)``."""
        assert src != dst
        donor = self.shards[src]
        rows, vecs, born = donor.extract_entries(n, t_now=t_now)
        moved_gids: List[int] = []
        src_map = self._global_of[src]
        migrated = set()
        for r in rows:
            r = int(r)
            moved_gids.append(int(src_map[r]))
            src_map[r] = -1
            migrated.add(r)
        # everything else the extraction drained was a real (TTL) eviction
        evicted = self._retire(src, [r for r in donor.drain_evicted()
                                     if r not in migrated])
        if not moved_gids:
            return [], evicted
        evicted += self._adopt(dst, moved_gids, vecs, born, t_now)
        return moved_gids, evicted

    # ------------------------------------------------------ shard loss
    def drop_shard_cache(self, s: int) -> List[int]:
        """Whole-shard cache loss: tombstone every live cache entry of
        shard ``s`` and retire their gids. The frozen corpus segment is
        untouched; only the online-inserted entries die with the shard.
        Returns the lost gids, for the pool to drop their answer metadata
        or re-home them (:meth:`restore_entries`)."""
        shard = self.shards[s]
        shard.wipe_cache()
        return self._retire(s, shard.drain_evicted())

    def restore_entries(self, dst: int, gids: Sequence[int],
                        vecs: np.ndarray, born: Sequence[float],
                        t_now: float = 0.0) -> List[int]:
        """Re-home lost cache entries onto shard ``dst`` with their
        ORIGINAL gids and insert timestamps (recovery from peer copies).
        Returns the gids the recipient's own capacity/TTL pass evicted
        during adoption."""
        return self._adopt(dst, gids, vecs, born, t_now)

    @staticmethod
    def _exact_cache_neighbors(recip: OnlineIndex, vecs: np.ndarray):
        """Exact nearest LIVE cache rows of ``recip`` per adopted vector
        (candidate lists for adoption; None when the recipient's cache is
        empty — random long edges alone wire the first arrivals). The
        live rows are copied to the host and ranked by numpy."""
        live = np.flatnonzero(recip._live[:recip.cache_rows])
        if len(live) == 0:
            return None
        cand_rows = recip.base_n + live
        cand = recip.db[torch.as_tensor(cand_rows, device=recip.device)]
        k = min(max(recip.degree - recip.long_edges, 1), len(live))
        ids_l, _ = exact_knn(cand.cpu().numpy(),
                             np.asarray(vecs, np.float32), k,
                             metric=recip.metric, device="cpu")
        return [cand_rows[row].tolist() for row in ids_l]

    @property
    def cache_size(self) -> int:
        return sum(sh.cache_size for sh in self.shards if sh is not None)

    def born_at(self, gid: int) -> Optional[float]:
        """Insert timestamp of a live cache gid (None if evicted/unknown)
        — TTL expiry is judged at serve time by the pool."""
        loc = self._gid_loc.get(gid)
        if loc is None:
            return None
        s, shard_row = loc  # already in shard-row space (base_n + slot)
        return self.shards[s].born_at(shard_row)

    # ------------------------------------------------- exact (oracle) path
    def exact_search(self, queries: np.ndarray, k: int,
                     shard_lists: Optional[np.ndarray] = None):
        """Exhaustive per-shard top-k over the frozen corpus (on the
        index's device), merged. ``shard_lists`` (Q, nprobe) restricts each
        query to its routed shards (None = fan-out-all, which equals the
        monolithic exact oracle). Returns host (ids (Q, k) global, dists
        (Q, k)), padded −1 / +inf."""
        from repro_torch.kernels.ops import merge_partial_topk

        q = np.atleast_2d(np.asarray(queries, np.float32))
        Q = q.shape[0]
        S = self.num_shards
        all_ids = np.full((Q, S, k), -1, np.int64)
        all_d = np.full((Q, S, k), np.inf, np.float32)
        for s, rows in enumerate(self.shard_rows):
            ns = len(rows)
            if ns == 0:
                continue
            kk = min(k, ns)
            ids_l, d = exact_knn(self.db[rows], q, kk, metric=self.metric,
                                 device=self.device)
            all_ids[:, s, :kk] = rows[ids_l]
            all_d[:, s, :kk] = d
        if shard_lists is not None:
            mask = np.zeros((Q, S), bool)
            np.put_along_axis(mask, np.asarray(shard_lists), True, axis=1)
            all_ids = np.where(mask[:, :, None], all_ids, -1)
        ids, dists = merge_partial_topk(all_ids.astype(np.int32),
                                        all_d.astype(np.float32), k=k)
        return ids.numpy(), dists.numpy()


def make_shard_graph(vecs: np.ndarray, degree: int, seed: int = 0,
                     exact_threshold: int = 20000, device="cuda"):
    """The graph build over one shard's vectors in shard-LOCAL id space,
    on ``device``; ``exact_threshold`` as ``vector/graph.make_cagra_graph``
    takes it."""
    from repro_torch.vector.graph import make_cagra_graph

    return make_cagra_graph(vecs, degree, seed=seed,
                            exact_threshold=exact_threshold, device=device)
