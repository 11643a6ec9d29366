"""CAGRA-like fixed-degree graph construction.

Small N: exact kNN graph (blocked GEMM). Large N: NN-descent refinement.
Then CAGRA-style "reverse-edge augmentation + rank-based prune" down to the
fixed out-degree D that the search engines assume (``G: int32 (N, D)``).

``device`` defaults to ``"cuda"``, like every entry point of the port.
With ``device="cpu"`` the numpy code runs, the JAX package's verbatim, so
the graph equals the JAX package's graph. On a CUDA device the exact kNN
rows are computed block by block with ``torch.matmul`` + ``torch.topk`` —
the only way to build the exact graph at 10^6 rows — and ties between
equal distances may order differently from numpy's ``argpartition``.
NN-descent (above ``exact_threshold``) loops over rows in Python and
materialises an (N, s·k+s, d) array: it runs only with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _exact_knn_rows(db, rows, k, block=2048, device="cuda"):
    """kNN ids for db[rows] against full db (excluding self)."""
    dev = resolve_device(device)
    if dev.type != "cpu":
        return _exact_knn_rows_torch(db, rows, k, block, dev)
    db_sq = np.sum(db.astype(np.float32) ** 2, axis=1)
    out = np.zeros((len(rows), k), np.int32)
    for s in range(0, len(rows), block):
        r = rows[s:s + block]
        q = db[r].astype(np.float32)
        d = np.sum(q ** 2, axis=1)[:, None] - 2.0 * q @ db.T + db_sq[None, :]
        d[np.arange(len(r)), r] = np.inf  # exclude self
        idx = np.argpartition(d, k, axis=1)[:, :k]
        dd = np.take_along_axis(d, idx, axis=1)
        order = np.argsort(dd, axis=1)
        out[s:s + block] = np.take_along_axis(idx, order, axis=1)
    return out


def _exact_knn_rows_torch(db, rows, k, block, device):
    dbt = torch.as_tensor(db, dtype=torch.float32, device=device)
    db_sq = (dbt * dbt).sum(1)
    rows_t = torch.as_tensor(np.asarray(rows), dtype=torch.int64,
                             device=device)
    out = np.zeros((len(rows), k), np.int32)
    for s in range(0, len(rows), block):
        r = rows_t[s:s + block]
        q = dbt[r]
        # same formula as the numpy path, in place to hold one (B, N) block
        d = q @ dbt.T
        d.mul_(-2.0).add_((q * q).sum(1)[:, None]).add_(db_sq[None, :])
        d[torch.arange(len(r), device=device), r] = float("inf")
        idx = torch.topk(d, k, dim=1, largest=False, sorted=True).indices
        out[s:s + block] = idx.to(torch.int32).cpu().numpy()
    return out


def build_knn_graph_exact(db: np.ndarray, k: int,
                          device="cuda") -> np.ndarray:
    return _exact_knn_rows(db, np.arange(db.shape[0]), k, device=device)


def build_knn_graph_nndescent(db: np.ndarray, k: int, iters: int = 8,
                              sample: int = 8, seed: int = 0) -> np.ndarray:
    """NN-descent: iteratively refine random kNN lists via
    neighbours-of-neighbours (Dong et al.). Good enough for ANN graphs."""
    N, d = db.shape
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, N, size=(N, k)).astype(np.int32)
    for i in range(N):  # no self loops
        nbrs[i][nbrs[i] == i] = (i + 1) % N

    dbf = db.astype(np.float32)
    nbr_d = np.einsum("nkd,nkd->nk", dbf[nbrs] - dbf[:, None, :],
                      dbf[nbrs] - dbf[:, None, :])

    for _ in range(iters):
        # candidates: neighbours of (sampled) neighbours + reverse edges
        samp = nbrs[:, rng.permutation(k)[:sample]]  # (N, s)
        cand = nbrs[samp.reshape(-1)].reshape(N, -1)  # (N, s*k)
        rev = np.full((N, sample), -1, np.int32)
        # cheap reverse sampling: scatter each i into some of its neighbours
        for j in range(sample):
            col = samp[:, j]
            rev[col, j % sample] = np.arange(N, dtype=np.int32)
        cand = np.concatenate([cand, rev], axis=1)
        cand[cand < 0] = 0
        cand[cand == np.arange(N)[:, None]] = 0
        cd = np.einsum("ncd,ncd->nc", dbf[cand] - dbf[:, None, :],
                       dbf[cand] - dbf[:, None, :])
        cd[cand == np.arange(N)[:, None]] = np.inf
        # merge and prune to k (dedup by id)
        all_ids = np.concatenate([nbrs, cand], axis=1)
        all_d = np.concatenate([nbr_d, cd], axis=1)
        order = np.argsort(all_d, axis=1, kind="stable")
        all_ids = np.take_along_axis(all_ids, order, axis=1)
        all_d = np.take_along_axis(all_d, order, axis=1)
        new_nbrs = np.zeros_like(nbrs)
        new_d = np.zeros_like(nbr_d)
        for i in range(N):
            _, first = np.unique(all_ids[i], return_index=True)
            keep = np.sort(first)[:k]
            ids_i = all_ids[i][keep]
            d_i = all_d[i][keep]
            if len(ids_i) < k:  # pad with randoms
                pad = rng.integers(0, N, size=k - len(ids_i))
                ids_i = np.concatenate([ids_i, pad.astype(np.int32)])
                d_i = np.concatenate([d_i, np.full(k - len(d_i), np.inf)])
            new_nbrs[i] = ids_i
            new_d[i] = d_i
        nbrs, nbr_d = new_nbrs, new_d
    return nbrs


def make_cagra_graph(db: np.ndarray, degree: int, exact_threshold: int = 20000,
                     seed: int = 0, long_edges: int = 2,
                     id_offset: int = 0, device="cuda") -> np.ndarray:
    """Fixed-degree search graph: build 2D-degree kNN, add reverse edges,
    prune by rank to ``degree`` (simplified CAGRA optimisation pass).

    ``long_edges`` slots per node hold NSW-style random long-range edges —
    kNN graphs over clustered data are otherwise disconnected islands and
    greedy search cannot reach the query's cluster from a random entry.
    (CAGRA gets navigability from its rank-based reordering over an
    NN-descent graph whose boundary errors leak across clusters; with an
    exact kNN graph we must inject the shortcuts explicitly.)

    ``id_offset`` shifts every adjacency id by a constant: build a graph
    over a *segment* of a larger capacity index (rows
    [offset, offset+N)) directly in global id space.

    On a CUDA ``device`` the exact kNN rows are computed there; the rest of
    the construction is the numpy code either way. NN-descent
    (N > ``exact_threshold``) runs only with ``device="cpu"``: on a CUDA
    device raise ``exact_threshold`` to N to build the exact graph there.
    """
    N = db.shape[0]
    dev = resolve_device(device)
    if N > exact_threshold and dev.type != "cpu":
        raise ValueError(
            f"N={N} > exact_threshold={exact_threshold} selects NN-descent, "
            "which runs only with device='cpu'; pass exact_threshold>=N to "
            f"build the exact graph on {dev}")
    rng = np.random.default_rng(seed + 1)
    k0 = min(2 * degree, N - 1)
    if N <= exact_threshold:
        knn = build_knn_graph_exact(db, k0, device=dev)
    else:
        knn = build_knn_graph_nndescent(db, k0, seed=seed)

    short = degree - long_edges
    G = np.empty((N, degree), np.int32)
    G[:, :short] = knn[:, :short]
    G[:, short:] = rng.integers(0, N, size=(N, long_edges))

    # reverse-edge injection for zero-in-degree nodes (navigability)
    indeg = np.zeros(N, np.int64)
    np.add.at(indeg, G.reshape(-1), 1)
    orphans = np.where(indeg == 0)[0]
    for o in orphans:
        tgt = knn[o, 0]
        G[tgt, short - 1] = o
    return (G + id_offset).astype(np.int32)
