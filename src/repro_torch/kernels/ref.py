"""Plain-PyTorch versions of the port's kernels (their references): the
distance stage and prefill/decode attention.

They run on any device: the dispatchers (``kernels/ops.py``) send CPU
tensors here, and ``chip_smoke.py`` compares each Hopper kernel with its
plain version on the card. Distance indexing follows the JAX package's
gather semantics: ids clamp into [0, N) (dummies, id −1, read row 0).
Attention computes in float32 inside and returns ``q.dtype``, as the JAX
package's ``kernels/ref.py`` does.
"""
from __future__ import annotations

import math

import torch

DUMMY_DIST = 1e30
NEG_INF = -1e30


def _rows(db, task_ids):
    return db[task_ids.long().clamp(0, db.shape[0] - 1)].float()


def distance_tasks_ref(db, queries, task_ids, task_slot, metric: str = "l2"):
    """Plain version of the slot-gather distance stage.

    Gathers the owning query row per task and reduces row-wise — O(T·d)
    work, the same dataflow as the ``slot_gather`` kernel.

    db:        (N, d)  database vectors
    queries:   (R, d)  per-request-slot query vectors
    task_ids:  (T,)    db row per task; -1 marks a masked dummy
    task_slot: (T,)    owning request slot per task
    Returns (T,) float32 distances; dummies get DUMMY_DIST.
    """
    x = _rows(db, task_ids)  # (T, d)
    q = queries[task_slot.long()].float()  # (T, d)
    if metric == "l2":
        dist = ((x - q) ** 2).sum(-1)
    elif metric == "ip":
        dist = -(x * q).sum(-1)
    else:
        raise ValueError(metric)
    return torch.where(task_ids >= 0, dist, DUMMY_DIST)


def distance_tasks_onehot_ref(db, queries, task_ids, task_slot,
                              metric: str = "l2"):
    """Plain version of the matmul+one-hot distance stage.

    Computes the full (T, R) task-by-slot Gram matrix then one-hot-selects
    the owning column — O(T·R·d) work, the numerical oracle for the
    ``matmul_onehot`` path (the slot-gather path must agree to 1e-4).
    """
    x = _rows(db, task_ids)  # (T, d)
    q = queries.float()  # (R, d)
    xq = x @ q.T  # (T, R)
    R = q.shape[0]
    onehot = task_slot.long()[:, None] == torch.arange(R, device=q.device)[None]
    sel_xq = torch.where(onehot, xq, 0.0).sum(1)
    if metric == "l2":
        xnorm = (x * x).sum(1)
        qnorm = (q * q).sum(1)
        sel_qn = torch.where(onehot, qnorm[None, :], 0.0).sum(1)
        dist = xnorm - 2.0 * sel_xq + sel_qn
    elif metric == "ip":
        dist = -sel_xq
    else:
        raise ValueError(metric)
    return torch.where(task_ids >= 0, dist, DUMMY_DIST)


def _lane_rows(dbs, task_ids):
    """(G, T, d): each lane's rows by a batched gather, ids clamped into
    [0, N) as in ``_rows``."""
    lane = torch.arange(dbs.shape[0], device=dbs.device)[:, None]
    return dbs[lane, task_ids.long().clamp(0, dbs.shape[1] - 1)].float()


def distance_tasks_group_ref(dbs, queries, task_ids, task_slot,
                             metric: str = "l2"):
    """Plain version of the slot-gather stage over G lanes: dbs (G, N, d),
    queries (G, R, d), task_ids/task_slot (G, T) -> (G, T); lane g is
    ``distance_tasks_ref`` on lane g's arrays (``jax.vmap`` of the JAX
    reference)."""
    x = _lane_rows(dbs, task_ids)  # (G, T, d)
    lane = torch.arange(dbs.shape[0], device=dbs.device)[:, None]
    q = queries[lane, task_slot.long()].float()  # (G, T, d)
    if metric == "l2":
        dist = ((x - q) ** 2).sum(-1)
    elif metric == "ip":
        dist = -(x * q).sum(-1)
    else:
        raise ValueError(metric)
    return torch.where(task_ids >= 0, dist, DUMMY_DIST)


def distance_tasks_onehot_group_ref(dbs, queries, task_ids, task_slot,
                                    metric: str = "l2"):
    """Plain version of the one-hot stage over G lanes (shapes as
    ``distance_tasks_group_ref``): each lane's (T, R) Gram, then a one-hot
    select of the owning column."""
    x = _lane_rows(dbs, task_ids)  # (G, T, d)
    q = queries.float()  # (G, R, d)
    xq = x @ q.transpose(1, 2)  # (G, T, R)
    R = q.shape[1]
    onehot = (task_slot.long()[..., None]
              == torch.arange(R, device=q.device)[None, None])
    sel_xq = torch.where(onehot, xq, 0.0).sum(-1)
    if metric == "l2":
        xnorm = (x * x).sum(-1)
        qnorm = (q * q).sum(-1)  # (G, R)
        sel_qn = torch.where(onehot, qnorm[:, None, :], 0.0).sum(-1)
        dist = xnorm - 2.0 * sel_xq + sel_qn
    elif metric == "ip":
        dist = -sel_xq
    else:
        raise ValueError(metric)
    return torch.where(task_ids >= 0, dist, DUMMY_DIST)


def mha_ref(q, k, v, causal: bool = True):
    """q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd) -> (B,Sq,H,hd). GQA broadcast:
    query head h reads kv head h // (H/Hkv); causal mask qpos >= kpos over
    row indices; scale 1/sqrt(hd)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attn_ref(q, k, v, cur_len: int, return_lse: bool = False):
    """q: (B,H,hd) single step; k/v: (B,S,Hkv,hd); positions <= cur_len
    attend. Returns (B,H,hd) in q's dtype; with ``return_lse`` (out in
    float32, unrounded, and each head's (B,H) float32 log-sum-exp of its
    scaled scores over those positions): the kernel's partial for the
    sequence-sharded decode."""
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) / math.sqrt(hd)
    valid = torch.arange(S, device=q.device) <= cur_len
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v.float())
    out = out.reshape(B, H, hd)
    if not return_lse:
        return out.to(q.dtype)
    return out, torch.logsumexp(scores, dim=-1).reshape(B, H)
