"""Device dispatchers for the port's kernels (the JAX package's
``kernels/ops.py``: ``distance_tasks``, ``flash_attention`` and
``decode_attention``, same signatures), and the sharded pool's three
partial-top-k merges as torch ops on their tensors' device.

CUDA tensors go to the Hopper kernels; CPU tensors go to the plain-PyTorch
versions. There is no fallback: a CUDA tensor never reaches the plain
version, and a kernel that fails to build or launch raises. The kernels are
bound through ctypes and have no backward, so the four dispatchers refuse,
on either device, an input that needs a gradient while autograd is on
(training attends through ``models/attention.py::attend_blocked``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import distance as _dist
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.vector.cagra import smallest_k

MODES = ("slot_gather", "matmul_onehot")
_INF = 1e30


def merge_partial_topk(ids, dists, *, k: int):
    """Scatter–gather merge: per-shard partial top-k lists into the global
    top-k. ids (..., S, K) int32 global row ids (−1 = padding), dists
    (..., S, K) float32 (numpy arrays or tensors). Returns tensors (ids
    (..., k) int32, dists (..., k) float32) ascending, −1/1e30 padded when
    fewer than ``k`` valid entries exist.

    One selection over the flattened S·K pool; ties break to the lower flat
    index (shard order), as ``jax.lax.top_k`` does in the JAX package: a
    stable ascending sort (``vector/cagra.py::smallest_k``), never
    ``torch.topk``, whose tie order is not specified."""
    ids = torch.as_tensor(ids)
    dists = torch.as_tensor(dists, device=ids.device)
    pool = ids.shape[-2] * ids.shape[-1]
    assert k <= pool, (k, tuple(ids.shape))
    flat_ids = ids.reshape(ids.shape[:-2] + (pool,))
    flat_d = torch.where(flat_ids >= 0,
                         dists.reshape(flat_ids.shape).float(), _INF)
    out_d, sel = smallest_k(flat_d, k)
    out_ids = torch.where(out_d < _INF, flat_ids.gather(-1, sel), -1)
    return out_ids, out_d


def fold_partial_topk(buf_ids, buf_dists, top_ids, top_dists, trans, g_idx,
                      slots, rows, cols):
    """On-device fold: each completing child's (M,) partial list, read from
    the grouped engine state at (lane g_idx, slot), translated shard-local →
    global through ``trans`` (S, T) (−1 = tombstoned; a local id past T − 1
    clips to the last column, a −1 sentinel) and written into its parent's
    merge-buffer row ``rows`` at shard column ``cols``, in place.

    buf_ids/buf_dists (P, S, M); top_ids/top_dists (G, R, M); g_idx, slots,
    rows, cols (B,) int64 tensors. The pool pads B to a power of two by
    repeating entry 0, so duplicate writes store identical values. Returns
    the buffers."""
    cid = top_ids[g_idx, slots]  # (B, M) shard-local ids
    cd = top_dists[g_idx, slots]
    safe = cid.long().clamp(0, trans.shape[1] - 1)
    gid = torch.where(cid >= 0, trans[cols[:, None], safe], -1)
    buf_ids[rows, cols] = gid.to(buf_ids.dtype)
    buf_dists[rows, cols] = cd
    return buf_ids, buf_dists


def finalize_partial_topk(buf_ids, buf_dists, rows_f, *, k: int):
    """Finish the parents whose merge-buffer rows are complete: one
    ``merge_partial_topk`` per row over its (S, M) pool, then clear the rows
    for reuse (in place). ``rows_f`` (F,) int64, power-of-two padded by
    repeating entry 0 (re-merging and re-clearing a row is idempotent).
    Returns (buf_ids, buf_dists, merged ids (F, k), merged dists (F, k))."""
    m_ids, m_d = merge_partial_topk(buf_ids[rows_f], buf_dists[rows_f], k=k)
    buf_ids[rows_f] = -1
    buf_dists[rows_f] = _INF
    return buf_ids, buf_dists, m_ids, m_d


def _refuse_autograd(name: str, *tensors):
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"ops.{name}: an input requires grad, but the kernel is bound "
            "through ctypes and has no backward (its gradient would be "
            "silently lost); run under torch.no_grad(), or train through "
            "attention_forward(..., blocked=True)")


def _on_card(t) -> bool:
    """True for a CUDA tensor. CPU tensors take the plain version, and so
    do meta tensors, the dry run's stand-ins (``launch/dryrun.py``), which
    hold no data: on them the plain version only traces shapes."""
    if t.device.type == "cuda":
        return True
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {t.device}")
    return False


def distance_tasks(db, queries, task_ids, task_slot, metric: str = "l2",
                   task_block: int = 256, mode: str = "slot_gather"):
    """Fixed-shape distance stage: (T,) float32, dummies (id −1) = 1e30.

    db (N,d) · queries (R,d) · task_ids/task_slot (T,) int32 with
    T % task_block == 0 (the engine pads with dummies). ``task_block`` is
    the TPU kernel's tile and is kept as the same contract; the CUDA
    kernels run one warp per task whatever its value."""
    _refuse_autograd("distance_tasks", db, queries)
    T = task_ids.shape[0]
    if task_block <= 0 or T % task_block:
        raise ValueError(f"T={T} must be a multiple of task_block="
                         f"{task_block}")
    if mode not in MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")
    if _on_card(db):
        kernel = (_dist.distance_slot_gather if mode == "slot_gather"
                  else _dist.distance_onehot)
        return kernel(db, queries, task_ids, task_slot, metric=metric)
    plain = (_ref.distance_tasks_ref if mode == "slot_gather"
             else _ref.distance_tasks_onehot_ref)
    return plain(db, queries, task_ids, task_slot, metric=metric)


def distance_tasks_group(dbs, queries, task_ids, task_slot,
                         metric: str = "l2", task_block: int = 256,
                         mode: str = "slot_gather"):
    """The distance stage over G lanes in one call: (G, T) float32.

    dbs (G, N, d) · queries (G, R, d) · task_ids/task_slot (G, T) int32,
    T % task_block == 0. Lane g equals ``distance_tasks`` on lane g's
    arrays: the written-out counterpart of the ``jax.vmap`` over shard
    replicas in the JAX package's ``extend_multi_group``. CUDA tensors take
    one launch of the lane kernel; CPU tensors the batched plain version."""
    _refuse_autograd("distance_tasks_group", dbs, queries)
    T = task_ids.shape[-1]
    if task_block <= 0 or T % task_block:
        raise ValueError(f"T={T} must be a multiple of task_block="
                         f"{task_block}")
    if mode not in MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")
    if dbs.dim() != 3:
        raise ValueError(f"dbs must be (G, N, d), got {tuple(dbs.shape)}")
    if _on_card(dbs):
        kernel = (_dist.distance_slot_gather_group if mode == "slot_gather"
                  else _dist.distance_onehot_group)
        return kernel(dbs, queries, task_ids, task_slot, metric=metric)
    _dist.check_inputs(dbs, queries, task_ids, task_slot, metric)
    plain = (_ref.distance_tasks_group_ref if mode == "slot_gather"
             else _ref.distance_tasks_onehot_group_ref)
    return plain(dbs, queries, task_ids, task_slot, metric=metric)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 256,
                    block_k: int = 256):
    """q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd) -> (B,Sq,H,hd). ``block_q`` and
    ``block_k`` are the TPU kernel's tiles, accepted and ignored: the CUDA
    kernel picks its own tiles from hd and masks ragged ones."""
    _refuse_autograd("flash_attention", q, k, v)
    if _on_card(q):
        return _fa.flash_attention(q, k, v, causal=causal)
    return _ref.mha_ref(q, k, v, causal=causal)


def decode_attention(q, k, v, cur_len: int, block_s: int = 512,
                     return_lse: bool = False):
    """q (B,H,hd) over the cache k/v (B,S,Hkv,hd) at positions <= cur_len
    -> (B,H,hd); with ``return_lse`` -> (out in float32, lse (B,H)
    float32), the partial the sequence-sharded decode combines: the output
    unrounded and each head's log-sum-exp of its scaled scores.
    ``block_s`` is the TPU kernel's tile, accepted and ignored: the CUDA
    kernel splits the positions by the card's SM count."""
    _refuse_autograd("decode_attention", q, k, v)
    if _on_card(q):
        return _dec.decode_attention(q, k, v, cur_len, return_lse=return_lse)
    return _ref.decode_attn_ref(q, k, v, cur_len, return_lse=return_lse)
