"""Device dispatchers for the port's kernels (the JAX package's
``kernels/ops.py``: ``distance_tasks``, ``flash_attention`` and
``decode_attention``, same signatures).

CUDA tensors go to the Hopper kernels; CPU tensors go to the plain-PyTorch
versions. There is no fallback: a CUDA tensor never reaches the plain
version, and a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import distance as _dist
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

MODES = ("slot_gather", "matmul_onehot")


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def distance_tasks(db, queries, task_ids, task_slot, metric: str = "l2",
                   task_block: int = 256, mode: str = "slot_gather"):
    """Fixed-shape distance stage: (T,) float32, dummies (id −1) = 1e30.

    db (N,d) · queries (R,d) · task_ids/task_slot (T,) int32 with
    T % task_block == 0 (the engine pads with dummies). ``task_block`` is
    the TPU kernel's tile and is kept as the same contract; the CUDA
    kernels run one warp per task whatever its value."""
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
    if _on_card(q):
        return _fa.flash_attention(q, k, v, causal=causal)
    return _ref.mha_ref(q, k, v, causal=causal)


def decode_attention(q, k, v, cur_len: int, block_s: int = 512):
    """q (B,H,hd) over the cache k/v (B,S,Hkv,hd) at positions <= cur_len
    -> (B,H,hd). ``block_s`` is the TPU kernel's tile, accepted and
    ignored: the CUDA kernel splits the positions by the card's SM count."""
    if _on_card(q):
        return _dec.decode_attention(q, k, v, cur_len)
    return _ref.decode_attn_ref(q, k, v, cur_len)
