"""State carried into the port from numpy (the port's counterpart of
loading weights): the index arrays, a whole engine state pulled from the
JAX package with ``jax.device_get``, host-side slot checkpoints, and a
language model's parameter tree.

Inputs are duck-typed numpy views, so this module needs neither JAX nor the
JAX package: anything with the named attributes converts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def index_from_numpy(db, graph, device="cuda"):
    """(db (N, d) float32, graph (N, D) int32) contiguous tensors on
    ``device``. Tensors already of that dtype and on that device are used
    as they are (the index then shares them), numpy arrays on the CPU
    without a copy."""
    dev = resolve_device(device)
    db_t = torch.as_tensor(db, dtype=torch.float32, device=dev).contiguous()
    graph_t = torch.as_tensor(graph, dtype=torch.int32, device=dev).contiguous()
    if db_t.dim() != 2 or graph_t.dim() != 2 \
            or db_t.shape[0] != graph_t.shape[0]:
        raise ValueError(f"db {tuple(db_t.shape)} and graph "
                         f"{tuple(graph_t.shape)} must be (N, d) and (N, D)")
    return db_t, graph_t


_STATE_FIELDS = (("query_vecs", np.float32), ("top_ids", np.int32),
                 ("top_dists", np.float32), ("expanded", np.bool_),
                 ("visited", np.int32), ("active", np.bool_),
                 ("extends", np.int32), ("budget", np.int32))


def engine_state_from_numpy(arrays, device="cuda"):
    """A port ``EngineState`` from an object with the engine-state fields
    as arrays (e.g. ``jax.device_get`` of the JAX package's
    ``EngineState``)."""
    from repro_torch.core.continuous_batching import EngineState

    dev = resolve_device(device)
    return EngineState(**{
        name: torch.as_tensor(np.array(getattr(arrays, name), dtype),
                              device=dev)
        for name, dtype in _STATE_FIELDS})


def checkpoint_from_numpy(ckpt):
    """A port ``SlotCheckpoint`` from an object with a slot checkpoint's
    numpy fields (e.g. the JAX package's ``SlotCheckpoint``)."""
    from repro_torch.core.continuous_batching import SlotCheckpoint

    top_k = getattr(ckpt, "top_k", None)
    return SlotCheckpoint(
        query_vec=np.array(ckpt.query_vec, np.float32),
        top_ids=np.array(ckpt.top_ids, np.int32),
        top_dists=np.array(ckpt.top_dists, np.float32),
        expanded=np.array(ckpt.expanded, bool),
        visited=np.array(ckpt.visited, np.int32),
        extends=int(ckpt.extends),
        budget=int(getattr(ckpt, "budget", 0)),
        top_k=None if top_k is None else int(top_k))


def _layer_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int):
    """A tree whose leaves are stacked on a leading axis of ``n`` -> a list
    of ``n`` trees."""
    return [_layer_tree(tree, i) for i in range(n)]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(np.asarray(tree))


# bfloat16 in numpy: two raw bytes a value, the void dtype ``np.savez``
# writes for an ``ml_dtypes.bfloat16`` array (and ``np.load`` reads back)
BF16_VOID = np.dtype("V2")


def tensor_from_numpy(a):
    """A CPU tensor of ``a``'s dtype; a 2-byte void (bfloat16 as numpy
    holds it without ``ml_dtypes``, or an ``ml_dtypes.bfloat16`` array)
    becomes bfloat16, bit for bit."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def tensor_to_numpy(t):
    """The inverse of ``tensor_from_numpy``: bfloat16 as ``BF16_VOID``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_VOID)
    return t.numpy()


def lm_params_from_numpy(cfg, params, device="cuda", keep_dtype=False):
    """The port's parameters from a parameter tree in the JAX package's
    layout with numpy leaves (``jax.device_get`` of
    ``model_zoo.init_params``), on ``device``:

    - ``block_kind="attn"``: ``blocks["l0"]`` with each leaf stacked on a
      leading layer axis (a MoE's experts stacked (L, E, ., .)) becomes a
      list of per-layer dicts; the ``mtp`` subtree is unstacked;
    - ``"mamba_attn"`` and ``"xlstm"``: ``blocks["l{i}"]`` stacked on the
      group axis becomes a list of per-group dicts keyed ``l{i}``;
    - ``"encdec"``: ``encoder`` and ``decoder``, stacked on their layer
      axes, become lists of per-layer dicts.

    Each leaf takes the dtype the port's init gives it: ``cfg.dtype``, but
    float32 for the MoE router and mamba's ``A_log`` and ``D``. Values are
    carried bit for bit (bfloat16 leaves pass exactly through float32).
    With ``keep_dtype`` each leaf keeps its own dtype instead (a
    checkpoint's leaves, the optimizer's float32 moments; see
    ``tensor_from_numpy``)."""
    from repro_torch.models.mamba import F32_LEAVES
    from repro_torch.models.moe import ROUTER_DTYPE
    from repro_torch.models.transformer import (DTYPES, group_layer_kinds,
                                                num_groups)

    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    f32 = {"router": ROUTER_DTYPE, **{k: torch.float32 for k in F32_LEAVES}}

    def put(tree, name=""):
        if isinstance(tree, dict):
            return {k: put(v, k) for k, v in tree.items()}
        if keep_dtype:
            return tensor_from_numpy(tree).to(dev)
        return torch.tensor(np.asarray(tree, np.float32)).to(
            device=dev, dtype=f32.get(name, dtype))

    if cfg.block_kind == "encdec":
        stacks = {"encoder": cfg.encoder_layers,
                  "decoder": cfg.num_layers - cfg.encoder_layers}
    else:
        group_layer_kinds(cfg)  # ValueError for a block kind with no stack
        stacks = {"blocks": num_groups(cfg)}
    out = {}
    for key, tree in params.items():
        n = stacks.get(key)
        if n is None:
            out[key] = put(tree, key)
            continue
        if _leading(tree) != n:
            raise ValueError(f"tree's {key} has {_leading(tree)} layers or "
                             f"groups, cfg {n}")
        if cfg.block_kind == "attn":
            tree = tree["l0"]
        out[key] = [put(t) for t in _unstack(tree, n)]
    return out


def lm_params_to_numpy(params, keep_dtype=False):
    """The inverse of ``lm_params_from_numpy``: the JAX package's layout
    (per-layer lists stacked into ``blocks["l0"]``, per-group lists into
    ``blocks["l{i}"]``, ``encoder``/``decoder`` onto their layer axes;
    ``mtp`` unstacked) with float32 numpy leaves, exact for float32 and
    bfloat16 parameters; with ``keep_dtype`` each leaf in its own dtype
    (``tensor_to_numpy``)."""
    def get(tree):
        if isinstance(tree, dict):
            return {k: get(v) for k, v in tree.items()}
        if keep_dtype:
            return tensor_to_numpy(tree)
        return tree.detach().float().cpu().numpy()

    out = {}
    for k, v in params.items():
        if not isinstance(v, list):
            out[k] = get(v)
        elif k == "blocks" and "l0" not in v[0]:  # per-layer attention blocks
            out[k] = {"l0": _stack([get(b) for b in v])}
        else:
            out[k] = _stack([get(b) for b in v])
    return out
