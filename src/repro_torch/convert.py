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


def lm_params_from_numpy(cfg, params, device="cuda"):
    """The port's parameters from an LM parameter tree in the JAX package's
    layout with numpy leaves (``jax.device_get`` of
    ``model_zoo.init_params``): ``embed``, ``final_norm``, ``lm_head``
    (untied), ``blocks["l0"]`` with each leaf stacked on a leading layer
    axis (a MoE's experts stacked (L, E, ., .)) and the unstacked ``mtp``
    subtree. Returns the port's tree (``blocks`` a list of per-layer dicts)
    on ``device``, each leaf in the dtype ``init_lm_params`` gives it:
    ``cfg.dtype``, the MoE router float32. Values are carried bit for bit
    (bfloat16 leaves pass exactly through float32)."""
    from repro_torch.models.moe import ROUTER_DTYPE
    from repro_torch.models.transformer import DTYPES, check_supported

    check_supported(cfg)
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]

    def put(tree, name=""):
        if isinstance(tree, dict):
            return {k: put(v, k) for k, v in tree.items()}
        return torch.tensor(np.asarray(tree, np.float32)).to(
            device=dev, dtype=ROUTER_DTYPE if name == "router" else dtype)

    stacked = params["blocks"]["l0"]
    n = len(np.asarray(stacked["ln1"]))
    if n != cfg.num_layers:
        raise ValueError(f"tree has {n} layers, cfg {cfg.num_layers}")
    out = {k: put(v, k) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [put(_layer_tree(stacked, i)) for i in range(n)]
    return out


def lm_params_to_numpy(params):
    """The inverse of ``lm_params_from_numpy``: the JAX package's layout
    (``blocks["l0"]`` stacked on a leading layer axis, ``mtp`` unstacked)
    with float32 numpy leaves, exact for float32 and bfloat16 parameters."""
    def get(tree):
        if isinstance(tree, dict):
            return {k: get(v) for k, v in tree.items()}
        return tree.detach().float().cpu().numpy()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    out = {k: get(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {"l0": stack([get(b) for b in params["blocks"]])}
    return out
