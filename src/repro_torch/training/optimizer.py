"""AdamW (the JAX package's ``training/optimizer.py``). Moments are float32
and shaped like their parameters; the update is per-leaf math in float32
in the reference's order of operations, cast back to each leaf's dtype.

Parameter trees are the port's: nested dicts and lists of tensors.
``tree_leaves`` walks them in insertion order (``jax.tree.leaves`` sorts
dict keys, so sums over leaves, as ``global_norm``'s, add in another order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_leaves(tree):
    """The tensors of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of the same structure); the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def init_opt_state(params) -> Dict[str, Any]:
    """{"m", "v": float32 zeros shaped like each leaf, "step": int64 0-d}."""
    # zeros_like keeps a DTensor leaf's layout (the dry run's shards)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int64, device=leaf.device)}


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree):
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}); the
    inputs are left as they are."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = _schedule(cfg, step)
    c1 = 1 - cfg.b1 ** step.float()
    c2 = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
