"""A model's weights, made by the benchmark on the card from the seed.

The tree has the port's layout (``model_zoo.param_specs``: shapes and
dtypes on ``meta``, nothing drawn by the program). Its values follow the
port's initial distributions, drawn in a few large calls: every random
leaf of one dtype and one scale is a view into one flat buffer that a
single generator fills. The same tensors are handed to the program
(``RealServer(params=...)``) and to the plain reference, so the reference
takes nothing the program made.
"""
from __future__ import annotations

import math
from collections import defaultdict

import torch

CHUNK = 1 << 30  # elements a generator call fills
ZERO = ("ln1", "ln2", "final_norm", "conv_b", "bq", "bk", "bv")


def _constant(name: str, shape, dtype, device):
    if name in ZERO:
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "dt_bias":  # softplus^-1(1)
        return torch.full(shape, math.log(math.e - 1), dtype=torch.float32,
                          device=device).to(dtype)
    if name == "A_log":  # S4D-real: A = -(1 .. d_state) on every channel
        di, ds = shape
        a = torch.arange(1, ds + 1, dtype=torch.float32, device=device)
        return torch.log(a)[None, :].repeat(di, 1).to(dtype)
    if name == "D":
        return torch.ones(shape, dtype=dtype, device=device)
    return None


def _scale(name: str, shape) -> float:
    if name == "embed":
        return 0.02
    if len(shape) < 2:
        raise ValueError(f"no initial distribution for leaf {name!r} "
                         f"{tuple(shape)}")
    return 1.0 / math.sqrt(shape[-2])  # fan-in


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v) for v in tree]
    return tree


def make_weights(spec_tree, seed: int, device) -> dict:
    """Fill a tree of meta tensors on ``device`` from ``seed``."""
    tree = _copy_tree(spec_tree)
    groups = defaultdict(list)  # (dtype, scale) -> [(path, shape)]
    for path, t in _leaves(tree):
        name = str(path[-1])
        const = _constant(name, t.shape, t.dtype, device)
        if const is not None:
            _set(tree, path, const)
        else:
            groups[(t.dtype, _scale(name, t.shape))].append((path, t.shape))
    gen = torch.Generator(device=device).manual_seed(seed)
    for (dtype, scale), members in sorted(groups.items(),
                                          key=lambda kv: (str(kv[0][0]),
                                                          kv[0][1])):
        total = sum(math.prod(s) for _, s in members)
        flat = torch.empty(total, dtype=dtype, device=device)
        for s0 in range(0, total, CHUNK):
            flat[s0:s0 + CHUNK].normal_(0.0, scale, generator=gen)
        off = 0
        for path, shape in members:
            n = math.prod(shape)
            _set(tree, path, flat[off:off + n].view(shape))
            off += n
    return tree

