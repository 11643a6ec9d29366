"""``scan(body, carry, xs)``: the port's ``jax.lax.scan``, through which its
recurrences run (the sLSTM over time, the mLSTM and mamba over chunks,
mamba over a chunk's positions) and the train step over microbatches.

``body(carry, x_t) -> (carry, y_t)``; ``xs`` and the returned ``ys`` are
pytrees of tensors stacked on a leading axis of ``length`` steps (``xs``
may be None when ``length`` is given; ``y_t`` None gives ``ys`` None).
The port's recurrences scan over the step index (``torch.arange(n)`` on
the host) and slice their inputs in the body as the loops did: a slice of
a moved axis would give autograd's sums and products other layouts, and
the gradients other rounding.

On tensors that hold values it runs every step: the loop it replaces,
value for value. In the dry run (an active ``launch/cost.py`` counter and
a carry on the meta device, where nothing is computed) it runs five
steps: the first two, one middle step that stands for the n − 4 middle
steps (under ``CostCounter.repeat``, which counts its ops, its backward
and its kept storages n − 4 times), and the last two; ``ys`` stacks the
middle step's output n − 4 times. The steps at either end run as
themselves because they differ from the middle ones: the first reads the
initial state, the last feeds no further step, and the state's layout
(a DTensor's placements, here and in the gradient autograd sums where
the steps meet) may change over the first step's output and the first
sum before it repeats. Nested scans multiply.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.launch import cost

# the steps the dry run runs as themselves before and after the middle one
_LEAD = _TRAIL = 2


def _at(xs, t: int):
    if isinstance(xs, torch.Tensor):
        return xs[t]  # the recurrences' step index, per step
    return pytree.tree_map(lambda x: x[t], xs)


def _stack(ys, stack=torch.stack):
    if ys[0] is None:  # a body with no per-step output (lax.scan's None)
        return None
    return pytree.tree_map(lambda *y: stack(y), *ys)


class _Tiled(torch.autograd.Function):
    """The outputs of the steps that ran, the middle step's ``repeats``
    times, stacked as the n steps' outputs would be. Backward selects each
    step's row of the gradient, as ``stack``'s backward does, the middle
    step's under ``repeat`` (over a DTensor sharded on the step axis each
    select gathers it)."""

    @staticmethod
    def forward(ctx, counter, repeats, *ys):
        ctx.counter, ctx.repeats = counter, repeats
        return torch.stack(ys[:_LEAD] + ys[_LEAD:_LEAD + 1] * repeats
                           + ys[_LEAD + 1:])

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[0]
        rows = [grad.select(0, t) for t in range(_LEAD)]
        with ctx.counter.repeat(ctx.repeats):
            rows.append(grad.select(0, _LEAD))
        rows += [grad.select(0, t) for t in range(n - _TRAIL, n)]
        return (None, None, *rows)


def _counter_for(carry):
    """The active counter when every tensor of ``carry`` is on the meta
    device (a dry run), else None."""
    counter = cost.active()
    if counter is None:
        return None
    leaves = [t for t in pytree.tree_leaves(carry)
              if isinstance(t, torch.Tensor)]
    if leaves and all(getattr(t, "_local_tensor", t).is_meta
                      for t in leaves):
        return counter
    return None


def scan(body, carry, xs, length=None):
    """Returns (the last carry, the stacked ``y_t``)."""
    n = length if length is not None else pytree.tree_leaves(xs)[0].shape[0]
    counter = _counter_for(carry)
    repeats = n - _LEAD - _TRAIL
    ys = []
    for t in range(n if counter is None or repeats < 2 else _LEAD):
        carry, y = body(carry, _at(xs, t))
        ys.append(y)
    if len(ys) == n:
        return carry, _stack(ys)
    with counter.repeat(repeats, carry) as step:
        carry, y = body(carry, _at(xs, _LEAD))
        step.made(carry, y)
    ys.append(y)
    for t in range(n - _TRAIL, n):
        carry, y = body(carry, _at(xs, t))
        ys.append(y)
    return carry, _stack(ys, lambda y: _Tiled.apply(counter, repeats, *y))
