"""The train step (microbatch accumulation × per-layer remat × MoE aux) and
the host ``Trainer`` with checkpoint/restart fault tolerance (the JAX
package's ``training/train_loop.py``).

Gradients come from autograd over the leaves of the port's parameter tree
(``torch.autograd.grad``). Microbatches run one after the other through
``models/scan.py`` and their gradients accumulate in float32, ``g / n``
each, as the reference's ``lax.scan`` accumulates them; live activation
memory is one microbatch's.
Each microbatch's slice keeps the batch's sharding pinned (``constrain``,
the identity outside the dry run's ``activation_sharding``).
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models import model_zoo
from repro_torch.models.scan import scan
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, tree_leaves,
                                            tree_unflatten)


def value_and_grad(cfg, params, batch):
    """(loss, metrics, grads): the loss and metrics detached, the
    gradients in the structure of ``params`` and each leaf's dtype (zeros
    for a leaf the loss does not reach). Gradients are taken on detached
    aliases of the leaves: the caller's tensors keep ``requires_grad``
    off, so the tree still serves through the kernels."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model_zoo.loss_fn(cfg, tree_unflatten(params, leaves),
                                          batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: torch.as_tensor(v).detach()
                            for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg, opt_cfg: AdamWConfig, num_microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), new trees each time (the inputs are left as they are).

    The batch's leading dim must divide by ``num_microbatches``; the
    gradients are averaged over the microbatches."""
    n = num_microbatches

    def train_step(params, opt_state, batch):
        if n == 1:
            loss, metrics, grads = value_and_grad(cfg, params, batch)
        else:
            def step(carry, i):
                g_acc, l_acc = carry
                mb = {k: constrain(v.reshape(n, v.shape[0] // n,
                                             *v.shape[1:]),
                                   None, "batch", *([None] * (v.ndim - 1))
                                   )[int(i)]
                      for k, v in batch.items()}
                loss, metrics, g = value_and_grad(cfg, params, mb)
                g_acc = [a + b.float() / n
                         for a, b in zip(g_acc, tree_leaves(g))]
                return (g_acc, l_acc + loss / n), metrics

            g_acc = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tree_leaves(params)]
            l_acc = torch.zeros((), dtype=torch.float32,
                                device=g_acc[0].device)
            # the microbatch index on the host: the step slices it out
            (g_acc, loss), metrics = scan(step, (g_acc, l_acc),
                                          torch.arange(n))
            grads = tree_unflatten(params, g_acc)
            metrics = {k: v.mean() for k, v in metrics.items()}
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads,
                                                      opt_state)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


class Trainer:
    """Host loop: the train step + periodic atomic checkpoints + resume.

    Fault tolerance contract (``tests/test_torch_checkpoint.py``): a run
    killed at any point resumes from the latest complete checkpoint with
    bit-identical params/opt-state and a data pipeline that replays the
    exact step sequence (``data.batch_at`` is pure in step).

    ``params``: a parameter tree to start from (e.g. converted from the
    JAX package) instead of ``model_zoo.init_params(cfg, seed)``; a
    checkpoint in ``checkpoint_dir`` wins over both. ``step_s`` holds each
    step's wall time (host clock, to the loss on the host; checkpoint
    writes not included)."""

    def __init__(self, cfg, data, opt_cfg: Optional[AdamWConfig] = None,
                 num_microbatches: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 50, seed: int = 0, device="cuda",
                 params=None):
        from repro_torch.checkpoint.checkpointer import Checkpointer

        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.ckpt = (Checkpointer(checkpoint_dir, cfg, device=self.device)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.step_fn = make_train_step(cfg, self.opt_cfg, num_microbatches)
        self.step_s = []
        restored = self.ckpt.restore_latest() if self.ckpt else None
        if restored is not None:
            self.params, self.opt_state, self.step = restored
        else:
            self.params = (params if params is not None else
                           model_zoo.init_params(cfg, seed, self.device))
            self.opt_state = init_opt_state(self.params)
            self.step = 0

    def batch(self, step: int):
        """The data's batch ``step`` as tensors on the trainer's device."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self.data.batch_at(step).items()}

    def run(self, num_steps: int, log_every: int = 10, log=print):
        """Steps until ``self.step == num_steps``; returns each step's
        loss."""
        history = []
        t0 = time.perf_counter()  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
        while self.step < num_steps:
            t_step = time.perf_counter()  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, self.batch(self.step))
            self.step += 1
            loss = float(metrics["loss"])
            t = time.perf_counter()  # repro-analyze: disable=DET002 (wall-clock reporting of real work)
            self.step_s.append(t - t_step)
            history.append(loss)
            if log and self.step % log_every == 0:
                log(f"step {self.step:5d} loss {loss:.4f} "
                    f"({(t - t0) / self.step:.2f}s/step)")
            if self.ckpt and self.step % self.checkpoint_every == 0:
                self.ckpt.save(self.params, self.opt_state, self.step)
        if self.ckpt:
            self.ckpt.save(self.params, self.opt_state, self.step)
        return history
