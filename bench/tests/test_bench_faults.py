"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (one card: no exchange between
chips to leave out). Small cells on the CPU, the harness's look for a
card skipped, the program patched under the run."""
import numpy as np
import pytest
import torch

from bench_tiny import POOL, SERVE, pool_cell, run, serve_cell


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _serve_faults(model_zoo):
    real = model_zoo.decode_fn

    def unchanged(cfg, params, token, caches, cur_len, *a):
        old = _clone(caches)  # the step's state, as it came in
        logits, _ = real(cfg, params, token, caches, cur_len, *a)
        return logits, old

    def altered(cfg, params, token, caches, cur_len, *a):
        logits, caches = real(cfg, params, token, caches, cur_len, *a)
        return logits.roll(1, dims=-1), caches  # each token one id off

    def half(cfg, params, token, caches, cur_len, *a):
        logits, caches = real(cfg, params, token, caches, cur_len, *a)
        B = logits.shape[0]
        logits = logits.clone()
        logits[B // 2:] = logits[:B - B // 2].mean(0, keepdim=True)
        return logits, caches

    return {"state_unchanged": unchanged, "token_altered": altered,
            "half_batch": half}


@pytest.mark.parametrize("fault", ["state_unchanged", "token_altered",
                                   "half_batch"])
def test_serving_fault_is_not_correct(fault, monkeypatch):
    from repro_torch.models import model_zoo

    monkeypatch.setattr(model_zoo, "decode_fn", _serve_faults(model_zoo)[fault])
    c, t = serve_cell(batch=4)
    out, _, _ = run(SERVE, c, t, seconds=0.1)
    assert out["correct"] is False
    assert out["checks"]["logit_gap_mean"]["value"] > out["checks"]["logit_gap_mean"][
        "limit"]


def test_pool_step_returning_its_state_unchanged(monkeypatch):
    from repro_torch.core import continuous_batching as cb

    real = cb.extend_multi

    def unchanged(state, *a, **kw):
        saved = {k: v.clone() for k, v in vars(state).items()
                 if isinstance(v, torch.Tensor)}
        out = real(state, *a, **kw)
        for k, v in saved.items():
            setattr(state, k, v)
        return out

    monkeypatch.setattr(cb, "extend_multi", unchanged)
    c, t = pool_cell()
    t["drain_s"] = 0.5
    out, _, _ = run(POOL, c, t)
    assert out["correct"] is False


def test_pool_answer_altered(monkeypatch):
    from repro_torch.core import continuous_batching as cb

    real = cb.ContinuousBatchingEngine.step_multi

    def altered(self, *a, **kw):
        done, tasks = real(self, *a, **kw)
        return [(rid, (ids + 1) % 3000, d, e, s)
                for rid, ids, d, e, s in done], tasks

    monkeypatch.setattr(cb.ContinuousBatchingEngine, "step_multi", altered)
    out, _, _ = run(POOL, *pool_cell())
    assert out["correct"] is False
    assert out["checks"]["dist_err"]["value"] > out["checks"]["dist_err"][
        "limit"]


def test_pool_half_of_the_task_batch_left_out(monkeypatch):
    from repro_torch.kernels import ops

    real = ops.distance_tasks

    def half(db, queries, task_ids, task_slot, *a, **kw):
        d = real(db, queries, task_ids, task_slot, *a, **kw)
        T = d.shape[0]
        valid = d[: T // 2][d[: T // 2] < 1e29]
        fill = valid.mean() if valid.numel() else d.new_zeros(())
        return torch.cat([d[: T // 2],
                          torch.where(d[T // 2:] < 1e29, fill, d[T // 2:])])

    monkeypatch.setattr(ops, "distance_tasks", half)
    out, _, _ = run(POOL, *pool_cell())
    assert out["correct"] is False
    assert np.isfinite(out["checks"]["dist_err"]["value"])
