"""The control (the reference in the program's place, at the precision
below the configuration's: fp8 weights for the bfloat16 model, TF32 for
the float32 pool) comes out not correct against each cell's limits,
where the program passes.

On the CPU at a small size; at the cells' own size on the card (marked
``cuda``: ``python -m pytest bench/tests -m cuda`` on a machine with
one)."""
import pytest
import torch

from bench import manifest as mf
from bench.calibrate import readings
from bench_tiny import MAN, POOL, SERVE, one_thread, pool_cell, serve_cell


def limits(cell):
    return mf.limits_file(mf.cell(MAN, cell)["config"])["numbers"]


def test_serving_control_fails_where_the_program_passes():
    c, t = serve_cell(batch=8)
    t["prompt_lengths"] = [16]
    with one_thread():
        r = readings(mf.cell(MAN, SERVE), c, t,
                     mf.limits_file("jamba2-mini-rag"), 5, 0.1, True, "cpu")
    lim = limits(SERVE)["logit_gap_mean"]
    assert r["program"]["logit_gap_mean"] <= lim
    assert r["control"]["logit_gap_mean"] > lim


def test_pool_control_fails_where_the_program_passes():
    c, t = pool_cell()
    with one_thread():
        r = readings(mf.cell(MAN, POOL), c, t, mf.limits_file("sift1m-pool"),
                     5, 1.0, True, "cpu")
    lim = limits(POOL)["dist_err"]
    assert r["program"]["dist_err"] <= lim < r["control"]["dist_err"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [POOL, SERVE])
def test_control_at_the_cells_own_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells' own size")
    w = mf.cell(MAN, cell)
    config = mf.config_file(MAN, w["config"])
    traffic = mf.traffic_file(w["traffic"])
    if "prompt_lengths" in traffic:  # the call a run compares
        traffic["prompt_lengths"] = [max(traffic["prompt_lengths"])]
    lim = limits(cell)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        r = readings(w, config, traffic, mf.limits_file(w["config"]), seed,
                     1.0, True)
        fails = [k for k in lim if k in r["control"] and (
            r["control"][k] < lim[k] if k == "recall"
            else r["control"][k] > lim[k])]
        assert fails, r
