"""The plain references agree with the port at a small size on the CPU,
through a whole run of each cell: float32 served tokens are the
reference's best (capacity drops included), pool answers carry their
ids' own distances."""
import numpy as np
import pytest
import torch

from bench.reference import jamba, knn
from bench_tiny import POOL, SERVE, pool_cell, run, serve_cell


@pytest.mark.parametrize("batch,capacity_factor", [(4, None), (12, 0.5)])
def test_serving_run_matches_the_reference(batch, capacity_factor):
    c, t = serve_cell(batch=batch, capacity_factor=capacity_factor)
    out, checks, sysrun = run(SERVE, c, t, seconds=0.1)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap_mean"]["value"] < 1e-4
    if capacity_factor is not None:  # drops happened, and agreed
        assert sysrun.counters["reference_pairs_dropped"] > 0
    assert out["attempted"] % (batch * 2) == 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"output_tokens_per_s", "ttft_ms",
                                   "setup_s"}


def test_pool_run_matches_the_reference():
    c, t = pool_cell()
    out, checks, sysrun = run(POOL, c, t)
    assert out["correct"], out["checks"]
    assert out["checks"]["dist_err"]["value"] < 1e-5
    assert out["checks"]["recall"]["value"] > 0.3
    assert out["attempted"] > 0 and list(out)[-1] == "checks"


def test_reference_prefill_equals_its_decode_without_drops():
    """The two groupings give one function when nothing is dropped."""
    from bench.systems.serve import model_config
    from bench.weights import make_weights
    from repro_torch.models import model_zoo

    c, _ = serve_cell(capacity_factor=8.0)
    w = make_weights(model_zoo.param_specs(model_config(c)), 3, "cpu")
    tok = torch.randint(0, 512, (3, 10), generator=torch.Generator()
                        .manual_seed(0))
    a, da = jamba.logits_at(w, c, tok, list(range(10)), "batch")
    b, db = jamba.logits_at(w, c, tok, list(range(10)), "position")
    assert da == db == 0
    assert torch.allclose(a, b, atol=1e-5)


def test_knn_reference_and_its_control():
    g = torch.Generator().manual_seed(1)
    db = torch.randn(400, 16, generator=g)
    q = db[:5] + 0.01
    ids, d = knn.exact_topk(db, q, 3)
    assert ids[:, 0].tolist() == list(range(5))
    assert torch.allclose(d, knn.distances_of(db, q, ids), atol=1e-9)
    cids, cd = knn.exact_topk(db, q, 3, control=True)
    assert (cd.double() - d).abs().max() > 1e-6  # TF32 is coarser
    x = torch.tensor([1.0 + 2**-12, 3.0])
    assert knn.tf32_round(x).tolist() == [1.0, 3.0]
    assert np.all(np.isfinite(cd.numpy()))


def test_traced_runs_report_the_per_layer_metrics():
    """On the CPU the device readers find nothing (no card in the trace)
    and leave their metrics out; the host-clock and counter ones stay."""
    out, _, _ = run(POOL, *pool_cell(), trace=True)
    assert {"extend_chunk_ms", "task_occupancy",
            "preemptions_per_1k"} <= set(out["metrics"])
    assert "breakdown" in out and out["correct"]
    out, _, _ = run(SERVE, *serve_cell(), seconds=0.1, trace=True)
    assert {"retrieve_ms.serve", "reprefill_share", "decode_step_ms",
            "serve_mfu"} <= set(out["metrics"])
    assert out["counters"]["moe_pairs_routed"] > 0
