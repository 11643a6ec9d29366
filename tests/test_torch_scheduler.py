"""The port's scheduler replays the recorded decision trace
(tests/data/scheduler_trace.json, recorded against the JAX package's
pre-refactor scheduler) decision for decision. The file is the acceptance
test: it is never regenerated to make the port pass."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import VectorPoolConfig  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from scheduler_trace_driver import DATA_PATH, run_trace  # noqa: E402


@pytest.mark.parametrize("policy", ["trinity", "prefill_first",
                                    "decode_first", "fifo_shared"])
def test_port_scheduler_replays_recorded_trace(policy):
    with open(DATA_PATH) as f:
        recorded = json.load(f)[policy]
    cfg = dataclasses.replace(VectorPoolConfig(), preemption_enabled=True,
                              preempt_slack_ms=2.0, max_preemptions=2)

    def factory(p):
        return tsched.LaneScheduler(cfg, policy=p)

    def make_request(rid, kind, qvec, t, ddl, est):
        return tsched.VectorRequest(rid, kind, qvec, t, ddl, est_extends=est)

    replayed = json.loads(json.dumps(run_trace(factory, make_request, policy)))
    assert len(replayed) == len(recorded)
    for i, (got, want) in enumerate(zip(replayed, recorded)):
        assert got == want, (policy, i, got, want)


def test_two_queue_alias_and_registry():
    assert tsched.TwoQueueScheduler is tsched.LaneScheduler
    reg = tsched.build_registry(VectorPoolConfig())
    assert {n: c.lane for n, c in reg.items()} == {
        "prefill": "edf", "decode": "fifo", "cache_lookup": "edf",
        "insert": "background"}
    with pytest.raises(ValueError):
        tsched.RetrievalClass("x", "lifo")
    sched = tsched.LaneScheduler(VectorPoolConfig())
    with pytest.raises(KeyError, match="registered"):
        sched.submit(tsched.VectorRequest(0, "nope", None, 0.0, 1.0))
