"""The port's ShardedVectorPool against the JAX package's under the faults
of ``test_sharded.py`` and ``test_dispatch_pipeline.py``: stage-aware
preemption, a replica killed mid-run (with and without checkpoint rescue,
with retry backoff and a retry cap), hedged twins around a straggler,
cancellation and planned drains. The legacy arm is held against the JAX
legacy arm and the megabatched arm against the JAX megabatch arm; the
equalities are those of ``test_torch_sharded_pool.py``.

The JAX package's hedging and kill scenarios turn on ``rebalance_enabled``
to share one engine seed among a shard's replicas; here both packages run
them with the knob on and, as a second case, off."""
import pytest

torch = pytest.importorskip("torch")

from repro.core import scheduler as jsched  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402

from test_torch_sharded_pool import (TWO_ARMS, _assert_same, _drive,  # noqa: E402
                                     _pools, setup)  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its tests run many tiny ops,
    and several test workers on one machine would otherwise oversubscribe
    its cores with torch's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arm", TWO_ARMS)
def test_preemption_matches_jax(setup, arm):
    """A tight-deadline decode probe preempts a slowed prefill storm (100x:
    a megabatched cohort's extend is priced below a lone replica's);
    eviction + checkpoint-resume round-trip identically."""
    _, queries = setup
    kw = dict(decode_deadline_ms=3.0, prefill_deadline_ms=60.0,
              preempt_slack_ms=2.5, max_preemptions=2, num_shards=2)
    jp, tp = _pools(setup, arm, **kw)
    for mod, pool in ((jsched, jp), (tsched, tp)):
        for r in range(len(pool.replicas)):
            pool.set_slowdown(r, 100.0)
        for i in range(16):
            pool.submit(mod.VectorRequest(i, "prefill", queries[i], 0.0,
                                          60e-3))
        pool.submit(mod.VectorRequest(100, "decode", queries[32], 0.5e-3,
                                      3.5e-3))
        pool.run_until(0.1)
    assert tp.metrics.preemptions > 0
    _assert_same(jp, tp)


def _kill_busiest(pool, t):
    victim = max(range(len(pool.replicas)),
                 key=lambda i: len(pool.replicas[i].in_flight))
    assert pool.replicas[victim].in_flight
    pool.kill_replica(victim)


KILLS = [(True, 0.0, 0), (False, 0.0, 0), (False, 1.0, 1)]
KILL_IDS = ["rescue", "restart", "backoff-cap"]


@pytest.mark.parametrize("arm", TWO_ARMS)
@pytest.mark.parametrize(
    "rescue,backoff,retries,rebalance",
    [k + (False,) for k in KILLS] + [k + (True,) for k in KILLS],
    ids=KILL_IDS + [i + "+rebalance" for i in KILL_IDS])
def test_kill_mid_chunk_matches_jax(setup, arm, rescue, backoff, retries,
                                    rebalance):
    """A replica dies between grouped chunks with children in flight: its
    lane is freed, its children resume (rescue) or restart, an orphaned
    shard is re-homed; a second kill exhausts the retry cap."""
    _, queries = setup
    kw = dict(rescue_enabled=rescue, retry_backoff_ms=backoff,
              max_retries=retries, rebalance_enabled=rebalance)
    jp, tp = _pools(setup, arm, replicas_per_shard=2, **kw)
    chaos = {16: _kill_busiest, 28: _kill_busiest}
    _drive(jp, jsched, queries, n=32, gap=2e-7, chaos=chaos)
    _drive(tp, tsched, queries, n=32, gap=2e-7, chaos=chaos)
    assert tp.metrics.replica_deaths == 2
    assert (tp.metrics.rescued if rescue else tp.metrics.retries) > 0
    _assert_same(jp, tp)


def test_kill_sole_replica_reassigns_shard(setup):
    _, queries = setup
    jp, tp = _pools(setup, "mega+merge+dbuf")
    chaos = {16: _kill_busiest}
    _drive(jp, jsched, queries, n=24, gap=2e-7, chaos=chaos)
    _drive(tp, tsched, queries, n=24, gap=2e-7, chaos=chaos)
    assert tp.metrics.shard_reassignments == 1
    assert len(tp.replicas) == 4
    _assert_same(jp, tp)


@pytest.mark.parametrize(
    "arm,rebalance",
    [(a, False) for a in TWO_ARMS] + [(a, True) for a in TWO_ARMS],
    ids=list(TWO_ARMS) + [a + "+rebalance" for a in TWO_ARMS])
def test_hedging_matches_jax(setup, arm, rebalance):
    """A hard straggler triggers hedged twins; the winner is kept and the
    loser cancelled or dropped, each shard folded exactly once."""
    _, queries = setup
    jp, tp = _pools(setup, arm, replicas_per_shard=2, hedge_enabled=True,
                    hedge_factor=4.0, rebalance_enabled=rebalance)
    for pool in (jp, tp):
        pool.set_slowdown(0, 200.0)
    _drive(jp, jsched, queries, n=32)
    _drive(tp, tsched, queries, n=32)
    assert tp.metrics.hedges >= 1
    _assert_same(jp, tp)


@pytest.mark.parametrize("arm", TWO_ARMS)
def test_cancel_and_drain_match_jax(setup, arm):
    """Cancel a parent in flight and two not yet released (the whole
    fan-out torn down), then drain a replica per shard floor. The parent
    cancelled in flight is rid 5: its child rids (5 << 6 | s) name no
    pending parent (ROADMAP Queue C: a child rid equal to a pending
    parent's makes both packages remove that parent instead)."""
    _, queries = setup
    jp, tp = _pools(setup, arm, replicas_per_shard=2)
    for mod, pool in ((jsched, jp), (tsched, tp)):
        t = 0.0
        for i in range(40):
            pool.submit(mod.VectorRequest(i, "prefill", queries[i], t,
                                          t + 10.0))
            t += 1e-7
        pool.run_until(t * 0.5)
        for rid in (5, 25, 39):
            assert pool.cancel(rid)
        assert pool.drain_replica()
        assert pool.drain_replica(shard=3)
        assert not pool.drain_replica(shard=3)  # at its floor
        pool.run_until(t + 5.0)
    assert tp.metrics.probes_cancelled == 3 and tp.metrics.drains == 2
    _assert_same(jp, tp)
    for s in range(4):
        assert tp.shard_load_score(s, 1.0) == jp.shard_load_score(s, 1.0)
    assert tp.shard_load_summary(1.0) == jp.shard_load_summary(1.0)
