"""The port's traffic generators (``serving/traffic.py``) against the JAX
package's: the rate shapes (constant, diurnal, flash crowd, composed), the
tenant mixes (static weights, repeats from a prompt pool, the three
archetypes), the drifting-mix trace and ``generate_timed`` give equal
request lists (every ``GenRequest`` field) on the same seeds."""
import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serving import traffic as jt  # noqa: E402
from repro_torch.serving import traffic as tt  # noqa: E402


def _reqs(reqs):
    return [dataclasses.asdict(r) for r in reqs]


def _same(make, t_end, rid_base=0):
    a = make(jt).generate(t_end, rid_base)
    b = make(tt).generate(t_end, rid_base)
    assert a and _reqs(b) == _reqs(a)
    return b


def _plain(m):
    return m.TenantSpec("plain", prompt_len=(64, 128), max_new_tokens=(4, 8))


@pytest.mark.parametrize("shape", ["constant", "diurnal", "flash", "compose"])
def test_rate_shapes_equal_jax(shape):
    def rate(m):
        return {"constant": lambda: m.constant(500.0),
                "diurnal": lambda: m.diurnal(400.0, amplitude=0.9,
                                             period_s=2.0),
                "flash": lambda: m.flash_crowd(900.0, t_start=1.0,
                                               ramp_s=0.1, hold_s=0.3,
                                               decay_s=0.1),
                "compose": lambda: m.compose(
                    m.constant(100.0),
                    m.flash_crowd(900.0, t_start=1.0, ramp_s=0.1,
                                  hold_s=0.3, decay_s=0.1))}[shape]()

    for t in np.linspace(0.0, 2.0, 41):
        assert rate(tt)(float(t)) == rate(jt)(float(t))
    _same(lambda m: m.TrafficGenerator(rate(m), [_plain(m)], seed=2), 2.0)
    assert tt.TrafficGenerator(rate(tt), [_plain(tt)]).peak_rate(2.0) == \
        jt.TrafficGenerator(rate(jt), [_plain(jt)]).peak_rate(2.0)


def test_tenant_mixes_equal_jax():
    def gen(m):
        a = m.TenantSpec("a", weight=3.0, prompt_len=(64, 65),
                         max_new_tokens=(4, 5), rag_interval=2)
        b = m.TenantSpec("b", weight=1.0, prompt_len=(900, 901),
                         max_new_tokens=(9, 10), repeat_p=0.5,
                         prompt_pool=4, prefill_rag=False)
        return m.TrafficGenerator(m.constant(300.0), [a, b], seed=4)

    reqs = _same(gen, 2.0, rid_base=7)
    assert any(r.prompt_id is not None for r in reqs)
    _same(lambda m: m.TrafficGenerator(
        m.constant(200.0), [m.BULK_PREFILL, m.RAG_DECODE, m.REPEAT_CHAT],
        seed=9), 1.0)
    assert tt.RID_LIMIT == jt.RID_LIMIT
    for name in ("BULK_PREFILL", "RAG_DECODE", "REPEAT_CHAT"):
        assert dataclasses.asdict(getattr(tt, name)) == \
            dataclasses.asdict(getattr(jt, name))


@pytest.mark.parametrize("seed", [0, 5])
def test_drifting_mix_trace_equal_jax(seed):
    reqs = _same(lambda m: m.drifting_mix_trace(1.0, 200.0, seed=seed), 1.0)
    assert len(reqs) > 50
    w_t, w_j = tt.drifting_mix_weights(1.0), jt.drifting_mix_weights(1.0)
    for t in np.linspace(-0.1, 1.1, 25):
        assert w_t(float(t)) == w_j(float(t))


def test_generate_timed_equals_generate():
    """The wall-clock seam reports on real work and returns the same
    trace as ``generate``; its report's counts equal the JAX package's."""
    gen = tt.drifting_mix_trace(1.0, 200.0, seed=3)
    reqs, rep = tt.generate_timed(gen, 1.0, rid_base=5)
    jreqs, jrep = jt.generate_timed(jt.drifting_mix_trace(1.0, 200.0,
                                                          seed=3), 1.0, 5)
    assert _reqs(reqs) == _reqs(jreqs) == _reqs(gen.generate(1.0, 5))
    for k in ("requests", "trace_s", "offered_rps", "tenant_users"):
        assert rep[k] == jrep[k]
    assert rep["gen_wall_s"] > 0


def test_rid_window_overflow_raises_as_in_jax():
    for m in (jt, tt):
        gen = m.TrafficGenerator(m.constant(100.0), [_plain(m)], seed=0)
        with pytest.raises(ValueError, match="rid window"):
            gen.generate(1.0, rid_base=m.RID_LIMIT - 3)
