"""The port's serving building blocks against the JAX package's, exactly:
``request`` (``ClusterMetrics`` and its rolling windows, ``RollingWindow``,
``slo_good``, ``percentile``), ``kv_link``, ``kv_cache``
(``PagedKVManager``, ``kv_bytes_per_token`` on every config and
``pad_prefill_caches`` on the prefill→decode handoff of
``test_ivf_and_handoff.py`` and on every cache kind), the prefill and decode instances of
``engine``, every function of the roofline model, ``make_placements``, and
the ``ShapeConfig`` and ``AutoscalerConfig`` copies."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.configs.base as jbase  # noqa: E402
from repro.core import architectures as jarch  # noqa: E402
from repro.core import roofline_model as jroof  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving import kv_link as jlink  # noqa: E402
from repro.serving import request as jreq  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.configs.base as tbase  # noqa: E402
from repro_torch.core import architectures as tarch  # noqa: E402
from repro_torch.core import roofline_model as troof  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving import kv_link as tlink  # noqa: E402
from repro_torch.serving import request as treq  # noqa: E402

ARCHS = tconfigs.list_archs()


def _cfgs(arch):
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ["ShapeConfig", "AutoscalerConfig"])
def test_config_classes_equal_to_jax(name):
    jf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(getattr(jbase, name))]
    tf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(getattr(tbase, name))]
    assert jf == tf
    assert getattr(tbase, name).__dataclass_params__.frozen


def test_shapes_equal_to_jax():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in ARCHS:
        j, t = _cfgs(arch)
        assert [s.name for s in tbase.shapes_for(t)] == \
            [s.name for s in jbase.shapes_for(j)]


# ------------------------------------------------------------ roofline
def test_roofline_functions_equal_jax():
    assert dataclasses.asdict(troof.V5E) == dataclasses.asdict(jroof.V5E)
    hw = troof.Hardware(peak_flops=989e12, hbm_bw=3.35e12)
    jhw = jroof.Hardware(peak_flops=989e12, hbm_bw=3.35e12)
    for ai in (0.1, 0.5, 6.0, 240.0, 1e4):
        assert troof.u_max(ai) == jroof.u_max(ai)
        assert troof.u_max(ai, hw) == jroof.u_max(ai, jhw)
    for x in (0, 1, 4, 48, 1000):
        assert troof.u_curve(x, 48.0, 0.8, 0.3) == \
            jroof.u_curve(x, 48.0, 0.8, 0.3)
    for s, d in ((128, 4096), (32768, 5120)):
        assert troof.prefill_ai(s, d) == jroof.prefill_ai(s, d)
    for b in (1, 8, 64, 512):
        assert troof.decode_ai(b) == jroof.decode_ai(b)
    assert troof.ann_ai(16) == jroof.ann_ai(16)
    pool = tbase.VectorPoolConfig()
    jpool = jbase.VectorPoolConfig()
    assert troof.stage_curves(pool, [1, 8, 64], [1, 16, 128]) == \
        jroof.stage_curves(jpool, [1, 8, 64], [1, 16, 128])
    assert troof.extend_time(pool) == jroof.extend_time(jpool)
    for g in (1, 8):
        for db in (False, True):
            assert troof.extend_time_group(pool, g, db) == \
                jroof.extend_time_group(jpool, g, db)
    assert troof.per_request_batch_search_time(pool, 8, 12) == \
        jroof.per_request_batch_search_time(jpool, 8, 12)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_prices_equal_jax(arch):
    """prefill_time, decode_step_time and model_step_times price each
    ported config at its published widths (MoE and MLA included) as the
    JAX package does."""
    j, t = _cfgs(arch)
    for tokens, chips in ((512, 8), (4096, 1)):
        assert troof.prefill_time(t, tokens, chips) == \
            jroof.prefill_time(j, tokens, chips)
    for batch, ctx in ((8, 544), (64, 4096)):
        assert troof.decode_step_time(t, batch, ctx, 8) == \
            jroof.decode_step_time(j, batch, ctx, 8)
    for ts, js in zip(tbase.SHAPES.values(), jbase.SHAPES.values()):
        assert troof.model_step_times(t, ts, 8) == \
            jroof.model_step_times(j, js, 8)
    assert tkv.kv_bytes_per_token(t) == jkv.kv_bytes_per_token(j)


def test_placements_equal_jax():
    for chips in (4, 8):
        tp, jp = tarch.make_placements(chips_per_node=chips), \
            jarch.make_placements(chips_per_node=chips)
        assert {k: dataclasses.asdict(v) for k, v in tp.items()} == \
            {k: dataclasses.asdict(v) for k, v in jp.items()}


# ------------------------------------------------------ KV link and cache
def test_kv_link_equal_jax():
    links = (jlink.KVLink(bandwidth=1e9, window=1.0),
             tlink.KVLink(bandwidth=1e9, window=1.0))
    out = [[], []]
    for i, link in enumerate(links):
        for t, nbytes in ((0.0, 5e8), (0.0, 5e8), (2.0, 1e8), (2.05, 3e7)):
            out[i].append(link.transfer(t, nbytes))
        out[i] += [link.utilization(t) for t in (1.0, 2.1, 10.0)]
    assert out[1] == out[0]
    assert abs(out[1][1] - 1.0) < 1e-9


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_kv_manager_equal_jax(arch):
    j, t = _cfgs(arch)
    mgrs = (jkv.PagedKVManager(2e9, j, page_tokens=128),
            tkv.PagedKVManager(2e9, t, page_tokens=128))
    trace = [[], []]
    for i, m in enumerate(mgrs):
        trace[i].append((m.capacity_pages, m.allocate(1, 1000),
                         m.allocate(2, 10 ** 9), m.can_admit(500)))
        for _ in range(300 if 1 in m.tables else 0):
            trace[i].append((m.extend(1, 1), m.used_pages))
        m.free(1)
        trace[i].append((m.used_pages, m.utilization))
    assert trace[1] == trace[0]


def test_pad_prefill_caches_matches_jax_handoff():
    """test_ivf_and_handoff's handoff on gemma-7b's smoke config: prefill 16
    tokens, pad the caches to 20, decode 4 more. The port's padded caches
    equal the JAX package's and the continued logits agree (1e-4, sums in
    another order), on the caches' own device."""
    import jax
    import jax.numpy as jnp

    from repro.models import model_zoo as jzoo
    from repro_torch import convert
    from repro_torch.models import model_zoo as tzoo

    jcfg = jconfigs.get_smoke_config("gemma-7b")
    tcfg = tconfigs.get_smoke_config("gemma-7b")
    jparams = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_numpy(tcfg, jax.device_get(jparams),
                                           device="cpu")
    B, S, extra = 2, 16, 4
    toks = np.random.default_rng(3).integers(0, 500, (B, S + extra)) \
        .astype(np.int32)
    _, jc = jzoo.prefill_fn(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    jc = jkv.pad_prefill_caches(jc, S + extra)
    tt = torch.as_tensor(toks)
    _, tc = tzoo.prefill_fn(tcfg, tparams, {"tokens": tt[:, :S]})
    tc = tkv.pad_prefill_caches(tc, S + extra)
    assert len(tc) == tcfg.num_layers
    for i, c in enumerate(tc):
        for name in ("k", "v"):
            assert c[name].shape[1] == S + extra
            assert c[name].device.type == "cpu"
            np.testing.assert_allclose(
                c[name].numpy(), np.asarray(jc["l0"][name][i], np.float32),
                rtol=1e-5, atol=1e-5)
            assert not c[name][:, S:].any()
    jl = tl = None
    for i in range(extra):
        jl, jc = jzoo.decode_fn(jcfg, jparams,
                                jnp.asarray(toks[:, S + i:S + i + 1]), jc,
                                jnp.int32(S + i))
        tl, tc = tzoo.decode_fn(tcfg, tparams, tt[:, S + i:S + i + 1], tc,
                                S + i)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               rtol=1e-4, atol=1e-4)
    # a cache already at (or past) the decode size passes through
    assert tkv.pad_prefill_caches(tc, S)[0]["k"] is tc[0]["k"]


HANDOFF_ARCHS = ["gemma-7b", "deepseek-moe-16b", "deepseek-v3-671b",
                 "xlstm-350m", "seamless-m4t-large-v2", "jamba-1.5-large-398b"]


def _pad_attention_leaves(jc, max_len):
    """The reference's handoff as its docstring states it, done here on the
    JAX package's caches: the k/v/ckv/kr leaves (g, B, S, ...) padded on
    axis 2, recurrent states and the cross ck/cv as they are."""
    import jax
    import jax.numpy as jnp

    def one(path, leaf):
        if path[-1].key in tkv.SEQUENCE_LEAVES:
            pad = [(0, 0)] * leaf.ndim
            pad[2] = (0, max_len - leaf.shape[2])
            return jnp.pad(leaf, pad)
        return leaf

    return jax.tree_util.tree_map_with_path(one, jc)


@pytest.mark.parametrize("arch", HANDOFF_ARCHS)
def test_handoff_keeps_every_cache_kind(arch):
    """Prefill 16 tokens, hand the caches over with ``pad_prefill_caches``
    to 20, decode 4 more: the logits equal the JAX package's prefill,
    attention leaves padded, decode (1e-4). Attention caches grow on dim 1
    (k/v; MLA's 3-D ckv/kr too); recurrent states (mLSTM, sLSTM, mamba)
    and the cross ck/cv pass through unchanged."""
    import jax
    import jax.numpy as jnp

    from repro.models import model_zoo as jzoo
    from repro_torch import convert
    from repro_torch.models import model_zoo as tzoo

    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jparams = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_numpy(tcfg, jax.device_get(jparams),
                                           device="cpu")
    B, S, extra = 2, 16, 4
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 500, (B, S + extra)).astype(np.int32)
    batch = {"tokens": toks[:, :S]}
    if tcfg.block_kind == "encdec":
        batch["frames"] = rng.normal(size=(B, S, tcfg.d_model)).astype(
            np.float32)
    _, jc = jzoo.prefill_fn(jcfg, jparams,
                            {k: jnp.asarray(v) for k, v in batch.items()})
    jc = _pad_attention_leaves(jc, S + extra)
    _, tc = tzoo.prefill_fn(tcfg, tparams,
                            {k: torch.as_tensor(v) for k, v in batch.items()})
    padded = tkv.pad_prefill_caches(tc, S + extra)
    for c, p in zip(_leaves_by_name(padded), _leaves_by_name(tc)):
        (name, new), (_, old) = c, p
        if name in tkv.SEQUENCE_LEAVES:
            assert new.shape[1] == S + extra
            assert torch.equal(new[:, :S], old) and not new[:, S:].any()
        else:
            assert new is old
    tc = padded
    for i in range(extra):
        step = toks[:, S + i:S + i + 1]
        jl, jc = jzoo.decode_fn(jcfg, jparams, jnp.asarray(step), jc,
                                jnp.int32(S + i))
        tl, tc = tzoo.decode_fn(tcfg, tparams, torch.as_tensor(step), tc,
                                S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                   rtol=1e-4, atol=1e-4)


def _leaves_by_name(tree, name=None):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves_by_name(v, k)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves_by_name(v)]
    return [(name, tree)]


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("arch", ARCHS)
def test_instances_equal_jax(arch):
    """Prefill batches and decode steps priced, admitted and released as
    in the JAX package, with a placement's capacity loss, contention and
    EP penalty, and a straggler's slowdown."""
    j, t = _cfgs(arch)
    out = [[], []]
    for i, (eng, req, mcfg) in enumerate(((jeng, jreq, j), (teng, treq, t))):
        p = eng.PrefillInstance(0, mcfg, 8, capacity_factor=0.875,
                                contention=1.15)
        d = eng.DecodeInstance(1, mcfg, 8, max_batch=4,
                               capacity_factor=0.875, contention=1.15,
                               ep_penalty=3.5e-5)
        reqs = [req.GenRequest(k, prompt_len=256 + 64 * k, max_new_tokens=8,
                               t_arrival=0.0) for k in range(6)]
        out[i].append((p.batch_time(4096), p.start_batch(0.1, reqs[:3]),
                       p.busy_until, p.max_batch_tokens))
        for r in reqs:
            ok = d.can_admit(r)
            if ok:
                d.admit(r)
            out[i].append((ok, d.free_slots, d.step_time(0.2)))
        d.health.slowdown = 3.0
        out[i].append(d.step_time(0.3))
        d.release(reqs[0])
        out[i].append((d.free_slots, d.step_time(0.4),
                       dataclasses.asdict(d.health)))
    assert out[1] == out[0]


# ------------------------------------------------------ request metrics
def _finished(mod, rid, t0, ttft, tpot, n_tok=4):
    r = mod.GenRequest(rid, prompt_len=64, max_new_tokens=n_tok,
                       t_arrival=t0)
    r.t_first_token = t0 + ttft
    r.token_times = [r.t_first_token + i * tpot for i in range(n_tok)]
    r.tokens_out = n_tok
    r.t_done = r.token_times[-1]
    return r


@pytest.mark.parametrize("window", [1e9, 0.5, 0.0])
def test_cluster_metrics_equal_jax(window):
    """The full-run and windowed percentiles, finish rates, goodput and
    the summary on one trace of finished requests, with a cache hit and a
    request that never decoded."""
    outs = []
    for mod in (jreq, treq):
        m = mod.ClusterMetrics()
        m.set_window(window)
        rng = np.random.default_rng(0)
        t = 0.0
        for i in range(120):
            t += float(rng.exponential(0.01))
            m.record_finish(_finished(
                mod, i, t, ttft=float(rng.uniform(0.01, 0.05)),
                tpot=float(rng.uniform(0.001, 0.004))))
        hit = mod.GenRequest(500, 10, 4, t)
        hit.cache_hit, hit.t_first_token, hit.t_done = True, t + 0.01, t + 0.01
        m.record_finish(hit)
        m.cache_hits += 1
        m.scale_events.append(mod.ScaleEvent(t, "vector", +1, "test", 2.5))
        row = [m.summary(t)]
        for q in (50, 90, 95, 99):
            row.append((m.ttft_p(q), m.tpot_p(q), m.window_ttft_p(q, t),
                        m.window_tpot_p(q, t)))
        row.append((m.window_finish_rate(t),
                    m.window_goodput(t, 0.03, 0.003),
                    m.goodput(t, 0.03, 0.003, gpu_units=3)))
        row.append([mod.slo_good(r, 0.03, 0.003) for r in m.finished])
        outs.append(row)
    assert outs[1] == outs[0]


def test_rolling_window_and_percentile_equal_jax():
    outs = []
    for mod in (jreq, treq):
        row = []
        for span in (2.0, 0.0):
            w = mod.RollingWindow(span)
            for i in range(10):
                w.add(i * 0.1, i * 1.5)
            row.append((w.rate(1.0), w.count(1.0), w.values(1.0),
                        w.percentile(90, 1.0), w.mean(1.0), w.count(100.0),
                        w.rate(0.9)))
        row.append((mod.percentile([3.0, None, 1.0, 2.0], 50),
                    mod.percentile([], 95)))
        outs.append(row)
    assert outs[1] == outs[0]
