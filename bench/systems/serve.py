"""RAG serving of a model through the port's ``launch/serve.py::RealServer``
(prefill, the decode-side cache filled token by token, greedy decode,
and the server's own retrieval probes through its ``VectorPool``).

The loop is closed: one ``generate`` call at a time, each a batch of
``batch`` prompts of one length; the lengths run in cycles, each cycle
every length of ``prompt_lengths`` once in an order drawn from the seed,
and the window holds whole cycles (a cycle starts only while the window
is under its seconds), so every window holds the mix in equal shares.
Token ids come from the seed; the weights are the benchmark's
(``bench/weights.py``), handed to the server.

What the timed path produced is kept: every call's served tokens (the
token the prefill's logits chose, then each decode step's), its prompts,
and the probes' answers. ``check`` runs the plain reference over one
call of the longest prompts, drawn from the seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import answers
from bench.check import Check
from bench.data import make_dataset, subseeds
from bench.reference import jamba
from bench.weights import make_weights


def model_config(c: dict, name: str = "bench"):
    """The port's ``ModelConfig`` for a Jamba configuration file. A key
    the port cannot honour as stated raises."""
    from repro_torch.configs.base import MoEConfig, ModelConfig

    a = c["assumed"]
    period = c["attn_layer_period"]
    want = {
        "attn_layer_offset": period // 2,  # transformer.group_layer_kinds
        "expert_layer_offset": 0,  # transformer._uses_moe
        "mamba_dt_rank": -(-c["hidden_size"] // 16),  # mamba.dt_rank_for
        "hidden_act": "silu", "mamba_conv_bias": True,
        "mamba_proj_bias": False, "num_logits_to_keep": 1,
        "sliding_window": None, "tie_word_embeddings": False,
    }
    for k, v in want.items():
        if c[k] != v:
            raise ValueError(f"{k}={c[k]!r}: the port runs {v!r}")
    if c["num_hidden_layers"] % period:
        raise ValueError("num_hidden_layers is not whole periods")
    return ModelConfig(
        name=name, family="hybrid",
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        head_dim=a.get("head_dim", 0), block_kind="mamba_attn",
        attn_kind="gqa", mlp_kind="moe",
        moe=MoEConfig(num_experts=c["num_experts"], num_shared_experts=0,
                      top_k=c["num_experts_per_tok"],
                      expert_ffn=c["intermediate_size"],
                      capacity_factor=a["capacity_factor"]),
        moe_every=c["expert_layer_period"], attn_every=period,
        mamba_d_state=c["mamba_d_state"], mamba_d_conv=c["mamba_d_conv"],
        mamba_expand=c["mamba_expand"], norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"], rope_theta=a["rope_theta"],
        max_seq_len=c["max_position_embeddings"], dtype=a["torch_dtype"],
        subquadratic=True)


class Run:
    def __init__(self, config, traffic, limits, seed, device, tracer):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device, self.tracer = seed, torch.device(device), tracer
        self.record = {}
        self.counters = {}

    # ------------------------------------------------------------ set-up
    def setup(self):
        from repro_torch.configs.base import VectorPoolConfig
        from repro_torch.launch.serve import RealServer
        from repro_torch.models import model_zoo

        c, t = self.config, self.traffic
        s_w, s_traffic, self.s_check = subseeds(self.seed, 3)
        self.cfg = model_config(c)
        self.weights = make_weights(model_zoo.param_specs(self.cfg), s_w,
                                    self.device)
        pool = dict(c["pool"])
        # the server's corpus is the deployment's, one data set for every
        # run (RealServer draws it from its seed, its probes by a fixed rng)
        self.corpus_seed = pool.pop("corpus_seed")
        self.pool_cfg = VectorPoolConfig(**pool)
        self.server = RealServer(self.cfg, self.pool_cfg,
                                 rag_interval=t["rag_interval"],
                                 seed=self.corpus_seed, device=self.device,
                                 params=self.weights)
        self.rng = np.random.default_rng(s_traffic)
        self._wrap()
        if self.tracer.enabled:
            self._instrument()
        self._warm()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _wrap(self):
        s, tracer = self.server, self.tracer
        prefill, decode, retrieve = s._prefill, s._decode, s._retrieve
        self.call = None  # the generate call in flight

        def prefill_w(p, b):
            tracer.poll()
            with tracer.note("serve.prefill"):
                return prefill(p, b)

        def decode_w(p, tok, caches, cur_len):
            call = self.call
            if call is not None and cur_len == 0:
                # generate synchronised after its prefill: TTFT ends here
                call["t_decode0"] = time.perf_counter()
            if call is not None and cur_len == call["S"]:
                call["t0"] = tok  # the token the prefill's logits chose
                if tracer.enabled:  # the re-prefill ends here, on the card
                    self._sync()
                    call["reprefill_s"] = (time.perf_counter()
                                           - call["t_decode0"])
            tracer.poll()
            with tracer.note("serve.decode"):
                return decode(p, tok, caches, cur_len)

        def retrieve_w(kind, qvec):
            tracer.poll()
            t0 = time.perf_counter()
            with tracer.note("serve.retrieve"):
                out = retrieve(kind, qvec)
            if self.call is not None:
                self.call["probe_s"].append((kind, time.perf_counter() - t0))
            return out

        s._prefill, s._decode, s._retrieve = prefill_w, decode_w, retrieve_w

    def _instrument(self):
        """The traced run only: each decode-attention launch's bytes while
        a segment is traced, and the MoE's routed and dropped pairs (a
        second top-k over the router's logits, summed on the card)."""
        from repro_torch.kernels import ops
        from repro_torch.models import moe

        from bench.ops.decode_attention_bytes import launch_bytes

        tracer, launches = self.tracer, []
        dec, fwd = ops.decode_attention, moe.moe_forward
        pairs = torch.zeros(2, dtype=torch.int64, device=self.device)

        def decode_attention(q, k, v, cur_len, *a, **kw):
            if tracer.recording:
                B, H, hd = q.shape
                out = kw.get("return_lse") and 4 or q.element_size()
                launches.append(launch_bytes(
                    B, H, k.shape[2], hd, min(int(cur_len) + 1, k.shape[1]),
                    k.element_size(), out))
            return dec(q, k, v, cur_len, *a, **kw)

        def moe_forward(params, x, cfg, capacity=0):
            if not self.counting:
                return fwd(params, x, cfg, capacity)
            m = cfg.moe
            T = x.shape[0]
            cap = capacity or moe.capacity_for(T, cfg)
            idx = torch.topk(x.float() @ params["router"], m.top_k).indices
            load = torch.zeros(m.num_experts, dtype=torch.int64,
                               device=x.device).scatter_add_(
                0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
            pairs[0] += T * m.top_k  # no host sync: the counts stay here
            pairs[1] += (load - cap).clamp(min=0).sum()
            return fwd(params, x, cfg, capacity)

        ops.decode_attention, moe.moe_forward = decode_attention, moe_forward
        self.decode_launch_bytes, self.moe_pairs = launches, pairs
        self.counting = False

    def _prompts(self, S):
        return self.rng.integers(0, self.config["vocab_size"],
                                 size=(self.traffic["batch"], S),
                                 dtype=np.int32)

    def _warm(self):
        """Every shape the traffic uses, once: each prompt length's
        prefill, decode steps on the batch's cache, one probe."""
        from repro_torch.models import model_zoo

        t, s = self.traffic, self.server
        B = t["batch"]
        for S in t["prompt_lengths"]:
            tok = torch.as_tensor(self._prompts(S), device=self.device)
            s._prefill(self.weights, {"tokens": tok})
            self._sync()
        S = max(t["prompt_lengths"])
        caches = model_zoo.init_decode_caches(self.cfg, B, S + t["max_new"],
                                              self.device)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=self.device)
        for i in range(2):
            s._decode(self.weights, tok, caches, i)
        s._retrieve("prefill", s.pool.db[0])
        del caches
        self._sync()

    # ------------------------------------------------------------ window
    def _generate(self, S):
        prompts = self._prompts(S)
        call = {"S": S, "probe_s": [], "prompts": prompts}
        self.call = call
        call["t_start"] = time.perf_counter()
        toks, stats = self.server.generate(prompts,
                                           max_new=self.traffic["max_new"])
        call["t_end"] = time.perf_counter()
        self.call = None
        call["ttft_s"] = stats["ttft_s"]
        call["toks"] = toks
        call["t0"] = call["t0"].reshape(-1).cpu().numpy()
        return call

    def window(self, seconds):
        t = self.traffic
        self.rid0 = self.server._rid
        self.calls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for S in self.rng.permutation(t["prompt_lengths"]):
                self.calls.append(self._generate(int(S)))
        self.rid1 = self.server._rid
        r = self.record
        r["window_s"] = self.calls[-1]["t_end"] - self.calls[0]["t_start"]
        r["calls"] = [{k: v for k, v in c.items()
                       if k not in ("prompts", "toks", "t0")}
                      for c in self.calls]
        r["batch"], r["max_new"] = t["batch"], t["max_new"]
        r["attempted"] = t["batch"] * len(self.calls)
        r["failed"] = 0
        if self.tracer.enabled:
            self._traced_tail()

    def _traced_tail(self):
        """The traced run: after the window, one more call of
        ``trace.tail_prompt_length`` under the profiler, the decode
        launches' bytes and the MoE's pairs counted; it is not judged."""
        self.moe_pairs.zero_()
        self.counting = True
        self.tracer.start()
        self._generate(self.traffic["trace"]["tail_prompt_length"])
        self.tracer.stop()
        self.counting = False
        self._sync()
        self.record["decode_launch_bytes"] = list(self.decode_launch_bytes)
        routed, dropped = self.moe_pairs.tolist()
        self.counters.update(moe_pairs_routed=routed,
                             moe_pairs_dropped=dropped)

    # ------------------------------------------------------------ check
    def close(self):
        """Keep the probes' answers; free the server (the weights are the
        benchmark's and stay for the reference)."""
        probes = [q for q in self.server.pool.metrics.completed
                  if self.rid0 < q.rid <= self.rid1]
        self.probes = (np.stack([q.qvec for q in probes]),
                       np.stack([q.result_ids for q in probes]),
                       np.stack([q.result_dists for q in probes]))
        self.server = None
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked_call(self):
        rng = np.random.default_rng(self.s_check)
        longest = max(c["S"] for c in self.calls)
        calls = [c for c in self.calls if c["S"] == longest]
        call = calls[int(rng.integers(len(calls)))]
        n = self.traffic["check"]["requests"]
        rows = np.sort(rng.choice(self.traffic["batch"], size=n,
                                  replace=False))
        return call, rows

    def gaps(self, control=False) -> dict:
        """Per served token of the checked requests, how far its logit
        lies below the reference's best: ``program`` for the token the
        program served, ``control`` (with ``control``) for the token the
        fp8 reference puts first at the same position."""
        call, rows = self.checked_call()
        S = call["S"]
        dev = self.device
        served = np.concatenate([call["t0"][:, None], call["toks"]], axis=1)
        prompts = torch.as_tensor(call["prompts"], dtype=torch.long,
                                  device=dev)
        seq = torch.cat([prompts, torch.as_tensor(served[:, :-1],
                                                  dtype=torch.long,
                                                  device=dev)], dim=1)
        pos = list(range(S, seq.shape[1]))

        def logits(quant):
            lp, dp = jamba.logits_at(self.weights, self.config, prompts,
                                     [S - 1], "batch", quant)
            ld, dd = jamba.logits_at(self.weights, self.config, seq, pos,
                                     "position", quant)
            return torch.cat([lp, ld], dim=1)[rows], dp + dd

        ref, dropped = logits(None)
        self.counters["reference_pairs_dropped"] = dropped
        best = ref.max(-1).values

        def gap(chosen):
            return (best - ref.gather(-1, chosen[..., None])[..., 0]).cpu().numpy()

        out = {"program": gap(torch.as_tensor(served[rows], dtype=torch.long,
                                              device=dev))}
        if control:
            out["control"] = gap(logits("fp8")[0].argmax(-1))
        return out

    def judge_probes(self, control=False):
        q, ids, dists = self.probes
        db, _ = make_dataset(self.pool_cfg.num_vectors, self.pool_cfg.dim,
                             num_queries=1, seed=self.corpus_seed)
        db = torch.as_tensor(db, device=self.device)
        qt = torch.as_tensor(q, device=self.device)
        k = self.pool_cfg.top_k
        if control:
            ids, dists = answers.control_answers(db, qt, k)
        return answers.judge(db, qt, ids, dists, k)

    def readings(self, control=False) -> dict:
        """The compared numbers of the program, and with ``control`` of
        the control in its place."""
        g = self.gaps(control)
        out = {}
        for who in g:
            p = self.judge_probes(control=who == "control")
            out[who] = {"logit_gap_mean": float(g[who].mean()),
                        "logit_gap_max": float(g[who].max()),
                        "logit_gap_p90": float(np.quantile(g[who], 0.9)),
                        "served": int(g[who].size),
                        "dist_err": p["dist_err"], "recall": p["recall"],
                        "malformed": p["malformed"]}
        return out

    def check(self):
        lim = self.limits["numbers"]
        p = self.readings()["program"]
        return [Check("logit_gap_mean", p["logit_gap_mean"],
                      lim["logit_gap_mean"]),
                Check("probe_dist_err", p["dist_err"], lim["dist_err"]),
                Check("probe_recall", p["recall"], lim["recall"], ">="),
                Check("probe_malformed", p["malformed"], 0)]
