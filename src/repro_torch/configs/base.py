"""Model and vector-pool configurations for the PyTorch port.

Copies of ``MoEConfig``, ``MLAConfig``, ``ModelConfig``, ``ShapeConfig``,
``VectorPoolConfig`` and ``AutoscalerConfig``: the same fields with the
same defaults, so one config drives both packages, and ``MeshConfig``
with the production meshes ``SINGLE_POD`` and ``MULTI_POD``.
``tests/test_torch_isolation.py`` holds them equal.
``ModelConfig.param_count`` counts through the port's own
``models/model_zoo.py::analytic_param_count``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (fine-grained, shared + routed)."""

    num_experts: int  # routed experts
    num_shared_experts: int  # always-on shared experts
    top_k: int  # routed experts activated per token
    expert_ffn: int  # d_ff of each routed expert
    shared_ffn: int = 0  # d_ff of the shared expert(s); 0 => expert_ffn
    router_dtype: str = "float32"
    capacity_factor: float = 1.25  # dispatch capacity per expert

    @property
    def shared_ffn_dim(self) -> int:
        return self.shared_ffn or self.expert_ffn


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention sub-config."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture (published numbers; see configs/<id>.py)."""

    name: str
    family: str  # "dense" | "moe" | "hybrid" | "ssm" | "audio" | "vlm"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    # block structure
    block_kind: str = "attn"  # "attn" | "mamba_attn" | "xlstm" | "encdec"
    attn_kind: str = "gqa"  # "gqa" | "mla"
    mlp_kind: str = "swiglu"  # "swiglu" | "geglu" | "moe" | "none"
    moe: Optional[MoEConfig] = None
    moe_every: int = 1  # MoE FFN on layers where (idx % moe_every == 0)
    mla: Optional[MLAConfig] = None
    # misc published details
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # MTP (deepseek-v3 multi-token prediction)
    mtp_depth: int = 0
    # hybrid (jamba): one attention layer every `attn_every` layers
    attn_every: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # xlstm: pattern of block kinds, cycled over layers
    xlstm_pattern: Tuple[str, ...] = ()
    # enc-dec split (seamless): encoder layers + decoder layers = num_layers
    encoder_layers: int = 0
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: str = "none"  # "none" | "audio" | "vision"
    frontend_tokens: int = 0  # embeddings prepended by the stub frontend
    max_seq_len: int = 32768
    dtype: str = "bfloat16"
    # attention scaling for sub-quadratic support declaration
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        from repro_torch.models.model_zoo import analytic_param_count

        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model_zoo import analytic_param_count

        return analytic_param_count(self, active_only=True)


# ---------------------------------------------------------------------------
# Input shapes (the assigned 4-shape set)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg: ModelConfig):
    """The applicable shape list for an architecture (skips documented in
    DESIGN.md §Arch-applicability)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return out


# ---------------------------------------------------------------------------
# Trinity vector-pool config (paper §3.2/§3.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VectorPoolConfig:
    """Continuous-batching ANN engine + two-queue scheduler parameters."""

    # dataset / index
    num_vectors: int = 100_000
    dim: int = 128
    graph_degree: int = 16  # D: fixed out-degree
    metric: str = "l2"  # "l2" | "ip"
    # engine (per §3.2)
    max_requests: int = 64  # running-batch slot count
    top_m: int = 32  # internal candidate list size (topM)
    parents_per_step: int = 2  # p: parents expanded per request per extend
    task_batch: int = 2048  # fixed distance-kernel shape (padded w/ dummies)
    visited_slots: int = 2048  # open-addressing visited table size per slot
    search_width: int = 1  # initial random entry points multiplier
    top_k: int = 10  # results returned
    # fused stepping: K extend steps per device dispatch (lax.scan) — the
    # host syncs completion masks once per chunk instead of every step
    extend_chunk: int = 4
    # distance-stage compute path: "slot_gather" (row-wise O(T·d), default)
    # or "matmul_onehot" (original O(T·R·d) MXU path, kept as oracle)
    distance_mode: str = "slot_gather"
    # scheduler (per §3.3)
    r_min: float = 0.1
    r_max: float = 0.9
    r_init: float = 0.3
    tau_pre_ms: float = 0.5  # prefill flush timeout
    tau_global_ms: float = 2.0  # global flush timeout
    prefill_deadline_ms: float = 25.0  # L_pre,max
    decode_deadline_ms: float = 100.0
    control_interval_ms: float = 200.0  # adaptive control loop period
    # stage-aware preemption (paper contribution 3): evict running searches
    # between fused extend chunks when urgent work is queued and no slot is
    # free; checkpointed state resumes bit-identically (continuous_batching)
    preemption_enabled: bool = True
    preempt_slack_ms: float = 2.0  # queued slack below this => urgent
    max_preemptions: int = 2  # per-request eviction cap (starvation guard)
    # semantic answer cache (retrieval-class workload): prompt-embedding
    # lookup before prefill; a hit under the distance threshold serves the
    # cached answer and skips the whole PD pipeline; a miss inserts the new
    # (prompt embedding -> answer) pair at completion as a deadline-less
    # background-class request that fills spare engine slots
    semantic_cache_enabled: bool = False
    cache_capacity: int = 1024  # initial cache-segment capacity (doubles)
    cache_hit_threshold: float = 0.25  # hit iff best cache dist <= this
    cache_top_k: int = 4  # results returned per cache lookup
    cache_lookup_budget: int = 32  # extend budget per lookup (0 = unlimited)
    insert_budget: int = 16  # extend budget per insert neighbor search
    # bounded cache segment (eviction): entries older than cache_ttl_s are
    # lazily evicted at the next insert; cache_max_entries caps the live
    # entry count (oldest evicted first) and evicted slots are REUSED, so
    # capacity stops doubling unbounded. 0 = off (legacy unbounded growth)
    cache_ttl_s: float = 0.0
    cache_max_entries: int = 0
    # answer-transfer cost: a semantic-cache hit ships its cached answer
    # (answer_tokens × this many bytes) over the shared KV link instead of
    # serving in zero simulated time — small payloads still queue behind
    # in-flight multi-MB prefill KV transfers. 0 = legacy free hits
    answer_bytes_per_token: float = 4.0
    # sharded serving (scatter–gather): partition the corpus into
    # num_shards balanced-k-means shards, each a self-contained
    # OnlineIndex owned by replicas_per_shard replicas; searches fan out
    # to nprobe_shards nearest shard centroids (0 = all shards, exact
    # under exhaustive per-shard search) and merge via a jitted partial
    # top-k. Inserts route to the owning shard only (no global broadcast)
    num_shards: int = 1
    nprobe_shards: int = 0  # 0 = fan out to every shard
    replicas_per_shard: int = 1
    shard_kmeans_iters: int = 8
    # fine routing sub-centroids per shard: the balanced partition splits
    # popular cells across shards, so routing scores each shard by the MIN
    # distance over several sub-centroids instead of one mean
    shard_route_centroids: int = 4
    cache_replication: int = 2  # min replicas on shards holding cache rows
    # megabatched cross-shard dispatch: the sharded pool steps every
    # replica sitting at the clock frontier through ONE vmapped
    # extend_multi dispatch over stacked per-lane engine state (a
    # (G, R, …) leading layout) instead of one dispatch + sync per
    # replica — per-lane math is bit-identical to serial stepping
    # (asserted in tests/test_dispatch_pipeline.py). Off = the serial
    # per-replica legacy path, bit-identical to PR 4
    megabatch_enabled: bool = True
    # on-device partial-top-k merge: completing per-shard children fold
    # their (top_m,) partial lists — shard-local→global id translation
    # included as a jitted gather over the partition table — into a
    # preallocated per-parent device buffer; one device top_k finalizes
    # the parent and the host syncs only the merged (top_k,) ids+dists
    # instead of S partial lists. Requires megabatch_enabled; off = the
    # host-side merge_partial_topk legacy path
    device_merge_enabled: bool = True
    # double-buffered chunks: the megabatched extend for chunk N is
    # dispatched asynchronously and the host runs next-round scheduling
    # work (pending-arrival release, controller updates) BEFORE syncing
    # chunk N's completion masks, overlapping host bookkeeping with
    # device compute. Rescue snapshots, preemption and chaos kills still
    # land at chunk boundaries. Requires megabatch_enabled
    double_buffer_enabled: bool = True
    # device merge-buffer rows: concurrent fan-out parents that can hold
    # device-side partial results at once; overflow parents fall back to
    # the host merge for that request (correct, just slower)
    merge_buffer_rows: int = 256
    # per-replica index row capacity (HBM model): a replica whose index
    # (frozen + cache segments) exceeds this refuses to build — the signal
    # that a corpus must be sharded. 0 = unlimited
    replica_max_rows: int = 0
    # workload-adaptive shard rebalancing: with the knob on, the sharded
    # pool tracks per-shard load (EWMA probe/insert rates, queue depth,
    # recent child wait p95) and, between fused chunks, (a) moves a
    # replica from the coldest to the hottest shard when the imbalance
    # clears the hysteresis band — in-flight work re-queues
    # checkpoint-intact on the donor shard — and (b) migrates the oldest
    # cache entries off a shard nearing its entry/row budget to the
    # least-occupied neighbor (global cache ids stay stable across the
    # move). Off (default) = the PR-4 static partition, bit-identical
    rebalance_enabled: bool = False
    rebalance_cooldown_s: float = 0.25  # min time between rebalance actions
    # hysteresis band: a shard is hot when its per-replica load exceeds
    # hot_factor × the pool mean AND some donor sits below cold_factor ×
    # the mean — both must hold, so oscillating load cannot thrash
    rebalance_hot_factor: float = 2.0
    rebalance_cold_factor: float = 0.75
    rebalance_window_s: float = 0.1  # EWMA horizon for per-shard load rates
    # cache-entry migration: a shard whose live cache occupancy exceeds
    # this fraction of its budget (cache_max_entries and/or the row budget
    # left under replica_max_rows) sheds its oldest entries BEFORE the cap
    # forces a real eviction
    rebalance_migrate_watermark: float = 0.85
    rebalance_migrate_batch: int = 8  # cache entries moved per migration
    # failure recovery (chaos/high-availability serving). ALL knobs default
    # OFF: with every knob at its default the pool is bit-identical to the
    # legacy failure path (kill_replica restarts in-flight work from
    # scratch with an immediate re-queue, a whole-shard loss silently
    # drops its cache entries)
    # checkpoint rescue: snapshot every in-flight slot's SlotCheckpoint
    # host-side after each fused chunk (one extra gather dispatch + sync
    # per chunk); on replica death the victims RESUME from their snapshot
    # on a surviving replica instead of restarting from scratch
    rescue_enabled: bool = False
    # death-retry backoff: a killed (non-rescued) request re-queues after
    # min(backoff, half its remaining deadline slack) instead of
    # immediately — deadline-aware so a retry never sleeps past the point
    # of rescue. 0 = immediate re-queue (legacy)
    retry_backoff_ms: float = 0.0
    # death-retry cap: a request killed more than this many times completes
    # as FAILED (empty results, counted in PoolMetrics.retries_exhausted)
    # instead of retrying forever. 0 = unlimited retries (legacy)
    max_retries: int = 0
    # hedged dispatch: a per-shard child in flight longer than
    # hedge_factor × its expected service time (est_extends × T_ext EWMA),
    # or stuck on a quarantined straggler replica, gets a duplicate twin
    # submitted to the same shard; the first result wins, the loser is
    # cancelled, and the fan-out pending set dedupes so parents complete
    # exactly once
    hedge_enabled: bool = False
    hedge_factor: float = 6.0
    # cache-entry backup: keep host-side peer copies of every cache entry
    # (vector + insert timestamp) so a whole-shard loss re-homes the lost
    # entries onto a surviving shard (original gids + timestamps — repeat
    # prompts still hit) instead of silently converting them to misses
    cache_backup_enabled: bool = False
    # runtime invariant sanitizer (repro.serving.sanitizer): wrap the
    # pool's step/kill/move/index seams with record-only checks —
    # per-replica clock monotonicity, exactly-once completion per rid,
    # checkpoint conservation across moves/rescues, cache gid uniqueness
    # across eviction+migration, and (under ClusterSim) no orphaned
    # probes after kills. Off (default) = nothing is wrapped; behavior
    # is bit-identical to a build without the sanitizer
    sanitizer_enabled: bool = False
    # hardware model (TPU v5e-class, assigned constants)
    peak_flops: float = 197e12
    hbm_bw: float = 819e9
    ici_bw: float = 50e9


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Closed-loop SLO autoscaler for the cluster sim (goodput control
    plane). OFF by default: a :class:`~repro_torch.serving.cluster.ClusterSim`
    only runs the controller when constructed with
    ``autoscaler=AutoscalerConfig(...)`` — with the default (``None``)
    nothing is scheduled, no seam changes behavior, and cluster runs are
    bit-identical to a build without the subsystem. The controller is a
    KEDA-style target tracker: each epoch it publishes a
    ``ControlSignals`` snapshot from the rolling windows and applies at
    most one scale action per pool under a fixed total-GPU budget, with
    two-sided hysteresis + cooldown (the rebalancer's anti-thrash idiom)
    and scale-down via safe drain (checkpoint-intact for vector
    replicas, stop-admissions graceful drain for LLM instances)."""

    # control epoch: one signals snapshot + at most one scale action per
    # pool each epoch (simulated seconds)
    epoch_s: float = 0.02
    # rolling signal window for the windowed TTFT/ITL percentiles, probe
    # deadline-miss rate and goodput rate (simulated seconds)
    window_s: float = 0.25
    # SLO targets defining goodput: a finished request is "good" when
    # TTFT <= ttft_slo_s and (when it decoded) TPOT <= tpot_slo_s
    ttft_slo_s: float = 0.4
    tpot_slo_s: float = 0.05
    # tolerated windowed probe deadline-miss rate before the vector pool
    # reads as under-provisioned
    probe_miss_budget: float = 0.1
    # fixed total GPU budget in instance units (1 unit = one prefill or
    # decode instance or one vector replica); 0 = freeze the allocation
    # present when the controller attaches
    gpu_budget: int = 0
    # serving minimums — drains never take a pool below these (the
    # vector floor is per shard, and cache-holding shards additionally
    # keep cfg.cache_replication replicas)
    min_prefill: int = 1
    min_decode: int = 1
    min_vector: int = 1
    # target-tracking setpoints: queued work per active instance the
    # controller tries to hold each pool at (vector replicas batch many
    # probes per engine, so they carry a deeper target)
    queue_target: float = 2.0
    queue_target_vector: float = 4.0
    # two-sided hysteresis band on normalized pool pressure
    # (metric / target): above hot_factor => scale up; a donor must sit
    # below cold_factor — both must hold, so oscillating load cannot
    # thrash (the rebalancer's hot/cold idiom)
    hot_factor: float = 1.0
    cold_factor: float = 0.35
    # minimum time between scale-ups / scale-downs of the same pool
    cooldown_up_s: float = 0.05
    cooldown_down_s: float = 0.1
    # stage-aware priority guard: a vector-pool deficit may only take a
    # decode unit while the windowed ITL p95 is within this factor of
    # tpot_slo_s — a starved vector pool cannot push decode out of SLO
    itl_protect_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))
