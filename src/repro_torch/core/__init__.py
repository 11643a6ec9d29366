"""Trinity core on PyTorch: the paper's contribution.

  continuous_batching — §3.2 extend-step engine with the fixed-shape
                        global distance stage (Hopper kernel on the card)
  scheduler           — §3.3 lane scheduling (EDF/FIFO/background) +
                        adaptive r/τ + stage-aware preemption policy
  trinity_pool        — shared vector-search pool (replicas, stragglers,
                        elasticity, failures, online inserts, the answer
                        cache) and its sharded, megabatched form
  roofline_model      — the V5E-model prices of the simulated clocks
                        (extend steps, prefill, decode steps)
  architectures       — §3.1 the three vector-search placements
"""
from repro_torch.core.continuous_batching import ContinuousBatchingEngine  # noqa
from repro_torch.core.scheduler import TwoQueueScheduler, VectorRequest  # noqa
from repro_torch.core.trinity_pool import ShardedVectorPool, VectorPool  # noqa
