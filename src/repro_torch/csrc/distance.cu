// Fixed-shape distance stage of the continuous-batching engine, by hand for
// Hopper (sm_90a), with a native lane dimension: G lanes (shard replicas),
// each with its own db (N, d), queries (R, d) and T tasks, in one launch.
// G = 1 is the single engine's call. Two kernels, one per engine
// `distance_mode`:
//
//   distance_slot_gather — replaces the TPU kernel
//     src/repro/kernels/distance.py::_distance_kernel_gather
//     (distance_tasks(mode="slot_gather"), the default mode).
//     Per task t of lane g: x = db[g, id], q = queries[g, slot];
//     l2 = sum((x - q)^2), ip = -sum(x * q); 1e30 where id < 0.
//
//   distance_onehot — replaces the TPU kernel
//     src/repro/kernels/distance.py::_distance_kernel
//     (distance_tasks(mode="matmul_onehot")).
//     Same tasks, the one-hot form's formula: l2 = |x|^2 - 2 x.q + |q|^2,
//     ip = -x.q. The TPU ran an (TB, d) x (R, d)^T Gram on its matrix unit
//     and then selected one column of R; here only the owning slot's dot
//     product is formed, with |x|^2 and |q|^2 reduced in the same pass.
//
// The JAX package batches lanes with jax.vmap around the Pallas call
// (src/repro/core/continuous_batching.py, extend_multi_group); a CUDA kernel
// has no vmap, so the lane is a dimension of the task range here: task j of
// the flattened (G, T) range is lane j / T.
//
// What bounds it on this card. A task reads one random db row (4d bytes,
// 512 at d = 128) and its query row (from an (R, d) block that stays in L2)
// and does ~3d flops: 0.75 flop a byte, far below the fp32 ridge, so the
// work is bytes, and random bytes, each row a dependent load behind its id.
//   * G = 1 (T = 2048 at the engine shape, ~0.8 MB): ~0.25 us of bytes
//     under a ~2 us launch floor (a one-element add, back to back): launch
//     and one id -> row latency chain bound it.
//   * G = 32 (64 K tasks, ~27 MB): the bytes bound (~8 us at 3.35 TB/s)
//     passes the floor. The kernel moves the rows at ~1.6 TB/s random and
//     ~1.9 TB/s consecutive, so DRAM locality does not bind; a streaming
//     read of as many contiguous bytes (torch.sum) gets ~2.1 TB/s at this
//     size: the rest is a launch of this length, its floor and ramp
//     (PERF.md; tools/profile_torch_distance.py).
//
// The design: one warp a task, the task range flat over the lanes. Each
// lane of the warp loads float4 i, i + 32, ... of the row and of the query
// row after the id (element i, i + 32, ... where d % 4 != 0 or a base is not
// 16-byte aligned), accumulates with fmaf and sums by one fixed butterfly,
// so the id -> row chain is the whole latency, any G or grid gives the same
// bits, and lane g of a G-lane launch equals a G = 1 launch on lane g.
// A bulk-copy gather ring (a persistent grid, cp.async.bulk of each row into
// two shared-memory stages on mbarriers) was built and timed against it: its
// copies and barriers add ~1.3 us of latency, and it lost at every measured
// G for the slot-gather form (PERF.md, section 6), so it is not kept.
//
// Out-of-range indices follow the JAX gather semantics the plain versions
// use: ids clamp into [0, N) and slots into [0, R), within each lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr float kDummyDist = 1e30f;
constexpr int kWarpsPerBlock = 8;  // one task a warp
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kOnehot: accumulate |x|^2, x.q, |q|^2 (one-hot form); else sum((x-q)^2)
// for l2 or x.q for ip (slot-gather form). Task j of the flat (g, t) range
// belongs to lane g = j / t, whose rows are db[g] and queries[g].
template <bool kVec, bool kOnehot, bool kL2>
__global__ void __launch_bounds__(kThreads)
distance_kernel(const float* __restrict__ db, int64_t n, int d,
                const float* __restrict__ queries, int r,
                const int32_t* __restrict__ ids,
                const int32_t* __restrict__ slots,
                float* __restrict__ out, int t, int total) {
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (task >= total) return;  // warp-uniform: the whole warp shares one task
  const int32_t id = __ldg(ids + task);
  if (id < 0) {
    if (lane == 0) out[task] = kDummyDist;
    return;
  }
  const int g = task / t;
  const int64_t row = id < n ? static_cast<int64_t>(id) : n - 1;
  int slot = __ldg(slots + task);
  slot = slot < 0 ? 0 : (slot < r ? slot : r - 1);
  const float* x = db + (static_cast<int64_t>(g) * n + row) * d;
  const float* q = queries + (static_cast<int64_t>(g) * r + slot) * d;

  float acc = 0.f, xx = 0.f, qq = 0.f;
  auto step = [&](float xv, float qv) {
    if (kOnehot) {
      xx = fmaf(xv, xv, xx);
      acc = fmaf(xv, qv, acc);
      qq = fmaf(qv, qv, qq);
    } else if (kL2) {
      const float diff = xv - qv;
      acc = fmaf(diff, diff, acc);
    } else {
      acc = fmaf(xv, qv, acc);
    }
  };
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = lane; i < (d >> 2); i += 32) {
      const float4 xv = __ldg(x4 + i);
      const float4 qv = __ldg(q4 + i);
      step(xv.x, qv.x);
      step(xv.y, qv.y);
      step(xv.z, qv.z);
      step(xv.w, qv.w);
    }
  } else {
    for (int i = lane; i < d; i += 32) step(__ldg(x + i), __ldg(q + i));
  }

  acc = warp_sum(acc);
  float dist;
  if (kOnehot && kL2) {
    xx = warp_sum(xx);
    qq = warp_sum(qq);
    dist = xx - 2.f * acc + qq;
  } else if (kL2) {
    dist = acc;
  } else {
    dist = -acc;
  }
  if (lane == 0) out[task] = dist;
}

template <bool kOnehot>
int launch(const float* db, int g, int64_t n, int d, const float* queries, int r,
           const int32_t* ids, const int32_t* slots, float* out, int t,
           int metric_l2, void* stream) {
  if (g <= 0 || t <= 0 || n <= 0 || r <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total64 = static_cast<int64_t>(g) * t;
  if (total64 > INT_MAX || static_cast<int64_t>(g) * r > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = static_cast<int>(total64);
  const bool vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(db) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(queries) % 16 == 0);
  const dim3 grid((total + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(V, L2)                                                      \
  distance_kernel<V, kOnehot, L2><<<grid, kThreads, 0, s>>>(db, n, d, queries, r, \
                                                            ids, slots, out, t,   \
                                                            total)
  if (vec) {
    if (metric_l2) REPRO_LAUNCH(true, true); else REPRO_LAUNCH(true, false);
  } else {
    if (metric_l2) REPRO_LAUNCH(false, true); else REPRO_LAUNCH(false, false);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). db (g, n, d), queries (g, r, d),
// ids, slots and out (g, t), all contiguous. Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int repro_distance_slot_gather(const float* db, int g, int64_t n, int d,
                                          const float* queries, int r,
                                          const int32_t* ids, const int32_t* slots,
                                          float* out, int t, int metric_l2,
                                          void* stream) {
  return launch<false>(db, g, n, d, queries, r, ids, slots, out, t, metric_l2, stream);
}

extern "C" int repro_distance_onehot(const float* db, int g, int64_t n, int d,
                                     const float* queries, int r,
                                     const int32_t* ids, const int32_t* slots,
                                     float* out, int t, int metric_l2, void* stream) {
  return launch<true>(db, g, n, d, queries, r, ids, slots, out, t, metric_l2, stream);
}
