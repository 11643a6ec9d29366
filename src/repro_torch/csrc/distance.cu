// Fixed-shape distance stage of the continuous-batching engine, by hand for
// Hopper (sm_90a). Two kernels, one per engine `distance_mode`:
//
//   distance_slot_gather — replaces the TPU kernel
//     src/repro/kernels/distance.py::_distance_kernel_gather
//     (distance_tasks(mode="slot_gather"), the default mode).
//     Per task t: x = db[id_t], q = queries[slot_t];
//     l2 = sum((x - q)^2), ip = -sum(x * q); 1e30 where id_t < 0.
//
//   distance_onehot — replaces the TPU kernel
//     src/repro/kernels/distance.py::_distance_kernel
//     (distance_tasks(mode="matmul_onehot")).
//     Same tasks, the one-hot form's formula: l2 = |x|^2 - 2 x.q + |q|^2,
//     ip = -x.q. The TPU ran an (TB, d) x (R, d)^T Gram on its matrix unit
//     and then selected one column of R; here only the owning slot's dot
//     product is formed (the other R-1 columns were wasted work), with
//     |x|^2 and |q|^2 reduced by the same warp in the same pass.
//
// Bound on this card. Each task reads one db row (4d bytes, d = 128 at the
// engine shape), reads its query row from a (R, d) block that stays in L2,
// and does ~3d flops: about 0.75 flop per byte, far below the H100's
// ~20 flop/byte fp32 ridge, so the work is memory-bound. At T = 2048 tasks
// about 1.1 MB moves: ~0.33 us at 3.35 TB/s, well under the few
// microseconds a launch costs. The kernel is therefore launch-bound at the
// engine shape; what the design does about the bytes is to move each
// byte once, with the widest loads:
//   * one warp per task; each lane issues 16-byte float4 loads, so one warp
//     instruction reads a 512-byte row segment (at d = 128, the whole row);
//     rows whose length is not a multiple of 4 floats (or unaligned bases)
//     take a scalar path;
//   * dummy tasks (id < 0) read nothing and write exactly 1e30;
//   * the query row is read through the read-only path (L1), not staged in
//     shared memory: a block of 8 tasks needs at most 8 of the R rows, so
//     copying the whole (R, d) block per block would read more than it
//     saves;
//   * the row sum is a butterfly of warp shuffles in a fixed order: no
//     atomics, and repeated runs give the same bits.
// The launch cost itself (the real bound here) is left to a later change:
// CUDA-graph capture of the engine's K-step chunk.
//
// Out-of-range indices follow the JAX gather semantics the plain versions
// use: ids clamp into [0, n) and slots into [0, r).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kDummyDist = 1e30f;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kOnehot: accumulate |x|^2, x.q, |q|^2 (one-hot form); else sum((x-q)^2)
// for l2 or x.q for ip (slot-gather form).
template <bool kVec, bool kOnehot, bool kL2>
__global__ void __launch_bounds__(kThreads)
distance_kernel(const float* __restrict__ db, int64_t n, int d,
                const float* __restrict__ queries, int r,
                const int32_t* __restrict__ ids,
                const int32_t* __restrict__ slots,
                float* __restrict__ out, int t) {
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (task >= t) return;  // warp-uniform: the whole warp shares one task
  const int32_t id = __ldg(ids + task);
  if (id < 0) {
    if (lane == 0) out[task] = kDummyDist;
    return;
  }
  const int64_t row = id < n ? static_cast<int64_t>(id) : n - 1;
  int slot = __ldg(slots + task);
  slot = slot < 0 ? 0 : (slot < r ? slot : r - 1);
  const float* x = db + row * d;
  const float* q = queries + static_cast<int64_t>(slot) * d;

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
int launch(const float* db, int64_t n, int d, const float* queries, int r,
           const int32_t* ids, const int32_t* slots, float* out, int t,
           int metric_l2, void* stream) {
  if (t <= 0 || n <= 0 || r <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(db) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(queries) % 16 == 0);
  const dim3 grid((t + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(V, L2) \
  distance_kernel<V, kOnehot, L2><<<grid, kThreads, 0, s>>>(db, n, d, queries, r, ids, slots, out, t)
  if (vec) {
    if (metric_l2) REPRO_LAUNCH(true, true); else REPRO_LAUNCH(true, false);
  } else {
    if (metric_l2) REPRO_LAUNCH(false, true); else REPRO_LAUNCH(false, false);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int repro_distance_slot_gather(const float* db, int64_t n, int d,
                                          const float* queries, int r,
                                          const int32_t* ids, const int32_t* slots,
                                          float* out, int t, int metric_l2,
                                          void* stream) {
  return launch<false>(db, n, d, queries, r, ids, slots, out, t, metric_l2, stream);
}

extern "C" int repro_distance_onehot(const float* db, int64_t n, int d,
                                     const float* queries, int r,
                                     const int32_t* ids, const int32_t* slots,
                                     float* out, int t, int metric_l2,
                                     void* stream) {
  return launch<true>(db, n, d, queries, r, ids, slots, out, t, metric_l2, stream);
}
