// Prefill and decode attention of the serving path, by hand for Hopper
// (sm_90a). Two functions of the port:
//
//   flash_attention — replaces the TPU kernel
//     src/repro/kernels/flash_attention.py::_flash_kernel (flash_attention).
//     q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd), f32 or bf16; query head h
//     reads kv head h / (H / Hkv) (GQA); scale 1/sqrt(hd); online softmax
//     with m, l and the output accumulator in f32; causal mask qpos >= kpos
//     over row indices; output (B, Sq, H, hd) in q's type. One launch:
//     bf16 on the tensor cores, f32 on the fp32 cores.
//
//   decode_attention — replaces the TPU kernel
//     src/repro/kernels/decode_attention.py::_decode_kernel
//     (decode_attention). One new token per sequence: q (B, H, hd) attends
//     over the cache k/v (B, S, Hkv, hd) at positions <= cur_len (one
//     scalar for the whole batch, passed by value from the host). Output
//     (B, H, hd) in q's type. Two launches: a split-KV pass writing f32
//     partial (m, l, acc) triples, and a combine pass.
//
// Bound on this card, and what the design does about it.
//
// flash_attention does 4 * B * H * hd * (Sq * Sk, or about half of it
// under the causal mask) flops on 2 * (B*Sq*H + B*Sk*Hkv) * hd elements.
// At the serving shape (B = 4, S = 512, H = 40, Hkv = 10, hd = 128, bf16)
// that is 1.08e10 flops against 52 MB: ~11 us at the bf16 tensor-core
// peak and ~16 us at 3.35 TB/s, so the bound is bytes there and flops from
// S ~ 1k up. Two kernels share one design, chosen by the input type:
//   * bf16 (the serving path) runs on the tensor cores: mma.sync m16n8k16
//     with f32 accumulators, fragments loaded by ldmatrix from shared
//     memory (rows padded by 16 bytes so the 8 rows of each ldmatrix fall
//     in 8 bank groups); a warp owns 16 q rows; S = Q K^T stays in
//     registers, its accumulator tiles are rounded to bf16 and used as the
//     A fragments of P V (no round trip through shared memory); the online
//     softmax works on the accumulators with two quad shuffles per row.
//     Loads are plain 16-byte loads with no copy/compute overlap inside a
//     block (cp.async/TMA pipelining and wgmma are later work), so it sits
//     above both bounds;
//   * f32 runs on the fp32 cores (67 TFLOP/s peak): TF32 products would
//     not hold float32's precision. S = Q K^T is register-tiled (BQ/8 rows
//     x BK/16 columns a thread), P V reads P as float4 over k, K is stored
//     transposed with rows padded by one float.
// Common to both:
//   * one block of 128 threads per (q tile, head, batch row); a loop over
//     kv tiles inside the block takes the TPU's sequential grid axis, and
//     under the causal mask it stops at the tile that holds the diagonal;
//   * q, k, v are read in place from the (B, S, H, hd) layout through
//     their strides (no transposed copies), each element once per q tile
//     (the bf16 kernel falls back to element loads when a pointer or a
//     stride is not 16-byte aligned);
//   * any Sq, Sk: the ragged tiles are zero-filled and masked (the TPU
//     version halved its block until it divided S);
//   * q tiles are issued longest-first, so under the causal mask the last
//     wave holds the short tiles.
//
// decode_attention reads the cache rows at positions <= cur_len once:
// B * (cur_len + 1) * Hkv * hd * 2 elements (11.1 MB at B = 4, cur_len =
// 543, Hkv = 10, hd = 128, bf16: 3.3 us) for ~4 * B * H * hd * (cur_len+1)
// flops: about g/2 flops per byte, so it is bound by bytes. What it does:
//   * the g query heads that share a kv head are computed together in one
//     block, so each cache row is read once (g up to 16);
//   * split-KV: B * Hkv blocks alone (40 at the serving shape) would leave
//     most of the 132 SMs idle, so positions [0, cur_len] are cut into
//     chunks, one block each, about two blocks per SM in all; each group of
//     lanes in a warp (hd / EPL lanes, EPL elements a lane, coalesced) takes
//     one position at a time and keeps its own online-softmax state, which
//     it writes out as a partial; a second launch combines the partials of
//     each (b, h) in a fixed order;
//   * positions past cur_len are never read;
//   * no atomics anywhere: repeated runs give the same bits.
//
// Both kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the plain versions' mask value
constexpr int kThreads = 128;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

constexpr int align4(int n) { return (n + 3) & ~3; }

// ---------------------------------------------------------------------------
// flash_attention (prefill)
// ---------------------------------------------------------------------------

template <int HD>
struct FlashTile {
  static constexpr int BQ = HD > 128 ? 32 : 64;  // q rows per block
  static constexpr int BK = HD >= 128 ? 32 : 64;  // kv rows per tile
  static constexpr int QS = HD + 1;              // Q row stride (floats)
  static constexpr int KS = BK + 1;              // K^T row stride
  static constexpr int PS = BK + 4;              // P row stride (float4 rows)
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = align4(Q_OFF + BQ * QS);
  static constexpr int V_OFF = align4(K_OFF + HD * KS);
  static constexpr int P_OFF = align4(V_OFF + BK * HD);
  static constexpr int M_OFF = align4(P_OFF + BQ * PS);
  static constexpr int L_OFF = M_OFF + BQ;
  static constexpr int A_OFF = L_OFF + BQ;
  static constexpr int FLOATS = A_OFF + BQ;
  static constexpr int BYTES = FLOATS * 4;
  // S = Q K^T: thread (ty, tx) of 8 x 16 owns rows ty + 8i, columns tx + 16j
  static constexpr int RI = BQ / 8;
  static constexpr int CJ = BK / 16;
  // O: COLS distinct columns and ROWS rows a thread
  static constexpr int COLS = HD >= kThreads ? HD / kThreads : 1;
  static constexpr int ROWS = BQ * HD / kThreads / COLS;
  static constexpr int TPR = kThreads / BQ;  // threads per row in the softmax
  static_assert(BQ % 8 == 0 && BK % 16 == 0 && BK % 4 == 0, "tile shape");
  static_assert(HD >= kThreads ? HD % kThreads == 0 : kThreads % HD == 0, "hd");
  static_assert(32 % TPR == 0 && BK % TPR == 0, "softmax lanes");
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
    int group, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int causal,
    float scale) {
  using F = FlashTile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + F::Q_OFF;
  float* Kt = smem + F::K_OFF;
  float* Vs = smem + F::V_OFF;
  float* Ps = smem + F::P_OFF;
  float* m_s = smem + F::M_OFF;
  float* l_s = smem + F::L_OFF;
  float* a_s = smem + F::A_OFF;

  const int t = threadIdx.x;
  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * F::BQ;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + hk * skh;
  const float* vb = v + b * svb + hk * svh;

  for (int idx = t; idx < F::BQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    Qs[r * F::QS + d] = q0 + r < Sq ? qb[(q0 + r) * sqs + d] : 0.f;
  }
  if (t < F::BQ) {
    m_s[t] = kNegInf;
    l_s[t] = 0.f;
  }

  const int tx = t % 16, ty = t / 16;
  float acc[F::ROWS][F::COLS];
#pragma unroll
  for (int r = 0; r < F::ROWS; ++r)
#pragma unroll
    for (int c = 0; c < F::COLS; ++c) acc[r][c] = 0.f;
  auto o_row = [&](int r) {
    return HD >= kThreads ? r : t / HD + r * (kThreads / HD);
  };
  auto o_col = [&](int c) { return HD >= kThreads ? t + c * kThreads : t % HD; };

  const int kv_end = causal ? min(Sk, q0 + F::BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += F::BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = t; idx < F::BK * HD; idx += kThreads) {
      const int c = idx / HD, d = idx % HD;
      const bool in = k0 + c < Sk;
      Kt[d * F::KS + c] = in ? kb[(k0 + c) * sks + d] : 0.f;
      Vs[c * HD + d] = in ? vb[(k0 + c) * svs + d] : 0.f;
    }
    __syncthreads();

    // S tile = scale * Q K^T, masked
    float s[F::RI][F::CJ];
#pragma unroll
    for (int i = 0; i < F::RI; ++i)
#pragma unroll
      for (int j = 0; j < F::CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[F::RI], kv[F::CJ];
#pragma unroll
      for (int i = 0; i < F::RI; ++i) qv[i] = Qs[(ty + 8 * i) * F::QS + d];
#pragma unroll
      for (int j = 0; j < F::CJ; ++j) kv[j] = Kt[d * F::KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < F::RI; ++i)
#pragma unroll
        for (int j = 0; j < F::CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < F::RI; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < F::CJ; ++j) {
        const int c = tx + 16 * j;
        const bool ok = k0 + c < Sk && (!causal || q0 + r >= k0 + c);
        Ps[r * F::PS + c] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, TPR adjacent lanes per row
    {
      const int r = t / F::TPR, part = t % F::TPR;
      const float m_old = m_s[r];
      float mx = kNegInf;
      for (int c = part; c < F::BK; c += F::TPR) mx = fmaxf(mx, Ps[r * F::PS + c]);
#pragma unroll
      for (int off = F::TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < F::BK; c += F::TPR) {
        const float p = expf(Ps[r * F::PS + c] - m_new);
        Ps[r * F::PS + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = F::TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha * O + P V
#pragma unroll
    for (int r = 0; r < F::ROWS; ++r) {
      const float alpha = a_s[o_row(r)];
#pragma unroll
      for (int c = 0; c < F::COLS; ++c) acc[r][c] *= alpha;
    }
    for (int k4 = 0; k4 < F::BK; k4 += 4) {
      float vv[F::COLS][4];
#pragma unroll
      for (int c = 0; c < F::COLS; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) vv[c][kk] = Vs[(k4 + kk) * HD + o_col(c)];
#pragma unroll
      for (int r = 0; r < F::ROWS; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(&Ps[o_row(r) * F::PS + k4]);
#pragma unroll
        for (int c = 0; c < F::COLS; ++c) {
          float a = acc[r][c];
          a = fmaf(p.x, vv[c][0], a);
          a = fmaf(p.y, vv[c][1], a);
          a = fmaf(p.z, vv[c][2], a);
          a = fmaf(p.w, vv[c][3], a);
          acc[r][c] = a;
        }
      }
    }
  }
  __syncthreads();

  float* ob = o + (static_cast<int64_t>(b) * Sq * H + h) * HD;
#pragma unroll
  for (int r = 0; r < F::ROWS; ++r) {
    const int row = o_row(r);
    if (q0 + row >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int c = 0; c < F::COLS; ++c)
      ob[static_cast<int64_t>(q0 + row) * H * HD + o_col(c)] = acc[r][c] * inv;
  }
}

// ---- bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulators) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
struct MmaTile {
  static constexpr int BQ = 64;                  // q rows a block, 16 a warp
  static constexpr int BK = HD > 128 ? 32 : 64;  // kv rows a tile
  static constexpr int RS = HD + 8;  // smem row stride (bf16): 16-byte pad,
                                     // so ldmatrix's 8 rows hit 8 bank groups
  static constexpr int NT = BK / 8;  // S n-tiles (8 columns) a warp
  static constexpr int OT = HD / 8;  // O n-tiles a warp
  static constexpr int BYTES = (BQ + 2 * BK) * RS * 2;
  static_assert(HD % 16 == 0 && BK % 16 == 0, "mma tile shape");
};

// rows [row0, row0 + ROWS) of a (rows, HD) bf16 operand into shared memory,
// 16 bytes a thread and step (vec) or element by element; rows at or past
// n_valid are zero, so masked products stay finite
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int row0,
                                          int n_valid, bool vec) {
  constexpr int CH = HD / 8;
  constexpr int RS = MmaTile<HD>::RS;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx % CH) * 8;
    union {
      uint4 u;
      unsigned short h[8];
    } val;
    val.u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid) {
      const __nv_bfloat16* p = src + static_cast<int64_t>(row0 + r) * row_stride + c;
      if (vec) {
        val.u = *reinterpret_cast<const uint4*>(p);
      } else {
        const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
        for (int e = 0; e < 8; ++e) val.h[e] = ps[e];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * RS + c) = val.u;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
    int Sk, int H, int group, int64_t sqb, int64_t sqs, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
    int64_t svh, int causal, int vec, float scale) {
  using F = MmaTile<HD>;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Ks = Qs + F::BQ * F::RS;
  __nv_bfloat16* Vs = Ks + F::BK * F::RS;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;  // mma group and lane in the group
  const int qt = causal ? static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * F::BQ;
  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + hk * skh;
  const __nv_bfloat16* vb = v + b * svb + hk * svh;
  load_rows<HD, F::BQ>(Qs, qb, sqs, q0, Sq, vec);

  // this lane's rows: row_g (accumulator elements 0, 1) and row_g + 8 (2, 3)
  const int wrow = warp * 16;
  const int row_g = q0 + wrow + g;
  // ldmatrix row/column offsets of this lane (see the fragment layouts of
  // mma.m16n8k16: A row-major from Q and P, B from K rows and, transposed,
  // from V rows)
  const int a_row = (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const int k_row = (lane % 8) + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;

  float acc[F::OT][4];
#pragma unroll
  for (int i = 0; i < F::OT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int kv_end = causal ? min(Sk, q0 + F::BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += F::BK) {
    __syncthreads();  // Q is stored; the previous tile's K and V are consumed
    load_rows<HD, F::BK>(Ks, kb, sks, k0, Sk, vec);
    load_rows<HD, F::BK>(Vs, vb, svs, k0, Sk, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK columns
    float s[F::NT][4];
#pragma unroll
    for (int j = 0; j < F::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < HD / 16; ++kq) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (wrow + a_row) * F::RS + kq * 16 + a_col);
#pragma unroll
      for (int jp = 0; jp < F::BK / 16; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Ks + (jp * 16 + k_row) * F::RS + kq * 16 + k_col);
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask, online softmax (a row's 4 lanes share it by shuffles)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < F::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_g + (e / 2) * 8;
        const int col = k0 + 8 * j + 2 * tg + (e % 2);
        const bool ok = col < Sk && (!causal || row >= col);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < F::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e / 2]);
        s[j][e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = alpha[r] * l[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < F::OT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e / 2];

    // O += P V: P's accumulator tiles are the A fragments of the next mma
#pragma unroll
    for (int kk = 0; kk < F::BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + (kk * 16 + a_row) * F::RS + np * 16 + a_col);
        mma_bf16(acc[2 * np], a, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        o + ((static_cast<int64_t>(b) * Sq + row) * H + h) * HD);
#pragma unroll
    for (int i = 0; i < F::OT; ++i)
      orow[(8 * i + 2 * tg) / 2] = pack_bf16(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
  }
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int Hkv, int64_t sqb, int64_t sqs,
                 int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
                 int64_t svb, int64_t svs, int64_t svh, int causal,
                 cudaStream_t stream) {
  using F = FlashTile<HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Sq + F::BQ - 1) / F::BQ, H, B);
  flash_kernel<HD><<<grid, kThreads, F::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, H / Hkv, sqb,
      sqs, sqh, skb, sks, skh, svb, svs, svh, causal, 1.f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int H, int Hkv, int64_t sqb, int64_t sqs,
                     int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
                     int64_t svb, int64_t svs, int64_t svh, int causal,
                     cudaStream_t stream) {
  using F = MmaTile<HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // 16-byte loads need 16-byte aligned rows: the base pointers and every
  // stride a multiple of 8 elements (always so for contiguous projections)
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
                   ((sqb | sqs | sqh | skb | sks | skh | svb | svs | svh) % 8 == 0);
  const dim3 grid((Sq + F::BQ - 1) / F::BQ, H, B);
  flash_mma_kernel<HD><<<grid, kThreads, F::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H,
      H / Hkv, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, causal, vec ? 1 : 0,
      1.f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_flash(int hd, const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int64_t sqb,
                   int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
                   int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                   int causal, cudaStream_t stream) {
  // bf16 runs on the tensor cores; f32 on the fp32 cores (TF32 products
  // would not hold float32's precision)
#define REPRO_FLASH(HD_)                                                         \
  case HD_:                                                                      \
    if constexpr (std::is_same<T, __nv_bfloat16>::value)                         \
      return launch_flash_mma<HD_>(q, k, v, o, B, Sq, Sk, H, Hkv, sqb, sqs, sqh, \
                                   skb, sks, skh, svb, svs, svh, causal, stream); \
    else                                                                         \
      return launch_flash<HD_>(q, k, v, o, B, Sq, Sk, H, Hkv, sqb, sqs, sqh,     \
                               skb, sks, skh, svb, svs, svh, causal, stream);
  switch (hd) {
    REPRO_FLASH(16)
    REPRO_FLASH(32)
    REPRO_FLASH(64)
    REPRO_FLASH(128)
    REPRO_FLASH(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH
}

// ---------------------------------------------------------------------------
// decode_attention (one token over the cache)
// ---------------------------------------------------------------------------

constexpr int decode_epl(int hd) { return hd >= 256 ? 8 : hd >= 128 ? 4 : 2; }

// lane groups per block: each group of hd / EPL lanes takes one position
constexpr int decode_groups(int hd) { return (kThreads / 32) * (32 / (hd / decode_epl(hd))); }

template <typename T, int EPL, int GMAX>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int H, int g, int hd, int n_valid, int chunk,
    int n_part, int64_t sqb, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, float scale) {
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int lpp = hd / EPL;  // lanes per position: 8, 16 or 32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / lpp, li = lane % lpp;
  const int per_warp = 32 / lpp;
  const int n_groups = (kThreads / 32) * per_warp;
  const int grp = warp * per_warp + sub;

  float qr[GMAX][EPL], m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      acc[gi][i] = 0.f;
      qr[gi][i] = gi < g ? to_f(q[b * sqb + (hk * g + gi) * sqh + i * lpp + li]) * scale
                         : 0.f;
    }
  }

  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;
  const int s0 = split * chunk, s1 = min(s0 + chunk, n_valid);
  // the loop bound is the same for every lane of a warp, so the shuffles
  // below always run with the whole warp; lanes past s1 read nothing
  for (int base = s0 + warp * per_warp; base < s1; base += n_groups) {
    const int s = base + sub;
    const bool live = s < s1;
    float kr[EPL], vr[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      kr[i] = live ? to_f(kb[s * sks + i * lpp + li]) : 0.f;
      vr[i] = live ? to_f(vb[s * svs + i * lpp + li]) : 0.f;
    }
    float sc[GMAX];
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) d = fmaf(qr[gi][i], kr[i], d);
      sc[gi] = d;
    }
    for (int off = lpp / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) sc[gi] += __shfl_xor_sync(0xffffffffu, sc[gi], off);
    }
    if (live) {
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        const float m_new = fmaxf(m[gi], sc[gi]);
        const float alpha = expf(m[gi] - m_new);
        const float p = expf(sc[gi] - m_new);
        l[gi] = fmaf(l[gi], alpha, p);
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[gi][i] = fmaf(acc[gi][i], alpha, p * vr[i]);
        m[gi] = m_new;
      }
    }
  }

  const int pidx = split * n_groups + grp;
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi >= g) break;
    const int64_t row = (static_cast<int64_t>(b) * H + hk * g + gi) * n_part + pidx;
#pragma unroll
    for (int i = 0; i < EPL; ++i) part_acc[row * hd + i * lpp + li] = acc[gi][i];
    if (li == 0) {
      part_m[row] = m[gi];
      part_l[row] = l[gi];
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      T* __restrict__ out, int H, int hd,
                                      int n_part) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * n_part;
  float mx = kNegInf;
  for (int p = 0; p < n_part; ++p) mx = fmaxf(mx, part_m[row0 + p]);
  float den = 0.f, num = 0.f;
  for (int p = 0; p < n_part; ++p) {
    const float w = expf(part_m[row0 + p] - mx);
    den = fmaf(w, part_l[row0 + p], den);
    num = fmaf(w, part_acc[(row0 + p) * hd + d], num);
  }
  out[(static_cast<int64_t>(b) * H + h) * hd + d] = from_f<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int EPL, int GMAX>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  float* part_acc, float* part_m, float* part_l, int B, int H,
                  int Hkv, int hd, int n_valid, int n_split, int chunk,
                  int64_t sqb, int64_t sqh, int64_t skb, int64_t sks,
                  int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                  cudaStream_t stream) {
  const int n_part = n_split * decode_groups(hd);
  decode_split_kernel<T, EPL, GMAX><<<dim3(n_split, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_acc, part_m, part_l, H, H / Hkv, hd,
      n_valid, chunk, n_part, sqb, sqh, skb, sks, skh, svb, svs, svh,
      1.f / sqrtf(static_cast<float>(hd)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(H, B), hd, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(o), H, hd, n_part);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPL>
int dispatch_decode_g(int g, const void* q, const void* k, const void* v,
                      void* o, float* pa, float* pm, float* pl, int B, int H,
                      int Hkv, int hd, int n_valid, int n_split, int chunk,
                      int64_t sqb, int64_t sqh, int64_t skb, int64_t sks,
                      int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                      cudaStream_t stream) {
#define REPRO_DECODE(G_)                                                          \
  if (g <= G_)                                                                    \
    return launch_decode<T, EPL, G_>(q, k, v, o, pa, pm, pl, B, H, Hkv, hd,       \
                                     n_valid, n_split, chunk, sqb, sqh, skb, sks, \
                                     skh, svb, svs, svh, stream);
  REPRO_DECODE(1)
  REPRO_DECODE(2)
  REPRO_DECODE(4)
  REPRO_DECODE(8)
  REPRO_DECODE(16)
#undef REPRO_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_decode(const void* q, const void* k, const void* v, void* o,
                    float* pa, float* pm, float* pl, int B, int H, int Hkv,
                    int hd, int n_valid, int n_split, int chunk, int64_t sqb,
                    int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
                    int64_t svb, int64_t svs, int64_t svh, cudaStream_t stream) {
  const int g = H / Hkv;
  switch (decode_epl(hd)) {
    case 2:
      return dispatch_decode_g<T, 2>(g, q, k, v, o, pa, pm, pl, B, H, Hkv, hd, n_valid,
                                     n_split, chunk, sqb, sqh, skb, sks, skh, svb, svs,
                                     svh, stream);
    case 4:
      return dispatch_decode_g<T, 4>(g, q, k, v, o, pa, pm, pl, B, H, Hkv, hd, n_valid,
                                     n_split, chunk, sqb, sqh, skb, sks, skh, svb, svs,
                                     svh, stream);
    default:
      return dispatch_decode_g<T, 8>(g, q, k, v, o, pa, pm, pl, B, H, Hkv, hd, n_valid,
                                     n_split, chunk, sqb, sqh, skb, sks, skh, svb, svs,
                                     svh, stream);
  }
}

bool supported_hd(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of every tensor is contiguous and o is a contiguous
// (B, Sq, H, hd) tensor. Returns a cudaError_t value (0 = launched).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Sk, int H, int Hkv, int hd, int64_t sqb, int64_t sqs,
    int64_t sqh, int64_t skb, int64_t sks, int64_t skh, int64_t svb,
    int64_t svs, int64_t svh, int causal, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0 || !supported_hd(hd) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_flash<float>(hd, q, k, v, o, B, Sq, Sk, H, Hkv, sqb, sqs, sqh, skb,
                                 sks, skh, svb, svs, svh, causal, stream);
  return dispatch_flash<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, Hkv, sqb, sqs, sqh,
                                       skb, sks, skh, svb, svs, svh, causal, stream);
}

// Partials per split for head dim hd: the caller allocates part_acc
// (B, H, n_split * this, hd) and part_m / part_l (B, H, n_split * this),
// all float32.
extern "C" int repro_decode_partials_per_split(int hd) {
  return supported_hd(hd) ? decode_groups(hd) : 0;
}

// Positions [0, n_valid) of the cache are read, in n_split chunks of
// `chunk` positions (n_split * chunk >= n_valid). o is a contiguous
// (B, H, hd) tensor.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o, float* part_acc,
    float* part_m, float* part_l, int dtype, int B, int H, int Hkv, int hd,
    int n_valid, int n_split, int chunk, int64_t sqb, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
    int64_t svh, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 16 || !supported_hd(hd) ||
      n_valid <= 0 || n_split <= 0 || chunk <= 0 ||
      static_cast<int64_t>(n_split) * chunk < n_valid || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_decode<float>(q, k, v, o, part_acc, part_m, part_l, B, H, Hkv, hd,
                                  n_valid, n_split, chunk, sqb, sqh, skb, sks, skh, svb,
                                  svs, svh, stream);
  return dispatch_decode<__nv_bfloat16>(q, k, v, o, part_acc, part_m, part_l, B, H, Hkv,
                                        hd, n_valid, n_split, chunk, sqb, sqh, skb, sks,
                                        skh, svb, svs, svh, stream);
}
