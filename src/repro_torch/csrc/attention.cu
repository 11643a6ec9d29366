// Prefill and decode attention of the serving path, by hand for Hopper
// (sm_90a). Two functions of the port:
//
//   flash_attention — replaces the TPU kernel
//     src/repro/kernels/flash_attention.py::_flash_kernel (flash_attention).
//     q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd), f32 or bf16; query head h
//     reads kv head h / (H / Hkv) (GQA); scale 1/sqrt(hd); online softmax
//     with m, l and the output accumulator in f32; causal mask qpos >= kpos
//     over row indices; output (B, Sq, H, hd) in q's type. One launch of
//     one of four variants, chosen by flash_variant (the same rule as
//     kernels/flash_attention.py::flash_variant):
//       flash_wgmma_kernel     bf16, hd 64 or 128, 16-byte aligned bases
//                              and strides (every contiguous or fused
//                              projection)
//       flash_wgmma256_kernel  bf16, hd 256, the same alignment
//       flash_mma_kernel       any other bf16 (hd 16, 32; odd strides)
//       flash_fp32_kernel      f32, on the tensor cores by 3xTF32
//
//   decode_attention — replaces the TPU kernel
//     src/repro/kernels/decode_attention.py::_decode_kernel
//     (decode_attention). One new token per sequence: q (B, H, hd) attends
//     over the cache k/v (B, S, Hkv, hd) at positions <= cur_len (one
//     scalar for the whole batch, passed by value from the host). Output
//     (B, H, hd) in q's type or, when the log-sum-exp is asked for, a
//     partial for the sequence-sharded decode's combine: the output in f32
//     (not rounded to q's type) and each head's log-sum-exp of its scaled
//     scores as f32 (B, H). One launch: decode_split_kernel.
//
// Bound on this card, and what the design does about it.
//
// flash_attention does 4 * B * H * hd * (Sq * Sk, or about half of it
// under the causal mask) flops on 2 * (B*Sq*H + B*Sk*Hkv) * hd elements.
// At the serving shape (B = 4, S = 512, H = 40, Hkv = 10, hd = 128, bf16)
// that is 1.08e10 flops against 52 MB: ~11 us at the bf16 tensor-core
// peak and ~16 us at 3.35 TB/s, so the bound is bytes there and flops from
// S ~ 1k up. flash_wgmma_kernel is built for the tensor cores:
//   * wgmma: S = Q K^T as m64n128k16 with both operands in shared memory;
//     P, rounded to bf16 in registers, is the register A operand of
//     O += P V (V through the transpose bit); f32 accumulators. A block is
//     two consumer warpgroups of 64 q rows each (BQ = 128) and one
//     producer warp;
//   * TMA: Q and the K/V tiles (BK = 128 rows) come in by
//     cp.async.bulk.tensor through 4-D tensor maps (hd, heads, rows, batch)
//     built on the host from the strides, 128-byte swizzled (an hd-128 row
//     is two 64-column boxes), into two Q buffers and a ring of 2 (hd 128)
//     or 3 (hd 64) K/V stages with full/empty mbarriers; rows past Sq or
//     Sk are zero-filled by TMA and masked. cuTensorMapEncodeTiled is
//     fetched through cudaGetDriverEntryPoint, so nothing links libcuda;
//   * persistent: one block an SM walks the (q tile, head, batch) items,
//     q tiles longest-first and the g heads of a kv head side by side (they
//     share its K/V tiles in L2), each round of items in the other
//     direction so long and short tiles even out; the producer loads the
//     next item's Q and K/V while the consumers finish the current one;
//   * ping-pong: named barriers alternate the two warpgroups' S products,
//     so one's softmax runs under the other's products;
//   * softmax: exp2 with scale * log2(e) folded into one FMA; the mask only
//     on tiles that cross the diagonal or the end of k; row sums kept per
//     thread and reduced once at the end.
// What still holds it back (PERF.md): the softmax of a warpgroup does not
// overlap its own products (an overlapped version, with setmaxnreg, ran
// slower with two K/V stages), the diagonal tile is computed whole for
// the warpgroup that needs half of it, and each K/V tile is read from L2
// by each of the g heads' blocks (no cluster multicast).
// flash_wgmma256_kernel is the same design at hd 256, where a 64-row
// warpgroup's O accumulator is 128 registers a thread and a 128-row Q tile
// 64 KB: a producer warpgroup hands its registers to the two consumer
// warpgroups (setmaxnreg), Q has one buffer, K/V come in 64-row tiles
// through a 2-stage ring with separate K and V barriers, S is m64n64k16
// and P V m64n256k16; warpgroup 0 skips the tile past its diagonal. Its
// items go (b, kv head) by (b, kv head), so the K/V of the few heads in
// flight stay in L2 (at S = 2048 all of them would not): with the heads
// fastest it was bound by moving K/V tiles, not by its products (PERF.md).
// flash_mma_kernel (bf16) and flash_fp32_kernel (f32) share one mma.sync
// design (FA2-style, 16 q rows a warp): K/V double-buffered by cp.async in
// the widest pieces the alignment allows, the next tile in flight under the
// current one's products; flash_wgmma's softmax; bf16 as m16n8k16 with Q's
// fragments kept in registers up to hd 128; f32 as 3xTF32 m16n8k8 (each
// operand split into two TF32 parts, three products: float32's accuracy,
// which one TF32 product would not hold). At hd 16 and 32 the exps, not the
// products, set the pace: 16 a clock an SM. The design is at the kernels.
// Common to all four: any Sq, Sk (the TPU version halved its block until
// it divided S); q, k, v read in place through their strides; no atomics,
// so repeated runs give the same bits.
//
// decode_attention reads the cache rows at positions <= cur_len once:
// B * (cur_len + 1) * Hkv * hd * 2 elements (11.1 MB at B = 4, cur_len =
// 543, Hkv = 10, hd = 128, bf16: 3.3 us) for ~4 * B * H * hd * (cur_len+1)
// flops: about g/2 flops per byte, so it is bound by bytes, and at these
// sizes by latency. What it does:
//   * the g query heads that share a kv head are computed together in one
//     block, so each cache row is read once (g up to 16);
//   * split-KV: positions [0, cur_len] are cut into at most 8 chunks of
//     whole 32-position tiles, about one tile a warp; a block of 4 warps
//     (fewer when a tile's K and V pass 48 KB) takes one chunk of one
//     (b, kv head);
//   * each warp streams its tiles' K and V by TMA (4-D maps whose row
//     extent ends at cur_len + 1, so TMA zero-fills rather than reading
//     past it) and works alone: scores for all g heads at 32 positions (a
//     lane each, from 16-byte swizzled shared-memory reads), one max and
//     one sum per head and tile by shuffles, P V into its own columns; no
//     block-wide barrier until the end;
//   * the chunks of one (b, kv head) are one thread-block cluster: every
//     warp leaves its (m, l, acc) partial in shared memory, and the
//     cluster merges them over distributed shared memory in (split, warp)
//     order, in the same launch;
//   * no atomics anywhere: repeated runs give the same bits.
// What still holds it back: latency, not bytes. One block with one tile
// takes ~11 us by CUDA events where a one-element add takes ~5 us; the
// scores and P V run on the fp32 cores, one warp a tile.
//
// Every kernel launches on the caller's stream, allocates nothing, and its
// C entry returns cudaGetLastError() (or the launch's error) after its
// launch.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;  // the plain versions' mask value

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA (both kernels' copies) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also tells the barrier how many bytes TMA will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; the transfer's bytes complete on `bar`; out-of-range rows are
// zero-filled and never read
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// first 1024-byte aligned address of dynamic shared memory (the 128-byte
// swizzle repeats every 1024 bytes; TMA and wgmma assume that alignment)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// flash_attention (prefill)
// ---------------------------------------------------------------------------

// ---- flash_mma (bf16) and flash_fp32 (f32 by 3xTF32) on mma.sync ----
//
// The two variants for what TMA and wgmma do not take: flash_mma every bf16
// input the wgmma variants do not (hd 16 and 32; bases or strides that are
// not 16-byte aligned), flash_fp32 every float32 input. One design, two
// element types:
//   * a warp owns 16 q rows (32 at bf16 hd 32: two m-tiles share each K/V
//     fragment); S = Q K^T and O += P V are mma.sync tiles with f32
//     accumulators (bf16: m16n8k16 from ldmatrix fragments; f32: m16n8k8 on
//     TF32 operands, three products a tile, below);
//   * K/V tiles are double-buffered in shared memory and the next tile is in
//     flight while the current one is computed: cp.async in pieces of W
//     bytes, the largest of 16, 8 and 4 that divides every base and stride
//     (so a view of a fused projection with an odd row stride still loads 8
//     or 4 bytes at a time), one barrier a tile. W = 2 (a bf16 base or
//     stride at an odd element) has no cp.async: plain 2-byte loads, still
//     into the other stage ahead of the current tile's products;
//   * softmax as flash_wgmma's: exp2 (ex2.approx) with scale * log2(e)
//     folded into one FMA, the mask only on tiles that cross the diagonal or
//     Sk, a row's max shared by quad shuffles, its sum kept per lane and
//     reduced once at the end; a warp skips the tiles past its last row.
//     The running max moves only when a row's max passes it by more than 8
//     (log2 domain), so most tiles skip rescaling O;
//   * bf16 keeps Q's A fragments in registers for the whole kv loop at hd
//     <= 128; at hd 256 they would be 64 registers beside O's 128, so Q is
//     read from shared memory each tile;
//   * the grid is (head, q tile, batch), heads fastest: the g query heads of
//     a kv head run side by side and share its K/V tiles in L2; q tiles go
//     longest-first under the causal mask.
// What bounds them: at hd 16 and 32 the exps (16 a clock an SM), at hd 128
// and 256 the products; issuing S(j + 1) under tile j's exps needed a third
// stage and more registers, and ran slower (PERF.md).
// 3xTF32 (flash_fp32): each f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), and a product accumulates lo*hi + hi*lo + hi*hi in
// f32: float32's accuracy to about 2^-21, where one TF32 product (a 10-bit
// mantissa) would not hold it. The m16n8k8 accumulator gives lane (g, t)
// the columns 2t and 2t+1 of an 8-column tile where an A fragment wants t
// and t+4: P stays in registers as it is, and V's B fragment is read in the
// same permuted order (kv rows 2t and 2t+1), which P V's sum over k allows.

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

// c (16x8, f32) += a (16x8, tf32, row) * b (8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both TF32 (round to nearest, ties away, as cvt.rna)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a b in float32's accuracy (3xTF32), the small products first
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x in one MUFU op (-inf -> +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cp.async of W bytes (4, 8 or 16) into shared memory; 16-byte pieces skip L1
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(W)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until every cp.async group this thread committed has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int W> struct Piece;  // a register type of W bytes
template <> struct Piece<16> { using type = uint4; };
template <> struct Piece<8> { using type = uint2; };
template <> struct Piece<4> { using type = uint32_t; };
template <> struct Piece<2> { using type = unsigned short; };

// Tile shapes per type and hd, each the fastest of those timed side by side
// on the card (PERF.md): one block keeps a BQ x HD Q tile and two
// stages of BK-row K and V tiles in shared memory.
template <typename T, int HD>
struct MmaTile {
  static constexpr bool F32 = sizeof(T) == 4;
  // 16-row m-tiles a warp: two at bf16 hd 32, so each K/V fragment feeds
  // two products and a tile's fixed costs cover twice the scores
  static constexpr int MT = !F32 && HD == 32 ? 2 : 1;
  static constexpr int WARPS = !F32 && HD > 128 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * MT * WARPS;  // q rows a block
  static constexpr int BK = F32 ? (HD <= 64 ? 64 : 32) : HD == 32 ? 128 : HD > 128 ? 32 : 64;
  // blocks an SM in the launch bound: ptxas then allocates the registers
  // the f32 tiles need (with none it chose 128 and spilled)
  static constexpr int MIN_BLOCKS = F32 ? 2 : 1;
  // shared-memory row stride (elements): bf16 rows 16 bytes apart in the
  // bank groups, so ldmatrix's 8 rows hit 8 of them; f32 rows 4 banks
  // apart, so a fragment's 8 rows x 4 columns hit all 32
  static constexpr int RS = F32 ? HD + 4 : HD + 8;
  static constexpr int NT = BK / 8;  // 8-column S tiles an m-tile
  static constexpr int OT = HD / 8;  // 8-column O tiles an m-tile
  static constexpr bool QREG = !F32 && HD <= 128;  // Q's fragments in registers
  static constexpr int STAGE = BK * RS;  // elements of K (or V) in one stage
  static constexpr int BYTES = (BQ + 4 * BK) * RS * static_cast<int>(sizeof(T));
  static_assert(HD % 16 == 0 && BK % 16 == 0, "mma tile shape");
  static_assert(BYTES <= 232448, "shared memory");
};

// rows [row0, row0 + ROWS) of a (rows, HD) operand into shared memory rows
// RS elements apart, in W-byte pieces (cp.async for W >= 4); rows at or
// past n_valid are stored as zeros, so masked products stay finite. When
// the threads cover whole rows, each keeps one column and steps its
// pointers by a constant, so a piece costs few instructions beside its copy.
template <typename T, int HD, int ROWS, int RS, int NTHR, int W>
__device__ __forceinline__ void load_tile_w(T* dst, const T* src, int64_t row_stride,
                                            int row0, int n_valid) {
  using P = typename Piece<W>::type;
  constexpr int PER = W / static_cast<int>(sizeof(T));  // elements a piece
  constexpr int PIECES = HD / PER;                     // pieces a row
  auto piece = [&](T* d, const T* s, bool in) {
    if (!in)
      *reinterpret_cast<P*>(d) = P{};
    else if constexpr (W >= 4)
      cp_async<W>(d, s);
    else
      *reinterpret_cast<P*>(d) = *reinterpret_cast<const P*>(s);
  };
  if constexpr (NTHR % PIECES == 0) {
    constexpr int STEP = NTHR / PIECES;  // rows a pass
    const int r0 = static_cast<int>(threadIdx.x) / PIECES;
    const int c = (static_cast<int>(threadIdx.x) % PIECES) * PER;
    const T* s = src + static_cast<int64_t>(row0 + r0) * row_stride + c;
    T* d = dst + r0 * RS + c;
    const int64_t s_step = STEP * row_stride;
#pragma unroll 4
    for (int r = r0; r < ROWS; r += STEP, s += s_step, d += STEP * RS)
      piece(d, s, row0 + r < n_valid);
  } else {
    for (int idx = threadIdx.x; idx < ROWS * PIECES; idx += NTHR) {
      const int r = idx / PIECES, c = (idx % PIECES) * PER;
      piece(dst + r * RS + c, src + static_cast<int64_t>(row0 + r) * row_stride + c,
            row0 + r < n_valid);
    }
  }
}

template <typename T, int HD, int ROWS, int RS, int NTHR>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row_stride,
                                          int row0, int n_valid, int w) {
  if (w == 16) {
    load_tile_w<T, HD, ROWS, RS, NTHR, 16>(dst, src, row_stride, row0, n_valid);
  } else if (w == 8) {
    load_tile_w<T, HD, ROWS, RS, NTHR, 8>(dst, src, row_stride, row0, n_valid);
  } else if (sizeof(T) == 4 || w == 4) {
    load_tile_w<T, HD, ROWS, RS, NTHR, 4>(dst, src, row_stride, row0, n_valid);
  } else {
    if constexpr (sizeof(T) == 2)
      load_tile_w<T, HD, ROWS, RS, NTHR, 2>(dst, src, row_stride, row0, n_valid);
  }
}

// the max (or the sum) over one row's values of an accumulator tile, row
// r = 0 (elements 0, 1) or 1 (2, 3), as a tree: no long dependent chain
template <int NT, bool MAX>
__device__ __forceinline__ float row_reduce(const float (&s)[NT][4], int r) {
  float t[NT];
#pragma unroll
  for (int x = 0; x < NT; ++x)
    t[x] = MAX ? fmaxf(s[x][2 * r], s[x][2 * r + 1]) : s[x][2 * r] + s[x][2 * r + 1];
#pragma unroll
  for (int w = 1; w < NT; w *= 2)
#pragma unroll
    for (int x = 0; x + w < NT; x += 2 * w) t[x] = MAX ? fmaxf(t[x], t[x + w]) : t[x] + t[x + w];
  return t[0];
}

// One block per (head, q tile, batch row): BQ q rows of one head over
// every K/V tile it needs, the next tile's copy in flight under the
// current tile's products.
template <typename T, int HD>
__device__ __forceinline__ void flash_mma_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int H, int group, int64_t sqb, int64_t sqs,
    int64_t sqh, int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
    int64_t svh, int causal, int w, float scale_log2, unsigned char* smem) {
  using F = MmaTile<T, HD>;
  constexpr int MT = F::MT;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + F::BQ * F::RS;  // two stages
  T* Vs = Ks + 2 * F::STAGE;   // two stages

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;  // mma group and lane in the group
  const int h = blockIdx.x, b = blockIdx.z, hk = h / group;
  const int n_qt = static_cast<int>(gridDim.y);
  const int q0 = (causal ? n_qt - 1 - static_cast<int>(blockIdx.y)
                         : static_cast<int>(blockIdx.y)) * F::BQ;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;
  const int kv_end = causal ? min(Sk, q0 + F::BQ) : Sk;
  const int n_tiles = (kv_end + F::BK - 1) / F::BK;

  // tile t's K and V into stage t % 2, as one commit group
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int st = t % 2;
      load_tile<T, HD, F::BK, F::RS, F::THREADS>(Ks + st * F::STAGE, kb, sks, t * F::BK,
                                                 Sk, w);
      load_tile<T, HD, F::BK, F::RS, F::THREADS>(Vs + st * F::STAGE, vb, svs, t * F::BK,
                                                 Sk, w);
    }
    cp_async_commit();
  };
  load_tile<T, HD, F::BQ, F::RS, F::THREADS>(Qs, qb, sqs, q0, Sq, w);
  issue(0);  // with Q: one group

  // the warp's rows: m-tile mt is rows wrow + 16 mt .. + 15; this lane's
  // rows in it are + g (accumulator elements 0, 1) and + g + 8 (2, 3)
  const int wrow = 16 * MT * warp;
  const int warp_last = q0 + wrow + 16 * MT - 1;  // tiles past it are all masked here
  // ldmatrix row/column offsets of this lane (bf16; see the fragment
  // layouts of mma.m16n8k16: A row-major from Q and P, B from K rows and,
  // transposed, from V rows)
  const int a_row = (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const int k_row = (lane % 8) + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;

  float acc[MT][F::OT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < F::OT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;
  float m[MT][2], l[MT][2];  // running max (log2 domain, scaled); this lane's row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
  uint32_t qf[MT][F::QREG ? HD / 16 : 1][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * F::BK;
    cp_async_wait_all();
    __syncthreads();  // tile j has landed for all; every warp is done with j - 1
    issue(j + 1);     // into the stage tile j - 1 held
    if constexpr (F::QREG) {
      if (j == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kq = 0; kq < HD / 16; ++kq)
            ldmatrix_x4(qf[mt][kq], Qs + (wrow + 16 * mt + a_row) * F::RS + kq * 16 + a_col);
      }
    }
    if (causal && k0 > warp_last) continue;  // all masked for this warp
    const T* Kt = Ks + (j % 2) * F::STAGE;
    const T* Vt = Vs + (j % 2) * F::STAGE;

    // S = Q K^T for this warp's m-tiles x BK columns
    float s[MT][F::NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int x = 0; x < F::NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][x][e] = 0.f;
    if constexpr (F::F32) {
#pragma unroll
      for (int kq = 0; kq < HD / 8; ++kq) {
        // A: rows g, g + 8 x columns tg, tg + 4 of this 8-wide k step
        const T* qr = Qs + (wrow + g) * F::RS + kq * 8 + tg;
        uint32_t ah[4], al[4];
        split_tf32(qr[0], ah[0], al[0]);
        split_tf32(qr[8 * F::RS], ah[1], al[1]);
        split_tf32(qr[4], ah[2], al[2]);
        split_tf32(qr[8 * F::RS + 4], ah[3], al[3]);
#pragma unroll
        for (int x = 0; x < F::NT; ++x) {
          // B (k, n) = K[n][k]: k = tg and tg + 4, n = g
          const T* kr = Kt + (x * 8 + g) * F::RS + kq * 8 + tg;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kr[0], bh0, bl0);
          split_tf32(kr[4], bh1, bl1);
          mma_3xtf32(s[0][x], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    } else {
#pragma unroll
      for (int kq = 0; kq < HD / 16; ++kq) {
        uint32_t a[MT][4];
        if constexpr (!F::QREG) ldmatrix_x4(a[0], Qs + (wrow + a_row) * F::RS + kq * 16 + a_col);
#pragma unroll
        for (int jp = 0; jp < F::BK / 16; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, Kt + (jp * 16 + k_row) * F::RS + kq * 16 + k_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (F::QREG) {
              mma_bf16(s[mt][2 * jp], qf[mt][kq], bk[0], bk[1]);
              mma_bf16(s[mt][2 * jp + 1], qf[mt][kq], bk[2], bk[3]);
            } else {
              mma_bf16(s[mt][2 * jp], a[mt], bk[0], bk[1]);
              mma_bf16(s[mt][2 * jp + 1], a[mt], bk[2], bk[3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // the mask, only on tiles that cross this m-tile's diagonal or Sk
      const int row_g = q0 + wrow + 16 * mt + g;
      if (k0 + F::BK > Sk || (causal && k0 + F::BK - 1 > row_g - g)) {
#pragma unroll
        for (int x = 0; x < F::NT; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row_g + (e / 2) * 8;
            const int col = k0 + 8 * x + 2 * tg + (e % 2);
            if (col >= Sk || (causal && row < col)) s[mt][x][e] = -INFINITY;
          }
      }

      // online softmax in registers: p = 2^(s * scale * log2 e - m). The
      // reference max m of the warp's rows moves only when some row's max
      // passes it by more than 8 (p then stays below 2^8), so most tiles
      // skip rescaling O; the result is the same function. Key 0 is live
      // for every row and the first tile is never skipped, so m is finite
      // from there on.
      float mx[2];
      bool grow = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = row_reduce<F::NT, true>(s[mt], r);
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] *= scale_log2;
        grow = grow || mx[r] > m[mt][r] + 8.f;
      }
      if (__any_sync(0xffffffffu, grow)) {
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[mt][r], mx[r]);
          alpha[r] = ex2(m[mt][r] - (m_new == -INFINITY ? 0.f : m_new));
          m[mt][r] = m_new;
          l[mt][r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < F::OT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][i][e] *= alpha[e / 2];
      }
      float neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) neg_m[r] = m[mt][r] == -INFINITY ? 0.f : -m[mt][r];
#pragma unroll
      for (int x = 0; x < F::NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][x][e] = ex2(fmaf(s[mt][x][e], scale_log2, neg_m[e / 2]));
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mt][r] += row_reduce<F::NT, false>(s[mt], r);
    }

    // O += P V: P's accumulator tiles are the A fragments of the products
    if constexpr (F::F32) {
#pragma unroll
      for (int x = 0; x < F::NT; ++x) {
        // A (g, k = tg) is P at kv 2tg, A (g, k = tg + 4) P at kv 2tg + 1
        uint32_t ph[4], pl[4];
        split_tf32(s[0][x][0], ph[0], pl[0]);
        split_tf32(s[0][x][2], ph[1], pl[1]);
        split_tf32(s[0][x][1], ph[2], pl[2]);
        split_tf32(s[0][x][3], ph[3], pl[3]);
#pragma unroll
        for (int n = 0; n < F::OT; ++n) {
          // B (k, n = g) = V[kv][8n + g] at the same kv rows 2tg, 2tg + 1
          const T* vr = Vt + (x * 8 + 2 * tg) * F::RS + n * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[0], bh0, bl0);
          split_tf32(vr[F::RS], bh1, bl1);
          mma_3xtf32(acc[0][n], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < F::BK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vt + (kk * 16 + a_row) * F::RS + np * 16 + a_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bv[0], bv[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bv[2], bv[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + wrow + 16 * mt + g + 8 * r;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      T* orow = o + ((static_cast<int64_t>(b) * Sq + row) * H + h) * HD + 2 * tg;
#pragma unroll
      for (int i = 0; i < F::OT; ++i) {
        const float x0 = acc[mt][i][2 * r] * inv, x1 = acc[mt][i][2 * r + 1] * inv;
        if constexpr (F::F32)
          *reinterpret_cast<float2*>(orow + 8 * i) = make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(orow + 8 * i) = pack_bf16(x0, x1);
      }
    }
}

template <int HD>
__global__ void __launch_bounds__(MmaTile<__nv_bfloat16, HD>::THREADS,
                                  MmaTile<__nv_bfloat16, HD>::MIN_BLOCKS) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq, int Sk,
    int H, int group, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int causal, int w,
    float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  flash_mma_body<__nv_bfloat16, HD>(q, k, v, o, Sq, Sk, H, group, sqb, sqs, sqh, skb, sks,
                                    skh, svb, svs, svh, causal, w, scale_log2, smem_mma);
}

template <int HD>
__global__ void __launch_bounds__(MmaTile<float, HD>::THREADS,
                                  MmaTile<float, HD>::MIN_BLOCKS) flash_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int Sq, int Sk, int H, int group, int64_t sqb, int64_t sqs,
    int64_t sqh, int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
    int64_t svh, int causal, int w, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_fp32[];
  flash_mma_body<float, HD>(q, k, v, o, Sq, Sk, H, group, sqb, sqs, sqh, skb, sks, skh,
                            svb, svs, svh, causal, w, scale_log2, smem_fp32);
}

template <typename T, int HD>
const void* mma_kernel() {
  if constexpr (sizeof(T) == 4)
    return reinterpret_cast<const void*>(flash_fp32_kernel<HD>);
  else
    return reinterpret_cast<const void*>(flash_mma_kernel<HD>);
}

// the widest piece (16, 8, 4 or 2 bytes, at least one element) that
// divides every base address and every stride in bytes
int load_width(const void* q, const void* k, const void* v, const int64_t (&strides)[9],
               int elt) {
  uint64_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v);
  for (int64_t s : strides) bits |= static_cast<uint64_t>(s) * elt;
  int w = 16;
  while (w > elt && bits % w != 0) w /= 2;
  return w;
}

// flash_mma_kernel (bf16) or flash_fp32_kernel (float) at head dim HD
template <typename T, int HD>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int H, int Hkv, int64_t sqb, int64_t sqs,
                     int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
                     int64_t svb, int64_t svs, int64_t svh, int causal,
                     cudaStream_t stream) {
  using F = MmaTile<T, HD>;
  const void* kernel = mma_kernel<T, HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int64_t strides[9] = {sqb, sqs, sqh, skb, sks, skh, svb, svs, svh};
  int w = load_width(q, k, v, strides, static_cast<int>(sizeof(T)));
  const int n_qt = (Sq + F::BQ - 1) / F::BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);  // gridDim.y
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  int group = H / Hkv;
  float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  void* args[] = {&qt, &kt, &vt, &ot, &Sq, &Sk, &H, &group, &sqb, &sqs,
                  &sqh, &skb, &sks, &skh, &svb, &svs, &svh, &causal, &w, &scale_log2};
  const cudaError_t e = cudaLaunchKernel(kernel, dim3(H, n_qt, B), dim3(F::THREADS), args,
                                         F::BYTES, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 on wgmma, fed by TMA (hd 64 and 128) ----

// cuTensorMapEncodeTiled lives in libcuda: it is fetched at run time
// through the runtime's cudaGetDriverEntryPoint, so the build links no
// libcuda and _build.NVCC_FLAGS stay as they are.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a strided (batch, rows, heads, hd) operand, seen by TMA
// as 4-D (hd, heads, rows, batch), innermost first; strides in elements.
// `rows` is the extent TMA may read: boxes past it are zero-filled. A box
// is box_inner elements of one row of one head, box_rows rows deep.
// Returns a cudaError_t value.
int make_map(CUtensorMap* map, const void* base, int elt, int hd, int heads,
             int rows, int batch, int64_t s_head, int64_t s_row, int64_t s_batch,
             int box_inner, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head * elt),
                                 static_cast<cuuint64_t>(s_row * elt),
                                 static_cast<cuuint64_t>(s_batch * elt)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_inner), 1u,
                             static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult r = enc(
      map, elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
      const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets in 16-byte units, layout B128
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFFu) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers that an asynchronous wgmma reads or writes: the compiler
// may not move their uses across this point, nor reuse them before it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, smem desc) * B (128 x 16, smem desc);
// scale_d = 0 overwrites d. Both operands K-major, 128-byte swizzled.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem
// desc, N-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem
// desc, N-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, smem desc) * B (64 x 16, smem desc);
// scale_d = 0 overwrites d. Both operands K-major, 128-byte swizzled.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256, smem
// desc, N-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V at N = hd columns
template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};

template <int HD>
struct WgTile {
  static constexpr int BQ = 128;  // q rows a work item: 64 a consumer warpgroup
  static constexpr int BK = 128;  // kv rows a tile
  static constexpr int NBOX = HD / 64;  // 128-byte (64-column) boxes a row
  static constexpr int NST = HD > 64 ? 2 : 3;  // K/V ring stages
  static constexpr int BOX_Q = BQ * 128, BOX_K = BK * 128;  // bytes a box
  static constexpr int Q_BYTES = NBOX * BOX_Q;  // one of the two Q buffers
  static constexpr int KV_BYTES = NBOX * BOX_K;  // K or V, one stage
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + NST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + NST * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (4 + 2 * NST) * 8 + 1024;  // + alignment
  static constexpr int CONSUMERS = 256;  // two warpgroups
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static_assert(HD == 64 || HD == 128, "wgmma flash takes hd 64 and 128");
  static_assert(BYTES <= 232448, "shared memory");
};

// work item i of n_items -> (q tile, head, batch row): q tiles longest-first
// under the causal mask, and the heads fastest, so the g query heads of one
// kv head run side by side and share its K/V tiles in L2
struct WgItem {
  int q0, h, b, n_tiles;
};

template <int BQ, int BK>
__device__ __forceinline__ WgItem wg_item(int i, int n_qt, int H, int B, int Sk,
                                          int causal) {
  const int rank = i / (H * B), rem = i % (H * B);
  const int qt = causal ? n_qt - 1 - rank : rank;
  WgItem w;
  w.q0 = qt * BQ;
  w.h = rem % H;
  w.b = rem / H;
  const int kv_end = causal ? min(Sk, w.q0 + BQ) : Sk;
  w.n_tiles = (kv_end + BK - 1) / BK;
  return w;
}

// the it-th work item of this block: rounds of gridDim.x items, walked
// forward and back in turn, so the long and the short q tiles even out
__device__ __forceinline__ int wg_item_index(int it) {
  const int G = gridDim.x;
  return it * G + ((it & 1) ? G - 1 - static_cast<int>(blockIdx.x)
                            : static_cast<int>(blockIdx.x));
}

// named barriers (id 0 is __syncthreads): sync waits for `count` threads,
// arrive counts this thread and goes on
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Persistent: each block walks its work items (wg_item_index); the
// producer warp runs ahead into the next item's Q (two buffers) and K/V
// tiles (the ring) while the consumers finish the current one.
template <int HD>
__global__ void __launch_bounds__(WgTile<HD>::THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int B,
    int Sq, int Sk, int H, int group, int causal, float scale_log2) {
  using F = WgTile<HD>;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* base = align1024(smem_wg);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + F::BAR_OFF);  // [2]
  uint64_t* q_empty = q_full + 2;    // [2] both warpgroups are done with a Q
  uint64_t* full = q_empty + 2;      // a stage's K and V have landed
  uint64_t* empty = full + F::NST;   // both consumer warpgroups are done with it

  const int n_qt = (Sq + F::BQ - 1) / F::BQ;
  const int n_items = n_qt * H * B;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(q_full + x, 1);
      mbar_init(q_empty + x, F::CONSUMERS);
    }
    for (int s = 0; s < F::NST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, F::CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= F::CONSUMERS) {
    // producer: one thread keeps the Q buffers and the ring full
    if (tid == F::CONSUMERS) {
      int n = 0;  // K/V tiles issued so far, over all items
      for (int it = 0, i; (i = wg_item_index(it)) < n_items; ++it) {
        const WgItem w = wg_item<F::BQ, F::BK>(i, n_qt, H, B, Sk, causal);
        const int hk = w.h / group, qb = it % 2;
        if (it >= 2) mbar_wait(q_empty + qb, ((it / 2) + 1) & 1);
        mbar_expect_tx(q_full + qb, F::Q_BYTES);
        for (int x = 0; x < F::NBOX; ++x)
          tma_load_4d(base + qb * F::Q_BYTES + x * F::BOX_Q, &qmap, q_full + qb, 64 * x,
                      w.h, w.q0, w.b);
        for (int j = 0; j < w.n_tiles; ++j, ++n) {
          const int s = n % F::NST;
          if (n >= F::NST) mbar_wait(empty + s, ((n / F::NST) + 1) & 1);
          mbar_expect_tx(full + s, 2 * F::KV_BYTES);
          unsigned char* ks = base + F::K_OFF + s * F::KV_BYTES;
          unsigned char* vs = base + F::V_OFF + s * F::KV_BYTES;
          for (int x = 0; x < F::NBOX; ++x) {
            tma_load_4d(ks + x * F::BOX_K, &kmap, full + s, 64 * x, hk, j * F::BK, w.b);
            tma_load_4d(vs + x * F::BOX_K, &vmap, full + s, 64 * x, hk, j * F::BK, w.b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); this
  // thread's accumulator rows are row0 (elements 4t, 4t+1) and row0 + 8
  // (4t+2, 4t+3), columns 8t + 2 (lane % 4) + {0, 1} of n-tile t
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int col_l = 2 * (lane % 4);
  int n = 0;  // K/V tiles consumed so far, over all items
  // ping-pong: named barrier 1 + wg opens warpgroup wg's S GEMM; each
  // warpgroup opens the other's after issuing its own, so one warpgroup's
  // softmax runs under the other's products. Warpgroup 0 goes first.
  if (wg == 1) named_arrive(1, F::CONSUMERS);
  for (int it = 0, i; (i = wg_item_index(it)) < n_items; ++it) {
    const WgItem w = wg_item<F::BQ, F::BK>(i, n_qt, H, B, Sk, causal);
    const int qb = it % 2;
    const int row0 = w.q0 + 64 * wg + 16 * warp + lane / 4;
    const uint32_t q_smem = smem_addr(base + qb * F::Q_BYTES) + wg * 64 * 128;

    float acc[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) acc[x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain (scaled)
    float l[2] = {0.f, 0.f};              // this thread's part of the row sums

    mbar_wait(q_full + qb, (it / 2) & 1);
    for (int j = 0; j < w.n_tiles; ++j, ++n) {
      const int s = n % F::NST, k0 = j * F::BK;
      mbar_wait(full + s, (n / F::NST) & 1);
      const uint32_t k_smem = smem_addr(base + F::K_OFF + s * F::KV_BYTES);
      const uint32_t v_smem = smem_addr(base + F::V_OFF + s * F::KV_BYTES);

      // S = Q K^T: both K-major; a 16-wide k step is 32 bytes into a
      // 128-byte swizzled row, and every 4 steps the next 64-column box
      float sc[F::BK / 2];
      named_sync(1 + wg, F::CONSUMERS);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32u;
        wgmma_ss_n128(sc, desc_sw128(q_smem + (kk / 4) * F::BOX_Q + koff, 1, 64),
                      desc_sw128(k_smem + (kk / 4) * F::BOX_K + koff, 1, 64), kk > 0);
      }
      wgmma_commit();
      named_arrive(2 - wg, F::CONSUMERS);
      wgmma_wait<0>();
      fence_regs(sc);
      if (j == w.n_tiles - 1) mbar_arrive(q_empty + qb);  // Q is read for the last time

      // the mask, only on tiles that cross the diagonal or the end of k
      if (k0 + F::BK > Sk || (causal && k0 + F::BK - 1 > w.q0 + 64 * wg)) {
#pragma unroll
        for (int x = 0; x < F::BK / 2; ++x) {
          const int row = row0 + 8 * ((x / 2) % 2);
          const int col = k0 + 8 * (x / 4) + col_l + (x % 2);
          if (col >= Sk || (causal && row < col)) sc[x] = -INFINITY;
        }
      }

      // online softmax in registers: p = 2^(s * scale * log2 e - m); every
      // row has a live key in the first tile (key 0), so m is finite from
      // there on
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int x = 0; x < F::BK / 2; ++x) mx[(x / 2) % 2] = fmaxf(mx[(x / 2) % 2], sc[x]);
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_use);
        neg_m[r] = -m_use;
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < F::BK / 2; ++x) {
        const int r = (x / 2) % 2;
        sc[x] = exp2f(fmaf(sc[x], scale_log2, neg_m[r]));
        sum[r] += sc[x];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], sum[r]);
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) acc[x] *= alpha[(x / 2) % 2];

      // O += P V: P, rounded to bf16, is the register A operand; V is
      // N-major in shared memory (transpose bit), 16 kv rows = 2048 bytes
      // a step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                               pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                               pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                               pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
        Wgmma<HD>::rs(acc, a, desc_sw128(v_smem + kk * 16 * 128, F::BOX_K / 16, 64));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + s);
    }

    // epilogue, while the producer already fills the next item's buffers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          o + ((static_cast<int64_t>(w.b) * Sq + row) * H + w.h) * HD);
#pragma unroll
      for (int t = 0; t < HD / 8; ++t)
        orow[(8 * t + col_l) / 2] =
            pack_bf16(acc[4 * t + 2 * r] * inv, acc[4 * t + 2 * r + 1] * inv);
    }
  }
  if (wg == 0) named_sync(1, F::CONSUMERS);  // warpgroup 1's last opening
}

// ---- bf16 at hd 256 on wgmma: a producer warpgroup, setmaxnreg ----
//
// The O accumulator of a 64-row warpgroup at hd 256 is 128 registers a
// thread, and one 128-row Q tile is 64 KB of shared memory, so
// flash_wgmma_kernel's layout (a producer warp, two Q buffers, 128-row K/V
// tiles) does not fit either budget. Here a whole producer warpgroup gives
// its registers back (setmaxnreg.dec) and the two consumer warpgroups take
// them (setmaxnreg.inc: 232 a thread, where 384 threads would have 168), Q
// has one buffer, and K/V come in 64-row tiles through a ring of 2 stages
// (64 KB + 2 x 2 x 32 KB = 192 KB). K and V of a stage have barriers of
// their own, so S = Q K^T starts as soon as K has landed and the producer
// refills K while P V still reads V.

struct Wg256Tile {
  static constexpr int HD = 256;
  static constexpr int BQ = 128;  // q rows a work item: 64 a consumer warpgroup
  static constexpr int BK = 64;   // kv rows a tile
  static constexpr int NBOX = HD / 64;  // 128-byte (64-column) boxes a row
  static constexpr int NST = 2;         // K/V ring stages
  static constexpr int BOX_Q = BQ * 128, BOX_K = BK * 128;  // bytes a box
  static constexpr int Q_BYTES = NBOX * BOX_Q;   // the one Q buffer
  static constexpr int KV_BYTES = NBOX * BOX_K;  // K or V, one stage
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + NST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + NST * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 + 4 * NST) * 8 + 1024;  // + alignment
  static constexpr int CONSUMERS = 256;            // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // + one producer warpgroup
  // registers a thread after setmaxnreg; the two moves balance (128 x 128
  // given back, 256 x 64 taken), as a CTA can take only what its own warps
  // give back
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int LAUNCH_REGS = 168;  // 65536 / 384, rounded down to 8
  static_assert(128 * (LAUNCH_REGS - PRODUCER_REGS) ==
                    CONSUMERS * (CONSUMER_REGS - LAUNCH_REGS), "register moves");
  static_assert(BQ == 2 * BK, "the diagonal is one whole tile a warpgroup");
  static_assert(BYTES <= 232448, "shared memory");
};

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Work item i of the hd-256 kernel -> (q tile, head, batch row): the
// (batch row, kv head) pairs one after the other, and inside one the q
// tiles longest-first under the causal mask with the g query heads of the
// kv head fastest. The items a round of blocks takes at once then read the
// K and V of a few kv heads, which stay in the L2 while all their q tiles
// run (at gemma-7b's B = 4, S = 2048 the K and V of all 64 (b, kv head)
// pairs, 134 MB, would not fit its 50 MB); with the back-and-forth walk of
// wg_item_index the long and short q tiles of a pair land on the same
// blocks and even out.
template <int BQ, int BK>
__device__ __forceinline__ WgItem wg256_item(int i, int n_qt, int H, int Sk, int causal,
                                             int group) {
  const int Hkv = H / group, per = n_qt * group;  // items of one (b, kv head)
  const int kv = i / per, j = i % per, pos = j / group;
  WgItem w;
  w.q0 = (causal ? n_qt - 1 - pos : pos) * BQ;
  w.h = (kv % Hkv) * group + j % group;
  w.b = kv / Hkv;
  const int kv_end = causal ? min(Sk, w.q0 + BQ) : Sk;
  w.n_tiles = (kv_end + BK - 1) / BK;
  return w;
}

// Persistent, as flash_wgmma_kernel: each block walks its work items
// (wg_item_index, in wg256_item's order), and the two consumer warpgroups
// take turns at their S products (named barriers 1, 2). Under the causal
// mask warpgroup 0's rows end where the item's last tile begins, so that
// tile is all masked for it: warpgroup 0 keeps its turn there and frees the
// stage without computing.
__global__ void __launch_bounds__(Wg256Tile::THREADS, 1) flash_wgmma256_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int B,
    int Sq, int Sk, int H, int group, int causal, float scale_log2) {
  using F = Wg256Tile;
  extern __shared__ __align__(1024) unsigned char smem_wg256[];
  unsigned char* base = align1024(smem_wg256);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + F::BAR_OFF);
  uint64_t* q_empty = q_full + 1;      // both warpgroups are done with Q
  uint64_t* k_full = q_full + 2;       // [NST] a stage's K has landed
  uint64_t* v_full = k_full + F::NST;  // [NST] its V has landed
  uint64_t* k_empty = v_full + F::NST;  // [NST] both warpgroups are done with K
  uint64_t* v_empty = k_empty + F::NST;  // [NST] .. with V

  const int n_qt = (Sq + F::BQ - 1) / F::BQ;
  const int n_items = n_qt * H * B;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, F::CONSUMERS);
    for (int s = 0; s < F::NST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, F::CONSUMERS);
      mbar_init(v_empty + s, F::CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the role by warpgroup, through a shuffle so the compiler sees it as
  // warp-uniform: warpgroup 2 produces, 0 and 1 consume
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    setmaxnreg_dec<F::PRODUCER_REGS>();
    // producer: one thread keeps Q and the ring full
    if (tid == F::CONSUMERS) {
      int n = 0;  // K/V tiles issued so far, over all items
      for (int it = 0, i; (i = wg_item_index(it)) < n_items; ++it) {
        const WgItem w = wg256_item<F::BQ, F::BK>(i, n_qt, H, Sk, causal, group);
        const int hk = w.h / group;
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
        mbar_expect_tx(q_full, F::Q_BYTES);
        for (int x = 0; x < F::NBOX; ++x)
          tma_load_4d(base + x * F::BOX_Q, &qmap, q_full, 64 * x, w.h, w.q0, w.b);
        for (int j = 0; j < w.n_tiles; ++j, ++n) {
          const int s = n % F::NST;
          const uint32_t freed = ((n / F::NST) + 1) & 1;
          unsigned char* ks = base + F::K_OFF + s * F::KV_BYTES;
          unsigned char* vs = base + F::V_OFF + s * F::KV_BYTES;
          if (n >= F::NST) mbar_wait(k_empty + s, freed);
          mbar_expect_tx(k_full + s, F::KV_BYTES);
          for (int x = 0; x < F::NBOX; ++x)
            tma_load_4d(ks + x * F::BOX_K, &kmap, k_full + s, 64 * x, hk, j * F::BK, w.b);
          if (n >= F::NST) mbar_wait(v_empty + s, freed);
          mbar_expect_tx(v_full + s, F::KV_BYTES);
          for (int x = 0; x < F::NBOX; ++x)
            tma_load_4d(vs + x * F::BOX_K, &vmap, v_full + s, 64 * x, hk, j * F::BK, w.b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<F::CONSUMER_REGS>();

  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); this
  // thread's accumulator rows are row0 (elements 4t, 4t+1) and row0 + 8
  // (4t+2, 4t+3), columns 8t + 2 (lane % 4) + {0, 1} of n-tile t
  // wg is warp-uniform to the compiler, and so are the loop bounds that
  // depend on it: the wgmmas inside stay unserialized
  const int wg = role;
  const int col_l = 2 * (tid % 4);
  const uint32_t q_smem = smem_addr(base) + wg * 64 * 128;
  int n = 0;  // K/V tiles consumed so far, over all items
  if (wg == 1) named_arrive(1, F::CONSUMERS);  // warpgroup 0 goes first
  for (int it = 0, i; (i = wg_item_index(it)) < n_items; ++it) {
    const WgItem w = wg256_item<F::BQ, F::BK>(i, n_qt, H, Sk, causal, group);
    // this thread's first row, 64 wg + 16 warp + lane / 4 into the item,
    // from %tid.x read again for each item: kept across the item loop, it
    // is the one value the register allocator would spill
    uint32_t t;
    asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
    const int row0 = w.q0 + static_cast<int>((t >> 5) * 16 + ((t & 31) >> 2));
    const int own_end = causal ? min(Sk, w.q0 + 64 * wg + 64) : Sk;
    const int n_own = (own_end + F::BK - 1) / F::BK;  // tiles this warpgroup computes

    float acc[F::HD / 2];
#pragma unroll
    for (int x = 0; x < F::HD / 2; ++x) acc[x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain (scaled)
    float l[2] = {0.f, 0.f};              // this thread's part of the row sums

    mbar_wait(q_full, it & 1);
    for (int j = 0; j < n_own; ++j, ++n) {
      const int s = n % F::NST, k0 = j * F::BK;
      const uint32_t phase = (n / F::NST) & 1;
      const uint32_t k_smem = smem_addr(base + F::K_OFF + s * F::KV_BYTES);
      const uint32_t v_smem = smem_addr(base + F::V_OFF + s * F::KV_BYTES);
      mbar_wait(k_full + s, phase);

      // S = Q K^T: both K-major; a 16-wide k step is 32 bytes into a
      // 128-byte swizzled row, and every 4 steps the next 64-column box
      float sc[F::BK / 2];
      named_sync(1 + wg, F::CONSUMERS);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::HD / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32u;
        wgmma_ss_n64(sc, desc_sw128(q_smem + (kk / 4) * F::BOX_Q + koff, 1, 64),
                     desc_sw128(k_smem + (kk / 4) * F::BOX_K + koff, 1, 64), kk > 0);
      }
      wgmma_commit();
      named_arrive(2 - wg, F::CONSUMERS);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty + s);
      if (j == n_own - 1) mbar_arrive(q_empty);  // Q is read for the last time

      // the mask, only on the diagonal tile and at the end of k
      if (k0 + F::BK > Sk || (causal && k0 + F::BK - 1 > w.q0 + 64 * wg)) {
#pragma unroll
        for (int x = 0; x < F::BK / 2; ++x) {
          const int row = row0 + 8 * ((x / 2) % 2);
          const int col = k0 + 8 * (x / 4) + col_l + (x % 2);
          if (col >= Sk || (causal && row < col)) sc[x] = -INFINITY;
        }
      }

      // online softmax in registers, as flash_wgmma_kernel
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int x = 0; x < F::BK / 2; ++x) mx[(x / 2) % 2] = fmaxf(mx[(x / 2) % 2], sc[x]);
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_use);
        neg_m[r] = -m_use;
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < F::BK / 2; ++x) {
        const int r = (x / 2) % 2;
        sc[x] = exp2f(fmaf(sc[x], scale_log2, neg_m[r]));
        sum[r] += sc[x];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], sum[r]);
#pragma unroll
      for (int x = 0; x < F::HD / 2; ++x) acc[x] *= alpha[(x / 2) % 2];

      // O += P V as m64n256k16: P, rounded to bf16, is the register A
      // operand, packed before the fence (a register written after it
      // makes the compiler fence again before its wgmma); V is N-major in
      // shared memory (transpose bit), its four boxes BOX_K bytes apart,
      // 16 kv rows = 2048 bytes a step
      uint32_t pa[F::BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < F::BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      mbar_wait(v_full + s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::BK / 16; ++kk)
        wgmma_rs_n256(acc, pa[kk], desc_sw128(v_smem + kk * 16 * 128, F::BOX_K / 16, 64));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(v_empty + s);
    }
    // the item's tiles past this warpgroup's diagonal (warpgroup 0 under
    // the causal mask): keep the turn and free the stage, without waiting
    // for its loads. This is safe because of the turns: once warpgroup 0
    // has its turn at tile n, warpgroup 1 has issued its S of tile n - 1,
    // so it is done with tile n - NST and these arrivals count toward tile
    // n's phase of the empty barriers; and before warpgroup 0 waits on this
    // stage again (tile n + NST, in the next item), warpgroup 1 has waited
    // for tile n's K (its last S of the item comes before the next Q) and,
    // before the turn that lets warpgroup 0 read that V, for tile n's V, so
    // no phase of the full barriers is skipped unseen.
    for (int j = n_own; j < w.n_tiles; ++j, ++n) {
      const int s = n % F::NST;
      named_sync(1 + wg, F::CONSUMERS);
      named_arrive(2 - wg, F::CONSUMERS);
      mbar_arrive(k_empty + s);
      mbar_arrive(v_empty + s);
    }

    // epilogue, while the producer already fills the next item's buffers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          o + ((static_cast<int64_t>(w.b) * Sq + row) * H + w.h) * F::HD);
#pragma unroll
      for (int t = 0; t < F::HD / 8; ++t)
        orow[(8 * t + col_l) / 2] =
            pack_bf16(acc[4 * t + 2 * r] * inv, acc[4 * t + 2 * r + 1] * inv);
    }
  }
  if (wg == 0) named_sync(1, F::CONSUMERS);  // warpgroup 1's last opening
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <int HD>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                       int Sq, int Sk, int H, int Hkv, int64_t sqb, int64_t sqs,
                       int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
                       int64_t svb, int64_t svs, int64_t svh, int causal,
                       cudaStream_t stream) {
  using F = WgTile<HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, 2, HD, H, Sq, B, sqh, sqs, sqb, 64, F::BQ,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&km, k, 2, HD, Hkv, Sk, B, skh, sks, skb, 64, F::BK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&vm, v, 2, HD, Hkv, Sk, B, svh, svs, svb, 64, F::BK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const int64_t n_items = static_cast<int64_t>((Sq + F::BQ - 1) / F::BQ) * H * B;
  const int sms = sm_count();
  if (sms <= 0 || n_items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);  // one block an SM
  flash_wgmma_kernel<HD><<<grid, F::THREADS, F::BYTES, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), B, Sq, Sk, H, H / Hkv, causal,
      1.4426950408889634f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

int launch_flash_wgmma256(const void* q, const void* k, const void* v, void* o, int B,
                          int Sq, int Sk, int H, int Hkv, int64_t sqb, int64_t sqs,
                          int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
                          int64_t svb, int64_t svs, int64_t svh, int causal,
                          cudaStream_t stream) {
  using F = Wg256Tile;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, 2, F::HD, H, Sq, B, sqh, sqs, sqb, 64, F::BQ,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&km, k, 2, F::HD, Hkv, Sk, B, skh, sks, skb, 64, F::BK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&vm, v, 2, F::HD, Hkv, Sk, B, svh, svs, svb, 64, F::BK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const int64_t n_items = static_cast<int64_t>((Sq + F::BQ - 1) / F::BQ) * H * B;
  const int sms = sm_count();
  if (sms <= 0 || n_items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);  // one block an SM
  flash_wgmma256_kernel<<<grid, F::THREADS, F::BYTES, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), B, Sq, Sk, H, H / Hkv, causal,
      1.4426950408889634f / sqrtf(static_cast<float>(F::HD)));
  return static_cast<int>(cudaGetLastError());
}

// The dispatch rule between the hand-written variants (kernels/
// flash_attention.py::flash_variant is the same rule in Python, tested on
// the CPU): f32 -> flash_fp32_kernel (3xTF32); bf16 with 16-byte
// aligned bases and strides (TMA's requirement) at hd 64 or 128 ->
// flash_wgmma_kernel, at hd 256 -> flash_wgmma256_kernel; any other bf16
// (hd 16, 32; strides TMA cannot take) -> flash_mma_kernel.
enum FlashVariant { kFlashFp32 = 0, kFlashMma = 1, kFlashWgmma = 2, kFlashWgmma256 = 3 };

int flash_variant(int dtype, int hd, const void* q, const void* k, const void* v,
                  const int64_t (&strides)[9]) {
  if (dtype == 0) return kFlashFp32;
  bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  for (int64_t s : strides) aligned = aligned && s > 0 && s % 8 == 0;
  if (!aligned) return kFlashMma;
  return hd == 64 || hd == 128 ? kFlashWgmma : hd == 256 ? kFlashWgmma256 : kFlashMma;
}

int dispatch_flash(int variant, int hd, const void* q, const void* k, const void* v,
                   void* o, int B, int Sq, int Sk, int H, int Hkv, int64_t sqb,
                   int64_t sqs, int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
                   int64_t svb, int64_t svs, int64_t svh, int causal,
                   cudaStream_t stream) {
#define REPRO_FLASH_ARGS \
  q, k, v, o, B, Sq, Sk, H, Hkv, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, causal, stream
#define REPRO_FLASH(HD_)                                       \
  case HD_:                                                    \
    return variant == kFlashFp32                                 \
               ? launch_flash_mma<float, HD_>(REPRO_FLASH_ARGS)  \
               : launch_flash_mma<__nv_bfloat16, HD_>(REPRO_FLASH_ARGS);
  if (variant == kFlashWgmma) {
    if (hd == 64) return launch_flash_wgmma<64>(REPRO_FLASH_ARGS);
    if (hd == 128) return launch_flash_wgmma<128>(REPRO_FLASH_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == kFlashWgmma256)
    return hd == 256 ? launch_flash_wgmma256(REPRO_FLASH_ARGS)
                     : static_cast<int>(cudaErrorInvalidValue);
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
#undef REPRO_FLASH_ARGS
}

// ---------------------------------------------------------------------------
// decode_attention (one token over the cache)
// ---------------------------------------------------------------------------

constexpr int kDecTile = 32;     // cache positions a tile: one a lane
constexpr int kDecMaxSplit = 8;  // splits of one (b, kv head): a portable cluster

template <typename T, int HD, int GMAX>
struct DecTile {
  static constexpr int TS = kDecTile;
  static constexpr int ELT = sizeof(T);
  static constexpr int ROW = HD * ELT;                 // bytes of a cache row
  static constexpr int SPAN = ROW < 128 ? ROW : 128;   // swizzle span = box width
  static constexpr int SWMASK = SPAN / 16 - 1;         // 16-byte chunks a span, - 1
  static constexpr int BOX_BYTES = TS * SPAN;
  static constexpr int TILE_BYTES = TS * ROW;          // K or V of one tile
  static constexpr int STAGE = 2 * TILE_BYTES;         // a warp's K and V
  static constexpr int W = 4 * STAGE <= 196608 ? 4 : 196608 / STAGE;  // warps a block
  static constexpr int THREADS = 32 * W;
  static constexpr int V4 = 16 / ELT;                  // elements a 16-byte chunk
  static constexpr int CPL = HD >= 32 ? HD / 32 : 1;   // P V columns a lane
  static constexpr int LG = HD >= 32 ? 1 : 32 / HD;    // lane groups (hd < 32)
  static constexpr int PPL = TS / LG;                  // positions a lane group
  static constexpr int VEC = CPL < V4 ? CPL : V4;      // elements a V load
  static constexpr int Q_OFF = W * STAGE;              // f32 (GMAX, HD), pre-scaled
  static constexpr int P_OFF = Q_OFF + GMAX * HD * 4;  // f32 (W, GMAX, TS)
  static constexpr int BAR_OFF = P_OFF + W * GMAX * TS * 4;
  static constexpr int BYTES = BAR_OFF + W * 8 + 1024;  // + alignment
  // a warp's partial (m, l: GMAX each; acc: GMAX x HD, f32) over its stage
  static constexpr int PART_FLOATS = GMAX * (HD + 2);
  static_assert(ROW % SPAN == 0 && SPAN >= 32, "cache row width");
  static_assert(PART_FLOATS * 4 <= STAGE, "partial over the stage");
  static_assert(PPL % 4 == 0 && (CPL * ELT) % (VEC * ELT) == 0, "P V steps");
  static_assert(BYTES <= 232448, "shared memory");
};

// byte offset in a staged tile of 16-byte chunk c of position p: the tile
// is ROW / SPAN boxes of TS rows x SPAN bytes, swizzled as TMA wrote it
// (bits 4.. of the offset XOR bits 7.., over the span's chunk count), so a
// warp reading one chunk of 32 positions hits every bank group
template <typename F>
__device__ __forceinline__ int dec_chunk(int p, int c) {
  const int o = (c * 16 / F::SPAN) * F::BOX_BYTES + p * F::SPAN + (c * 16) % F::SPAN;
  return o ^ (((o >> 7) & F::SWMASK) << 4);
}

// N consecutive elements (N * sizeof(T) in 2..16 bytes, aligned) as floats
template <typename T, int N>
__device__ __forceinline__ void load_f(const unsigned char* p, float (&x)[N]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = reinterpret_cast<const float*>(p)[i];
  } else if constexpr (N == 1) {
    x[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// lane 0 of a warp: K and V of tile `tile` (positions s0 + TS tile ..) into
// the warp's stage, both completing on the warp's barrier
template <typename F>
__device__ __forceinline__ void dec_issue(unsigned char* stage, uint64_t* bar,
                                          const CUtensorMap* kmap, const CUtensorMap* vmap,
                                          int tile, int s0, int hk, int b) {
  const int pos = s0 + tile * F::TS;
  mbar_expect_tx(bar, F::STAGE);
  for (int x = 0; x < F::ROW / F::SPAN; ++x) {
    const int c0 = x * (F::SPAN / F::ELT);
    tma_load_4d(stage + x * F::BOX_BYTES, kmap, bar, c0, hk, pos, b);
    tma_load_4d(stage + F::TILE_BYTES + x * F::BOX_BYTES, vmap, bar, c0, hk, pos, b);
  }
}

// One block per (split, kv head, batch row) takes the g query heads of the
// kv head over cache positions [s0, s1), in tiles of TS positions. Each
// warp takes tiles warp, warp + W, .. on its own: it streams a tile's K
// and V into its stage by TMA, scores its TS positions (a lane each) for
// all g heads, keeps the online softmax of each head in registers (one max
// and one sum per head and tile), and adds P V into columns of its own;
// no block-wide barrier until the end. The n_split blocks of one
// (b, kv head) form a thread-block cluster: every warp leaves its (m, l,
// acc) partial in its block's shared memory, and the cluster merges them
// over distributed shared memory in (split, warp) order.
template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(DecTile<T, HD, GMAX>::THREADS) decode_split_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const T* __restrict__ q, void* __restrict__ out, float* __restrict__ lse, int H, int g,
    int n_valid, int chunk, int64_t sqb, int64_t sqh, float scale_log2) {
  using F = DecTile<T, HD, GMAX>;
  extern __shared__ __align__(1024) unsigned char smem_dec[];
  unsigned char* base = align1024(smem_dec);
  float* q_s = reinterpret_cast<float*>(base + F::Q_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + F::BAR_OFF);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;  // = the cluster
  const int s0 = split * chunk, s1 = min(s0 + chunk, n_valid);
  const int n_tiles = (s1 - s0 + F::TS - 1) / F::TS;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  unsigned char* stage = base + warp * F::STAGE;
  uint64_t* bar = bars + warp;
  float* p_s = reinterpret_cast<float*>(base + F::P_OFF) + warp * GMAX * F::TS;

  if (t == 0) {  // every warp's first tile in flight before anything else
    for (int w = 0; w < F::W; ++w) mbar_init(bars + w, 1);
    fence_barrier_init();
    for (int w = 0; w < F::W && w < n_tiles; ++w)
      dec_issue<F>(base + w * F::STAGE, bars + w, &kmap, &vmap, w, s0, hk, b);
  }
  for (int i = t; i < GMAX * HD; i += F::THREADS) {
    const int gi = i / HD, d = i % HD;
    q_s[i] = gi < g ? to_f(q[b * sqb + (hk * g + gi) * sqh + d]) * scale_log2 : 0.f;
  }
  __syncthreads();

  // P V: lane (col0 .. col0 + CPL) x positions [pp0, pp0 + PPL)
  const int col0 = (lane % (32 / F::LG)) * F::CPL;
  const int pp0 = (lane / (32 / F::LG)) * F::PPL;
  float acc[GMAX][F::CPL];
  float m[GMAX], l[GMAX];  // the same in every lane
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < F::CPL; ++c) acc[gi][c] = 0.f;
  }

  for (int tile = warp, use = 0; tile < n_tiles; tile += F::W, ++use) {
    mbar_wait(bar, use & 1);
    const unsigned char* ks = stage;
    const unsigned char* vs = stage + F::TILE_BYTES;

    // scores at position `lane`, all heads (two partial sums each)
    float dot[GMAX][2];
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) dot[gi][0] = dot[gi][1] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / F::V4; ++c) {
      float kv[F::V4];
      load_f<T, F::V4>(ks + dec_chunk<F>(lane, c), kv);
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + gi * HD + c * F::V4);
#pragma unroll
        for (int e4 = 0; e4 < F::V4 / 4; ++e4) {
          const float4 w = qv[e4];
          float& d = dot[gi][(c * (F::V4 / 4) + e4) & 1];
          d = fmaf(kv[4 * e4], w.x, d);
          d = fmaf(kv[4 * e4 + 1], w.y, d);
          d = fmaf(kv[4 * e4 + 2], w.z, d);
          d = fmaf(kv[4 * e4 + 3], w.w, d);
        }
      }
    }
    // online softmax per head over the tile; a tile holds a live position
    // (its first), so each max is finite
    const bool live = s0 + tile * F::TS + lane < s1;
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi < g) {
        const float sv = live ? dot[gi][0] + dot[gi][1] : -INFINITY;
        float mx = sv;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[gi], mx);
        const float pv = exp2f(sv - m_new);
        float sum = pv;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float alpha = exp2f(m[gi] - m_new);
        l[gi] = fmaf(l[gi], alpha, sum);
        m[gi] = m_new;
        p_s[gi * F::TS + lane] = pv;
#pragma unroll
        for (int c = 0; c < F::CPL; ++c) acc[gi][c] *= alpha;
      }
    }
    __syncwarp();

    // acc += P V over this lane group's positions, four a step
#pragma unroll
    for (int pp = pp0; pp < pp0 + F::PPL; pp += 4) {
      float vv[4][F::CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < F::CPL; c += F::VEC) {
          const int e = col0 + c;
          float x[F::VEC];
          load_f<T, F::VEC>(vs + dec_chunk<F>(pp + u, e / F::V4) + (e % F::V4) * F::ELT, x);
#pragma unroll
          for (int i = 0; i < F::VEC; ++i) vv[u][c + i] = x[i];
        }
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        if (gi < g) {
          const float4 w = *reinterpret_cast<const float4*>(p_s + gi * F::TS + pp);
#pragma unroll
          for (int c = 0; c < F::CPL; ++c) {
            float a = acc[gi][c];
            a = fmaf(w.x, vv[0][c], a);
            a = fmaf(w.y, vv[1][c], a);
            a = fmaf(w.z, vv[2][c], a);
            a = fmaf(w.w, vv[3][c], a);
            acc[gi][c] = a;
          }
        }
      }
    }
    __syncwarp();  // the stage and P are consumed
    if (lane == 0 && tile + F::W < n_tiles)
      dec_issue<F>(stage, bar, &kmap, &vmap, tile + F::W, s0, hk, b);
  }

  // lane groups (hd < 32) sum their positions' parts, in a fixed order
#pragma unroll
  for (int off = 32 / F::LG; off < 32; off <<= 1)
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) acc[gi][0] += __shfl_xor_sync(0xffffffffu, acc[gi][0], off);

  // the warp's partial over its stage (its last TMA has landed and is read)
  float* part = reinterpret_cast<float*>(stage);  // m (GMAX), l (GMAX), acc (GMAX, HD)
  if (lane < GMAX) {
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi)
      if (gi == lane) {
        part[gi] = m[gi];
        part[GMAX + gi] = l[gi];
      }
  }
  if (lane < 32 / F::LG) {
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi)
#pragma unroll
      for (int c = 0; c < F::CPL; ++c) part[2 * GMAX + gi * HD + col0 + c] = acc[gi][c];
  }

  // the cluster merges: block r takes outputs r * THREADS + t, + n_split *
  // THREADS, ..; each reads every warp's partial in (split, warp) order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int64_t bh0 = static_cast<int64_t>(b) * H + hk * g;  // (b, first head)
  for (int i = split * F::THREADS + t; i < g * HD; i += n_split * F::THREADS) {
    const int gi = i / HD;
    float mx = -INFINITY, den = 0.f, num = 0.f;  // one pass, rescaled as it goes
    for (int p = 0; p < n_split; ++p) {
      const float* peer = cluster.map_shared_rank(reinterpret_cast<float*>(base), p);
#pragma unroll
      for (int w = 0; w < F::W; ++w) {
        const float* pw = peer + w * (F::STAGE / 4);
        const float mp = pw[gi];
        if (mp == -INFINITY) continue;  // a warp without a tile
        const float m_new = fmaxf(mx, mp);
        const float a_old = exp2f(mx - m_new), a_p = exp2f(mp - m_new);
        den = fmaf(den, a_old, a_p * pw[GMAX + gi]);
        num = fmaf(num, a_old, a_p * pw[2 * GMAX + i]);
        mx = m_new;
      }
    }
    const float val = num / fmaxf(den, 1e-30f);
    if (lse == nullptr) {
      static_cast<T*>(out)[bh0 * HD + i] = from_f<T>(val);
    } else {  // a partial for the seqshard combine: f32, and the head's
      // log-sum-exp of its scaled scores in natural log (mx and den are
      // in base 2: the scores carry scale * log2(e))
      static_cast<float*>(out)[bh0 * HD + i] = val;
      if (i % HD == 0) lse[bh0 + gi] = (mx + log2f(den)) * 0.6931471805599453f;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T, int HD, int GMAX>
int launch_decode(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  int H, int Hkv, int n_valid, int n_split, int chunk, int64_t sqb, int64_t sqh,
                  int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
                  int64_t svh, cudaStream_t stream) {
  using F = DecTile<T, HD, GMAX>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, HD, GMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           F::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const CUtensorMapSwizzle sw = F::SPAN == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : F::SPAN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  // the maps end at n_valid: TMA zero-fills past it and never reads there
  CUtensorMap km, vm;
  int err = make_map(&km, k, F::ELT, HD, Hkv, n_valid, B, skh, sks, skb, F::SPAN / F::ELT,
                     F::TS, sw);
  if (err == 0)
    err = make_map(&vm, v, F::ELT, HD, Hkv, n_valid, B, svh, svs, svb, F::SPAN / F::ELT,
                   F::TS, sw);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv, B);
  cfg.blockDim = dim3(F::THREADS);
  cfg.dynamicSmemBytes = F::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;  // the splits of one (b, kv head)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_split_kernel<T, HD, GMAX>, km, vm, static_cast<const T*>(q),
      o, lse, H, H / Hkv, n_valid, chunk, sqb, sqh,
      1.4426950408889634f / sqrtf(static_cast<float>(HD)));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_decode_g(int g, const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int Hkv, int n_valid,
                      int n_split, int chunk, int64_t sqb, int64_t sqh, int64_t skb,
                      int64_t sks, int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                      cudaStream_t stream) {
#define REPRO_DECODE(G_)                                                                 \
  if (g <= G_)                                                                           \
    return launch_decode<T, HD, G_>(q, k, v, o, lse, B, H, Hkv, n_valid, n_split, \
                                    chunk, sqb, sqh, skb, sks, skh, svb, svs, svh, stream);
  REPRO_DECODE(1)
  REPRO_DECODE(2)
  REPRO_DECODE(4)
  REPRO_DECODE(8)
  REPRO_DECODE(16)
#undef REPRO_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_decode(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                    int H, int Hkv, int hd, int n_valid,
                    int n_split, int chunk, int64_t sqb, int64_t sqh, int64_t skb,
                    int64_t sks, int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                    cudaStream_t stream) {
  const int g = H / Hkv;
#define REPRO_DECODE_HD(HD_)                                                            \
  case HD_:                                                                             \
    return dispatch_decode_g<T, HD_>(g, q, k, v, o, lse, B, H, Hkv, n_valid,           \
                                     n_split, chunk, sqb, sqh, skb, sks, skh, svb, svs, \
                                     svh, stream);
  switch (hd) {
    REPRO_DECODE_HD(16)
    REPRO_DECODE_HD(32)
    REPRO_DECODE_HD(64)
    REPRO_DECODE_HD(128)
    REPRO_DECODE_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_HD
}

bool supported_hd(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of every tensor is contiguous and o is a contiguous
// (B, Sq, H, hd) tensor. *variant receives the kernel that was launched
// (0 flash_fp32_kernel, 1 flash_mma_kernel, 2 flash_wgmma_kernel, 3
// flash_wgmma256_kernel). Returns a cudaError_t value (0 = launched).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Sk, int H, int Hkv, int hd, int64_t sqb, int64_t sqs,
    int64_t sqh, int64_t skb, int64_t sks, int64_t skh, int64_t svb,
    int64_t svs, int64_t svh, int causal, int* variant, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0 || !supported_hd(hd) ||
      (dtype != 0 && dtype != 1) || variant == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t strides[9] = {sqb, sqs, sqh, skb, sks, skh, svb, svs, svh};
  *variant = flash_variant(dtype, hd, q, k, v, strides);
  return dispatch_flash(*variant, hd, q, k, v, o, B, Sq, Sk, H, Hkv, sqb, sqs, sqh, skb,
                        sks, skh, svb, svs, svh, causal, stream);
}

// Positions [0, n_valid) of the cache are read, in n_split chunks of
// `chunk` positions (n_split * chunk >= n_valid > (n_split - 1) * chunk,
// n_split at most 8: the chunks of one (b, kv head) are one cluster);
// nothing at or past n_valid is read. k and v need 16-byte aligned bases
// and strides (TMA). o is a contiguous (B, H, hd) tensor of q's type;
// when lse is not null, o is float32 and lse a contiguous float32 (B, H)
// tensor that receives each head's log-sum-exp of its scaled scores
// (natural log). One launch.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B, int H,
    int Hkv, int hd, int n_valid, int n_split, int chunk, int64_t sqb, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs, int64_t svh,
    cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 16 || !supported_hd(hd) ||
      n_valid <= 0 || n_split <= 0 || n_split > kDecMaxSplit || chunk <= 0 ||
      static_cast<int64_t>(n_split) * chunk < n_valid ||
      static_cast<int64_t>(n_split - 1) * chunk >= n_valid || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_decode<float>(q, k, v, o, lse, B, H, Hkv, hd, n_valid, n_split, chunk, sqb,
                                  sqh, skb, sks, skh, svb, svs, svh, stream);
  return dispatch_decode<__nv_bfloat16>(q, k, v, o, lse, B, H, Hkv, hd, n_valid, n_split, chunk,
                                        sqb, sqh, skb, sks, skh, svb, svs, svh, stream);
}
