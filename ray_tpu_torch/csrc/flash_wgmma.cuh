// Tensor-core flash attention for Hopper (sm_90a): K1 (forward), K2 (dQ)
// and K3 (dK/dV) in bf16 and fp16 at every head dim, compiled at D = 64,
// 128, 192 and 256. Included by the flash_attention.tc_*.cu parts,
// which instantiate it one (type, D) each; flash_attention.cu's header
// states the contract, this file holds the design.
//
// One warpgroup (128 threads) per 64-row output tile, two for K3 at D 192
// and 256 (below). Every product is a `wgmma.mma_async` m64n64k16 with
// bf16 or fp16 operands (the instruction's .bf16 or .f16 form, the only
// difference between the two types besides the packing of P and dS) and
// fp32 accumulators; a head dim of D is D / 64 column blocks, each its own
// n64 product. Tiles stay in the input type in shared memory in the
// 128-byte-swizzled layout that wgmma descriptors read: a [64][D] tile is
// D/64 column blocks of [64 rows][128 B], the 16-byte chunk c of row r
// stored at chunk c ^ (r % 8). The same bytes serve as a K-major operand
// (D is the reduction) and as an MN-major one (rows are the reduction, D
// the output columns), so a tile that feeds both kinds of product (Q and
// dO in K3, K in K2) is loaded once. Loads are cp.async into a ring of two
// stages: the next tile streams in while the current one is multiplied.
// Ragged edges are zero-filled by the copy (src-size 0) and masked per
// element in the accumulator's coordinates.
//
// How an instance takes the head dim d (Mode):
//   * kFull, d = D: the row stride is the constant D (the main path);
//   * kPadded, d < D (d 80 on D 128, d 160 on D 192, d 16 on D 64): the
//     16-byte chunks at columns d..D are zero-filled in shared memory
//     (cp.async with src-size 0), never in global memory, so every tile is
//     whole 64-column swizzle atoms as the descriptors assume, and stores
//     skip columns d..D. Where d is not a multiple of 8, rows do not start
//     on a 16-byte boundary; the loads then go element by element through
//     registers into the same swizzled chunks (a generic-proxy store, made
//     visible to wgmma by the same proxy fence as the cp.async data);
//   * kChunked, d > 256: the head dim is cut into n chunks of w columns (w
//     a multiple of 8 in (128, 256], padded to D 192 or 256 as above, the
//     last chunk the rest). The products that contract over d (Q K^T,
//     dO V^T and their transposes) loop over the chunks into one
//     accumulator, each chunk's tiles loaded into shared memory in turn.
//     The products whose columns are d (P V, dS K, P^T dO, dS^T Q) give one
//     chunk of output columns per block: the chunk index is the innermost
//     part of blockIdx.x, and each block recomputes the scores. In K2 and
//     K3 the block's own chunk comes last, so its K (or Q and dO) tiles are
//     still in shared memory for the output product; lse is written by the
//     blocks of chunk 0. This mode loads synchronously (no ring): no model
//     of this family has such a head yet, and a block's four [64][256]
//     tiles would need a second stage of 128 KB.
//
// Registers. A [64][D] fp32 accumulator takes D / 2 registers a thread of
// one warpgroup: 128 at D 256. K1 and K2 hold one (and K2 two 32-register
// score tiles beside it). K3 holds two, dK and dV, which at D 192 and 256
// do not fit one warpgroup's 255 registers a thread; there
// (flash_bwd_dkv_tc2_kernel) warpgroup 0 computes S^T, P^T and dV and
// warpgroup 1 computes dP^T, dS^T and dK, P^T passing from one to the
// other through 16 KB of shared memory as fp32 (dS^T = P^T (dP^T - delta)
// takes the unrounded p, as the plain version does).
//
// wgmma m64nNk16 fp32 accumulator layout (PTX ISA, "wgmma register
// fragments"): thread t = 32 w + lane of the warpgroup holds, in register
// 4 j + 2 h + e, row 16 w + lane / 4 + 8 h and column 8 j + 2 (lane % 4) + e.
// For 16 consecutive columns 16 kk.. that is registers 8 kk .. 8 kk + 7,
// which packed pairwise into bf16x2 (or f16x2) are exactly the A fragment
// of a k16 step: a product's accumulator feeds the next product from
// registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "flash_common.cuh"

namespace rtt {
namespace tc {

constexpr int kRows = 64;          // tile rows: one warpgroup's M
constexpr int kFwdKeyTile = 64;    // keys per step of the forward (K1)
constexpr int kThreads = 128;      // one warpgroup
constexpr int kBlockBytes = kRows * 128;  // one [64][64] 16-bit column block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D> constexpr int kTileBytes = kRows * D * 2;  // [64][D]

enum Mode : int { kFull = 0, kPadded = 1, kChunked = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `cb` (columns 8 cb .. 8 cb + 7) of row r.
__device__ __forceinline__ uint32_t chunk_offset(int r, int cb) {
  return (cb >> 3) * kBlockBytes + r * 128 + (((cb & 7) ^ (r & 7)) << 4);
}

// Rows [row0, row0 + 64), columns [c0, c0 + n) of a [seq, ld] matrix of
// 16-bit values into the swizzled [64][D] tile at shared address `dst`
// (n <= D): rows past `seq` and columns past n become zeros. Asynchronous
// (cp.async) when ld and c0 are multiples of 8 (n then is one too); else
// synchronous, element by element. NT threads share the tile.
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const uint16_t* src,
                                          int row0, int seq, int ld, int c0,
                                          int n, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % NT == 0, "whole chunks per thread");
  const bool vec = ((ld | c0) & 7) == 0;
#pragma unroll
  for (int it = 0; it < kRows * kChunks / NT; ++it) {
    const int i = tid + it * NT, r = i / kChunks, cb = i % kChunks;
    const int g = row0 + r, col = 8 * cb;
    const uint32_t at = dst + chunk_offset(r, cb);
    if (vec) {
      const bool in = g < seq && col < n;
      const uint16_t* p = src + (in ? (size_t)g * ld + c0 + col : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       at),
                   "l"(p), "r"(in ? 16 : 0)
                   : "memory");
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = col + 2 * e;
        const size_t at_g = (size_t)g * ld + c0 + cc;
        const uint32_t lo = g < seq && cc < n ? src[at_g] : 0u;
        const uint32_t hi = g < seq && cc + 1 < n ? src[at_g + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// 64 fp32 of a row vector from `row0` (zeros past `seq`): threads 0-63.
__device__ __forceinline__ void load_row(uint32_t dst, const float* src,
                                         int row0, int seq, int i) {
  const int g = row0 + i;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst + 4 * i),
               "l"(src + (g < seq ? g : 0)), "r"(g < seq ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's completed cp.async writes visible to wgmma (the async
// proxy); a __syncthreads() after it publishes them to the warpgroup.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address
// `addr` (its 1024-byte atom aligned): 8-row groups 1024 B apart. Both
// byte offsets are 1024 B: for a K-major operand only the stride offset
// is read; an MN-major one of 64 columns spans a single swizzle atom along
// MN, so only the 8-row stride along K matters, whichever field holds it.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence, commit and wait above.
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void pin(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <typename T> constexpr bool kHalf = std::is_same<T, __half>::value;

#define RTT_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define RTT_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define RTT_MMA_SS(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               RTT_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                    \
               : RTT_ACC32(d)                                               \
               : "l"(a), "l"(b), "r"(accumulate))
#define RTT_MMA_RS(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               RTT_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"      \
               : RTT_ACC32(d)                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// d (+)= A B, 64x64x16: A [64 rows][16] and B [64 rows][16], both K-major
// in shared memory. `accumulate` 0 overwrites d.
template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  if constexpr (kHalf<T>) RTT_MMA_SS("f16");
  else RTT_MMA_SS("bf16");
}

// d += A B, 64x64x16: A from registers (16-bit pairs), B [16 rows][64]
// MN-major in shared memory (its rows are the reduction).
template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  if constexpr (kHalf<T>) RTT_MMA_RS("f16");
  else RTT_MMA_RS("bf16");
}

#undef RTT_ACC32
#undef RTT_D32
#undef RTT_MMA_SS
#undef RTT_MMA_RS

// Two floats rounded to nearest even into T and packed (lo in the low
// half), and one float rounded to T.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                                float hi) {
  if constexpr (kHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}
template <typename T> __device__ __forceinline__ T round1(float x) {
  if constexpr (kHalf<T>) return __float2half_rn(x);
  else return __float2bfloat16(x);
}

// The A fragments of the four k16 steps over a 64-column accumulator,
// rounded to T.
template <typename T>
__device__ __forceinline__ void to_a_frags(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Offset of k16 step kk along D of a K-major [64][D] tile: 32 bytes per
// step inside a 128-byte row of a column block.
__device__ __forceinline__ uint32_t k_step(int kk) {
  return (kk >> 2) * kBlockBytes + (kk & 3) * 32;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Columns col and col + 1 of a row of n columns: the pair at once where
// both exist and `pairs` (the row 4-byte aligned), each alone otherwise.
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int col, int n, bool pairs,
                                           float lo, float hi) {
  if (pairs && col + 1 < n) {
    *reinterpret_cast<uint32_t*>(row + col) = pack2<T>(lo, hi);
    return;
  }
  if (col < n) row[col] = round1<T>(lo);
  if (col + 1 < n) row[col + 1] = round1<T>(hi);
}

// Shared memory: the caller adds 1024 bytes so the tiles can start on a
// 1024-byte boundary, where the swizzle atoms must lie.
__device__ __forceinline__ uint32_t aligned_base(const uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

__device__ __forceinline__ const uint16_t* bits(const void* p) {
  return reinterpret_cast<const uint16_t*>(p);
}

// The columns of the head dim that a block takes. With nc == 1 the whole
// head, [0, d).
struct Cols {
  int d, nc, w;   // head dim (row stride), chunks, columns per chunk
  __device__ __forceinline__ int c0(int ch) const { return ch * w; }
  __device__ __forceinline__ int n(int ch) const { return min(w, d - ch * w); }
};

template <int D, int kMode>
__device__ __forceinline__ Cols cols_of(int d_arg, int n_chunks, int width) {
  if constexpr (kMode == kChunked) return Cols{d_arg, n_chunks, width};
  const int d = kMode == kFull ? D : d_arg;
  return Cols{d, 1, d};
}

// ---------------------------------------------------------------------------
// K1: forward. o = softmax(q k^T * scale) v, lse = m + log(l), per 64-row
// Q tile; K/V tiles of kFwdKeyTile keys stream through a 2-stage ring.
// The softmax runs in base 2 (scale folded with log2 e) and lse is stored
// in natural-log units.
// ---------------------------------------------------------------------------
template <int D, int kMode>
constexpr size_t fwd_smem_bytes() {
  return (kMode == kChunked ? 3 : 5) * kTileBytes<D> + 1024;
}

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int d_arg, int n_chunks,
                    int width, int seq_q, int seq_k, float scale,
                    int causal, int block_q, int block_k) {
  constexpr bool kChunk = kMode == kChunked;
  static_assert(kFwdKeyTile == kRows, "one n64 product per key tile");
  constexpr int TB = kTileBytes<D>, NB = D / 64;
  const Cols cl = cols_of<D, kMode>(d_arg, n_chunks, width);
  const int d = cl.d;
  extern __shared__ uint8_t smem_raw[];
  // Whole heads: Q, then K and V in two stages each. Chunked: one Q, K
  // and V chunk each.
  const uint32_t sQ = aligned_base(smem_raw);
  const uint32_t sK = sQ + TB, sV = sQ + (kChunk ? 2 : 3) * TB;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_rows = (seq_q + kRows - 1) / kRows;
  const int j = blockIdx.x % cl.nc, tile = blockIdx.x / cl.nc;
  const int bh = tile / n_rows, q0 = (tile % n_rows) * kRows;
  const uint16_t* qb = bits(q) + (size_t)bh * seq_q * d;
  const uint16_t* kb = bits(k) + (size_t)bh * seq_k * d;
  const uint16_t* vb = bits(v) + (size_t)bh * seq_k * d;
  const int oc0 = cl.c0(j), on = cl.n(j);   // this block's output columns
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;
  const float scale2 = scale * kLog2e;

  int row[2], limit[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + 16 * warp + g + 8 * h;
    limit[h] = row[h] < seq_q ? keys_visited(row[h], seq_k, offset, block_q,
                                             block_k, is_causal)
                              : 0;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  // Online softmax over one key tile, per element in fragment coordinates,
  // then O += P V, p rounded to T against this tile's running max.
  auto softmax_pv = [&](float (&s)[32], int k0, uint32_t sVt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * jj + 2 * c + e, i = 4 * jj + 2 * h + e;
          float x;
          if (key >= limit[h]) {
            x = -INFINITY;  // not visited by the Pallas kernel: no weight
          } else if (is_causal && row[h] + offset < key) {
            x = kNegInf;
          } else {
            x = s[i] * scale2;
          }
          s[i] = x;
          mx = fmaxf(mx, x);
        }
      mx = quad_max(mx);
      const float m_new = fmaxf(m[h], mx);
      const float alpha = exp2f(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          s[i] = exp2f(s[i] - m_new);
          sum += s[i];
        }
      l[h] = l[h] * alpha + quad_sum(sum);
      m[h] = m_new;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          acc[nb][4 * jj + 2 * h] *= alpha;
          acc[nb][4 * jj + 2 * h + 1] *= alpha;
        }
    }
    uint32_t pa[4][4];
    to_a_frags<T>(s, pa);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(pa[kk]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mma_rs<T>(acc[nb], pa[kk],
                  desc(sVt + nb * kBlockBytes + kk * 16 * 128));
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
  };

  // S (+)= Q K^T over one [64][D] pair of tiles.
  auto scores = [&](float (&s)[32], uint32_t sQt, uint32_t sKt, bool more) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<T>(s, desc(sQt + k_step(kk)), desc(sKt + k_step(kk)),
                more || kk > 0);
    wg_commit();
    wg_wait();
    pin(s);
  };

  // Rows further down visit at least as many keys as rows above them.
  const int k_end = keys_visited(min(q0 + kRows, seq_q) - 1, seq_k, offset,
                                 block_q, block_k, is_causal);
  const int n_tiles = (k_end + kFwdKeyTile - 1) / kFwdKeyTile;

  if constexpr (!kChunk) {
    load_tile<D, kThreads>(sQ, qb, q0, seq_q, d, 0, d, tid);
    if (n_tiles > 0) {
      load_tile<D, kThreads>(sK, kb, 0, seq_k, d, 0, d, tid);
      load_tile<D, kThreads>(sV, vb, 0, seq_k, d, 0, d, tid);
    }
    cp_commit();
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1, k0 = t * kFwdKeyTile;
      if (t + 1 < n_tiles) {
        load_tile<D, kThreads>(sK + (st ^ 1) * TB, kb, k0 + kFwdKeyTile,
                               seq_k, d, 0, d, tid);
        load_tile<D, kThreads>(sV + (st ^ 1) * TB, vb, k0 + kFwdKeyTile,
                               seq_k, d, 0, d, tid);
      }
      cp_commit();
      cp_wait<1>();  // this tile's group has landed; the next one may fly
      fence_async_smem();
      __syncthreads();
      float s[32];
      scores(s, sQ, sK + st * TB, false);
      softmax_pv(s, k0, sV + st * TB);
      __syncthreads();  // the load issued next overwrites this stage
    }
    cp_wait<0>();
  } else {
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kFwdKeyTile;
      load_tile<D, kThreads>(sV, vb, k0, seq_k, d, oc0, on, tid);
      float s[32];
      for (int ch = 0; ch < cl.nc; ++ch) {
        load_tile<D, kThreads>(sQ, qb, q0, seq_q, d, cl.c0(ch), cl.n(ch),
                               tid);
        load_tile<D, kThreads>(sK, kb, k0, seq_k, d, cl.c0(ch), cl.n(ch),
                               tid);
        cp_commit();
        cp_wait<0>();
        fence_async_smem();
        __syncthreads();
        scores(s, sQ, sK, ch > 0);
        __syncthreads();  // the next chunk overwrites sQ and sK
      }
      softmax_pv(s, k0, sV);
      __syncthreads();  // the next tile overwrites sV
    }
  }

  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq_q) continue;
    const float li = l[h] == 0.f ? 1.f : l[h];
    T* orow = o + (size_t)bh * seq_q * d + (size_t)row[h] * d + oc0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        store_cols<T>(orow, nb * 64 + 8 * jj + 2 * c, on, pairs,
                      acc[nb][4 * jj + 2 * h] / li,
                      acc[nb][4 * jj + 2 * h + 1] / li);
    if (c == 0 && j == 0) {
      // m is in log2 units except for the NEG_INF of rows with no key.
      const float mn = m[h] == kNegInf ? kNegInf : m[h] * kLn2;
      lse[(size_t)bh * seq_q + row[h]] = mn + logf(li);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dQ = scale * dS K for one 64-row Q tile, looping over 64-key tiles
// (K and V in a 2-stage ring; Q, dO, lse and delta resident):
//   S = Q K^T, dP = dO V^T            (both operands in shared memory)
//   P = exp(S scale - lse), 0 where masked; dS = P (dP - delta)
//   dQ += dS K                        (A from registers, K MN-major)
//
// Replaces _flash_bwd_dq_kernel (ray_tpu/ops/attention.py:146). At the
// main-path shape (B·H 96, S 1024, D 64, bf16, causal) its three products
// are 19.35 GFLOP, 0.0196 ms at the 989 TFLOP/s bf16 rate; its 64 MB of
// inputs and output take 0.019 ms at 3.35 TB/s. So all three products run
// on the tensor cores, dS goes to the third from the accumulator's
// registers, and K is read from the stage the first product used. What
// remains in the way is what K1 and K3 leave: one exp2 per score and the
// wait for each product.
//
// Work order: under causal masking the last Q tile visits 16 times as many
// key tiles as the first at S 1024. Blocks start in blockIdx.x order, so
// the Q tile index is reversed (heaviest first): the light tiles, not the
// heavy ones, fill the tail of the grid.
// ---------------------------------------------------------------------------
template <int D, int kMode>
constexpr size_t dq_smem_bytes() {
  return (kMode == kChunked ? 4 : 6) * kTileBytes<D> + 1024;
}

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int d_arg, int n_chunks, int width, int seq_q,
                       int seq_k, float scale, int causal) {
  constexpr bool kChunk = kMode == kChunked;
  constexpr int TB = kTileBytes<D>, NB = D / 64;
  const Cols cl = cols_of<D, kMode>(d_arg, n_chunks, width);
  const int d = cl.d;
  extern __shared__ uint8_t smem_raw[];
  // Whole heads: Q, dO, then K and V in two stages each. Chunked: one
  // chunk of each.
  const uint32_t sQ = aligned_base(smem_raw), sG = sQ + TB;
  const uint32_t sK = sQ + 2 * TB, sV = sQ + (kChunk ? 3 : 4) * TB;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_rows = (seq_q + kRows - 1) / kRows;
  const int j = blockIdx.x % cl.nc, tile = blockIdx.x / cl.nc;
  const int bh = tile / n_rows;
  const int q0 = (n_rows - 1 - tile % n_rows) * kRows;
  const uint16_t* qb = bits(q) + (size_t)bh * seq_q * d;
  const uint16_t* gb = bits(dout) + (size_t)bh * seq_q * d;
  const uint16_t* kb = bits(k) + (size_t)bh * seq_k * d;
  const uint16_t* vb = bits(v) + (size_t)bh * seq_k * d;
  const size_t roff = (size_t)bh * seq_q;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;
  const float scale2 = scale * kLog2e;

  int row[2];
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + 16 * warp + g + 8 * h;
    const bool in = row[h] < seq_q;
    l2[h] = in ? lse[roff + row[h]] * kLog2e : 0.f;
    dl[h] = in ? delta[roff + row[h]] : 0.f;
  }
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  // S (+)= Q K^T and dP (+)= dO V^T over one chunk's tiles.
  auto products = [&](float (&s)[32], float (&dp)[32], uint32_t sKt,
                      uint32_t sVt, bool more) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_ss<T>(s, desc(sQ + k_step(kk)), desc(sKt + k_step(kk)),
                more || kk > 0);
      mma_ss<T>(dp, desc(sG + k_step(kk)), desc(sVt + k_step(kk)),
                more || kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);
  };

  // dS = P (dP - delta), then dQ += dS K with dS rounded to T.
  auto ds_dq = [&](float (&s)[32], float (&dp)[32], int k0, uint32_t sKt) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * jj + 2 * c + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jj + 2 * h + e;
          const bool valid = row[h] < seq_q && key < seq_k &&
                             (!is_causal || row[h] + offset >= key);
          const float p = valid ? exp2f(s[i] * scale2 - l2[h]) : 0.f;
          dp[i] = p * (dp[i] - dl[h]);
        }
      }
    uint32_t da[4][4];
    to_a_frags<T>(dp, da);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(da[kk]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mma_rs<T>(acc[nb], da[kk],
                  desc(sKt + nb * kBlockBytes + kk * 16 * 128));
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
  };

  // Keys past the last row's diagonal have p = 0 for every row of the tile.
  const int last = min(q0 + kRows, seq_q) - 1;
  const int k_end = is_causal ? min(seq_k, max(0, last + offset + 1)) : seq_k;
  const int n_tiles = (k_end + kRows - 1) / kRows;

  if constexpr (!kChunk) {
    load_tile<D, kThreads>(sQ, qb, q0, seq_q, d, 0, d, tid);
    load_tile<D, kThreads>(sG, gb, q0, seq_q, d, 0, d, tid);
    if (n_tiles > 0) {
      load_tile<D, kThreads>(sK, kb, 0, seq_k, d, 0, d, tid);
      load_tile<D, kThreads>(sV, vb, 0, seq_k, d, 0, d, tid);
    }
    cp_commit();
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1, k0 = t * kRows;
      if (t + 1 < n_tiles) {
        load_tile<D, kThreads>(sK + (st ^ 1) * TB, kb, k0 + kRows, seq_k, d,
                               0, d, tid);
        load_tile<D, kThreads>(sV + (st ^ 1) * TB, vb, k0 + kRows, seq_k, d,
                               0, d, tid);
      }
      cp_commit();
      cp_wait<1>();
      fence_async_smem();
      __syncthreads();
      float s[32], dp[32];
      products(s, dp, sK + st * TB, sV + st * TB, false);
      ds_dq(s, dp, k0, sK + st * TB);
      __syncthreads();  // the load issued next overwrites this stage
    }
    cp_wait<0>();
  } else {
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kRows;
      float s[32], dp[32];
      for (int i = 0; i < cl.nc; ++i) {
        const int ch = (j + 1 + i) % cl.nc;  // the block's own chunk last
        const int c0 = cl.c0(ch), n = cl.n(ch);
        load_tile<D, kThreads>(sQ, qb, q0, seq_q, d, c0, n, tid);
        load_tile<D, kThreads>(sG, gb, q0, seq_q, d, c0, n, tid);
        load_tile<D, kThreads>(sK, kb, k0, seq_k, d, c0, n, tid);
        load_tile<D, kThreads>(sV, vb, k0, seq_k, d, c0, n, tid);
        cp_commit();
        cp_wait<0>();
        fence_async_smem();
        __syncthreads();
        products(s, dp, sK, sV, i > 0);
        if (i + 1 < cl.nc) __syncthreads();  // the next chunk's loads
      }
      ds_dq(s, dp, k0, sK);  // sK holds the block's own chunk of K
      __syncthreads();
    }
  }

  const int oc0 = cl.c0(j), on = cl.n(j);
  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq_q) continue;
    T* drow = dq + (size_t)bh * seq_q * d + (size_t)row[h] * d + oc0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        store_cols<T>(drow, nb * 64 + 8 * jj + 2 * c, on, pairs,
                      acc[nb][4 * jj + 2 * h] * scale,
                      acc[nb][4 * jj + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// K3: dV = P^T dO and dK = scale * dS^T Q for one 64-key tile, looping
// over 64-query tiles (Q, dO, lse, delta in a 2-stage ring):
//   S^T = K Q^T, dP^T = V dO^T        (both operands in shared memory)
//   P^T = exp(S^T scale - lse), 0 where masked; dS^T = P^T (dP^T - delta)
//   dV += P^T dO, dK += dS^T Q        (A from registers, B MN-major)
// One warpgroup at D 64 and 128 (whole heads only).
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkv_smem_bytes() {
  return 6 * kTileBytes<D> + 2 * 2 * kRows * 4 + 1024;
}

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int d_arg, int n_chunks,
                        int width, int seq_q, int seq_k, float scale,
                        int causal) {
  static_assert(kMode != kChunked && D <= 128, "see the two-warpgroup K3");
  constexpr int TB = kTileBytes<D>, NB = D / 64;
  const int d = kMode == kFull ? D : d_arg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = aligned_base(smem_raw), sV = sK + TB;
  const uint32_t sQ = sK + 2 * TB, sG = sK + 4 * TB;  // + stage * TB
  const uint32_t sRows = sK + 6 * TB;  // stage st: lse at + 512 st, delta +256
  const uint8_t* rows_ptr = smem_raw + (sRows - smem_u32(smem_raw));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_keys = (seq_k + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_keys, k0 = (blockIdx.x % n_keys) * kRows;
  const uint16_t* qb = bits(q) + (size_t)bh * seq_q * d;
  const uint16_t* gb = bits(dout) + (size_t)bh * seq_q * d;
  const size_t koff = (size_t)bh * seq_k * d;
  const size_t roff = (size_t)bh * seq_q;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;
  const float scale2 = scale * kLog2e;

  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = k0 + 16 * warp + g + 8 * h;
  float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[nb][i] = dv_acc[nb][i] = 0.f;

  // Query rows before k0 - offset see no key of this tile.
  const int q_first = is_causal ? (max(0, k0 - offset) / kRows) * kRows : 0;
  const int n_tiles = q_first < seq_q ? (seq_q - q_first + kRows - 1) / kRows
                                      : 0;

  auto load_q_tile = [&](int st, int q0) {
    load_tile<D, kThreads>(sQ + st * TB, qb, q0, seq_q, d, 0, d, tid);
    load_tile<D, kThreads>(sG + st * TB, gb, q0, seq_q, d, 0, d, tid);
    const uint32_t r = sRows + st * 512;
    if (tid < kRows) load_row(r, lse + roff, q0, seq_q, tid);
    else load_row(r + 256, delta + roff, q0, seq_q, tid - kRows);
  };
  load_tile<D, kThreads>(sK, bits(k) + koff, k0, seq_k, d, 0, d, tid);
  load_tile<D, kThreads>(sV, bits(v) + koff, k0, seq_k, d, 0, d, tid);
  if (n_tiles > 0) load_q_tile(0, q_first);
  cp_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, q0 = q_first + t * kRows;
    if (t + 1 < n_tiles) load_q_tile(st ^ 1, q0 + kRows);
    cp_commit();
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T over D.
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_ss<T>(s, desc(sK + k_step(kk)), desc(sQ + st * TB + k_step(kk)),
                kk > 0);
      mma_ss<T>(dp, desc(sV + k_step(kk)), desc(sG + st * TB + k_step(kk)),
                kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    const float* lse_s = reinterpret_cast<const float*>(rows_ptr + st * 512);
    const float* delta_s = lse_s + kRows;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + 2 * c + e, query = q0 + col;
        const float l2 = lse_s[col] * kLog2e, dl = delta_s[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jj + 2 * h + e;
          const bool valid = query < seq_q && key[h] < seq_k &&
                             (!is_causal || query + offset >= key[h]);
          const float p = valid ? exp2f(s[i] * scale2 - l2) : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl);
        }
      }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to T.
    uint32_t pa[4][4], da[4][4];
    to_a_frags<T>(s, pa);
    to_a_frags<T>(dp, da);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      pin(dv_acc[nb]);
      pin(dk_acc[nb]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(pa[kk]);
      pin(da[kk]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint32_t b = st * TB + nb * kBlockBytes + kk * 16 * 128;
        mma_rs<T>(dv_acc[nb], pa[kk], desc(sG + b));
        mma_rs<T>(dk_acc[nb], da[kk], desc(sQ + b));
      }
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      pin(dv_acc[nb]);
      pin(dk_acc[nb]);
    }
    __syncthreads();  // the load issued next overwrites this stage
  }
  cp_wait<0>();

  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq_k) continue;
    const size_t at = koff + (size_t)key[h] * d;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * jj + 2 * h, col = nb * 64 + 8 * jj + 2 * c;
        store_cols<T>(dk + at, col, d, pairs, dk_acc[nb][i] * scale,
                      dk_acc[nb][i + 1] * scale);
        store_cols<T>(dv + at, col, d, pairs, dv_acc[nb][i],
                      dv_acc[nb][i + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// K3 at D 192 and 256, whole heads and chunked: two warpgroups per 64-key
// tile. Warpgroup 0 runs S^T = K Q^T, P^T and dV += P^T dO; warpgroup 1
// runs dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q. P^T goes
// from the first to the second through shared memory as fp32, one 32-float
// fragment per thread at [i][t] (the same fragment layout in both
// warpgroups, so thread t of one and of the other hold the same elements).
// Each thread keeps one [64][D] accumulator: 128 registers at D 256.
// ---------------------------------------------------------------------------
template <int D, int kMode>
constexpr size_t dkv2_smem_bytes() {
  constexpr int stages = kMode == kChunked ? 1 : 2;
  return (2 + 2 * stages) * kTileBytes<D> + stages * 2 * kRows * 4 +
         kRows * kRows * 4 + 1024;
}

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(2 * kThreads)
flash_bwd_dkv_tc2_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int d_arg, int n_chunks,
                         int width, int seq_q, int seq_k, float scale,
                         int causal) {
  constexpr bool kChunk = kMode == kChunked;
  constexpr int NT = 2 * kThreads, TB = kTileBytes<D>, NB = D / 64;
  constexpr int kStages = kChunk ? 1 : 2;
  const Cols cl = cols_of<D, kMode>(d_arg, n_chunks, width);
  const int d = cl.d;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = aligned_base(smem_raw), sV = sK + TB;
  const uint32_t sQ = sK + 2 * TB, sG = sQ + kStages * TB;  // + stage * TB
  const uint32_t sRows = sG + kStages * TB;  // stage st: lse at + 512 st,
                                             // delta + 256
  const uint32_t sP = sRows + kStages * 512;
  float* p_x = reinterpret_cast<float*>(smem_raw + (sP - smem_u32(smem_raw)));

  const int tid = threadIdx.x, wg = tid / kThreads, t = tid % kThreads;
  const int warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;
  const int n_keys = (seq_k + kRows - 1) / kRows;
  const int j = blockIdx.x % cl.nc, tile = blockIdx.x / cl.nc;
  const int bh = tile / n_keys, k0 = (tile % n_keys) * kRows;
  const uint16_t* qb = bits(q) + (size_t)bh * seq_q * d;
  const uint16_t* gb = bits(dout) + (size_t)bh * seq_q * d;
  const uint16_t* kb = bits(k) + (size_t)bh * seq_k * d;
  const uint16_t* vb = bits(v) + (size_t)bh * seq_k * d;
  const size_t roff = (size_t)bh * seq_q;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;
  const float scale2 = scale * kLog2e;
  // The first product's A (K or V) and B (Q or dO), the second's B (dO or
  // Q), by warpgroup.
  const uint32_t sA = wg == 0 ? sK : sV;
  const uint32_t sB = wg == 0 ? sQ : sG, sOut = wg == 0 ? sG : sQ;

  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = k0 + 16 * warp + g + 8 * h;
  float acc[NB][32];  // warpgroup 0: dV; 1: dK
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  // Query rows before k0 - offset see no key of this tile.
  const int q_first = is_causal ? (max(0, k0 - offset) / kRows) * kRows : 0;
  const int n_tiles = q_first < seq_q ? (seq_q - q_first + kRows - 1) / kRows
                                      : 0;

  auto load_rows = [&](int st, int q0) {
    const uint32_t r = sRows + st * 512;
    if (tid < kRows) load_row(r, lse + roff, q0, seq_q, tid);
    else if (tid < 2 * kRows) load_row(r + 256, delta + roff, q0, seq_q,
                                       tid - kRows);
  };

  // x (+)= S^T (warpgroup 0) or dP^T (1) over one chunk's tiles.
  auto first = [&](float (&x)[32], uint32_t sBt, bool more) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<T>(x, desc(sA + k_step(kk)), desc(sBt + k_step(kk)),
                more || kk > 0);
    wg_commit();
    wg_wait();
    pin(x);
  };

  // P^T from S^T (warpgroup 0), handed to warpgroup 1 for dS^T; then each
  // warpgroup's output product with x rounded to T.
  auto second = [&](float (&x)[32], int q0, int st, uint32_t sOutT) {
    const float* lse_s = reinterpret_cast<const float*>(
        smem_raw + (sRows + st * 512 - smem_u32(smem_raw)));
    const float* delta_s = lse_s + kRows;
    if (wg == 0) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * jj + 2 * c + e, query = q0 + col;
          const float l2 = lse_s[col] * kLog2e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jj + 2 * h + e;
            const bool valid = query < seq_q && key[h] < seq_k &&
                               (!is_causal || query + offset >= key[h]);
            x[i] = valid ? exp2f(x[i] * scale2 - l2) : 0.f;
            p_x[i * kThreads + t] = x[i];
          }
        }
    }
    __syncthreads();  // P^T in shared memory
    if (wg == 1) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = delta_s[8 * jj + 2 * c + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jj + 2 * h + e;
            x[i] = p_x[i * kThreads + t] * (x[i] - dl);
          }
        }
    }
    uint32_t xa[4][4];
    to_a_frags<T>(x, xa);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(xa[kk]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mma_rs<T>(acc[nb], xa[kk],
                  desc(sOutT + nb * kBlockBytes + kk * 16 * 128));
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
  };

  if constexpr (!kChunk) {
    auto load_q_tile = [&](int st, int q0) {
      load_tile<D, NT>(sQ + st * TB, qb, q0, seq_q, d, 0, d, tid);
      load_tile<D, NT>(sG + st * TB, gb, q0, seq_q, d, 0, d, tid);
      load_rows(st, q0);
    };
    load_tile<D, NT>(sK, kb, k0, seq_k, d, 0, d, tid);
    load_tile<D, NT>(sV, vb, k0, seq_k, d, 0, d, tid);
    if (n_tiles > 0) load_q_tile(0, q_first);
    cp_commit();
    for (int u = 0; u < n_tiles; ++u) {
      const int st = u & 1, q0 = q_first + u * kRows;
      if (u + 1 < n_tiles) load_q_tile(st ^ 1, q0 + kRows);
      cp_commit();
      cp_wait<1>();
      fence_async_smem();
      __syncthreads();
      float x[32];
      first(x, sB + st * TB, false);
      second(x, q0, st, sOut + st * TB);
      __syncthreads();  // the load issued next overwrites this stage
    }
    cp_wait<0>();
  } else {
    for (int u = 0; u < n_tiles; ++u) {
      const int q0 = q_first + u * kRows;
      load_rows(0, q0);
      float x[32];
      for (int i = 0; i < cl.nc; ++i) {
        const int ch = (j + 1 + i) % cl.nc;  // the block's own chunk last
        const int c0 = cl.c0(ch), n = cl.n(ch);
        load_tile<D, NT>(sK, kb, k0, seq_k, d, c0, n, tid);
        load_tile<D, NT>(sV, vb, k0, seq_k, d, c0, n, tid);
        load_tile<D, NT>(sQ, qb, q0, seq_q, d, c0, n, tid);
        load_tile<D, NT>(sG, gb, q0, seq_q, d, c0, n, tid);
        cp_commit();
        cp_wait<0>();
        fence_async_smem();
        __syncthreads();
        first(x, sB, i > 0);
        if (i + 1 < cl.nc) __syncthreads();  // the next chunk's loads
      }
      second(x, q0, 0, sOut);  // sQ, sG hold the block's own chunk
      __syncthreads();
    }
  }

  const int oc0 = cl.c0(j), on = cl.n(j);
  const bool pairs = (d & 1) == 0;
  T* out = (wg == 0 ? dv : dk) + (size_t)bh * seq_k * d + oc0;
  const float f = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq_k) continue;
    T* orow = out + (size_t)key[h] * d;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * jj + 2 * h;
        store_cols<T>(orow, nb * 64 + 8 * jj + 2 * c, on, pairs,
                      acc[nb][i] * f, acc[nb][i + 1] * f);
      }
  }
}

// ---------------------------------------------------------------------------
// Host launchers, one (T, D) per part file (flash_tc.h declares them).
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t launch_prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// cp.async moves 16-byte chunks, so q, k, v and dO must start on a 16-byte
// boundary; the outputs are held to the same.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The mode of an instance for a head: chunked above one chunk (D 192 and
// 256 only), else the constant stride where d = D.
template <int D, typename F>
cudaError_t with_mode(const Geometry& geo, F&& f) {
  if (geo.n_chunks > 1) {
    if constexpr (D >= 192) return f(std::integral_constant<int, kChunked>());
    return cudaErrorInvalidValue;
  }
  if (geo.d == D) return f(std::integral_constant<int, kFull>());
  return f(std::integral_constant<int, kPadded>());
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int block_q, int block_k, const Geometry& geo,
                cudaStream_t stream) {
  if (!aligned16({q, k, v, o})) return cudaErrorMisalignedAddress;
  unsigned grid;
  if (!grid_size(tiles(geo.seq_q, kRows) * geo.n_chunks, geo.bh, &grid))
    return cudaErrorInvalidValue;
  return with_mode<D>(geo, [&](auto mode) {
    constexpr int M = decltype(mode)::value;
    auto kernel = flash_fwd_tc_kernel<T, D, M>;
    const size_t smem = fwd_smem_bytes<D, M>();
    cudaError_t err = launch_prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, geo.d,
        geo.n_chunks, geo.width, geo.seq_q, geo.seq_k, geo.scale, geo.causal,
        block_q, block_k);
    return cudaGetLastError();
  });
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Geometry& geo, cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dq})) return cudaErrorMisalignedAddress;
  unsigned grid;
  if (!grid_size(tiles(geo.seq_q, kRows) * geo.n_chunks, geo.bh, &grid))
    return cudaErrorInvalidValue;
  return with_mode<D>(geo, [&](auto mode) {
    constexpr int M = decltype(mode)::value;
    auto kernel = flash_bwd_dq_tc_kernel<T, D, M>;
    const size_t smem = dq_smem_bytes<D, M>();
    cudaError_t err = launch_prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dq, geo.d, geo.n_chunks,
        geo.width, geo.seq_q, geo.seq_k, geo.scale, geo.causal);
    return cudaGetLastError();
  });
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Geometry& geo,
                    cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dk, dv})) return cudaErrorMisalignedAddress;
  unsigned grid;
  if (!grid_size(tiles(geo.seq_k, kRows) * geo.n_chunks, geo.bh, &grid))
    return cudaErrorInvalidValue;
  return with_mode<D>(geo, [&](auto mode) {
    constexpr int M = decltype(mode)::value;
    if constexpr (D <= 128) {
      auto kernel = flash_bwd_dkv_tc_kernel<T, D, M>;
      const size_t smem = dkv_smem_bytes<D>();
      cudaError_t err = launch_prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
          (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, geo.d,
          geo.n_chunks, geo.width, geo.seq_q, geo.seq_k, geo.scale,
          geo.causal);
    } else {
      auto kernel = flash_bwd_dkv_tc2_kernel<T, D, M>;
      const size_t smem = dkv2_smem_bytes<D, M>();
      cudaError_t err = launch_prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, 2 * kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
          (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, geo.d,
          geo.n_chunks, geo.width, geo.seq_q, geo.seq_k, geo.scale,
          geo.causal);
    }
    return cudaGetLastError();
  });
}

}  // namespace tc
}  // namespace rtt

// The three launchers of one (T, D), for a part file to instantiate.
#define RTT_TC_INSTANCES(T, D)                                              \
  namespace rtt {                                                           \
  namespace tc {                                                            \
  template cudaError_t fwd<T, D>(const void*, const void*, const void*,    \
                                 void*, void*, int, int, const Geometry&,  \
                                 cudaStream_t);                             \
  template cudaError_t bwd_dq<T, D>(const void*, const void*, const void*, \
                                    const void*, const void*, const void*, \
                                    void*, const Geometry&, cudaStream_t); \
  template cudaError_t bwd_dkv<T, D>(                                       \
      const void*, const void*, const void*, const void*, const void*,      \
      const void*, void*, void*, const Geometry&, cudaStream_t);            \
  }                                                                         \
  }
