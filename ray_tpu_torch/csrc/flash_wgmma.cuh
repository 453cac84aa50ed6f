// Tensor-core flash attention for Hopper (sm_90a): K1 (forward), K2 (dQ)
// and K3 (dK/dV) in bf16 at head dims 33 to 128, compiled at D = 64 and
// 128. Included by flash_attention.cu, whose header states the contract;
// this file holds the design.
//
// One warpgroup (128 threads) per block and per 64-row output tile. Every
// product is a `wgmma.mma_async` m64n64k16 with bf16 operands and fp32
// accumulators; a head dim of 128 is two 64-column halves, each its own
// n64 product. Tiles stay bf16 in shared memory in the 128-byte-swizzled
// layout that wgmma descriptors read: a [64][D] tile is D/64 column blocks
// of [64 rows][128 B], the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8). The same bytes serve as a K-major operand (D is the
// reduction) and as an MN-major one (rows are the reduction, D the output
// columns), so a tile that feeds both kinds of product (Q and dO in K3,
// K in K2) is loaded once. Loads are cp.async into a ring of two stages:
// the next tile streams in while the current one is multiplied. Ragged
// edges are zero-filled by the copy (src-size 0) and masked per element
// in the accumulator's coordinates.
//
// A head dim d below D (d 80 on D 128; the kernels' kPad instances, while
// d = D takes instances whose row stride is the constant D, as before
// padding) is padded in shared memory, never in global memory: the 16-byte chunks at columns d..D are zero-filled
// (cp.async with src-size 0), so every tile is whole 64-column swizzle
// atoms as the descriptors assume, and stores skip columns d..D. Where d
// is not a multiple of 8, rows do not start on a 16-byte boundary; the
// loads then go element by element through registers into the same
// swizzled chunks (a generic-proxy store, made visible to wgmma by the
// same proxy fence as the cp.async data).
//
// wgmma m64nNk16 fp32 accumulator layout (PTX ISA, "wgmma register
// fragments"): thread t = 32 w + lane of the warpgroup holds, in register
// 4 j + 2 h + e, row 16 w + lane / 4 + 8 h and column 8 j + 2 (lane % 4) + e.
// For 16 consecutive columns 16 kk.. that is registers 8 kk .. 8 kk + 7,
// which packed pairwise into bf16x2 are exactly the A fragment of a k16
// step: a product's accumulator feeds the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace rtt {
namespace tc {

constexpr int kRows = 64;          // tile rows: one warpgroup's M
constexpr int kFwdKeyTile = 64;    // keys per step of the forward (K1)
constexpr int kThreads = 128;      // one warpgroup
constexpr int kBlockBytes = kRows * 128;  // one [64][64] bf16 column block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D> constexpr int kTileBytes = kRows * D * 2;  // [64][D] bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `cb` (columns 8 cb .. 8 cb + 7) of row r.
__device__ __forceinline__ uint32_t chunk_offset(int r, int cb) {
  return (cb >> 3) * kBlockBytes + r * 128 + (((cb & 7) ^ (r & 7)) << 4);
}

// Rows [row0, row0 + 64) of a [seq, d] bf16 matrix into the swizzled
// [64][D] tile at shared address `dst`: rows past `seq` and columns past
// `d` become zeros. Asynchronous (cp.async) when d is a multiple of 8;
// else synchronous, element by element.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int seq, int d, int tid) {
  constexpr int kChunks = D / 8;
  const bool vec = (d & 7) == 0;
  const uint16_t* bits = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / kChunks, cb = i % kChunks;
    const int g = row0 + r, c0 = 8 * cb;
    const uint32_t at = dst + chunk_offset(r, cb);
    if (vec) {
      const bool in = g < seq && c0 < d;
      const __nv_bfloat16* p = src + (in ? (size_t)g * d + c0 : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       at),
                   "l"(p), "r"(in ? 16 : 0)
                   : "memory");
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 2 * e;
        const size_t at_g = (size_t)g * d + c;
        const uint32_t lo = g < seq && c < d ? bits[at_g] : 0u;
        const uint32_t hi = g < seq && c + 1 < d ? bits[at_g + 1] : 0u;
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

// d (+)= A B, 64x64x16: A [64 rows][16] and B [64 rows][16], both K-major
// in shared memory. `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RTT_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, 64x64x16: A from registers (bf16x2 fragments), B [16 rows][64]
// MN-major in shared memory (its rows are the reduction).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef RTT_ACC32
#undef RTT_D32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of the four k16 steps over a 64-column accumulator,
// rounded to bf16.
__device__ __forceinline__ void to_a_frags(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
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

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float lo,
                                             float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// Columns col and col + 1 of a row of d columns: the pair at once where
// both exist and d is even (4-byte aligned), each alone otherwise.
__device__ __forceinline__ void store_cols(__nv_bfloat16* row, int col,
                                           int d, float lo, float hi) {
  if ((d & 1) == 0 && col + 1 < d) {
    store_bf16x2(row + col, lo, hi);
    return;
  }
  if (col < d) row[col] = __float2bfloat16(lo);
  if (col + 1 < d) row[col + 1] = __float2bfloat16(hi);
}

// Shared memory: the caller adds 1024 bytes so the tiles can start on a
// 1024-byte boundary, where the swizzle atoms must lie.
__device__ __forceinline__ uint32_t aligned_base(const uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// ---------------------------------------------------------------------------
// K1: forward. o = softmax(q k^T * scale) v, lse = m + log(l), per 64-row
// Q tile; K/V tiles of kFwdKeyTile keys stream through a 2-stage ring.
// The softmax runs in base 2 (scale folded with log2 e) and lse is stored
// in natural-log units.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem_bytes() { return 5 * kTileBytes<D> + 1024; }

template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int d_arg, int seq_q, int seq_k, float scale,
                    int causal, int block_q, int block_k) {
  const int d = kPad ? d_arg : D;  // kPad: head dim d below D, padded
  static_assert(kFwdKeyTile == kRows, "one n64 product per key tile");
  constexpr int TB = kTileBytes<D>, NB = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = aligned_base(smem_raw);
  const uint32_t sK = sQ + TB, sV = sQ + 3 * TB;  // + stage * TB

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_rows = (seq_q + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_rows, q0 = (blockIdx.x % n_rows) * kRows;
  const size_t qoff = (size_t)bh * seq_q * d, koff = (size_t)bh * seq_k * d;
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

  // Rows further down visit at least as many keys as rows above them.
  const int k_end = keys_visited(min(q0 + kRows, seq_q) - 1, seq_k, offset,
                                 block_q, block_k, is_causal);
  const int n_tiles = (k_end + kFwdKeyTile - 1) / kFwdKeyTile;

  load_tile<D>(sQ, q + qoff, q0, seq_q, d, tid);
  if (n_tiles > 0) {
    load_tile<D>(sK, k + koff, 0, seq_k, d, tid);
    load_tile<D>(sV, v + koff, 0, seq_k, d, tid);
  }
  cp_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, k0 = t * kFwdKeyTile;
    if (t + 1 < n_tiles) {
      load_tile<D>(sK + (st ^ 1) * TB, k + koff, k0 + kFwdKeyTile, seq_k, d,
                   tid);
      load_tile<D>(sV + (st ^ 1) * TB, v + koff, k0 + kFwdKeyTile, seq_k, d,
                   tid);
    }
    cp_commit();
    cp_wait<1>();  // this tile's group has landed; the next one may fly
    fence_async_smem();
    __syncthreads();

    // S = Q K^T over D.
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(s, desc(sQ + k_step(kk)), desc(sK + st * TB + k_step(kk)),
             kk > 0);
    wg_commit();
    wg_wait();
    pin(s);

    // Online softmax over this tile, per element in fragment coordinates.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * c + e, i = 4 * j + 2 * h + e;
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
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          s[i] = exp2f(s[i] - m_new);
          sum += s[i];
        }
      l[h] = l[h] * alpha + quad_sum(sum);
      m[h] = m_new;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[nb][4 * j + 2 * h] *= alpha;
          acc[nb][4 * j + 2 * h + 1] *= alpha;
        }
    }

    // O += P V, p rounded to bf16 against this tile's running max.
    uint32_t pa[4][4];
    to_a_frags(s, pa);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(pa[kk]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mma_rs(acc[nb], pa[kk],
               desc(sV + st * TB + nb * kBlockBytes + kk * 16 * 128));
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
    __syncthreads();  // the load issued next overwrites this stage
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq_q) continue;
    const float li = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* orow = o + qoff + (size_t)row[h] * d;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_cols(orow, nb * 64 + 8 * j + 2 * c, d,
                   acc[nb][4 * j + 2 * h] / li,
                   acc[nb][4 * j + 2 * h + 1] / li);
    if (c == 0) {
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
template <int D>
constexpr size_t dq_smem_bytes() { return 6 * kTileBytes<D> + 1024; }

template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int d_arg,
                       int seq_q, int seq_k, float scale, int causal) {
  const int d = kPad ? d_arg : D;
  constexpr int TB = kTileBytes<D>, NB = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = aligned_base(smem_raw), sG = sQ + TB;
  const uint32_t sK = sQ + 2 * TB, sV = sQ + 4 * TB;  // + stage * TB

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_rows = (seq_q + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_rows;
  const int q0 = (n_rows - 1 - (int)(blockIdx.x % n_rows)) * kRows;
  const size_t qoff = (size_t)bh * seq_q * d, koff = (size_t)bh * seq_k * d;
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

  // Keys past the last row's diagonal have p = 0 for every row of the tile.
  const int last = min(q0 + kRows, seq_q) - 1;
  const int k_end = is_causal ? min(seq_k, max(0, last + offset + 1)) : seq_k;
  const int n_tiles = (k_end + kRows - 1) / kRows;

  load_tile<D>(sQ, q + qoff, q0, seq_q, d, tid);
  load_tile<D>(sG, dout + qoff, q0, seq_q, d, tid);
  if (n_tiles > 0) {
    load_tile<D>(sK, k + koff, 0, seq_k, d, tid);
    load_tile<D>(sV, v + koff, 0, seq_k, d, tid);
  }
  cp_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, k0 = t * kRows;
    if (t + 1 < n_tiles) {
      load_tile<D>(sK + (st ^ 1) * TB, k + koff, k0 + kRows, seq_k, d, tid);
      load_tile<D>(sV + (st ^ 1) * TB, v + koff, k0 + kRows, seq_k, d, tid);
    }
    cp_commit();
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();

    // S = Q K^T and dP = dO V^T over D.
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_ss(s, desc(sQ + k_step(kk)), desc(sK + st * TB + k_step(kk)),
             kk > 0);
      mma_ss(dp, desc(sG + k_step(kk)), desc(sV + st * TB + k_step(kk)),
             kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * c + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool valid = row[h] < seq_q && key < seq_k &&
                             (!is_causal || row[h] + offset >= key);
          const float p = valid ? exp2f(s[i] * scale2 - l2[h]) : 0.f;
          dp[i] = p * (dp[i] - dl[h]);
        }
      }

    // dQ += dS K, dS rounded to bf16.
    uint32_t da[4][4];
    to_a_frags(dp, da);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(da[kk]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mma_rs(acc[nb], da[kk],
               desc(sK + st * TB + nb * kBlockBytes + kk * 16 * 128));
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
    __syncthreads();  // the load issued next overwrites this stage
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq_q) continue;
    __nv_bfloat16* drow = dq + qoff + (size_t)row[h] * d;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_cols(drow, nb * 64 + 8 * j + 2 * c, d,
                   acc[nb][4 * j + 2 * h] * scale,
                   acc[nb][4 * j + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// K3: dV = P^T dO and dK = scale * dS^T Q for one 64-key tile, looping
// over 64-query tiles (Q, dO, lse, delta in a 2-stage ring):
//   S^T = K Q^T, dP^T = V dO^T        (both operands in shared memory)
//   P^T = exp(S^T scale - lse), 0 where masked; dS^T = P^T (dP^T - delta)
//   dV += P^T dO, dK += dS^T Q        (A from registers, B MN-major)
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkv_smem_bytes() {
  return 6 * kTileBytes<D> + 2 * 2 * kRows * 4 + 1024;
}

template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int d_arg,
                        int seq_q, int seq_k, float scale, int causal) {
  const int d = kPad ? d_arg : D;
  constexpr int TB = kTileBytes<D>, NB = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = aligned_base(smem_raw), sV = sK + TB;
  const uint32_t sQ = sK + 2 * TB, sG = sK + 4 * TB;  // + stage * TB
  const uint32_t sRows = sK + 6 * TB;  // stage st: lse at + 512 st, delta +256
  const uint8_t* rows_ptr = smem_raw + (sRows - smem_u32(smem_raw));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_keys = (seq_k + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_keys, k0 = (blockIdx.x % n_keys) * kRows;
  const size_t qoff = (size_t)bh * seq_q * d, koff = (size_t)bh * seq_k * d;
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
    load_tile<D>(sQ + st * TB, q + qoff, q0, seq_q, d, tid);
    load_tile<D>(sG + st * TB, dout + qoff, q0, seq_q, d, tid);
    const uint32_t r = sRows + st * 512;
    if (tid < kRows) load_row(r, lse + roff, q0, seq_q, tid);
    else load_row(r + 256, delta + roff, q0, seq_q, tid - kRows);
  };
  load_tile<D>(sK, k + koff, k0, seq_k, d, tid);
  load_tile<D>(sV, v + koff, k0, seq_k, d, tid);
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
      mma_ss(s, desc(sK + k_step(kk)), desc(sQ + st * TB + k_step(kk)),
             kk > 0);
      mma_ss(dp, desc(sV + k_step(kk)), desc(sG + st * TB + k_step(kk)),
             kk > 0);
    }
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    const float* lse_s = reinterpret_cast<const float*>(rows_ptr + st * 512);
    const float* delta_s = lse_s + kRows;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e, query = q0 + col;
        const float l2 = lse_s[col] * kLog2e, dl = delta_s[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool valid = query < seq_q && key[h] < seq_k &&
                             (!is_causal || query + offset >= key[h]);
          const float p = valid ? exp2f(s[i] * scale2 - l2) : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl);
        }
      }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16.
    uint32_t pa[4][4], da[4][4];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
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
        mma_rs(dv_acc[nb], pa[kk], desc(sG + b));
        mma_rs(dk_acc[nb], da[kk], desc(sQ + b));
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

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq_k) continue;
    const size_t at = koff + (size_t)key[h] * d;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * h, col = nb * 64 + 8 * j + 2 * c;
        store_cols(dk + at, col, d, dk_acc[nb][i] * scale,
                   dk_acc[nb][i + 1] * scale);
        store_cols(dv + at, col, d, dv_acc[nb][i], dv_acc[nb][i + 1]);
      }
  }
}

}  // namespace tc
}  // namespace rtt
