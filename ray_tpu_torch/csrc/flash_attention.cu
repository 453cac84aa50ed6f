// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas kernels of ray_tpu/ops/attention.py:
//   K1 forward  <- _flash_kernel          (attention.py:53)
//   K2 dQ       <- _flash_bwd_dq_kernel   (attention.py:146)
//   K3 dK/dV    <- _flash_bwd_dkv_kernel  (attention.py:199)
// and computes what they compute, not how they tile it:
//   * layouts q [BH, Sq, D], k/v [BH, Sk, D], lse/delta [BH, Sq] fp32;
//   * any head dim D >= 1 and any B·H, in fp32, bf16 and fp16, as the
//     Pallas kernels take any D (their BlockSpecs hold the whole of it) and
//     any grid;
//   * causal masking aligned bottom-right (offset = Sk - Sq), masked logits
//     set to the same finite NEG_INF = -1e30 as the JAX kernels, so a row
//     whose visited keys are all masked gets p = 1 on each of them in the
//     forward (mean of V) exactly as _flash_kernel does, and the backward
//     kernels force p to 0 on masked entries (attention.py:178-181,
//     :231-233);
//   * the forward visits, per row, the keys of the whole block_k blocks up
//     to its block_q block's diagonal (attention.py:101-106), so the Python
//     block sizes are arguments here although the kernels tile by 64;
//   * dot inputs are rounded to the input type and products accumulate in
//     fp32; p is rounded to v's type before P.V, against the running max
//     after each 64-key tile, and P / dS to the input type before dS.K,
//     P^T.dO and dS^T.Q (attention.py:93, :186, :240); the softmax runs in
//     fp32 and lse is in natural-log units.
//
// Each kernel is compiled at a few head dims Dp and takes the true head
// dim d <= Dp at run time: it reads columns below d, fills columns d..Dp
// of its shared-memory tiles with zeros, and writes columns below d. A zero
// column adds nothing to Q K^T or dO V^T, and the columns of P V, dS K,
// P^T dO and dS^T Q below d do not read the columns above it, so the
// padded product is the true one. Above 256 the head dim is cut into
// chunks of at most 256 columns (Geometry): the products over d loop over
// the chunks into one accumulator, and each block computes one chunk of the
// output columns, recomputing the scores (flash_wgmma.cuh, kChunked). B·H,
// the row tiles and the chunks share blockIdx.x, B·H outermost, so the grid
// has no 65535 cap on B·H.
//
// Two designs, picked by `route` below from the dtype and head dim:
//
//   * bf16 and fp16, K1, K2 and K3 (flash_wgmma.cuh, one part file
//     flash_attention.tc_<type>_<Dp>.cu per type and width), padded to Dp
//     64, 128, 192 or 256, or chunked above 256: one warpgroup per
//     64-row tile (two for K3 at 192 and 256), every product a `wgmma` with
//     fp32 accumulators, tiles in 128-byte-swizzled shared memory filled by
//     cp.async, P and dS fed to the last product from registers.
//   * fp32 at every d (this file): 256 threads per (bh, row tile, chunk),
//     products as fp32 FMAs on the CUDA cores from tiles widened to fp32 in
//     shared memory (rows padded to Dp + 1 floats), loads synchronous,
//     padded to Dp 16, 32, 64, 128 or 256 and chunked by 256 above it.
//     Row tiles are 64, and 32 for K2 and K3 at Dp 256, whose 64-row tiles
//     would need more than the 227 KB of shared memory a block may opt in
//     to. fp32 stays here because tensor cores
//     would round its operands to TF32. bf16 and fp16 at d <= 32 ran here
//     until the tensor cores, padded to 64, measured 3-5x faster there
//     (PERF.md).
//
// What bounds them. At the main-path shape (BH = 96, S = 1024, D = 64,
// bf16, causal) the least time on an H100 SXM is set by the bytes for the
// forward (~51 MB at 3.35 TB/s, 15 us) and by the tensor-core rate for
// the two backward kernels (19.4 and 25.8 GFLOP at 989 TFLOP/s, 20 and
// 26 us). The CUDA-core design is held to the 67 TFLOP/s fp32 rate and
// below it by shared-memory reads (about one per FMA pair). The wgmma
// design moves the products to the tensor cores; what remains in its way
// is the softmax between them (one exp2 per score on the 16-per-clock
// multi-function unit, the masking and the rescale) and the wait for each
// product: a block does not overlap its own softmax with its next
// product, only the other blocks on the SM do. A padded width wastes the
// products over the zero columns (d 80 on Dp 128: 37.5%), and a chunked
// head recomputes the scores once per output chunk.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using rtt::Geometry;
using rtt::grid_size;
using rtt::keys_visited;
using rtt::kNegInf;
using rtt::tiles;

constexpr int kTile = 64;          // rows of Q and of K/V per tile, keys per
                                   // step of the forward
constexpr int kWideTile = 32;      // rows per tile of K2 and K3 at Dp 256
constexpr int kThreads = 256;      // 16 x 16
constexpr int kMaxChunk = 256;     // columns of a head-dim chunk, at most

// The kernels below are written for an element type T and instantiated
// for fp32, where the JAX kernels' `.astype(dtype)` before a dot
// (round_to) keeps every value.
template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// x rounded to T and back: the JAX kernels' `.astype(dtype)` before a dot.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// Rows [r0, r0 + ROWS), columns [c0, c0 + n) of a [seq, d] matrix into
// shared memory as fp32, rows padded to D + 1 (n <= D); rows past `seq` and
// columns past n are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int seq, int d, int c0, int n) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    int r = i / D, c = i % D, g = r0 + r;
    dst[r * (D + 1) + c] =
        g < seq && c < n ? to_float<T>(src[(size_t)g * d + c0 + c]) : 0.f;
  }
}

// Reductions over the 16 lanes that share a row group (lane bits 0-3).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Chunk ch of the head dim: its first column and its width.
__device__ __forceinline__ int chunk_c0(int ch, int w) { return ch * w; }
__device__ __forceinline__ int chunk_n(int ch, int w, int d) {
  return min(w, d - ch * w);
}

// ---------------------------------------------------------------------------
// K1, CUDA cores: forward. o = softmax(q k^T * scale) v, lse = m + log(l).
// One chunk (nc == 1): Q resident. Chunked: Q and K chunks in turn.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int d, int nc, int w, int seq_q,
                 int seq_k, float scale, int causal, int block_q,
                 int block_k) {
  constexpr int LD = D + 1, LP = kTile + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // p rounded to T, [kTile][LP]

  const int n_rows = tiles(seq_q, kTile);
  const int j = blockIdx.x % nc, tile = blockIdx.x / nc;
  const int bh = tile / n_rows, q0 = (tile % n_rows) * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * d, koff = (size_t)bh * seq_k * d;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;
  const int oc0 = chunk_c0(j, w), on = chunk_n(j, w, d);

  if (nc == 1) load_tile<T, D, kTile>(Qs, q + qoff, q0, seq_q, d, 0, d);

  int limit[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = q0 + rg + 16 * i;
    limit[i] = row < seq_q ? keys_visited(row, seq_k, offset, block_q,
                                          block_k, is_causal)
                           : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  // Rows further down visit at least as many keys as rows above them.
  const int k_end = keys_visited(min(q0 + kTile, seq_q) - 1, seq_k, offset,
                                 block_q, block_k, is_causal);
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    float s[4][4] = {};
    for (int ch = 0; ch < nc; ++ch) {
      const int c0 = chunk_c0(ch, w), n = chunk_n(ch, w, d);
      if (nc > 1) load_tile<T, D, kTile>(Qs, q + qoff, q0, seq_q, d, c0, n);
      load_tile<T, D, kTile>(Ks, k + koff, k0, seq_k, d, c0, n);
      if (ch == nc - 1)
        load_tile<T, D, kTile>(Vs, v + koff, k0, seq_k, d, oc0, on);
      __syncthreads();

#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(rg + 16 * i) * LD + c];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) b[jj] = Ks[(cg + 16 * jj) * LD + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            s[i][jj] = fmaf(a[i], b[jj], s[i][jj]);
      }
      if (ch + 1 < nc) __syncthreads();  // the next chunk's loads
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = k0 + cg + 16 * jj;
        float x;
        if (key >= limit[i]) {
          x = -INFINITY;  // not visited by the Pallas kernel: no weight
        } else if (is_causal && row + offset < key) {
          x = kNegInf;
        } else {
          x = s[i][jj] * scale;
        }
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        sum += p;
        Ps[(rg + 16 * i) * LP + cg + 16 * jj] = round_to<T>(p);
      }
      sum = group_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(rg + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * LD + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= seq_q) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = cg + 16 * c;
      if (col < on)
        o[qoff + (size_t)row * d + oc0 + col] = from_float<T>(acc[i][c] / li);
    }
    if (cg == 0 && j == 0) lse[(size_t)bh * seq_q + row] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// K2, CUDA cores: dQ = scale * dS K, dS = p * (dO V^T - delta), p = exp(s - lse).
// TILE rows of Q per block, TILE keys per step. Chunked: the block's own
// chunk last, so that Ks holds it for dS K.
// ---------------------------------------------------------------------------
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int d, int nc, int w, int seq_q, int seq_k, float scale,
                    int causal) {
  constexpr int LD = D + 1, LP = TILE + 1, DC = D / 16, NR = TILE / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + TILE * LD;  // dO
  float* Ks = Gs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ss = Vs + TILE * LD;  // dS rounded to T, [TILE][LP]

  const int n_rows = tiles(seq_q, TILE);
  const int j = blockIdx.x % nc, tile = blockIdx.x / nc;
  const int bh = tile / n_rows, q0 = (tile % n_rows) * TILE;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * d, koff = (size_t)bh * seq_k * d;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;

  if (nc == 1) {
    load_tile<T, D, TILE>(Qs, q + qoff, q0, seq_q, d, 0, d);
    load_tile<T, D, TILE>(Gs, dout + qoff, q0, seq_q, d, 0, d);
  }

  float lse_r[NR], delta_r[NR], acc[NR][DC];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = q0 + rg + 16 * i;
    lse_r[i] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    delta_r[i] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  // Keys past the last row's diagonal have p = 0 for every row of the tile.
  const int last = min(q0 + TILE, seq_q) - 1;
  const int k_end = is_causal ? min(seq_k, max(0, last + offset + 1)) : seq_k;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    float s[NR][NR] = {}, dp[NR][NR] = {};
    for (int ci = 0; ci < nc; ++ci) {
      const int ch = (j + 1 + ci) % nc;
      const int c0 = chunk_c0(ch, w), n = chunk_n(ch, w, d);
      if (nc > 1) {
        load_tile<T, D, TILE>(Qs, q + qoff, q0, seq_q, d, c0, n);
        load_tile<T, D, TILE>(Gs, dout + qoff, q0, seq_q, d, c0, n);
      }
      load_tile<T, D, TILE>(Ks, k + koff, k0, seq_k, d, c0, n);
      load_tile<T, D, TILE>(Vs, v + koff, k0, seq_k, d, c0, n);
      __syncthreads();

#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        float a[NR], g[NR], b[NR], e[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          a[i] = Qs[(rg + 16 * i) * LD + c];
          g[i] = Gs[(rg + 16 * i) * LD + c];
        }
#pragma unroll
        for (int jj = 0; jj < NR; ++jj) {
          b[jj] = Ks[(cg + 16 * jj) * LD + c];
          e[jj] = Vs[(cg + 16 * jj) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < NR; ++i)
#pragma unroll
          for (int jj = 0; jj < NR; ++jj) {
            s[i][jj] = fmaf(a[i], b[jj], s[i][jj]);
            dp[i][jj] = fmaf(g[i], e[jj], dp[i][jj]);
          }
      }
      if (ci + 1 < nc) __syncthreads();  // the next chunk's loads
    }

#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int row = q0 + rg + 16 * i;
#pragma unroll
      for (int jj = 0; jj < NR; ++jj) {
        const int key = k0 + cg + 16 * jj;
        const bool valid = row < seq_q && key < seq_k &&
                           (!is_causal || row + offset >= key);
        const float p = valid ? expf(s[i][jj] * scale - lse_r[i]) : 0.f;
        Ss[(rg + 16 * i) * LP + cg + 16 * jj] =
            round_to<T>(p * (dp[i][jj] - delta_r[i]));
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < TILE; ++kk) {
      float ds[NR], kv[DC];
#pragma unroll
      for (int i = 0; i < NR; ++i) ds[i] = Ss[(rg + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * LD + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
    __syncthreads();
  }

  const int oc0 = chunk_c0(j, w), on = chunk_n(j, w, d);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= seq_q) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = cg + 16 * c;
      if (col < on)
        dq[qoff + (size_t)row * d + oc0 + col] =
            from_float<T>(acc[i][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K3, CUDA cores: dV = P^T dO, dK = scale * dS^T Q, for one K/V tile of
// TILE keys over the Q tiles of TILE rows. One chunk: K and V resident.
// Chunked: the block's own chunk last, so that Qs and Gs hold it.
// ---------------------------------------------------------------------------
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int d, int nc, int w, int seq_q,
                     int seq_k, float scale, int causal) {
  constexpr int LD = D + 1, LP = TILE + 1, DC = D / 16, NR = TILE / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* Gs = Qs + TILE * LD;   // dO
  float* Pt = Gs + TILE * LD;   // P^T rounded to T, [TILE keys][LP]
  float* St = Pt + TILE * LP;   // dS^T rounded to T
  float* Ls = St + TILE * LP;   // lse of the Q tile
  float* Dl = Ls + TILE;        // delta of the Q tile

  const int n_keys = tiles(seq_k, TILE);
  const int j = blockIdx.x % nc, tile = blockIdx.x / nc;
  const int bh = tile / n_keys, k0 = (tile % n_keys) * TILE;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * d, koff = (size_t)bh * seq_k * d;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;

  if (nc == 1) {
    load_tile<T, D, TILE>(Ks, k + koff, k0, seq_k, d, 0, d);
    load_tile<T, D, TILE>(Vs, v + koff, k0, seq_k, d, 0, d);
  }

  float dk_acc[NR][DC], dv_acc[NR][DC];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // Query rows before k0 - offset see no key of this tile.
  const int q_begin = is_causal ? max(0, k0 - offset) : 0;
  for (int q0 = (q_begin / TILE) * TILE; q0 < seq_q; q0 += TILE) {
    float s[NR][NR] = {}, dp[NR][NR] = {};  // [key i][query j]
    for (int ci = 0; ci < nc; ++ci) {
      const int ch = (j + 1 + ci) % nc;
      const int c0 = chunk_c0(ch, w), n = chunk_n(ch, w, d);
      if (nc > 1) {
        load_tile<T, D, TILE>(Ks, k + koff, k0, seq_k, d, c0, n);
        load_tile<T, D, TILE>(Vs, v + koff, k0, seq_k, d, c0, n);
      }
      load_tile<T, D, TILE>(Qs, q + qoff, q0, seq_q, d, c0, n);
      load_tile<T, D, TILE>(Gs, dout + qoff, q0, seq_q, d, c0, n);
      if (ci == 0) {
        for (int i = threadIdx.x; i < TILE; i += kThreads) {
          const int r = q0 + i;
          Ls[i] = r < seq_q ? lse[(size_t)bh * seq_q + r] : 0.f;
          Dl[i] = r < seq_q ? delta[(size_t)bh * seq_q + r] : 0.f;
        }
      }
      __syncthreads();

#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        float a[NR], b[NR], e[NR], g[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          a[i] = Ks[(rg + 16 * i) * LD + c];
          b[i] = Vs[(rg + 16 * i) * LD + c];
        }
#pragma unroll
        for (int jj = 0; jj < NR; ++jj) {
          e[jj] = Qs[(cg + 16 * jj) * LD + c];
          g[jj] = Gs[(cg + 16 * jj) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < NR; ++i)
#pragma unroll
          for (int jj = 0; jj < NR; ++jj) {
            s[i][jj] = fmaf(a[i], e[jj], s[i][jj]);
            dp[i][jj] = fmaf(b[i], g[jj], dp[i][jj]);
          }
      }
      if (ci + 1 < nc) __syncthreads();  // the next chunk's loads
    }

#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int key = k0 + rg + 16 * i;
#pragma unroll
      for (int jj = 0; jj < NR; ++jj) {
        const int qj = cg + 16 * jj, row = q0 + qj;
        const bool valid = row < seq_q && key < seq_k &&
                           (!is_causal || row + offset >= key);
        const float p = valid ? expf(s[i][jj] * scale - Ls[qj]) : 0.f;
        Pt[(rg + 16 * i) * LP + qj] = round_to<T>(p);
        St[(rg + 16 * i) * LP + qj] = round_to<T>(p * (dp[i][jj] - Dl[qj]));
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int qq = 0; qq < TILE; ++qq) {
      float pt[NR], st[NR], g[DC], x[DC];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        pt[i] = Pt[(rg + 16 * i) * LP + qq];
        st[i] = St[(rg + 16 * i) * LP + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        g[c] = Gs[qq * LD + cg + 16 * c];
        x[c] = Qs[qq * LD + cg + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(pt[i], g[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(st[i], x[c], dk_acc[i][c]);
        }
    }
    __syncthreads();
  }

  const int oc0 = chunk_c0(j, w), on = chunk_n(j, w, d);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key >= seq_k) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = cg + 16 * c;
      if (col >= on) continue;
      const size_t at = koff + (size_t)key * d + oc0 + col;
      dk[at] = from_float<T>(dk_acc[i][c] * scale);
      dv[at] = from_float<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host launchers (CUDA cores).
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D> constexpr int bwd_tile() { return D > 128 ? kWideTile : kTile; }

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int block_q, int block_k, const Geometry& g,
                cudaStream_t stream) {
  const size_t smem =
      (3 * kTile * (D + 1) + kTile * (kTile + 1)) * sizeof(float);
  unsigned grid;
  if (!grid_size(tiles(g.seq_q, kTile) * g.n_chunks, g.bh, &grid))
    return cudaErrorInvalidValue;
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, g.d,
      g.n_chunks, g.width, g.seq_q, g.seq_k, g.scale, g.causal, block_q,
      block_k);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Geometry& g, cudaStream_t stream) {
  constexpr int TILE = bwd_tile<D>();
  const size_t smem =
      (4 * TILE * (D + 1) + TILE * (TILE + 1)) * sizeof(float);
  unsigned grid;
  if (!grid_size(tiles(g.seq_q, TILE) * g.n_chunks, g.bh, &grid))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_kernel<T, D, TILE>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, g.d, g.n_chunks,
      g.width, g.seq_q, g.seq_k, g.scale, g.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Geometry& g,
                    cudaStream_t stream) {
  constexpr int TILE = bwd_tile<D>();
  const size_t smem =
      (4 * TILE * (D + 1) + 2 * TILE * (TILE + 1) + 2 * TILE) * sizeof(float);
  unsigned grid;
  if (!grid_size(tiles(g.seq_k, TILE) * g.n_chunks, g.bh, &grid))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_kernel<T, D, TILE>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, g.d,
      g.n_chunks, g.width, g.seq_q, g.seq_k, g.scale, g.causal);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The padded width Dp that
// runs (dtype, d): bf16 and fp16 on the tensor cores, fp32 on the CUDA
// cores. A head above 256 is cut into the fewest chunks of at most 256
// columns, each a multiple of 8 wide but the last (`geo`). 0 where no
// kernel takes the call.
int route(int dtype, int d, Geometry* geo) {
  if (d < 1 || dtype < 0 || dtype > 2) return 0;
  const bool tc = dtype != 0;
  const int nc = (d + kMaxChunk - 1) / kMaxChunk;
  const int w = nc == 1 ? d : ((d + nc - 1) / nc + 7) / 8 * 8;
  geo->d = d;
  geo->n_chunks = nc;
  geo->width = w;
  if (tc) return w <= 64 ? 64 : w <= 128 ? 128 : w <= 192 ? 192 : 256;
  return w <= 16 ? 16 : w <= 32 ? 32 : w <= 64 ? 64 : w <= 128 ? 128 : 256;
}

}  // namespace

#define RTT_CASE(FN, T, DP, ...) \
  case DP: return (int)FN<T, DP>(__VA_ARGS__, geo, s);

// The instances: tensor cores for bf16 and fp16 at Dp 64-256 (the part
// files), CUDA cores for fp32 at every Dp (this file).
#define RTT_DISPATCH(FN, ...)                                              \
  do {                                                                     \
    Geometry geo{0, 0, 0, bh, seq_q, seq_k, sm_scale, causal};             \
    const int dp = route(dtype, head_dim, &geo);                           \
    if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || dp == 0)                    \
      return (int)cudaErrorInvalidValue;                                   \
    cudaStream_t s = (cudaStream_t)stream;                                 \
    if (dtype == 1) {                                                      \
      switch (dp) {                                                        \
        RTT_CASE(rtt::tc::FN, __nv_bfloat16, 64, __VA_ARGS__)              \
        RTT_CASE(rtt::tc::FN, __nv_bfloat16, 128, __VA_ARGS__)             \
        RTT_CASE(rtt::tc::FN, __nv_bfloat16, 192, __VA_ARGS__)             \
        RTT_CASE(rtt::tc::FN, __nv_bfloat16, 256, __VA_ARGS__)             \
      }                                                                    \
    } else if (dtype == 2) {                                               \
      switch (dp) {                                                        \
        RTT_CASE(rtt::tc::FN, __half, 64, __VA_ARGS__)                     \
        RTT_CASE(rtt::tc::FN, __half, 128, __VA_ARGS__)                    \
        RTT_CASE(rtt::tc::FN, __half, 192, __VA_ARGS__)                    \
        RTT_CASE(rtt::tc::FN, __half, 256, __VA_ARGS__)                    \
      }                                                                    \
    } else {                                                               \
      switch (dp) {                                                        \
        RTT_CASE(FN, float, 16, __VA_ARGS__)                               \
        RTT_CASE(FN, float, 32, __VA_ARGS__)                               \
        RTT_CASE(FN, float, 64, __VA_ARGS__)                               \
        RTT_CASE(FN, float, 128, __VA_ARGS__)                              \
        RTT_CASE(FN, float, 256, __VA_ARGS__)                              \
      }                                                                    \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

extern "C" {

// The route of (dtype, head_dim), as in `route`: out[0] 1 for the tensor
// cores, 0 for the CUDA cores; out[1] the padded width; out[2] the head-dim
// chunks. Returns 0 where no kernel takes the call, else 1.
int rtt_flash_route(int dtype, int head_dim, int* out) {
  Geometry geo{};
  const int dp = route(dtype, head_dim, &geo);
  if (dp == 0) return 0;
  out[0] = dtype != 0;
  out[1] = dp;
  out[2] = geo.n_chunks;
  return 1;
}

int rtt_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, void* o, void* lse, int bh, int seq_q,
                  int seq_k, float sm_scale, int causal, int block_q,
                  int block_k, void* stream) {
  if (block_q <= 0 || block_k <= 0) return (int)cudaErrorInvalidValue;
  RTT_DISPATCH(fwd, q, k, v, o, lse, block_q, block_k);
}

int rtt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* dout, const void* lse,
                     const void* delta, void* dq, int bh, int seq_q,
                     int seq_k, float sm_scale, int causal, void* stream) {
  RTT_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq);
}

int rtt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                      const void* v, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, int bh,
                      int seq_q, int seq_k, float sm_scale, int causal,
                      void* stream) {
  RTT_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv);
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
