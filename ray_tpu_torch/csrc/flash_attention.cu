// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas kernels of ray_tpu/ops/attention.py:
//   K1 forward  <- _flash_kernel          (attention.py:53)
//   K2 dQ       <- _flash_bwd_dq_kernel   (attention.py:146)
//   K3 dK/dV    <- _flash_bwd_dkv_kernel  (attention.py:199)
// and computes what they compute, not how they tile it:
//   * layouts q [BH, Sq, D], k/v [BH, Sk, D], lse/delta [BH, Sq] fp32;
//   * any head dim D from 1 to 256 and any B·H, in fp32, bf16 and fp16,
//     as the Pallas kernels take any D (their BlockSpecs hold the whole of
//     it) and any grid;
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
// Each kernel is compiled at a few head dims Dp (16, 32, 64, 128, 256) and
// takes the true head dim d <= Dp at run time: it reads columns below d,
// fills columns d..Dp of its shared-memory tiles with zeros, and writes
// columns below d. A zero column adds nothing to Q K^T or dO V^T, and the
// columns of P V, dS K, P^T dO and dS^T Q below d do not read the columns
// above it, so the padded product is the true one. B·H and the row tiles
// share blockIdx.x, B·H outermost, so the grid has no 65535 cap on B·H.
//
// Two designs, picked by `route` below from the dtype and head dim:
//
//   * bf16 at 33 <= d <= 128, K1, K2 and K3 (flash_wgmma.cuh), padded to
//     Dp 64 or 128: one warpgroup per 64-row tile, every product a bf16
//     `wgmma` with fp32 accumulators, tiles bf16 in 128-byte-swizzled
//     shared memory filled by cp.async through a 2-stage ring, P and dS
//     fed to the last product from registers.
//   * everything else (this file): fp32 and fp16 at every d, bf16 at d <=
//     32 and 129 <= d <= 256. 256 threads per (bh, row tile), products as
//     fp32 FMAs on the CUDA cores from tiles widened to fp32 in shared
//     memory (rows padded to Dp + 1 floats), loads synchronous. Row tiles
//     are 64, and 32 for K2 and K3 at Dp 256, whose 64-row tiles would
//     need more than the 227 KB of shared memory a block may opt in to.
//     fp32 stays here because tensor cores would round its operands to
//     TF32; fp16 takes the design templated on the element type; these
//     widths are off the main path.
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
// products over the zero columns (d 80 on Dp 128: 37.5%).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using rtt::keys_visited;
using rtt::kNegInf;

constexpr int kTile = 64;          // rows of Q and of K/V per tile, keys per
                                   // step of the forward
constexpr int kWideTile = 32;      // rows per tile of K2 and K3 at Dp 256
constexpr int kThreads = 256;      // 16 x 16

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back: the JAX kernels' `.astype(dtype)` before a dot.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// Rows [r0, r0 + ROWS) of a [seq, d] matrix into shared memory as fp32,
// rows padded to D + 1; rows past `seq` and columns past `d` are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int seq, int d) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    int r = i / D, c = i % D, g = r0 + r;
    dst[r * (D + 1) + c] =
        g < seq && c < d ? to_float<T>(src[(size_t)g * d + c]) : 0.f;
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

__host__ __device__ __forceinline__ int tiles(int n, int rows) {
  return (n + rows - 1) / rows;
}

// ---------------------------------------------------------------------------
// K1, CUDA cores: forward. o = softmax(q k^T * scale) v, lse = m + log(l).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int d, int seq_q, int seq_k,
                 float scale, int causal, int block_q, int block_k) {
  constexpr int LD = D + 1, LP = kTile + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // p rounded to T, [kTile][LP]

  const int n_rows = tiles(seq_q, kTile);
  const int bh = blockIdx.x / n_rows, q0 = (blockIdx.x % n_rows) * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * d, koff = (size_t)bh * seq_k * d;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;

  load_tile<T, D, kTile>(Qs, q + qoff, q0, seq_q, d);

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
    load_tile<T, D, kTile>(Ks, k + koff, k0, seq_k, d);
    load_tile<T, D, kTile>(Vs, v + koff, k0, seq_k, d);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 16
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(rg + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(cg + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + cg + 16 * j;
        float x;
        if (key >= limit[i]) {
          x = -INFINITY;  // not visited by the Pallas kernel: no weight
        } else if (is_causal && row + offset < key) {
          x = kNegInf;
        } else {
          x = s[i][j] * scale;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(rg + 16 * i) * LP + cg + 16 * j] = round_to<T>(p);
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
      if (col < d)
        o[qoff + (size_t)row * d + col] = from_float<T>(acc[i][c] / li);
    }
    if (cg == 0) lse[(size_t)bh * seq_q + row] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// K2, CUDA cores: dQ = scale * dS K, dS = p * (dO V^T - delta), p = exp(s - lse).
// TILE rows of Q per block, TILE keys per step.
// ---------------------------------------------------------------------------
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int d, int seq_q, int seq_k, float scale, int causal) {
  constexpr int LD = D + 1, LP = TILE + 1, DC = D / 16, NR = TILE / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + TILE * LD;  // dO
  float* Ks = Gs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ss = Vs + TILE * LD;  // dS rounded to T, [TILE][LP]

  const int n_rows = tiles(seq_q, TILE);
  const int bh = blockIdx.x / n_rows, q0 = (blockIdx.x % n_rows) * TILE;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * d, koff = (size_t)bh * seq_k * d;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;

  load_tile<T, D, TILE>(Qs, q + qoff, q0, seq_q, d);
  load_tile<T, D, TILE>(Gs, dout + qoff, q0, seq_q, d);

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
    load_tile<T, D, TILE>(Ks, k + koff, k0, seq_k, d);
    load_tile<T, D, TILE>(Vs, v + koff, k0, seq_k, d);
    __syncthreads();

    float s[NR][NR] = {}, dp[NR][NR] = {};
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[NR], g[NR], b[NR], e[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        a[i] = Qs[(rg + 16 * i) * LD + c];
        g[i] = Gs[(rg + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        b[j] = Ks[(cg + 16 * j) * LD + c];
        e[j] = Vs[(cg + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], e[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int row = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int key = k0 + cg + 16 * j;
        const bool valid = row < seq_q && key < seq_k &&
                           (!is_causal || row + offset >= key);
        const float p = valid ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        Ss[(rg + 16 * i) * LP + cg + 16 * j] =
            round_to<T>(p * (dp[i][j] - delta_r[i]));
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

#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= seq_q) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = cg + 16 * c;
      if (col < d)
        dq[qoff + (size_t)row * d + col] = from_float<T>(acc[i][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K3, CUDA cores: dV = P^T dO, dK = scale * dS^T Q, for one K/V tile of
// TILE keys over the Q tiles of TILE rows.
// ---------------------------------------------------------------------------
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int d, int seq_q, int seq_k,
                     float scale, int causal) {
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
  const int bh = blockIdx.x / n_keys, k0 = (blockIdx.x % n_keys) * TILE;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * d, koff = (size_t)bh * seq_k * d;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;

  load_tile<T, D, TILE>(Ks, k + koff, k0, seq_k, d);
  load_tile<T, D, TILE>(Vs, v + koff, k0, seq_k, d);

  float dk_acc[NR][DC], dv_acc[NR][DC];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // Query rows before k0 - offset see no key of this tile.
  const int q_begin = is_causal ? max(0, k0 - offset) : 0;
  for (int q0 = (q_begin / TILE) * TILE; q0 < seq_q; q0 += TILE) {
    load_tile<T, D, TILE>(Qs, q + qoff, q0, seq_q, d);
    load_tile<T, D, TILE>(Gs, dout + qoff, q0, seq_q, d);
    for (int i = threadIdx.x; i < TILE; i += kThreads) {
      const int r = q0 + i;
      Ls[i] = r < seq_q ? lse[(size_t)bh * seq_q + r] : 0.f;
      Dl[i] = r < seq_q ? delta[(size_t)bh * seq_q + r] : 0.f;
    }
    __syncthreads();

    float s[NR][NR] = {}, dp[NR][NR] = {};  // [key i][query j]
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[NR], b[NR], e[NR], g[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        a[i] = Ks[(rg + 16 * i) * LD + c];
        b[i] = Vs[(rg + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        e[j] = Qs[(cg + 16 * j) * LD + c];
        g[j] = Gs[(cg + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          s[i][j] = fmaf(a[i], e[j], s[i][j]);
          dp[i][j] = fmaf(b[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int key = k0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int qj = cg + 16 * j, row = q0 + qj;
        const bool valid = row < seq_q && key < seq_k &&
                           (!is_causal || row + offset >= key);
        const float p = valid ? expf(s[i][j] * scale - Ls[qj]) : 0.f;
        Pt[(rg + 16 * i) * LP + qj] = round_to<T>(p);
        St[(rg + 16 * i) * LP + qj] = round_to<T>(p * (dp[i][j] - Dl[qj]));
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

#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key >= seq_k) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = cg + 16 * c;
      if (col >= d) continue;
      const size_t at = koff + (size_t)key * d + col;
      dk[at] = from_float<T>(dk_acc[i][c] * scale);
      dv[at] = from_float<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host launchers.
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// One block per (bh, row tile) on blockIdx.x, which holds up to 2^31 - 1.
inline bool grid_size(int row_tiles, int bh, unsigned* grid) {
  const long long n = (long long)row_tiles * bh;
  if (n > INT_MAX) return false;
  *grid = (unsigned)n;
  return true;
}

template <int D> constexpr int bwd_tile() { return D > 128 ? kWideTile : kTile; }

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int d, int bh, int seq_q, int seq_k, float scale,
                int causal, int block_q, int block_k, cudaStream_t stream) {
  const size_t smem =
      (3 * kTile * (D + 1) + kTile * (kTile + 1)) * sizeof(float);
  unsigned grid;
  if (!grid_size(tiles(seq_q, kTile), bh, &grid)) return cudaErrorInvalidValue;
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, d, seq_q,
      seq_k, scale, causal, block_q, block_k);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int d, int bh, int seq_q, int seq_k, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int TILE = bwd_tile<D>();
  const size_t smem =
      (4 * TILE * (D + 1) + TILE * (TILE + 1)) * sizeof(float);
  unsigned grid;
  if (!grid_size(tiles(seq_q, TILE), bh, &grid)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_kernel<T, D, TILE>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, d, seq_q, seq_k, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int d, int bh, int seq_q, int seq_k,
                    float scale, int causal, cudaStream_t stream) {
  constexpr int TILE = bwd_tile<D>();
  const size_t smem =
      (4 * TILE * (D + 1) + 2 * TILE * (TILE + 1) + 2 * TILE) * sizeof(float);
  unsigned grid;
  if (!grid_size(tiles(seq_k, TILE), bh, &grid)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_kernel<T, D, TILE>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, d, seq_q, seq_k,
      scale, causal);
  return cudaGetLastError();
}

// Tensor-core launchers (bf16, Dp 64 or 128). cp.async moves 16-byte
// chunks, so q, k, v and dO must start on a 16-byte boundary; the outputs
// are held to the same.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <int D>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o,
                   void* lse, int d, int bh, int seq_q, int seq_k,
                   float scale, int causal, int block_q, int block_k,
                   cudaStream_t stream) {
  if (!aligned16({q, k, v, o})) return cudaErrorMisalignedAddress;
  unsigned grid;
  if (!grid_size(tiles(seq_q, rtt::tc::kRows), bh, &grid))
    return cudaErrorInvalidValue;
  auto kernel = d == D ? rtt::tc::flash_fwd_tc_kernel<D, false>
                       : rtt::tc::flash_fwd_tc_kernel<D, true>;
  const size_t smem = rtt::tc::fwd_smem_bytes<D>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, rtt::tc::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, d, seq_q,
      seq_k, scale, causal, block_q, block_k);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int d, int bh, int seq_q, int seq_k,
                      float scale, int causal, cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dq})) return cudaErrorMisalignedAddress;
  unsigned grid;
  if (!grid_size(tiles(seq_q, rtt::tc::kRows), bh, &grid))
    return cudaErrorInvalidValue;
  auto kernel = d == D ? rtt::tc::flash_bwd_dq_tc_kernel<D, false>
                       : rtt::tc::flash_bwd_dq_tc_kernel<D, true>;
  const size_t smem = rtt::tc::dq_smem_bytes<D>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, rtt::tc::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq, d, seq_q,
      seq_k, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int d, int bh, int seq_q,
                       int seq_k, float scale, int causal,
                       cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dk, dv})) return cudaErrorMisalignedAddress;
  unsigned grid;
  if (!grid_size(tiles(seq_k, rtt::tc::kRows), bh, &grid))
    return cudaErrorInvalidValue;
  auto kernel = d == D ? rtt::tc::flash_bwd_dkv_tc_kernel<D, false>
                       : rtt::tc::flash_bwd_dkv_tc_kernel<D, true>;
  const size_t smem = rtt::tc::dkv_smem_bytes<D>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, rtt::tc::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, d, seq_q, seq_k, scale, causal);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The design and padded
// head dim Dp that run (dtype, d): Dp for the CUDA-core kernels, -Dp for
// the tensor-core ones, 0 where no kernel takes them (d outside 1..256).
int route(int dtype, int d) {
  if (d < 1 || d > 256 || dtype < 0 || dtype > 2) return 0;
  const int dp = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
               : d <= 128 ? 128 : 256;
  return dtype == 1 && (dp == 64 || dp == 128) ? -dp : dp;
}

}  // namespace

#define RTT_CC_CASE(FN, T, DP, ...) \
  case DP: return (int)FN<T, DP>(__VA_ARGS__, s);

// bf16 at Dp 64 and 128 is the tensor cores' (route), so its CUDA-core
// kernels are compiled at Dp 16, 32 and 256 only.
#define RTT_DISPATCH(FN, TC_FN, ...)                                       \
  do {                                                                     \
    if (bh <= 0 || seq_q <= 0 || seq_k <= 0)                               \
      return (int)cudaErrorInvalidValue;                                   \
    const int r = route(dtype, head_dim);                                  \
    cudaStream_t s = (cudaStream_t)stream;                                 \
    if (r == -64) return (int)TC_FN<64>(__VA_ARGS__, s);                   \
    if (r == -128) return (int)TC_FN<128>(__VA_ARGS__, s);                 \
    if (dtype == 0) {                                                      \
      switch (r) {                                                         \
        RTT_CC_CASE(FN, float, 16, __VA_ARGS__)                            \
        RTT_CC_CASE(FN, float, 32, __VA_ARGS__)                            \
        RTT_CC_CASE(FN, float, 64, __VA_ARGS__)                            \
        RTT_CC_CASE(FN, float, 128, __VA_ARGS__)                           \
        RTT_CC_CASE(FN, float, 256, __VA_ARGS__)                           \
      }                                                                    \
    } else if (dtype == 1) {                                               \
      switch (r) {                                                         \
        RTT_CC_CASE(FN, __nv_bfloat16, 16, __VA_ARGS__)                    \
        RTT_CC_CASE(FN, __nv_bfloat16, 32, __VA_ARGS__)                    \
        RTT_CC_CASE(FN, __nv_bfloat16, 256, __VA_ARGS__)                   \
      }                                                                    \
    } else if (dtype == 2) {                                               \
      switch (r) {                                                         \
        RTT_CC_CASE(FN, __half, 16, __VA_ARGS__)                           \
        RTT_CC_CASE(FN, __half, 32, __VA_ARGS__)                           \
        RTT_CC_CASE(FN, __half, 64, __VA_ARGS__)                           \
        RTT_CC_CASE(FN, __half, 128, __VA_ARGS__)                          \
        RTT_CC_CASE(FN, __half, 256, __VA_ARGS__)                          \
      }                                                                    \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

extern "C" {

int rtt_flash_route(int dtype, int head_dim) { return route(dtype, head_dim); }

int rtt_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, void* o, void* lse, int bh, int seq_q,
                  int seq_k, float sm_scale, int causal, int block_q,
                  int block_k, void* stream) {
  if (block_q <= 0 || block_k <= 0) return (int)cudaErrorInvalidValue;
  RTT_DISPATCH(fwd, fwd_tc, q, k, v, o, lse, head_dim, bh, seq_q, seq_k,
               sm_scale, causal, block_q, block_k);
}

int rtt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* dout, const void* lse,
                     const void* delta, void* dq, int bh, int seq_q,
                     int seq_k, float sm_scale, int causal, void* stream) {
  RTT_DISPATCH(bwd_dq, bwd_dq_tc, q, k, v, dout, lse, delta, dq, head_dim,
               bh, seq_q, seq_k, sm_scale, causal);
}

int rtt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                      const void* v, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, int bh,
                      int seq_q, int seq_k, float sm_scale, int causal,
                      void* stream) {
  RTT_DISPATCH(bwd_dkv, bwd_dkv_tc, q, k, v, dout, lse, delta, dk, dv,
               head_dim, bh, seq_q, seq_k, sm_scale, causal);
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
