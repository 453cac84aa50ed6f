// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas kernels of ray_tpu/ops/attention.py:
//   K1 forward  <- _flash_kernel          (attention.py:53)
//   K2 dQ       <- _flash_bwd_dq_kernel   (attention.py:146)
//   K3 dK/dV    <- _flash_bwd_dkv_kernel  (attention.py:199)
// and computes what they compute, not how they tile it:
//   * layouts q [BH, Sq, D], k/v [BH, Sk, D], lse/delta [BH, Sq] fp32;
//   * causal masking aligned bottom-right (offset = Sk - Sq), masked logits
//     set to the same finite NEG_INF = -1e30 as the JAX kernels, so a row
//     whose visited keys are all masked gets p = 1 on each of them in the
//     forward (mean of V) exactly as _flash_kernel does, and the backward
//     kernels force p to 0 on masked entries (attention.py:178-181,
//     :231-233);
//   * the forward visits, per row, the keys of the whole block_k blocks up
//     to its block_q block's diagonal (attention.py:101-106), so the Python
//     block sizes are arguments here although the kernels tile by 64;
//   * dot inputs are rounded to the input type (bf16 or fp32) and products
//     accumulate in fp32; p is rounded to v's type before P.V, against the
//     running max after each 64-key tile, and P / dS to the input type
//     before dS.K, P^T.dO and dS^T.Q (attention.py:93, :186, :240); the
//     softmax runs in fp32 and lse is in natural-log units.
//
// Two designs, picked by a fixed dispatch on dtype and head dim (below):
//
//   * bf16 at head dim 64 or 128, K1, K2 and K3 (flash_wgmma.cuh): one
//     warpgroup per 64-row tile, every product a bf16 `wgmma` with fp32
//     accumulators, tiles bf16 in 128-byte-swizzled shared memory filled
//     by cp.async through a 2-stage ring, P and dS fed to the last
//     product from registers.
//   * fp32, and bf16 at head dims 16 and 32 (this file): 256 threads per
//     (bh, 64-row tile), products as fp32 FMAs on the CUDA cores from
//     tiles widened to fp32 in shared memory (rows padded to D + 1
//     floats), loads synchronous. fp32 stays here because tensor cores
//     would round its operands to TF32; bf16 at head dims 16 and 32 is off
//     the main path.
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
// product, only the other blocks on the SM do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
constexpr int kThreads = 256;      // 16 x 16

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to T and back: the JAX kernels' `.astype(dtype)` before a dot.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// Rows [r0, r0 + kTile) of a [seq, D] matrix into shared memory as fp32,
// rows padded to D + 1; rows past `seq` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int seq) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    int r = i / D, c = i % D, g = r0 + r;
    dst[r * (D + 1) + c] = g < seq ? to_float<T>(src[(size_t)g * D + c]) : 0.f;
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

// ---------------------------------------------------------------------------
// K1, CUDA cores: forward. o = softmax(q k^T * scale) v, lse = m + log(l).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq_q, int seq_k, float scale,
                 int causal, int block_q, int block_k) {
  constexpr int LD = D + 1, LP = kTile + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // p rounded to T, [kTile][LP]

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * D, koff = (size_t)bh * seq_k * D;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;

  load_tile<T, D>(Qs, q + qoff, q0, seq_q);

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
    load_tile<T, D>(Ks, k + koff, k0, seq_k);
    load_tile<T, D>(Vs, v + koff, k0, seq_k);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(rg + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(cg + 16 * j) * LD + d];
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
    for (int c = 0; c < DC; ++c)
      o[qoff + (size_t)row * D + cg + 16 * c] = from_float<T>(acc[i][c] / li);
    if (cg == 0) lse[(size_t)bh * seq_q + row] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// K2, CUDA cores: dQ = scale * dS K, dS = p * (dO V^T - delta), p = exp(s - lse).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int seq_q, int seq_k, float scale, int causal) {
  constexpr int LD = D + 1, LP = kTile + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kTile * LD;  // dO
  float* Ks = Gs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ss = Vs + kTile * LD;  // dS rounded to T, [kTile][LP]

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * D, koff = (size_t)bh * seq_k * D;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;

  load_tile<T, D>(Qs, q + qoff, q0, seq_q);
  load_tile<T, D>(Gs, dout + qoff, q0, seq_q);

  float lse_r[4], delta_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    lse_r[i] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    delta_r[i] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  // Keys past the last row's diagonal have p = 0 for every row of the tile.
  const int last = min(q0 + kTile, seq_q) - 1;
  const int k_end = is_causal ? min(seq_k, max(0, last + offset + 1)) : seq_k;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    load_tile<T, D>(Ks, k + koff, k0, seq_k);
    load_tile<T, D>(Vs, v + koff, k0, seq_k);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], b[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(rg + 16 * i) * LD + d];
        g[i] = Gs[(rg + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Ks[(cg + 16 * j) * LD + d];
        c[j] = Vs[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], c[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
    for (int kk = 0; kk < kTile; ++kk) {
      float ds[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(rg + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * LD + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= seq_q) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[qoff + (size_t)row * D + cg + 16 * c] =
          from_float<T>(acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// K3, CUDA cores: dV = P^T dO, dK = scale * dS^T Q, for one K/V tile over
// the Q tiles.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int seq_q, int seq_k, float scale,
                     int causal) {
  constexpr int LD = D + 1, LP = kTile + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* Gs = Qs + kTile * LD;   // dO
  float* Pt = Gs + kTile * LD;   // P^T rounded to T, [kTile keys][LP]
  float* St = Pt + kTile * LP;   // dS^T rounded to T
  float* Ls = St + kTile * LP;   // lse of the Q tile
  float* Dl = Ls + kTile;        // delta of the Q tile

  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * seq_q * D, koff = (size_t)bh * seq_k * D;
  const int offset = seq_k - seq_q;
  const bool is_causal = causal != 0;

  load_tile<T, D>(Ks, k + koff, k0, seq_k);
  load_tile<T, D>(Vs, v + koff, k0, seq_k);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // Query rows before k0 - offset see no key of this tile.
  const int q_begin = is_causal ? max(0, k0 - offset) : 0;
  for (int q0 = (q_begin / kTile) * kTile; q0 < seq_q; q0 += kTile) {
    load_tile<T, D>(Qs, q + qoff, q0, seq_q);
    load_tile<T, D>(Gs, dout + qoff, q0, seq_q);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int r = q0 + i;
      Ls[i] = r < seq_q ? lse[(size_t)bh * seq_q + r] : 0.f;
      Dl[i] = r < seq_q ? delta[(size_t)bh * seq_q + r] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};  // [key i][query j]
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], c[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Ks[(rg + 16 * i) * LD + d];
        b[i] = Vs[(rg + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = Qs[(cg + 16 * j) * LD + d];
        g[j] = Gs[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(b[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
    for (int qq = 0; qq < kTile; ++qq) {
      float pt[4], st[4], g[DC], x[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = Pt[(rg + 16 * i) * LP + qq];
        st[i] = St[(rg + 16 * i) * LP + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        g[c] = Gs[qq * LD + cg + 16 * c];
        x[c] = Qs[qq * LD + cg + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(pt[i], g[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(st[i], x[c], dk_acc[i][c]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key >= seq_k) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t at = koff + (size_t)key * D + cg + 16 * c;
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

inline int tiles(int n) { return (n + kTile - 1) / kTile; }

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int seq_q, int seq_k, float scale,
                int causal, int block_q, int block_k, cudaStream_t stream) {
  const size_t smem =
      (3 * kTile * (D + 1) + kTile * (kTile + 1)) * sizeof(float);
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<dim3(tiles(seq_q), bh), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, seq_q, seq_k,
      scale, causal, block_q, block_k);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int seq_q, int seq_k, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem =
      (4 * kTile * (D + 1) + kTile * (kTile + 1)) * sizeof(float);
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D>
      <<<dim3(tiles(seq_q), bh), kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
          (const float*)lse, (const float*)delta, (T*)dq, seq_q, seq_k, scale,
          causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int seq_q, int seq_k,
                    float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile) *
      sizeof(float);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D>
      <<<dim3(tiles(seq_k), bh), kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
          (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, seq_q, seq_k,
          scale, causal);
  return cudaGetLastError();
}

// Tensor-core launchers (bf16, head dim 64 or 128). cp.async moves 16-byte
// chunks, so q, k, v and dO must start on a 16-byte boundary; the outputs
// are held to the same.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <int D>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq_q, int seq_k, float scale,
                   int causal, int block_q, int block_k, cudaStream_t stream) {
  if (!aligned16({q, k, v, o})) return cudaErrorMisalignedAddress;
  auto kernel = rtt::tc::flash_fwd_tc_kernel<D>;
  const size_t smem = rtt::tc::fwd_smem_bytes<D>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(seq_q), bh), rtt::tc::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, seq_q, seq_k,
      scale, causal, block_q, block_k);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int seq_q, int seq_k, float scale,
                      int causal, cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dq})) return cudaErrorMisalignedAddress;
  auto kernel = rtt::tc::flash_bwd_dq_tc_kernel<D>;
  const size_t smem = rtt::tc::dq_smem_bytes<D>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(seq_q), bh), rtt::tc::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq, seq_q,
      seq_k, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int seq_q, int seq_k,
                       float scale, int causal, cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dk, dv})) return cudaErrorMisalignedAddress;
  auto kernel = rtt::tc::flash_bwd_dkv_tc_kernel<D>;
  const size_t smem = rtt::tc::dkv_smem_bytes<D>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(seq_k), bh), rtt::tc::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, seq_q, seq_k, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim in {16, 32, 64, 128}. TC_FN
// is the tensor-core design for bf16 at head dims 64 and 128; everything
// else runs FN, the CUDA-core design.
#define RTT_DISPATCH(FN, TC_FN, ...)                                       \
  do {                                                                     \
    if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || bh > 65535)                 \
      return (int)cudaErrorInvalidValue;                                   \
    cudaStream_t s = (cudaStream_t)stream;                                 \
    if (dtype == 0) {                                                      \
      switch (head_dim) {                                                  \
        case 16: return (int)FN<float, 16>(__VA_ARGS__, s);                \
        case 32: return (int)FN<float, 32>(__VA_ARGS__, s);                \
        case 64: return (int)FN<float, 64>(__VA_ARGS__, s);                \
        case 128: return (int)FN<float, 128>(__VA_ARGS__, s);              \
      }                                                                    \
    } else if (dtype == 1) {                                               \
      switch (head_dim) {                                                  \
        case 16: return (int)FN<__nv_bfloat16, 16>(__VA_ARGS__, s);        \
        case 32: return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__, s);        \
        case 64: return (int)TC_FN<64>(__VA_ARGS__, s);                    \
        case 128: return (int)TC_FN<128>(__VA_ARGS__, s);                  \
      }                                                                    \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

extern "C" {

int rtt_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, void* o, void* lse, int bh, int seq_q,
                  int seq_k, float sm_scale, int causal, int block_q,
                  int block_k, void* stream) {
  if (block_q <= 0 || block_k <= 0) return (int)cudaErrorInvalidValue;
  RTT_DISPATCH(fwd, fwd_tc, q, k, v, o, lse, bh, seq_q, seq_k, sm_scale, causal,
               block_q, block_k);
}

int rtt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* dout, const void* lse,
                     const void* delta, void* dq, int bh, int seq_q,
                     int seq_k, float sm_scale, int causal, void* stream) {
  RTT_DISPATCH(bwd_dq, bwd_dq_tc, q, k, v, dout, lse, delta, dq, bh, seq_q,
               seq_k, sm_scale, causal);
}

int rtt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                      const void* v, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, int bh,
                      int seq_q, int seq_k, float sm_scale, int causal,
                      void* stream) {
  RTT_DISPATCH(bwd_dkv, bwd_dkv_tc, q, k, v, dout, lse, delta, dk, dv, bh,
               seq_q, seq_k, sm_scale, causal);
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
