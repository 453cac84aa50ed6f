// What the flash-attention kernels of flash_attention.cu and its
// tensor-core parts share: the masking contract of
// ray_tpu/ops/attention.py, independent of how a kernel tiles, the shape of
// a call, and the tensor-core launchers that each part file instantiates.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace rtt {

constexpr float kNegInf = -1e30f;  // NEG_INF of ray_tpu/ops/attention.py

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Keys that _flash_kernel visits for query `row`: whole block_k blocks up
// to the diagonal of the row's block of block_q rows (attention.py:101-106).
__device__ __forceinline__ int keys_visited(int row, int seq_k, int offset,
                                            int block_q, int block_k,
                                            bool causal) {
  if (!causal) return seq_k;
  int qb = row / block_q;
  int nb = floor_div((qb + 1) * block_q + offset + block_k - 1, block_k);
  return min(seq_k, max(0, nb * block_k));
}

__host__ __device__ __forceinline__ int tiles(int n, int rows) {
  return (n + rows - 1) / rows;
}

// One block per (bh, row tile, head-dim chunk) on blockIdx.x, which holds
// up to 2^31 - 1.
inline bool grid_size(int row_tiles, int bh, unsigned* grid) {
  const long long n = (long long)row_tiles * bh;
  if (n > INT_MAX) return false;
  *grid = (unsigned)n;
  return true;
}

// A call's shape. The head dim d is cut into n_chunks chunks of `width`
// columns (the last one the rest); one chunk of d (width d) below 257.
struct Geometry {
  int d, n_chunks, width, bh, seq_q, seq_k;
  float scale;
  int causal;
};

namespace tc {

// Tensor-core launchers (flash_wgmma.cuh), T __nv_bfloat16 or __half and D
// 64, 128, 192 or 256, each (T, D) instantiated in a part file of its own.
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int block_q, int block_k, const Geometry& geo,
                cudaStream_t stream);
template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Geometry& geo, cudaStream_t stream);
template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Geometry& geo,
                    cudaStream_t stream);

}  // namespace tc
}  // namespace rtt
