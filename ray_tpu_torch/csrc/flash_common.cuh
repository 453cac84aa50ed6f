// What the flash-attention kernels of flash_attention.cu share: the masking
// contract of ray_tpu/ops/attention.py, independent of how a kernel tiles.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace rtt
