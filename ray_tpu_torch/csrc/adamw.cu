// AdamW's update for many fp32 leaves in one launch (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's optimizer is optax's adamw
// (ray_tpu/train/train_step.py), which XLA fuses into the step. Its
// counterpart, ray_tpu_torch/train/train_step.py `AdamW.update_plain`, is
// about 18 elementwise PyTorch kernels a leaf, each a pass over device
// memory: about 164 bytes a parameter.
//
// What bounds it: bytes. Each element reads p, g, mu and nu once and writes
// p, mu and nu once, all fp32 (g may be bf16 or fp16): 28 bytes a parameter,
// 78.3 GB a step for StableLM-3B's 2.80 B parameters, 23.4 ms at 3.35 TB/s.
// The design makes that one pass: a block loads its elements of the four
// arrays as 16-byte vectors (8 bytes for a 2-byte g), all before any
// arithmetic, computes in registers and stores the three results; loads and
// stores are marked streaming, as nothing is read twice.
//
// Many leaves a launch: the table of leaves (four pointers, the element
// count and g's type each) travels in the launch's parameters, up to
// kMaxLeaves of them in the 32,764 bytes that CUDA 12.1+ allows on
// Volta and later, so the host copies nothing to the card and waits on
// nothing; a leaf set larger than that takes more launches (the caller
// plans them, ray_tpu_torch/ops/adamw.py). Blocks walk one flat index space
// over the leaves: each leaf is cut into chunks of kChunk elements, block b
// takes chunk b of the concatenation, found by a binary search over the
// table's running chunk counts. A chunk of a leaf whose four pointers are
// aligned for the vectors runs vectorised; a leaf's last, partial chunk, and
// every chunk of a leaf that is not aligned (a view at an odd offset into a
// flat buffer), run one element a thread.
//
// The arithmetic is the plain version's on the card, rounded at the same
// points, so the two agree bit for bit: each product rounded before its sum
// (no fused multiply-add: the __f*_rn intrinsics are never contracted), a
// division by a Python scalar done as PyTorch's CUDA `div` does it, as a
// product with the scalar's reciprocal rounded to fp32 (computed on the
// host; for bc1 and bc2, which are fp32 values, the fp32 quotient 1/bc),
// and the division of two tensors and the square root IEEE-rounded. With
// c1 = fp32(1 - b1), c2 = fp32(1 - b2), r1 = 1/fp32(bc1), r2 = 1/fp32(bc2):
//   mu' = g c1 + mu b1
//   nu' = (g g) c2 + nu b2
//   u   = (mu' r1) / (sqrt(nu' r2) + eps) + p wd
//   p'  = p + u (-lr)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 720;    // ray_tpu_torch/ops/adamw.py MAX_LEAVES
constexpr int kThreads = 256;
constexpr int kVec = 4;            // elements of a vector: 16 bytes of fp32
constexpr int kVecs = 2;           // vectors of each array a thread
constexpr int kChunk = kThreads * kVec * kVecs;   // elements a block

// The launch's one parameter. Field order keeps every field aligned with no
// padding but before `n`.
struct Table {
  float c1, b1, c2, b2, r1, r2, eps, wd, neg_lr;
  int count;                          // leaves in this launch
  int chunk_start[kMaxLeaves + 1];    // running chunk counts
  long long n[kMaxLeaves];            // elements of each leaf
  float* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  unsigned char g_type[kMaxLeaves];   // 0 fp32, 1 bf16, 2 fp16
};
static_assert(sizeof(Table) <= 32764,
              "the leaf table must fit a launch's parameters");

__device__ __forceinline__ void adamw(const Table& t, float& p, float g,
                                      float& mu, float& nu) {
  mu = __fadd_rn(__fmul_rn(g, t.c1), __fmul_rn(mu, t.b1));
  nu = __fadd_rn(__fmul_rn(__fmul_rn(g, g), t.c2), __fmul_rn(nu, t.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, t.r2)), t.eps);
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(mu, t.r1), den),
                            __fmul_rn(p, t.wd));
  p = __fadd_rn(p, __fmul_rn(u, t.neg_lr));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) {
  return __half2float(x);
}

// Four gradients from one vector load: 16 bytes of fp32, 8 of bf16 or fp16.
__device__ __forceinline__ float4 load4(const float* g) {
  return __ldcs(reinterpret_cast<const float4*>(g));
}
template <typename G>
__device__ __forceinline__ float4 load4(const G* g) {
  const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(g));
  const G* h = reinterpret_cast<const G*>(&raw);
  return make_float4(to_float(h[0]), to_float(h[1]), to_float(h[2]),
                     to_float(h[3]));
}

__device__ __forceinline__ bool aligned(const void* ptr, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

template <typename G>
__device__ void chunk(const Table& t, int leaf, long long begin,
                      long long end) {
  float* p = t.p[leaf];
  const G* g = static_cast<const G*>(t.g[leaf]);
  float* mu = t.mu[leaf];
  float* nu = t.nu[leaf];
  const bool vec = aligned(p, 16) && aligned(mu, 16) && aligned(nu, 16) &&
                   aligned(g, kVec * sizeof(G));
  if (vec && end - begin == kChunk) {
    float4 pv[kVecs], gv[kVecs], mv[kVecs], nv[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long i = begin + (k * kThreads + threadIdx.x) * kVec;
      pv[k] = __ldcs(reinterpret_cast<const float4*>(p + i));
      gv[k] = load4(g + i);
      mv[k] = __ldcs(reinterpret_cast<const float4*>(mu + i));
      nv[k] = __ldcs(reinterpret_cast<const float4*>(nu + i));
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      adamw(t, pv[k].x, gv[k].x, mv[k].x, nv[k].x);
      adamw(t, pv[k].y, gv[k].y, mv[k].y, nv[k].y);
      adamw(t, pv[k].z, gv[k].z, mv[k].z, nv[k].z);
      adamw(t, pv[k].w, gv[k].w, mv[k].w, nv[k].w);
      const long long i = begin + (k * kThreads + threadIdx.x) * kVec;
      __stcs(reinterpret_cast<float4*>(p + i), pv[k]);
      __stcs(reinterpret_cast<float4*>(mu + i), mv[k]);
      __stcs(reinterpret_cast<float4*>(nu + i), nv[k]);
    }
    return;
  }
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    float pi = p[i], mi = mu[i], ni = nu[i];
    adamw(t, pi, to_float(g[i]), mi, ni);
    p[i] = pi;
    mu[i] = mi;
    nu[i] = ni;
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_tensors_kernel(const __grid_constant__ Table t) {
  const int b = blockIdx.x;
  // The last leaf whose chunks start at or before b: an empty leaf starts
  // where the next one does, so it is never the one found.
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const long long begin = (long long)(b - t.chunk_start[lo]) * kChunk;
  const long long end = begin + kChunk < t.n[lo] ? begin + kChunk : t.n[lo];
  switch (t.g_type[lo]) {
    case 0: chunk<float>(t, lo, begin, end); break;
    case 1: chunk<__nv_bfloat16>(t, lo, begin, end); break;
    default: chunk<__half>(t, lo, begin, end); break;
  }
}

}  // namespace

extern "C" {

int rtt_adamw_max_leaves() { return kMaxLeaves; }

// One launch over `count` leaves. `leaves` holds six rows of `count`
// int64s: the addresses of p, g, mu and nu, the element counts, and g's
// type (0 fp32, 1 bf16, 2 fp16). `consts`: c1, b1, c2, b2, r1, r2, eps, wd,
// -lr, in fp32 (the header). Both are read before this returns; the launch
// takes its own copy of the table.
int rtt_adamw(int count, const long long* leaves, const float* consts,
              void* stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Table t;
  t.c1 = consts[0];
  t.b1 = consts[1];
  t.c2 = consts[2];
  t.b2 = consts[3];
  t.r1 = consts[4];
  t.r2 = consts[5];
  t.eps = consts[6];
  t.wd = consts[7];
  t.neg_lr = consts[8];
  t.count = count;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = leaves[4 * count + i];
    const long long type = leaves[5 * count + i];
    if (n < 1 || type < 0 || type > 2) return (int)cudaErrorInvalidValue;
    t.chunk_start[i] = (int)chunks;
    chunks += (n + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    t.n[i] = n;
    t.p[i] = reinterpret_cast<float*>(leaves[i]);
    t.g[i] = reinterpret_cast<const void*>(leaves[count + i]);
    t.mu[i] = reinterpret_cast<float*>(leaves[2 * count + i]);
    t.nu[i] = reinterpret_cast<float*>(leaves[3 * count + i]);
    t.g_type[i] = (unsigned char)type;
  }
  t.chunk_start[count] = (int)chunks;
  adamw_tensors_kernel<<<(unsigned)chunks, kThreads, 0,
                         (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
