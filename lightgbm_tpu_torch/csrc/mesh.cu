// The fixed-order compensated fold of the mesh's exchanged histograms, for
// Hopper (sm_90a).
//
// Replaces the JAX package's kahan_fold (lightgbm_tpu/parallel/mesh.py:138),
// the XLA scan that every histogram exchange ends in: pair_allreduce (:161)
// and pair_reduce_scatter (:216) fold the 2W Kahan words they received
// (every shard's value words, then every shard's residual words), and
// compressed_allreduce (:173) and compressed_reduce_scatter (:230) the W
// collapsed words (float32, or bfloat16 on the wire for
// comm_precision=bf16). For K stacked components x_0 .. x_{K-1} of one
// output cell, in float32:
//   s = c = +0.0;
//   for j = 0 .. K-1:  y = x_j - c;  t = s + y;  c = (t - s) - y;  s = t;
//   out = s - c.
// The last step is s - c itself, not s + (-c) with a +0.0 residual as in
// the chunk fold of chunk_hist.cuh: the two differ in the sign of a zero
// (s = -0.0, c = +0.0). Every operation is an _rn intrinsic, which nvcc
// never contracts or reorders, so the kernel gives the bits of the plain
// PyTorch version (ops/mesh_kernels.py mesh_fold_plain), which does the
// same float32 operations in the same order. A bfloat16 component is
// widened to float32 exactly as it is loaded.
//
// Design: one thread per output cell walks the K components in index
// order, with kAhead loads issued before they are added (the loop of
// chunk_hist.cuh kahan_fold). A fold reads K x cells words and writes
// cells floats; at the bench shape (K = 8 at four shards, a leaf's
// 28 x 255 x 3 cells) that is 0.7 MB, a fraction of a microsecond of
// HBM, so the launch dominates: the kernel is simple on purpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;

enum Status { kOk = 0, kBadArgs = 1, kLaunch = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void kahan_step(float x, float& s, float& c) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

template <typename T>
__global__ void mesh_fold_kernel(const T* __restrict__ comps, int k,
                                 long cells, float* __restrict__ out) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cells) return;
  float s = 0.0f, c = 0.0f;
  int j = 0;
  for (; j + kAhead <= k; j += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      v[i] = widen(comps[(long)(j + i) * cells + e]);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) kahan_step(v[i], s, c);
  }
  for (; j < k; ++j) kahan_step(widen(comps[(long)j * cells + e]), s, c);
  out[e] = __fsub_rn(s, c);
}

}  // namespace

extern "C" {

// comps: (k, cells) float32 (bf16 == 0) or bfloat16 (bf16 == 1), row j the
// j-th component in fold order; out: (cells,) float32. k >= 1, cells >= 1.
// Launches on `stream`; returns a Status.
int mesh_fold(const void* comps, int bf16, int k, long long cells,
              float* out, cudaStream_t stream) {
  if (comps == nullptr || out == nullptr || k < 1 || cells < 1 ||
      (bf16 != 0 && bf16 != 1)) {
    return kBadArgs;
  }
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (bf16) {
    mesh_fold_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(comps), k, (long)cells, out);
  } else {
    mesh_fold_kernel<float><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(comps), k, (long)cells, out);
  }
  return cudaGetLastError() == cudaSuccess ? kOk : kLaunch;
}

const char* mesh_status_string(int status) {
  switch (status) {
    case kOk: return "ok";
    case kBadArgs: return "bad arguments";
    case kLaunch: return "kernel launch failed (cudaGetLastError)";
    default: return "unknown status";
  }
}

}  // extern "C"
