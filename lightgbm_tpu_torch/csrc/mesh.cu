// The fixed-order compensated fold of the mesh's exchanged histograms, for
// Hopper (sm_90a): one gather-fold launch an exchange.
//
// Replaces the JAX package's kahan_fold (lightgbm_tpu/parallel/mesh.py:138),
// the XLA scan that every histogram exchange ends in: pair_allreduce (:161)
// and pair_reduce_scatter (:216) fold the 2W Kahan words they received
// (every shard's value words, then every shard's residual words), and
// compressed_allreduce (:173) and compressed_reduce_scatter (:230) the W
// collapsed words (float32, or bfloat16 on the wire for
// comm_precision=bf16). For K components x_0 .. x_{K-1} of one output
// cell, in float32:
//   s = c = +0.0;
//   for j = 0 .. K-1:  y = x_j - c;  t = s + y;  c = (t - s) - y;  s = t;
//   out = s - c.
// The last step is s - c itself, not s + (-c) with a +0.0 residual as in
// the chunk fold of chunk_hist.cuh: the two differ in the sign of a zero
// (s = -0.0, c = +0.0). Every operation is an _rn intrinsic, which nvcc
// never contracts or reorders, so the kernel gives the bits of the plain
// PyTorch version (ops/mesh_kernels.py gather_fold_plain and
// mesh_fold_plain), which does the same float32 operations in the same
// order. A bfloat16 component is widened to float32 exactly as it is
// loaded.
//
// Gather: the K components are not stacked first. Each is a descriptor,
// a pointer and a stride: component j's cell (i, e) of an output viewed
// as (lead, run) is ptr_j[i * stride_j + e], and the output cell is
// out[i * out_stride + e]. The exchanges of parallel/mesh.py point the
// descriptors at every peer's own word tensor (reduce-scatter: at this
// shard's owned features of it, a run of f_loc x B x 3 cells a frontier
// row), so an exchange is this one launch and nothing else on the
// device; a buffer that a collective library fills takes the same
// descriptors. The table travels by value in the kernel's parameters
// (kMaxComps descriptors, 2 KB, inside the 4 KB every CUDA 12 toolkit
// takes), read through __grid_constant__ so that the loop's indexing
// reads the parameter bank rather than a local copy; there is no
// host-to-device copy. A fold of more than kMaxComps components (more
// than 64 shards at comm_precision=pair) runs in passes of kMaxComps
// that carry (s, c) through a (2, lead, run) float32 state buffer in
// index order, so its bits are the one-pass fold's.
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
constexpr int kMaxComps = 128;
constexpr long long kMaxGridY = 65535;

enum Status { kOk = 0, kBadArgs = 1, kLaunch = 2 };

// One pass's components: component j's cell (i, e) is ptr[j][i *
// stride[j] + e] (elements).
struct FoldTable {
  const void* ptr[kMaxComps];
  long long stride[kMaxComps];
};

// The output viewed as (lead, run), its stride between lead rows, the
// pass's component count, and whether the pass starts the fold from
// zero (first) and writes s - c (last) rather than (s, c) to the state.
struct FoldShape {
  long long lead, run, out_stride;
  int k, first, last;
};

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
__device__ __forceinline__ float comp(const FoldTable& tab, int j,
                                      long long i, long long e) {
  return widen(static_cast<const T*>(tab.ptr[j])[i * tab.stride[j] + e]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_fold_kernel(const __grid_constant__ FoldTable tab, FoldShape sh,
                       float* __restrict__ out, float* __restrict__ state) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= sh.run) return;
  const long long cells = sh.lead * sh.run;
  for (long long i = blockIdx.y; i < sh.lead; i += gridDim.y) {
    const long long cell = i * sh.run + e;
    float s = 0.0f, c = 0.0f;
    if (!sh.first) {
      s = state[cell];
      c = state[cells + cell];
    }
    int j = 0;
    for (; j + kAhead <= sh.k; j += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) v[a] = comp<T>(tab, j + a, i, e);
#pragma unroll
      for (int a = 0; a < kAhead; ++a) kahan_step(v[a], s, c);
    }
    for (; j < sh.k; ++j) kahan_step(comp<T>(tab, j, i, e), s, c);
    if (sh.last) {
      out[i * sh.out_stride + e] = __fsub_rn(s, c);
    } else {
      state[cell] = s;
      state[cells + cell] = c;
    }
  }
}

}  // namespace

extern "C" {

// The descriptors a launch takes; a fold of more components runs in
// ceil(k / gather_fold_max_comps()) launches.
int gather_fold_max_comps() { return kMaxComps; }

// table: 2k long longs, component j's address at [2j] and its stride
// between lead rows (elements) at [2j + 1], in fold order; every
// component float32 (bf16 == 0) or bfloat16 (bf16 == 1). out: the
// (lead, run) output, row i at out + i * out_stride (out_stride >= run).
// state: a (2, lead, run) float32 buffer when k > kMaxComps, else
// unused. Launches on `stream`; returns a Status.
int gather_fold(const long long* table, int k, int bf16, long long lead,
                long long run, float* out, long long out_stride,
                float* state, cudaStream_t stream) {
  if (table == nullptr || out == nullptr || k < 1 || lead < 1 || run < 1 ||
      (bf16 != 0 && bf16 != 1) || (lead > 1 && out_stride < run) ||
      (k > kMaxComps && state == nullptr)) {
    return kBadArgs;
  }
  const long long xblocks = (run + kThreads - 1) / kThreads;
  if (xblocks > 0x7fffffffLL) return kBadArgs;
  const dim3 grid((unsigned)xblocks,
                  (unsigned)(lead < kMaxGridY ? lead : kMaxGridY));
  FoldTable tab;
  FoldShape sh{lead, run, out_stride, 0, 1, 0};
  for (int j0 = 0; j0 < k; j0 += kMaxComps) {
    sh.k = k - j0 < kMaxComps ? k - j0 : kMaxComps;
    sh.first = j0 == 0;
    sh.last = j0 + sh.k == k;
    for (int j = 0; j < sh.k; ++j) {
      tab.ptr[j] = reinterpret_cast<const void*>(table[2 * (j0 + j)]);
      tab.stride[j] = table[2 * (j0 + j) + 1];
    }
    if (bf16) {
      gather_fold_kernel<__nv_bfloat16>
          <<<grid, kThreads, 0, stream>>>(tab, sh, out, state);
    } else {
      gather_fold_kernel<float><<<grid, kThreads, 0, stream>>>(tab, sh, out,
                                                               state);
    }
    if (cudaGetLastError() != cudaSuccess) return kLaunch;
  }
  return kOk;
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
