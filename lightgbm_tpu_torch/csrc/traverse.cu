// Tree-ensemble traversal for Hopper (sm_90a): the serving hot loop.
//
// Replaces the lockstep XLA traversal of the JAX package, which has no
// Pallas kernel: device_traverse (lightgbm_tpu/models/gbdt.py:65) under
// the jitted serving kernels of lightgbm_tpu/serving/compiled_model.py
//   _leaf_kernel (:76)                              -> tree_leaf
//   _raw_kernel, _transformed_kernel (:86, :95)     -> tree_raw<float>
//   _raw16_kernel, _transformed16_kernel (:110, :124) -> tree_raw<bf16>
// and the port's plain PyTorch walk (lightgbm_tpu_torch/models/gbdt.py
// device_traverse), about 14 small ops per depth step.
//
//   tree_leaf: leaf[r, t] = the leaf row r reaches in tree t   (B, T) int32
//   tree_raw:  raw[r, c]  = sum over trees t with t % K == c of
//                           leaf_value[t, leaf[r, t]], in tree order, f32
//
// A node is one 16-byte record packed at freeze time
// (ops/traverse_kernels.py pack_nodes): x = split feature with the
// categorical flag in bit 31, y = the f32-safe threshold's bits, z = left
// child, w = right child (a leaf is ~leaf, negative). One step of a walk
// is one 16-byte load. The decision is device_traverse's for every input:
// numeric `x <= thr` (NaN goes right), categorical
// `!isnan(x) && int(x) == int(thr)` with the cast saturating at +-inf
// (__float2int_rz; category ids are small and non-negative, so the
// decision equals the JAX package's and the plain version's).
//
// Design (simple first). One thread walks one (row, tree) pair until it
// reaches a leaf or `depth` steps, which is the lockstep loop's result.
// A block takes `rows` consecutive rows and stages them in shared memory
// once; the pairs of the block are numbered row-major (r * T + t), so
// consecutive lanes of a warp take consecutive trees of one row: the
// (B, T) store of tree_leaf is coalesced, and the lanes share the row's
// feature values in shared memory. tree_raw takes the trees in tiles:
// each pair writes its leaf value (f32, or bf16 widened to f32) to shared
// memory, then one thread per (row, class) adds its class's trees of the
// tile in tree order into an f32 accumulator that lives in shared memory
// across tiles. The order of every sum is fixed, so two launches give the
// same bits, and the plain version (the same sequential f32 adds) gives
// them too.
//
// Bound on this card. A 4096-row bucket of 28 features through 100
// trees of 63 leaves reads x once (0.46 MB) and the node records once
// (100 x 62 x 16 bytes, 0.10 MB) and writes 4096 x 100 int32 leaves
// (1.6 MB): about 2.2 MB, 0.66 us at 3.35 TB/s. The real floor is latency: each walk is a
// chain of up to `depth` dependent loads (node record, then the feature
// value), so a pair costs depth x (L2 or L1 hit latency); the design
// relies on many pairs in flight (hundreds of thousands per bucket) to
// hide it, and on the node records (tens of KB per model) staying in L1
// and L2. Trees in shared memory and several rows per thread are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// pairs a block aims at (several per thread keeps walks in flight)
constexpr int kPairsPerBlock = 1024;
// shared memory a block may use (below the 48 KB static limit)
constexpr int kSmemBytes = 40 * 1024;
constexpr int kBadShape = -1;
constexpr int kNoFit = -2;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One walk from `node` through the records of one tree; returns the
// final node state (~leaf once a leaf is reached).
__device__ __forceinline__ int walk(const float* xrow,
                                    const int4* __restrict__ tree, int node,
                                    int depth) {
  for (int d = 0; d < depth && node >= 0; ++d) {
    const int4 rec = __ldg(tree + node);
    const float v = xrow[rec.x & 0x7fffffff];
    const float thr = __int_as_float(rec.y);
    const bool left = rec.x < 0
        ? (!isnan(v) && __float2int_rz(v) == __float2int_rz(thr))
        : (v <= thr);
    node = left ? rec.z : rec.w;
  }
  return node;
}

// Copy the block's rows of x into shared memory (one contiguous span).
__device__ __forceinline__ const float* stage_rows(const float* __restrict__ x,
                                                   float* xs, bool stage,
                                                   int count) {
  if (!stage) return x;
  for (int i = threadIdx.x; i < count; i += blockDim.x) xs[i] = x[i];
  return xs;
}

__global__ void __launch_bounds__(kThreads)
tree_leaf_kernel(const float* __restrict__ x, int b, int f,
                 const int4* __restrict__ nodes,
                 const int* __restrict__ node0, int t, int s, int depth,
                 int rows, bool stage, int* __restrict__ out) {
  extern __shared__ float xs[];
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, b - row0);
  const float* src = stage_rows(x + (size_t)row0 * f, xs, stage, nrows * f);
  __syncthreads();
  const int pairs = nrows * t;
  int* dst = out + (size_t)row0 * t;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int r = p / t;
    const int tr = p - r * t;
    const int node = walk(src + (size_t)r * f, nodes + (size_t)tr * s,
                          __ldg(node0 + tr), depth);
    dst[p] = ~node;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
tree_raw_kernel(const float* __restrict__ x, int b, int f,
                const int4* __restrict__ nodes,
                const int* __restrict__ node0, int t, int s, int depth,
                const V* __restrict__ lv, int l, int k, int rows, int tile,
                bool stage, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* acc = smem;                 // (rows, k)
  float* vals = acc + rows * k;      // (rows, tile)
  float* xs = vals + rows * tile;    // (rows, f) when staged
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, b - row0);
  const float* src = stage_rows(x + (size_t)row0 * f, xs, stage, nrows * f);
  const int cells = nrows * k;
  for (int q = threadIdx.x; q < cells; q += blockDim.x) acc[q] = 0.0f;
  for (int t0 = 0; t0 < t; t0 += tile) {
    const int tn = min(tile, t - t0);
    __syncthreads();  // rows staged; the previous tile's adds are done
    for (int p = threadIdx.x; p < nrows * tn; p += blockDim.x) {
      const int r = p / tn;
      const int j = p - r * tn;
      const int tr = t0 + j;
      const int node = walk(src + (size_t)r * f, nodes + (size_t)tr * s,
                            __ldg(node0 + tr), depth);
      // a walk cut short by `depth` (not a valid model) reads leaf 0
      const int leaf = node < 0 ? ~node : 0;
      vals[r * tile + j] = widen(lv[(size_t)tr * l + leaf]);
    }
    __syncthreads();
    for (int q = threadIdx.x; q < cells; q += blockDim.x) {
      const int r = q / k;
      const int c = q - r * k;
      float a = acc[q];
      for (int j = ((c - t0) % k + k) % k; j < tn; j += k)
        a += vals[r * tile + j];
      acc[q] = a;
    }
  }
  // each thread wrote the cells it stores: no barrier needed
  float* dst = out + (size_t)row0 * k;
  for (int q = threadIdx.x; q < cells; q += blockDim.x) dst[q] = acc[q];
}

// Rows a block takes: enough pairs to keep the walks in flight, and the
// rows' features staged in shared memory when they fit.
int plan_rows(int b, int per_row, int fixed_floats_per_row, int f,
              bool* stage) {
  int rows = kPairsPerBlock / per_row;
  rows = rows < 1 ? 1 : (rows > b ? b : rows);
  *stage = true;
  while (rows > 1 &&
         (size_t)rows * (fixed_floats_per_row + f) * 4 > kSmemBytes)
    rows /= 2;
  if ((size_t)rows * (fixed_floats_per_row + f) * 4 > kSmemBytes)
    *stage = false;
  return rows;
}

int check_launch() { return static_cast<int>(cudaGetLastError()); }

template <typename V>
int launch_raw(const float* x, int b, int f, const void* nodes,
               const int* node0, int t, int s, int depth, const V* lv,
               int l, int k, float* out, void* stream) {
  if (b < 0 || f < 1 || t < 1 || s < 1 || depth < 0 || l < 1 || k < 1)
    return kBadShape;
  if (b == 0) return 0;
  const int tile = t < kPairsPerBlock ? t : kPairsPerBlock;
  bool stage;
  const int rows = plan_rows(b, tile, tile + k, f, &stage);
  const size_t smem =
      (size_t)rows * (tile + k + (stage ? f : 0)) * sizeof(float);
  if (smem > kSmemBytes) return kNoFit;
  const int grid = (b + rows - 1) / rows;
  tree_raw_kernel<V><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, b, f, static_cast<const int4*>(nodes), node0, t, s, depth, lv,
      l, k, rows, tile, stage, out);
  return check_launch();
}

}  // namespace

extern "C" {

// (B, T) int32 leaf indices of B rows of x (B, F) f32 row-major through T
// trees of S node records each (nodes (T, S) int4, node0 (T,) int32).
int tree_leaf(const float* x, int b, int f, const void* nodes,
              const int* node0, int t, int s, int depth, int* out,
              void* stream) {
  if (b < 0 || f < 1 || t < 1 || s < 1 || depth < 0) return kBadShape;
  if (b == 0) return 0;
  bool stage;
  const int rows = plan_rows(b, t, 0, f, &stage);
  const size_t smem = stage ? (size_t)rows * f * sizeof(float) : 0;
  const int grid = (b + rows - 1) / rows;
  tree_leaf_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, b, f, static_cast<const int4*>(nodes), node0, t, s, depth, rows,
      stage, out);
  return check_launch();
}

// (B, K) f32 class sums of the T trees' leaf values, lv (T, L) float32:
// tree t adds to class t % K, in tree order.
int tree_raw_f32(const float* x, int b, int f, const void* nodes,
                 const int* node0, int t, int s, int depth,
                 const float* lv, int l, int k, float* out, void* stream) {
  return launch_raw<float>(x, b, f, nodes, node0, t, s, depth, lv, l, k,
                           out, stream);
}

// The same with bfloat16 leaf values, accumulated in f32.
int tree_raw_bf16(const float* x, int b, int f, const void* nodes,
                  const int* node0, int t, int s, int depth,
                  const void* lv, int l, int k, float* out, void* stream) {
  return launch_raw<__nv_bfloat16>(
      x, b, f, nodes, node0, t, s, depth,
      static_cast<const __nv_bfloat16*>(lv), l, k, out, stream);
}

const char* traverse_status_string(int status) {
  if (status == kBadShape) return "unsupported shape";
  if (status == kNoFit)
    return "too many classes for one row's sums in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
