// Stable stream compaction of one leaf's rows for Hopper (sm_90a).
//
// Replaces the gather-index step of the JAX package's gather-compacted
// engine, an XLA program with no Pallas kernel:
//   compact_gather_indices (lightgbm_tpu/ops/partition.py:44, called by
//   compacted_histograms, ops/histogram.py:573)          -> compact_rows
//
// Given (N,) int32 keys (the row -> leaf map) and one key value in
// device memory (the leaf id), it writes
//   src[rank(p)] = p for every row p with keys[p] == value, in original
//                  order (rank = the number of such rows before p),
//   src[q] = N     for every position q past the count (the sentinel),
//   *count = the number of such rows,
// all on the device, with no host read: the count stays in device memory
// for compact_hist.cu, so the pair can be captured in a CUDA graph.
//
// Three launches, no atomics, no float work:
//   1. count: one block of 256 threads per 4096-row tile counts the tile's
//      rows (coalesced int32 loads, a warp reduction, a block sum);
//   2. scan: one block of 1024 threads turns the tile counts into
//      exclusive offsets in place (each thread sums a run of tiles, a
//      Hillis-Steele scan of the runs) and writes the total as the count;
//   3. scatter: each tile walks its rows in 16 steps of 256; a step's
//      ballot per warp and the warps' counts in shared memory give each
//      selected row its rank, so the tile writes its rows at its offset
//      in row order; then every position from the count up to the
//      buffer's end takes the sentinel (grid-stride).
// Each tile's rows land in their order and the tiles in theirs, so the
// result is the plain version's (cumsum rank, scatter with drop) element
// for element.
//
// Bound on this card. The function must read the keys (4 bytes a row)
// and write the (size,) buffer and the count once: 8 MB at 1M rows, 2.5
// us at 3.35 TB/s. The design reads the keys twice (the second time
// largely from L2 at 4 MB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 16;
constexpr int kTile = kThreads * kSteps;  // 4096 rows a block
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBadShape = -1;

__global__ void count_kernel(const int* __restrict__ keys,
                             const int* __restrict__ value, int n,
                             int* __restrict__ tile_counts) {
  __shared__ int warp_sums[kWarps];
  const int v = *value;
  const long base = (long)blockIdx.x * kTile;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const long row = base + k * kThreads + threadIdx.x;
    c += row < n && keys[row] == v ? 1 : 0;
  }
  c = __reduce_add_sync(kFull, c);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
    tile_counts[blockIdx.x] = t;
  }
}

__global__ void scan_kernel(int* __restrict__ tile_counts, int tiles,
                            int* __restrict__ count) {
  __shared__ int sums[kScanThreads];
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < tiles ? lo + per : tiles;
  int own = 0;
  for (int i = lo; i < hi; ++i) own += tile_counts[i];
  sums[threadIdx.x] = own;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = threadIdx.x >= off ? sums[threadIdx.x - off] : 0;
    __syncthreads();
    sums[threadIdx.x] += add;
    __syncthreads();
  }
  int run = sums[threadIdx.x] - own;  // exclusive
  for (int i = lo; i < hi; ++i) {
    const int c = tile_counts[i];
    tile_counts[i] = run;
    run += c;
  }
  if (threadIdx.x == kScanThreads - 1) *count = sums[kScanThreads - 1];
}

__global__ void scatter_kernel(const int* __restrict__ keys,
                               const int* __restrict__ value, int n,
                               const int* __restrict__ offsets,
                               const int* __restrict__ count,
                               int* __restrict__ src, int size) {
  __shared__ int warp_counts[2][kWarps];  // double-buffered across steps
  const int v = *value;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long base = (long)blockIdx.x * kTile;
  int run = offsets[blockIdx.x];
  for (int k = 0; k < kSteps; ++k) {
    const long row = base + k * kThreads + threadIdx.x;
    const bool sel = row < n && keys[row] == v;
    const unsigned m = __ballot_sync(kFull, sel);
    if (lane == 0) warp_counts[k & 1][warp] = __popc(m);
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_counts[k & 1][w];
      before += w < warp ? c : 0;
      all += c;
    }
    if (sel) {
      const int dst = run + before + __popc(m & below);
      if (dst < size) src[dst] = (int)row;  // rows past `size` are dropped
    }
    run += all;
  }
  const int total = *count;
  for (long q = (long)blockIdx.x * kThreads + threadIdx.x; q < size;
       q += (long)gridDim.x * kThreads)
    if (q >= total) src[q] = n;
}

}  // namespace

extern "C" {

// Tiles of the scratch buffer compact_rows needs for n rows (one int32
// each).
int compact_tiles(int n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

// src (size,) int32 and *count (one int32) from keys (n,) int32 and one
// key value, all in device memory; tile_counts: compact_tiles(n) int32
// of scratch.
int compact_rows(const int* keys, const int* value, int n, int* src,
                 int size, int* count, int* tile_counts, void* stream) {
  if (n < 0 || size < 0) return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = compact_tiles(n);
  count_kernel<<<tiles, kThreads, 0, s>>>(keys, value, n, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, kScanThreads, 0, s>>>(tile_counts, tiles, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<tiles, kThreads, 0, s>>>(keys, value, n, tile_counts,
                                            count, src, size);
  return (int)cudaGetLastError();
}

const char* compact_status_string(int status) {
  if (status == kBadShape) return "negative row count or buffer size";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
