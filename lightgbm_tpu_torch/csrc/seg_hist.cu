// Segment histogram over leaf-ordered packed bins for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the leaf-contiguous (partitioned)
// tree builder:
//   _seg_hist_kernel (lightgbm_tpu/ops/ordered_hist.py:123, pallas_call
//   at :156, dispatched by segment_histograms :189)        -> seg_hist
//
// It computes, over the position range [begin, begin + cnt) of rows kept
// physically sorted by leaf,
//   hist[f, b, :] = sum_{begin <= p < begin+cnt} [bin(f, p) == b]
//                   * (g[p], h[p], w[p])
// for every f < 4W, where the bins are packed four features per int32
// word (feature f in byte f & 3 of word f >> 2) and ghc_t = (g, h, w) is
// the (3, N) leaf-ordered in-bag statistics.
//
// Design. The TPU kernel slices the segment's geometric chunk bucket,
// picked by lax.switch, and carries the sum in VMEM over a sequential
// grid. Here the host must not learn the segment's size (that would be a
// host sync per split), and blocks run in no order. So the bounds stay
// in device memory and every block reads them:
//   1. seg_partials: one block per HIST_CHUNK = 4096-row chunk of the
//      WHOLE array and per feature tile. A block whose chunk lies outside
//      the cover [c_first, c_last] (cover_index's arithmetic, clamped to
//      the array) returns at once, so the work follows the segment, not
//      N. Covered blocks mask rows outside [begin, begin + cnt) by
//      position and accumulate the chunk's (F_tile, B, 3) f32 partial in
//      shared memory. Each warp owns whole features; a feature's byte is
//      ((unsigned)word >> 8 * (f & 3)) & 0xFF (unsigned shift: feature 3
//      of a word holds the sign bit). Lanes hold consecutive rows and
//      lanes that hit one bin add in lane order (__match_any_sync, one
//      rank per round), so the partial is the row-order f32 sum, whatever
//      the launch.
//   2. seg_fold: one thread per output cell folds the partials of the
//      covered chunks ONLY, c_first..c_last in order, with the f32 Kahan
//      arithmetic of hist.cu hist_fold, and returns the (value,
//      residual) pair. Partials of chunks outside the cover are never
//      written nor read (trailing zero chunks would change the Kahan
//      bits).
// No float atomics: two launches give the same bits, and the result
// equals the plain PyTorch version (ops/hist_kernels.py seg_hist_plain)
// run on the CPU.
//
// Bound on this card. The function must read the segment's words (4W
// bytes a row) and statistics (12 bytes a row) once and write the
// (value, residual) pair: (4W + 12) * cnt + 2 * 4W * B * 12 bytes, 42 MB
// for the root at 1M rows x 28 features (W = 7), about 12.5 us at
// 3.35 TB/s; its three f32 adds per (row, feature) take far less at
// 67 TFLOP/s. This design moves more: every covered chunk's rows (up to
// 2 * 4095 rows beyond the segment), four warps re-reading each word
// (from L1), and the chunk partials written and read back,
// covered_chunks * 4W * B * 12 bytes (22 MB for the root at 255 bins).
// Making it fast (fewer partial bytes, wider loads) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;       // HIST_CHUNK rows per block
constexpr int kSub = 1024;         // rows staged in shared memory at once
constexpr int kStageBytes = kSub * 3 * sizeof(float);

enum Status {
  kOk = 0,
  // negative codes are this file's own; positive ones are cudaError_t
  kBadShape = -1,
  kNoFit = -2,
};

struct Cover {
  long lo, hi;          // row range [lo, hi)
  int c_first, c_last;  // covered chunks, inclusive
};

// cover_index's arithmetic on device-resident bounds [begin, cnt]: an
// empty segment covers one chunk (cnt clamped to >= 1 for the cover, to
// >= 0 for the rows), both ends clamped into the array.
__device__ __forceinline__ Cover read_cover(const int* bounds, int chunks) {
  const long begin = bounds[0];
  const long cnt = bounds[1] > 0 ? bounds[1] : 0;
  Cover c;
  c.lo = begin;
  c.hi = begin + cnt;
  long first = begin / kChunk;
  long last = (begin + (cnt > 0 ? cnt : 1) - 1) / kChunk;
  first = first < 0 ? 0 : (first > chunks - 1 ? chunks - 1 : first);
  last = last < first ? first : (last > chunks - 1 ? chunks - 1 : last);
  c.c_first = (int)first;
  c.c_last = (int)last;
  return c;
}

__global__ void seg_partials(const int* __restrict__ words,
                             const float* __restrict__ ghc_t,
                             const int* __restrict__ bounds, int num_feat,
                             int n, int num_bins, int f_tile,
                             float* __restrict__ partials) {
  const int chunks = n / kChunk;
  const Cover cov = read_cover(bounds, chunks);
  const int chunk = blockIdx.x;
  if (chunk < cov.c_first || chunk > cov.c_last) return;  // block-uniform

  extern __shared__ float smem[];
  const int cells = f_tile * num_bins * 3;
  float* hist_s = smem;
  float* g_s = hist_s + cells;
  float* h_s = g_s + kSub;
  float* w_s = h_s + kSub;

  const int f0 = blockIdx.y * f_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = blockDim.x >> 5;

  for (int i = tid; i < cells; i += blockDim.x) hist_s[i] = 0.0f;

  for (int sub = 0; sub < kChunk; sub += kSub) {
    const long base = (long)chunk * kChunk + sub;
    if (base + kSub <= cov.lo || base >= cov.hi) continue;  // block-uniform
    __syncthreads();  // previous sub-chunk consumed, hist zeroed
    for (int r = tid; r < kSub; r += blockDim.x) {
      const long row = base + r;
      g_s[r] = ghc_t[row];
      h_s[r] = ghc_t[n + row];
      w_s[r] = ghc_t[2L * n + row];
    }
    __syncthreads();
    for (int f = warp; f < f_tile && f0 + f < num_feat; f += num_warps) {
      const int feat = f0 + f;
      const int* wrow = words + (long)(feat >> 2) * n + base;
      const unsigned shift = 8u * (unsigned)(feat & 3);
      for (int it = 0; it < kSub; it += 32) {
        const int r = it + lane;
        const long pos = base + r;
        const int bin = (int)(((unsigned)wrow[r] >> shift) & 0xFFu);
        const bool valid = pos >= cov.lo && pos < cov.hi && bin < num_bins;
        const int key = valid ? bin : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        const unsigned rank = __popc(peers & ((1u << lane) - 1u));
        const unsigned rounds =
            __reduce_max_sync(0xffffffffu, valid ? (unsigned)__popc(peers) : 0u);
        for (unsigned k = 0; k < rounds; ++k) {
          if (valid && rank == k) {
            float* cell = hist_s + (f * num_bins + bin) * 3;
            cell[0] += g_s[r];
            cell[1] += h_s[r];
            cell[2] += w_s[r];
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();
  const int row_len = num_bins * 3;
  for (int i = tid; i < cells; i += blockDim.x) {
    const int f = i / row_len;
    const int j = i - f * row_len;
    if (f0 + f < num_feat) {
      partials[((long)chunk * num_feat + f0 + f) * row_len + j] = hist_s[i];
    }
  }
}

__global__ void seg_fold(const float* __restrict__ partials,
                         const int* __restrict__ bounds, int chunks,
                         long cells, float* __restrict__ hi,
                         float* __restrict__ lo) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cells) return;
  const Cover cov = read_cover(bounds, chunks);
  float acc = 0.0f, comp = 0.0f;
  for (int c = cov.c_first; c <= cov.c_last; ++c) {
    const float y = partials[(long)c * cells + e] - comp;
    const float t = acc + y;
    comp = (t - acc) - y;
    acc = t;
  }
  hi[e] = acc;
  lo[e] = comp == 0.0f ? 0.0f : -comp;  // +0.0 residual, as the CPU path
}

int max_shared_bytes() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&cached, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return cached;
}

}  // namespace

extern "C" {

// ((num_feat, B, 3) value, residual) over the leaf-ordered rows
// [bounds[0], bounds[0] + bounds[1]); bounds is a (2,) int32 tensor in
// device memory. words: (num_feat / 4, n) int32; ghc_t: (3, n) f32;
// partials: (n / 4096) * num_feat * B * 3 floats of scratch.
int seg_hist(const int* words, const float* ghc_t, const int* bounds,
             int num_feat, int n, int num_bins, float* partials, float* hi,
             float* lo, void* stream) {
  if (num_feat < 4 || num_feat % 4 != 0 || n < kChunk || n % kChunk != 0 ||
      num_bins < 1 || num_bins > 256)
    return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_feat = num_bins * 3 * (int)sizeof(float);
  const int budget = max_shared_bytes() - kStageBytes;
  int fit = budget / per_feat;
  if (fit < 1) return kNoFit;
  if (fit > 32) fit = 32;  // one warp per feature, at most 32 warps
  const int tiles = (num_feat + fit - 1) / fit;
  const int f_tile = (num_feat + tiles - 1) / tiles;
  const int smem = f_tile * per_feat + kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      seg_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = n / kChunk;
  dim3 grid(chunks, tiles);
  seg_partials<<<grid, 32 * f_tile, smem, s>>>(words, ghc_t, bounds, num_feat,
                                               n, num_bins, f_tile, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long cells = (long)num_feat * num_bins * 3;
  const int threads = 256;
  seg_fold<<<(unsigned)((cells + threads - 1) / threads), threads, 0, s>>>(
      partials, bounds, chunks, cells, hi, lo);
  return (int)cudaGetLastError();
}

const char* seg_status_string(int status) {
  if (status == kBadShape) return "unsupported shape or bin count";
  if (status == kNoFit) return "one feature's histogram does not fit in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
