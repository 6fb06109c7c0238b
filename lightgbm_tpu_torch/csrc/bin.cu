// Dense binning for Hopper (sm_90a): the float32 matrix of a dataset
// turned into its (F, N) bin matrix on the card.
//
// Replaces the JAX package's device binning, an XLA program with no
// Pallas kernel: _bin_dense_on_device (lightgbm_tpu/io/dataset.py:156,
// called from DatasetLoader._construct at :1317), a jax.lax.map over
// 65,536-row chunks of
//
//   bin[f, n] = #{ b : bounds[f, b] < x[n, cols[f]] }     NaN read as 0.0
//
// (+-inf compare as themselves; built without flush-to-zero, so a
// subnormal bound or value compares as the host pass's float64 does).
// bounds (F, B) float32: feature f's bin upper bounds, rounded toward
// -inf from the float64 BinMapper bounds on the host (so the f32
// compare equals the host pass's f64 searchsorted(side="left") for
// every f32 input), rows of unequal length padded with +inf (which no
// value exceeds). The output is stored at its packed width: uint8,
// int16 or int32 (io/dataset.py bins_dtype).
//
// Same function, another method: a row of bounds is non-decreasing (the
// rounding is monotone, the pads are +inf), so the set of bounds below
// v is a prefix and the count is a lower-bound binary search over the
// row: log2(B) + 1 compares instead of B.
//
// Bound on this card. The bench matrix, 1,000,000 x 28 float32, reads
// 112 MB and writes 28 MB of uint8 bins: 0.042 ms at 3.35 TB/s. The
// searches are shared-memory loads (9 a value, 252 M at the bench
// shape), under the bytes' time when they overlap. Design:
// 1. A block owns a tile of features (all of them when their bounds fit
//    in 48 KB with the output tile) and loads their bounds into shared
//    memory once, each row padded with +inf to a power of two P; it
//    then walks row tiles of 256 rows, grid-stride, so the bounds are
//    read from device memory once a block. The grid is as many blocks
//    as fit on the card at once (the occupancy calculator's count).
// 2. Reads: thread t keeps feature t % ft and takes rows t / ft, t / ft
//    + 256 / ft, ... of a row tile, so a warp reads consecutive floats
//    of consecutive rows (coalesced where cols is the identity), and no
//    index is divided in the loop. A thread loads kIlp rows before it
//    searches, and runs their searches in lockstep: a fixed log2(P) + 1
//    steps with no branch, so kIlp shared-memory loads (and the global
//    loads before them) are in flight at once instead of one chain.
// 3. Writes: the bins go to a shared (features, 256 rows) tile, then out
//    with the row fastest, so each feature's 256 bins are one contiguous
//    store (the shared-memory transpose of the (N, F) input to the
//    features-major output).
// Rows of bounds too wide for shared memory (B > 8,192) are searched in
// device memory (through L1/L2) with a plain lower bound instead.
// No atomics, no data-dependent order: two launches give the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;                 // rows of a tile
constexpr int kIlp = 4;                    // searches in flight a thread
constexpr int kSmemBudget = 48 * 1024;     // no opt-in needed
constexpr int kMaxFeatTile = 64;

enum Status {
  kOk = 0,
  kBadArgs = 1,
  kBadWidth = 2,
  kLaunch = 3,
};

// The power of two a row of bounds is padded to in shared memory.
__host__ __device__ inline int pow2_at_least(int b) {
  int p = 1;
  while (p < b) p <<= 1;
  return p;
}
// Row stride of a feature's bounds in shared memory (odd, so that the
// first steps of the threads' searches, which read the same index of
// their own feature's row, fall in distinct banks) and of a feature's
// row in the output tile (one 4-byte word over 256 rows, for the same
// reason on the stores).
__host__ __device__ inline int smem_bound_stride(int b) {
  return pow2_at_least(b) + 1;
}
template <typename OutT>
__host__ __device__ constexpr int tile_stride() {
  return kRows + 4 / (int)sizeof(OutT);
}

// #{i < b : row[i] < v} for a non-decreasing row (lower bound).
__device__ inline int count_below(const float* row, int b, float v) {
  int lo = 0, len = b;
  while (len > 0) {
    const int half = len >> 1;
    if (row[lo + half] < v) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

template <typename OutT, bool kSmemBounds>
__global__ void __launch_bounds__(kThreads)
bin_dense_kernel(const float* __restrict__ x, int64_t n, int c,
                 const int* __restrict__ cols, int f,
                 const float* __restrict__ bounds, int b, int feat_tile,
                 OutT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ts = tile_stride<OutT>();
  const int f0 = blockIdx.y * feat_tile;
  const int ft = min(feat_tile, f - f0);
  const int p = pow2_at_least(b);
  const int bs = kSmemBounds ? smem_bound_stride(b) : b;
  float* sb = reinterpret_cast<float*>(smem);
  OutT* tile = reinterpret_cast<OutT*>(
      smem + (kSmemBounds ? (size_t)feat_tile * bs * sizeof(float) : 0));
  const float* brow = bounds + (size_t)f0 * b;
  if (kSmemBounds) {
    for (int i = threadIdx.x; i < ft * p; i += kThreads) {
      const int j = i / p;
      const int k = i - j * p;
      sb[j * bs + k] = k < b ? brow[j * b + k] : CUDART_INF_F;
    }
    brow = sb;
  }
  __syncthreads();
  // thread t keeps one feature, j = t % ft, and takes rows t / ft,
  // t / ft + rpp, ... of a tile: no index division in the loops
  const int rpp = kThreads / ft;             // rows a pass (ft <= 64)
  const int j = threadIdx.x % ft;
  const int rr = threadIdx.x / ft;
  const bool active = rr < rpp;
  const float* frow = brow + (size_t)j * bs;
  const int col = cols[f0 + j];
  const int64_t row_tiles = (n + kRows - 1) / kRows;
  for (int64_t rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const int64_t r0 = rt * kRows;
    const int rows = (int)min((int64_t)kRows, n - r0);
    for (int r = rr; active && r < rows; r += rpp * kIlp) {
      float v[kIlp];
#pragma unroll
      for (int k = 0; k < kIlp; ++k) {
        const int rk = r + k * rpp;
        v[k] = rk < rows ? x[(r0 + rk) * c + col] : -CUDART_INF_F;
        if (v[k] != v[k]) v[k] = 0.0f;       // NaN bins as 0.0
      }
      int pos[kIlp];
      if (kSmemBounds) {
        // branch-free search over the P-padded row: P/2, P/4, ..., 1
#pragma unroll
        for (int k = 0; k < kIlp; ++k) pos[k] = 0;
        for (int s = p >> 1; s > 0; s >>= 1) {
#pragma unroll
          for (int k = 0; k < kIlp; ++k) {
            pos[k] += frow[pos[k] + s - 1] < v[k] ? s : 0;
          }
        }
#pragma unroll
        for (int k = 0; k < kIlp; ++k) {
          pos[k] += frow[pos[k]] < v[k] ? 1 : 0;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kIlp; ++k) pos[k] = count_below(frow, b, v[k]);
      }
#pragma unroll
      for (int k = 0; k < kIlp; ++k) {
        const int rk = r + k * rpp;
        if (rk < rows) tile[j * ts + rk] = (OutT)pos[k];
      }
    }
    __syncthreads();
    if (rows == kRows) {
      for (int e = threadIdx.x; e < kRows * ft; e += kThreads) {
        out[(size_t)(f0 + e / kRows) * n + r0 + e % kRows] =
            tile[(e / kRows) * ts + e % kRows];
      }
    } else {
      for (int e = threadIdx.x; e < rows * ft; e += kThreads) {
        const int jj = e / rows;
        const int r = e - jj * rows;
        out[(size_t)(f0 + jj) * n + r0 + r] = tile[jj * ts + r];
      }
    }
    __syncthreads();
  }
}

template <typename OutT, bool kSmemBounds>
int launch_tiles(const float* x, int64_t n, int c, const int* cols, int f,
                 const float* bounds, int b, int feat_tile, size_t smem,
                 void* out, int sms, cudaStream_t stream) {
  auto kernel = bin_dense_kernel<OutT, kSmemBounds>;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem) != cudaSuccess || per_sm < 1) {
    per_sm = 1;
  }
  const int feat_tiles = (f + feat_tile - 1) / feat_tile;
  const int64_t row_tiles = (n + kRows - 1) / kRows;
  int64_t gx = ((int64_t)sms * per_sm + feat_tiles - 1) / feat_tiles;
  if (gx > row_tiles) gx = row_tiles;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned)gx, (unsigned)feat_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(x, n, c, cols, f, bounds, b,
                                          feat_tile,
                                          static_cast<OutT*>(out));
  return cudaGetLastError() == cudaSuccess ? kOk : kLaunch;
}

template <typename OutT>
int launch(const float* x, int64_t n, int c, const int* cols, int f,
           const float* bounds, int b, void* out, int sms,
           cudaStream_t stream) {
  const size_t per_feat_tile = (size_t)tile_stride<OutT>() * sizeof(OutT);
  const size_t per_feat_bounds = (size_t)smem_bound_stride(b) * sizeof(float);
  int feat_tile = (int)(kSmemBudget / (per_feat_tile + per_feat_bounds));
  const bool smem_bounds = feat_tile >= 1;
  if (!smem_bounds) {                       // bounds stay in device memory
    feat_tile = (int)(kSmemBudget / per_feat_tile);
  }
  feat_tile = feat_tile < f ? feat_tile : f;
  feat_tile = feat_tile < kMaxFeatTile ? feat_tile : kMaxFeatTile;
  if ((f + feat_tile - 1) / feat_tile > 65535) return kBadArgs;
  const size_t smem = (size_t)feat_tile *
                      (per_feat_tile + (smem_bounds ? per_feat_bounds : 0));
  if (smem_bounds) {
    return launch_tiles<OutT, true>(x, n, c, cols, f, bounds, b, feat_tile,
                                    smem, out, sms, stream);
  }
  return launch_tiles<OutT, false>(x, n, c, cols, f, bounds, b, feat_tile,
                                   smem, out, sms, stream);
}

}  // namespace

extern "C" {

// x (n, c) float32 row-major; cols (f,) int32 column of each feature;
// bounds (f, b) float32 row-major; out (f, n) of out_bytes (1: uint8,
// 2: int16, 4: int32). Launches on `stream`; returns a Status.
int bin_dense(const float* x, long long n, int c, const int* cols, int f,
              const float* bounds, int b, void* out, int out_bytes, int sms,
              cudaStream_t stream) {
  if (x == nullptr || cols == nullptr || bounds == nullptr ||
      out == nullptr || n <= 0 || c <= 0 || f <= 0 || b <= 0 || sms <= 0 ||
      b > (1 << 30)) {
    return kBadArgs;
  }
  switch (out_bytes) {
    case 1:
      return launch<uint8_t>(x, n, c, cols, f, bounds, b, out, sms, stream);
    case 2:
      return launch<int16_t>(x, n, c, cols, f, bounds, b, out, sms, stream);
    case 4:
      return launch<int32_t>(x, n, c, cols, f, bounds, b, out, sms, stream);
    default:
      return kBadWidth;
  }
}

const char* bin_status_string(int status) {
  switch (status) {
    case kOk: return "ok";
    case kBadArgs: return "bad arguments";
    case kBadWidth: return "output width must be 1, 2 or 4 bytes";
    case kLaunch: return "kernel launch failed (cudaGetLastError)";
    default: return "unknown status";
  }
}

}  // extern "C"
