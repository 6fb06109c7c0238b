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
// searches are shared-memory loads, 9 a value at 255 bins (252 M at the
// bench shape): about 0.04 ms of the SMs' shared-memory pipes when no two
// lanes of a warp meet in a bank, so loads, searches and stores must all
// overlap. Two routes.
//
// The lane route (bin_lane_kernel; up to 1,024 padded bounds a feature)
// replaced the first design (the direct route below) as the one the
// bench takes. Splitting the first design's 0.145 ms at the bench shape
// (bench/bin_split.py, H100) gave its loads and stores alone 0.083 ms and
// its searches and stores alone 0.126: too few loads in flight, and
// searches whose random positions met in banks. A first redesign that
// staged row tiles in a shared-memory ring with cp.async (8 warps an SM,
// its shared-memory limit raised on every launch) took 0.176 ms. So:
// 1. Bank-free searches. A group of up to 32 features (blockIdx.y) has a
//    (P, 32) table in shared memory: column l holds feature l % fg of
//    the group's fg, padded with +inf to a power of two P; bound k of
//    column l at k * 32 + l. Lane l searches only column l, so its loads
//    always hit bank l, whatever the positions; a group of fewer than 32
//    features is searched 32 / fg rows at once. Each block lays out its
//    table from the bounds once, 128 bounds of each column at a time:
//    coalesced loads into a padded (32, 129) stage, the next chunk's
//    loads in flight while the stage is transposed into the table, no
//    bank conflict on either side.
// 2. Loads in flight. Lane (sub, j) bins feature j for 32 bytes of
//    output rows (32 uint8, 16 int16 or 8 int32 bins): kLaneIlp values
//    at a time loaded straight into registers (a warp reads whole rows
//    of x, 112 bytes at 28 features), then searched in lockstep; 512
//    threads a block, a persistent grid, so many warps' loads are in
//    flight while others search. A step is one shared load at an
//    immediate offset, a compare, a select and an add (P = 256 and
//    1,024 unrolled). Prefetching the next values during a search (in
//    registers, or with cp.async into a per-warp buffer), ILP 4 or 16
//    and 256-thread blocks measured no faster (bench/bin_split.py).
// 3. Whole-sector stores. The lane packs its bins into eight words and
//    stores them with two 16-byte stores (scalar stores where the output
//    row is not 16-byte aligned or the matrix ends): no shared-memory
//    transpose.
// Any x works: a misaligned view, a column subset, a ragged end.
//
// The direct route (bin_dense_kernel; more than 1,024 bounds, the first
// design; bin_dense picks the route by the bounds' count): a block keeps
// its feature tile's bounds in at most 48 KB of static shared memory
// (rows of bounds of more than 8,192 are searched in device memory
// through L1/L2 with a plain lower bound instead), walks 256-row tiles
// grid-stride, each thread loading kIlp values and running their
// searches in lockstep, and stores through a shared (features, 256 rows)
// transpose tile. Not redesigned: at 3,000 int16 bins on the bench
// matrix it takes 0.576 ms on an H100, above torch.searchsorted's 0.475.
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

// --------------------------------------------------------- lane route

constexpr int kLaneThreads = 512;
constexpr int kLaneMaxP = 1024;             // padded bounds a feature
// values a lane loads, then searches in lockstep (with the block size,
// the plan bench/bin_split.py --sweep chose)
constexpr int kLaneIlp = 8;

// Rows one lane bins: 32 bytes of its feature's output row.
template <typename OutT>
__host__ __device__ constexpr int rows_lane() {
  return 32 / (int)sizeof(OutT);
}

// kIlp values of a lane's rows r, r + 1, ... (feature column `col`):
// -inf past the matrix, NaN read as 0.0.
template <int kIlp>
__device__ __forceinline__ void load_unit(float (&v)[kIlp],
                                          const float* __restrict__ x,
                                          int64_t r, int64_t n, int c,
                                          int col) {
  const float* xp = x + r * c + col;
  const int64_t left = n - r;
  if (left >= kIlp) {                          // a whole unit: no checks
#pragma unroll
    for (int k = 0; k < kIlp; ++k) v[k] = xp[k * c];
  } else {
    const int lim = left > 0 ? (int)left : 0;
#pragma unroll
    for (int k = 0; k < kIlp; ++k) v[k] = k < lim ? xp[k * c] : -CUDART_INF_F;
  }
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    if (v[k] != v[k]) v[k] = 0.0f;
  }
}

__device__ __forceinline__ void store_v4(void* p, unsigned a, unsigned b,
                                         unsigned c, unsigned d) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

constexpr int kStageK = 128;                 // bounds of a column a chunk
constexpr int kStageStride = kStageK + 1;   // odd: no bank conflicts

// Bounds k0 + e % kStageK of columns e / kStageK for the thread's
// entries e of a chunk: +inf past b.
__device__ __forceinline__ void load_chunk(
    float (&r)[32 * kStageK / kLaneThreads], const float* __restrict__ bounds,
    int b, int f0, int fg, int k0) {
#pragma unroll
  for (int i = 0; i < 32 * kStageK / kLaneThreads; ++i) {
    const int e = threadIdx.x + i * kLaneThreads;
    const int k = k0 + e % kStageK;
    r[i] = k < b ? bounds[(size_t)(f0 + (e / kStageK) % fg) * b + k]
                 : CUDART_INF_F;
  }
}

// The group's (p, 32) table in shared memory: bound k of column l
// (feature f0 + l % fg) at k * 32 + l, +inf past b. kStageK bounds a
// column at a time: loaded coalesced into the padded stage (a warp reads
// 32 bounds of one column), then transposed into the table (a warp writes
// one row of it, lane l from column l), the next chunk's loads issued
// before the transpose.
__device__ __forceinline__ void lay_out_table(const float* __restrict__ bounds,
                                              int b, int f0, int fg, int p,
                                              float* tab, float* stage) {
  constexpr int kPer = 32 * kStageK / kLaneThreads;
  float r[kPer];
  load_chunk(r, bounds, b, f0, fg, 0);
  for (int k0 = 0; k0 < p; k0 += kStageK) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kLaneThreads;
      stage[(e / kStageK) * kStageStride + e % kStageK] = r[i];
    }
    __syncthreads();
    if (k0 + kStageK < p) load_chunk(r, bounds, b, f0, fg, k0 + kStageK);
    const int entries = min(kStageK, p - k0) * 32;
    for (int e = threadIdx.x; e < entries; e += kLaneThreads) {
      tab[k0 * 32 + e] = stage[(e & 31) * kStageStride + (e >> 5)];
    }
    __syncthreads();
  }
}

// Dynamic shared memory of a lane block: the table and the stage.
inline size_t lane_smem(int p) {
  return ((size_t)p * 32 + 32 * kStageStride) * sizeof(float);
}

// kLogP > 0: P = 1 << kLogP known at compile time (each step's offset an
// immediate); 0: P at run time. At least one block an SM, so ptxas may
// take up to 128 registers (left to itself, it held the int16 instance
// at P = 1,024 to 40 and spilled).
template <typename OutT, int kLogP>
__global__ void __launch_bounds__(kLaneThreads, 1)
bin_lane_kernel(const float* __restrict__ x, int64_t n, int c,
                const int* __restrict__ cols, int f,
                const float* __restrict__ bounds, int b, int p_run,
                OutT* __restrict__ out) {
  extern __shared__ __align__(16) float tab[];
  constexpr int kRL = rows_lane<OutT>();
  constexpr int kIlp = kRL < kLaneIlp ? kRL : kLaneIlp;
  constexpr int kUnits = kRL / kIlp;                 // load units a pass
  constexpr int kPer = 4 / (int)sizeof(OutT);       // bins a 32-bit word
  constexpr unsigned kMask = (unsigned)((1ull << (8 * sizeof(OutT))) - 1ull);
  const int p = kLogP > 0 ? (1 << kLogP) : p_run;
  const int f0 = blockIdx.y * 32;
  const int fg = min(32, f - f0);
  const int rpw = 32 / fg;                           // row blocks a warp
  lay_out_table(bounds, b, f0, fg, p, tab, tab + (size_t)p * 32);
  const int lane = threadIdx.x & 31;
  const int sub = lane / fg;
  const int j = lane - sub * fg;
  const int rows_warp = rpw * kRL;
  const int64_t passes = (n + rows_warp - 1) / rows_warp;
  const int64_t step = (int64_t)gridDim.x * (blockDim.x >> 5);
  int64_t ps = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (sub >= rpw || ps >= passes) return;      // no barrier below
  const int col = cols[f0 + j];
  const float* tcol = tab + lane;
  OutT* orow = out + (size_t)(f0 + j) * n;
  // the lane's pass ps covers rows ps * rows_warp + sub * kRL, + kRL
  for (; ps < passes; ps += step) {
    const int64_t rb = ps * rows_warp + (int64_t)sub * kRL;
    unsigned w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = 0u;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      float v[kIlp];
      load_unit<kIlp>(v, x, rb + u * kIlp, n, c, col);
      // branch-free search over the P-padded column: P/2, ..., 1; q[k]
      // walks the column (bound i at q[32 i]), so a step is one load at
      // an immediate offset, a compare, a select and an add
      const float* q[kIlp];
#pragma unroll
      for (int k = 0; k < kIlp; ++k) q[k] = tcol;
#pragma unroll
      for (int st = p >> 1; st > 0; st >>= 1) {
#pragma unroll
        for (int k = 0; k < kIlp; ++k) {
          q[k] += q[k][(st - 1) * 32] < v[k] ? st * 32 : 0;
        }
      }
#pragma unroll
      for (int k = 0; k < kIlp; ++k) {
        const int pos = (int)((q[k] - tcol) >> 5) + (*q[k] < v[k] ? 1 : 0);
        const int kk = u * kIlp + k;
        w[kk / kPer] |= ((unsigned)pos & kMask)
                        << (8 * (int)sizeof(OutT) * (kk % kPer));
      }
    }
    if (rb >= n) continue;
    OutT* dst = orow + rb;
    if (rb + kRL <= n && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      store_v4(dst, w[0], w[1], w[2], w[3]);   // one whole 32-byte sector
      store_v4(reinterpret_cast<char*>(dst) + 16, w[4], w[5], w[6], w[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kRL; ++k) {
        if (rb + k < n) {
          dst[k] = (OutT)((w[k / kPer] >> (8 * (int)sizeof(OutT) *
                                          (k % kPer))) & kMask);
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Raise a lane kernel's shared-memory limit once per (device, size) and
// return the blocks an SM holds (cached: the attribute call is not made
// on every launch).
template <typename OutT, int kLogP>
int lane_blocks_per_sm(size_t smem, int* per_sm) {
  static size_t allowed[kMaxDevices] = {};
  static int resident[kMaxDevices] = {};
  static size_t sized[kMaxDevices] = {};
  auto kernel = bin_lane_kernel<OutT, kLogP>;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) {
    return kLaunch;
  }
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess) {
      return kLaunch;
    }
    allowed[dev] = smem;
  }
  if (sized[dev] != smem) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, kLaneThreads, smem) != cudaSuccess ||
        blocks < 1) {
      return kLaunch;
    }
    resident[dev] = blocks;
    sized[dev] = smem;
  }
  *per_sm = resident[dev];
  return kOk;
}

template <typename OutT, int kLogP>
int launch_lane_p(const float* x, int64_t n, int c, const int* cols, int f,
                  const float* bounds, int b, int p, void* out, int sms,
                  cudaStream_t stream) {
  auto kernel = bin_lane_kernel<OutT, kLogP>;
  const size_t smem = lane_smem(p);
  int per_sm = 0;
  if (lane_blocks_per_sm<OutT, kLogP>(smem, &per_sm) != kOk) return kLaunch;
  const int groups = (f + 31) / 32;
  const int rows_block = (kLaneThreads / 32) * rows_lane<OutT>() *
                         (32 / (f < 32 ? f : 32));
  const int64_t row_blocks = (n + rows_block - 1) / rows_block;
  int64_t gx = ((int64_t)sms * per_sm + groups - 1) / groups;
  if (gx > row_blocks) gx = row_blocks;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned)gx, (unsigned)groups);
  kernel<<<grid, kLaneThreads, smem, stream>>>(
      x, n, c, cols, f, bounds, b, p, static_cast<OutT*>(out));
  return cudaGetLastError() == cudaSuccess ? kOk : kLaunch;
}

template <typename OutT>
int launch_lane(const float* x, int64_t n, int c, const int* cols, int f,
                const float* bounds, int b, void* out, int sms,
                cudaStream_t stream) {
  const int p = pow2_at_least(b);
  switch (p) {   // the bench's 255 and 1,023 bins, unrolled
    case 256:
      return launch_lane_p<OutT, 8>(x, n, c, cols, f, bounds, b, p, out, sms,
                                    stream);
    case 1024:
      return launch_lane_p<OutT, 10>(x, n, c, cols, f, bounds, b, p, out,
                                     sms, stream);
    default:
      return launch_lane_p<OutT, 0>(x, n, c, cols, f, bounds, b, p, out, sms,
                                    stream);
  }
}

template <typename OutT>
int launch(const float* x, int64_t n, int c, const int* cols, int f,
           const float* bounds, int b, void* out, int sms,
           cudaStream_t stream) {
  if (pow2_at_least(b) <= kLaneMaxP) {
    return launch_lane<OutT>(x, n, c, cols, f, bounds, b, out, sms, stream);
  }
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
// 2: int16, 4: int32). One launch on `stream`: the lane route up to
// kLaneMaxP bounds, the direct route above. Returns a Status.
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
