// Gather-compacted leaf histogram for Hopper (sm_90a).
//
// Replaces the JAX package's gather-compacted engine, an XLA program with
// no Pallas kernel:
//   compacted_histograms (lightgbm_tpu/ops/histogram.py:573; off the TPU
//   its host route _compacted_bincount, :527)          -> compacted_hist
//
// Given `src`, the positions of one leaf's rows in their original order
// (compact.cu compact_rows), and `count`, their number in device memory,
// it computes
//   hist[f, b, :] = sum_{p < count} [bins[f, src[p]] == b]
//                   * (g[src[p]], h[src[p]], w[src[p]])
// as the (value, residual) pair of the chunk-order Kahan fold of
// row-order partials over HIST_CHUNK = 4096-row pieces of the compacted
// buffer, the last one ragged: max(ceil(count / 4096), 1) partials, no
// trailing padding chunk (a trailing zero chunk would change the Kahan
// bits). That is the chunking of _compacted_bincount; its partials are
// float64 sums cast to float32, these are float32 row-order sums, so the
// two agree to float32 rounding, not in bits.
//
// The host must not learn the count (a host sync per split), so the grid
// spans every (tile, chunk) of the whole buffer and a block past the
// count's cover returns at once; the fold reads the covered chunks only.
// The rest of the design (staging double-buffered, peer masks, leader
// accumulation, the fold) is chunk_hist.cuh's; this file says how a row
// is read: a block first brings its chunk's 4096 positions into shared
// memory (16-byte cp.async), then gathers each sub-chunk's statistics
// and bins from the (3, N) and (F, N) arrays with 4-byte cp.async
// copies (a gathered row has no 16-byte run; a bin comes as the aligned
// word that holds it, shifted out by the row's position), so the next
// sub-chunk's gathers are in flight while this one is summed; its slot
// is 0 below the count, -1 past it.
//
// Layout. The bins stay feature-major (F, N): a warp's 32 gathered rows
// of one feature touch min(32, 1 + 1/d) sectors, d the leaf's share of
// the rows in their span, so a split costs about min(N, 32 * count)
// bytes a feature against the masked scan's N; a row-major (N, F) copy
// would cost one or two sectors a row but a second copy of the matrix
// (PERF.md, PR 9).
//
// A block takes four features (kFeatureTile, one warp each). A chunk's
// 128 32-row steps a feature run one after another, each a chain of
// shared-memory round trips, so a leaf of a few chunks is bound by that
// chain; four-feature tiles spread a chunk over seven blocks at 28
// features. Measured against 1, 2, 8, 16 and 32 (PERF.md, PR 9,
// bench/compact_tiles.py): the fastest at 1% and 10% leaves and in the
// fused round; 32 is faster on a 50% leaf, which a tree has few of.
//
// Bound on this card. The function must read src (4 bytes a row) and
// the count, the leaf's bins and statistics (F * bin bytes + 12 a row)
// once and write the (value, residual) pair: at 1M x 28 uint8 and 255
// bins, (4 + 28 + 12) * count + 171 KB bytes.

#include "chunk_hist.cuh"

using namespace chunk_hist;

namespace {

// Rows of a (F, N) bin matrix gathered through a compacted index buffer;
// the slot is 0 below the count. A staged unit is one 4-byte word per
// (feature, row): the aligned word that holds the row's bin, which
// bin() shifts out by the row's position (staged as the aux row).
template <typename BinT>
struct GatherRows {
  static constexpr int kUnitBytes = 4;
  static constexpr int kFeatPerUnit = 1;
  static constexpr int kFeatureTile = 4;
  static constexpr bool kAux = true;  // each staged row's position
  static constexpr bool kSkipEmptySteps = false;
  static constexpr bool kGather = true;
  const BinT* units;
  const int* aux;  // = src (the alignment check of launch)
  const int* src;
  const int* count;
  long cnt, chunk_base;
  const int* src_s;  // the chunk's index buffer in shared memory

  __device__ bool prepare(int chunk, int n, int& s_first, int& s_last) {
    const Cover cov = read_count_cover(count, n / kChunk);
    if (chunk > cov.c_last) return false;
    cnt = cov.hi;
    chunk_base = (long)chunk * kChunk;
    const long rows = cnt - chunk_base < kChunk ? cnt - chunk_base : kChunk;
    s_first = 0;
    s_last = rows > 0 ? (int)((rows - 1) / kSub) : -1;  // empty: zeros
    return true;
  }

  // The chunk's positions src[chunk_base ..] (those below the count)
  // into shared memory, once a block, before the first sub-chunk.
  __device__ void load_index(int, unsigned char* dst) {
    src_s = reinterpret_cast<const int*>(dst);
    const long rows = cnt - chunk_base < kChunk ? cnt - chunk_base : kChunk;
    const int pieces = rows > 0 ? (int)((rows + 3) / 4) : 0;
    for (int i = threadIdx.x; i < pieces; i += blockDim.x)
      cp_async16(dst + 16 * i, src + chunk_base + 4 * i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  __device__ int slot(const int*, int, long pos) const {
    return pos < cnt ? 0 : -1;
  }

  __device__ int bin(const unsigned char* units_s, const int* aux_s, int f,
                     int r) const {
    const unsigned word = reinterpret_cast<const unsigned*>(units_s)[f * kSub + r];
    const unsigned shift = 8u * (((unsigned)aux_s[r] * sizeof(BinT)) & 3u);
    return sizeof(BinT) == 1 ? (int)((word >> shift) & 0xFFu)
                             : (int)(short)((word >> shift) & 0xFFFFu);
  }

  // Issue the sub-chunk at buffer position `base`: g, h, w and `units_n`
  // bin words of each row below the count, 4-byte cp.async copies
  // through the index buffer (they land while the previous sub-chunk is
  // summed), and each row's position as the aux row.
  __device__ void gather(const float* __restrict__ ghc_t, long n, long base,
                         int unit0, int units_n, unsigned char* dst) const {
    float* stats = reinterpret_cast<float*>(dst);
    int* pos_s = reinterpret_cast<int*>(dst + kSub * 12);
    unsigned char* words = dst + kSub * 16;
    const long off = base - chunk_base;
    const int total = (3 + units_n) * kSub;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int a = i / kSub;
      const int r = i & (kSub - 1);
      if (base + r >= cnt) continue;
      const long row = src_s[off + r];
      if (a < 3) {
        cp_async4(stats + a * kSub + r, ghc_t + a * n + row);
        if (a == 0) pos_s[r] = (int)row;
      } else {
        const uintptr_t at = reinterpret_cast<uintptr_t>(
            units + (long)(unit0 + a - 3) * n + row);
        cp_async4(words + 4 * ((a - 3) * kSub + r),
                  reinterpret_cast<const void*>(at & ~uintptr_t(3)));
      }
    }
  }
};

template <typename BinT>
int run(const void* bins, const float* ghc_t, const int* src,
        const int* count, int num_feat, int n, int num_bins, float* partials,
        float* hi, float* lo, void* stream) {
  GatherRows<BinT> rows{static_cast<const BinT*>(bins), src, src, count, 0,
                        0, nullptr};
  return launch(rows, ghc_t, count, n, num_bins, 1, num_feat, partials, hi,
                lo, static_cast<cudaStream_t>(stream), true);
}

}  // namespace

extern "C" {

// ((num_feat, B, 3) value, residual) over the rows src[0 .. *count) of
// the (num_feat, n) bins (bin_bytes 1 or 2) and the (3, n) statistics;
// src: (n,) int32 positions, count: one int32 in device memory.
// partials: (n / 4096) * num_feat * B * 3 floats of scratch.
int compacted_hist(const void* bins, int bin_bytes, const float* ghc_t,
                   const int* src, const int* count, int num_feat, int n,
                   int num_bins, float* partials, float* hi, float* lo,
                   void* stream) {
  if (bin_bytes == 1)
    return run<uint8_t>(bins, ghc_t, src, count, num_feat, n, num_bins,
                        partials, hi, lo, stream);
  if (bin_bytes == 2)
    return run<int16_t>(bins, ghc_t, src, count, num_feat, n, num_bins,
                        partials, hi, lo, stream);
  return kBadShape;
}

const char* compact_hist_status_string(int status) {
  if (status == kBadShape) return "unsupported shape, bin width or alignment";
  if (status == kNoFit) return "one feature's histogram does not fit in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
