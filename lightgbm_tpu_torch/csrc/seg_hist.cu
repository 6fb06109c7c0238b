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
// The TPU kernel slices the segment's geometric chunk bucket, picked by
// lax.switch, and carries the sum in VMEM over a sequential grid. Here
// the host must not learn the segment's size (that would be a host sync
// per split), so the [begin, cnt] bounds stay in device memory and every
// block reads them. The grid spans every (word, chunk) of the WHOLE
// array; a block whose chunk lies outside the cover [c_first, c_last]
// (cover_index's arithmetic, clamped to the array) returns at once, and a
// covered block stages only the sub-chunks that overlap the segment, so
// the work follows the segment, not N. The fold reads the covered chunks
// only, c_first..c_last in order: partials of other chunks are never
// written nor read (trailing zero chunks would change the Kahan bits).
// A block takes one word of four features (kFeatureTile): a segment of
// a few chunks then spreads over W times more blocks. Wider tiles stage
// g, h, w fewer times but measured slower on long segments (PERF.md).
// The rest of the design (staging, peer masks, leader
// accumulation, the fold) is chunk_hist.cuh's; this file says how a
// row is read: a feature's byte is ((unsigned)word >> 8 * (f & 3)) &
// 0xFF (unsigned shift: feature 3 of a word holds the sign bit), and its
// slot is 0 inside [begin, begin + cnt), -1 outside.
//
// Bound on this card. The function must read the segment's words (4W
// bytes a row) and statistics (12 bytes a row) once and write the
// (value, residual) pair: (4W + 12) * cnt + 2 * 4W * B * 12 bytes, 42 MB
// for the root at 1M rows x 28 features (W = 7), about 12.5 us at
// 3.35 TB/s; its three f32 adds per (row, feature) take far less at
// 67 TFLOP/s. The design moves more: up to 2 * (kSub - 1) staged rows
// beyond the segment, g, h, w once per word (from L2 after the chunk's
// first word), and the chunk partials written and read back,
// covered_chunks * 4W * B * 12 bytes (22 MB for the root at 255 bins).

#include "chunk_hist.cuh"

using namespace chunk_hist;

namespace {

// Rows of a (W, N) packed-word array; the slot is 0 inside the segment.
struct SegRows {
  static constexpr int kUnitBytes = 4;
  static constexpr int kFeatPerUnit = 4;
  static constexpr int kFeatureTile = 4;
  static constexpr bool kAux = false;
  static constexpr bool kSkipEmptySteps = false;
  const int* units;
  const int* aux;  // unused: membership is by position
  const int* bounds;
  long lo, hi;

  __device__ bool prepare(int chunk, int n, int& s_first, int& s_last) {
    const Cover cov = read_cover(bounds, n / kChunk);
    if (chunk < cov.c_first || chunk > cov.c_last) return false;
    lo = cov.lo;
    hi = cov.hi;
    const long base = (long)chunk * kChunk;
    const long a = (lo > base ? lo : base) - base;
    const long b = (hi < base + kChunk ? hi : base + kChunk) - base;
    s_first = a < b ? (int)(a / kSub) : 0;
    s_last = a < b ? (int)((b - 1) / kSub) : -1;  // empty: partial of zeros
    return true;
  }

  __device__ int slot(const int*, int, long pos) const {
    return pos >= lo && pos < hi ? 0 : -1;
  }

  __device__ int bin(const unsigned char* units_s, int f, int r) const {
    const unsigned word =
        (unsigned)reinterpret_cast<const int*>(units_s)[(f >> 2) * kSub + r];
    return (int)((word >> (8u * (unsigned)(f & 3))) & 0xFFu);
  }
};

}  // namespace

extern "C" {

// ((num_feat, B, 3) value, residual) over the leaf-ordered rows
// [bounds[0], bounds[0] + bounds[1]); bounds is a (2,) int32 tensor in
// device memory. words: (num_feat / 4, n) int32; ghc_t: (3, n) f32;
// partials: (n / 4096) * num_feat * B * 3 floats of scratch.
int seg_hist(const int* words, const float* ghc_t, const int* bounds,
             int num_feat, int n, int num_bins, float* partials, float* hi,
             float* lo, void* stream) {
  if (num_bins > 256) return kBadShape;
  SegRows rows{words, nullptr, bounds, 0, 0};
  return launch(rows, ghc_t, bounds, n, num_bins, 1, num_feat, partials, hi,
                lo, static_cast<cudaStream_t>(stream));
}

const char* seg_status_string(int status) {
  if (status == kBadShape) return "unsupported shape, bin count or alignment";
  if (status == kNoFit) return "one feature's histogram does not fit in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
