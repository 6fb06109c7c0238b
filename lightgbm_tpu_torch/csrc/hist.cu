// Masked and frontier gradient histograms for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of lightgbm_tpu/ops/pallas_hist.py
// that carry the masked training path:
//   _hist_kernel     (pallas_hist.py:62, pallas_call at :130)  -> masked_hist
//   _frontier_kernel (pallas_hist.py:81, pallas_call at :177)  -> frontier_hist
//
// Both compute, for L distinct leaf ids (L = 1 for masked_hist),
//   hist[l, f, b, :] = sum_c [bins[f, c] == b] * [row_leaf[c] == leaf[l]]
//                            * (g[c], h[c], w[c])
// with ghc_t = (g, h, w) the (3, N) in-bag statistics, as the (value,
// residual) pair of the chunk-order Kahan fold of row-order 4096-row
// chunk partials. The TPU kernels stream the bin matrix through one core
// in grid order and carry a plain f32 sum in VMEM (zero residual,
// pallas_hist.py:148-152); here blocks run in parallel in no order, so
// the sum is split into chunk partials and a fold, and the residual
// keeps the pair contract of the data-parallel and out-of-core slices.
// The design (staged sub-chunks, feature tiles, shared-memory peer
// masks, leader accumulation, empty-step masks, the fold) is
// chunk_hist.cuh's; this file says how a row is read: its bin from the
// (F, N) uint8 or int16 matrix, its slot from row_leaf among the L leaf
// ids (-1 outside the frontier). Rows of a leaf are scattered over the
// array, so most 32-row steps of a small leaf hold none of its rows and
// are skipped (kSkipEmptySteps).
//
// A block takes every feature up to 32 (kFeatureTile, one warp each):
// a chunk's g, h, w and row_leaf are then staged once. Smaller tiles
// stage them once per tile and measured slower on a small leaf, which
// is 62 of a tree's 63 launches (PERF.md).
//
// Bound on this card. Each call must read the bins (F*N bytes at
// uint8), ghc_t (12*N bytes) and row_leaf (4*N bytes) once: 44 MB at
// 1M x 28 uint8, about 13 us at 3.35 TB/s; the outputs are small. The
// design reads g, h, w and row_leaf once per feature tile (one tile at
// up to 32 features) and writes and reads back
// the chunk partials, chunks*L*F*B*12 bytes (22 MB per leaf at 1M x 28 x
// 255, L2-resident): without any step this floor is about 4x the byte
// bound. On top come the steps that hold rows of the frontier (peer
// mask, leader adds) and the serial adds of a bin that many rows of one
// 32-row step share.

#include "chunk_hist.cuh"

using namespace chunk_hist;

namespace {

// Rows of a (F, N) bin matrix; the slot is row_leaf's place among the
// frontier's leaf ids.
template <typename BinT>
struct LeafRows {
  static constexpr int kUnitBytes = sizeof(BinT);
  static constexpr int kFeatPerUnit = 1;
  static constexpr int kFeatureTile = kMaxWarps;
  static constexpr bool kAux = true;  // row_leaf is staged
  static constexpr bool kSkipEmptySteps = true;
  const BinT* units;
  const int* aux;
  const int* leaf_ids;
  int num_leaf;
  int leaf[kMaxSlots];

  __device__ bool prepare(int, int, int& s_first, int& s_last) {
#pragma unroll
    for (int l = 0; l < kMaxSlots; ++l) leaf[l] = l < num_leaf ? leaf_ids[l] : 0;
    s_first = 0;
    s_last = kChunk / kSub - 1;
    return true;
  }

  __device__ int slot(const int* aux_s, int r, long) const {
    const int rl = aux_s[r];
    int slot = -1;
#pragma unroll
    for (int l = 0; l < kMaxSlots; ++l)
      slot = (l < num_leaf && rl == leaf[l]) ? l : slot;
    return slot;
  }

  __device__ int bin(const unsigned char* units_s, int f, int r) const {
    return (int)reinterpret_cast<const BinT*>(units_s)[f * kSub + r];
  }
};

template <typename BinT>
int run(const void* bins, const float* ghc_t, const int* row_leaf,
        const int* leaf_ids, int num_leaf, int num_feat, int n, int num_bins,
        float* partials, float* hi, float* lo, void* stream) {
  LeafRows<BinT> rows{static_cast<const BinT*>(bins), row_leaf, leaf_ids,
                      num_leaf, {}};
  return launch(rows, ghc_t, nullptr, n, num_bins, num_leaf, num_feat,
                partials, hi, lo, static_cast<cudaStream_t>(stream));
}

int dispatch(const void* bins, int bin_bytes, const float* ghc_t,
             const int* row_leaf, const int* leaf_ids, int num_leaf,
             int num_feat, int n, int num_bins, float* partials, float* hi,
             float* lo, void* stream) {
  if (bin_bytes == 1)
    return run<uint8_t>(bins, ghc_t, row_leaf, leaf_ids, num_leaf, num_feat, n,
                        num_bins, partials, hi, lo, stream);
  if (bin_bytes == 2)
    return run<int16_t>(bins, ghc_t, row_leaf, leaf_ids, num_leaf, num_feat, n,
                        num_bins, partials, hi, lo, stream);
  return kBadShape;
}

}  // namespace

extern "C" {

// (F, B, 3) pair of the rows with row_leaf == *leaf_id (one leaf id in
// device memory). partials: chunks*F*B*3 floats of scratch.
int masked_hist(const void* bins, int bin_bytes, const float* ghc_t,
                const int* row_leaf, const int* leaf_id, int num_feat, int n,
                int num_bins, float* partials, float* hi, float* lo,
                void* stream) {
  return dispatch(bins, bin_bytes, ghc_t, row_leaf, leaf_id, 1, num_feat, n,
                  num_bins, partials, hi, lo, stream);
}

// (L, F, B, 3) pair for L distinct leaf ids in device memory, one pass
// over the bins. partials: chunks*L*F*B*3 floats of scratch.
int frontier_hist(const void* bins, int bin_bytes, const float* ghc_t,
                  const int* row_leaf, const int* leaf_ids, int num_leaf,
                  int num_feat, int n, int num_bins, float* partials,
                  float* hi, float* lo, void* stream) {
  return dispatch(bins, bin_bytes, ghc_t, row_leaf, leaf_ids, num_leaf,
                  num_feat, n, num_bins, partials, hi, lo, stream);
}

const char* hist_status_string(int status) {
  if (status == kBadShape) return "unsupported shape, bin width or alignment";
  if (status == kNoFit) return "one feature's histogram does not fit in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int hist_max_leaves() { return kMaxSlots; }

}  // extern "C"
