// Masked and frontier gradient histograms for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of lightgbm_tpu/ops/pallas_hist.py
// that carry the masked training path:
//   _hist_kernel     (pallas_hist.py:62, pallas_call at :130)  -> masked_hist
//   _frontier_kernel (pallas_hist.py:81, pallas_call at :177)  -> frontier_hist
// and the out-of-core pass's block fold of lightgbm_tpu/ops/histogram.py
//   hist_pair_fold_block (:277) / hist_pair_fold_collapse (:324)
//                                                          -> hist_pair_fold
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
// hist_pair_fold is masked_hist's function over one row block of an
// out-of-core pass (data/ooc_learner.py), continued from the carry
// (acc, comp) of the blocks before it and written back in place: each
// (chunk, feature, bin) cell's partial is the f32 sum of the leaf's rows
// in row order from +0.0, and the block's partials are folded into the
// carry in chunk order with kahan_fold's arithmetic. Blocks hold whole
// 4096-row chunks, so a pass's blocks folded in row order walk the chunk
// sequence of masked_hist over the whole array, and the collapse
// acc + ((-comp) + 0.0) gives its bits. It has a design of its own
// (pair_fold_kernel, one launch), because one block is a few dozen
// chunks: masked_hist's grid of one block a chunk fills less than half
// the card there, and its blocks stage every row whatever the leaf.
//   - The grid fills the card: a block takes a (chunk, feature tile),
//     the tile the fewest features (one warp each, at most kMaxTile)
//     that fit every block in one wave (kResident blocks an SM; 5
//     features at 262,144 rows: 384 blocks; 1 at 65,536: 448). A
//     chunk's tiles have adjacent block indices: its row_leaf and the
//     leaf's g, h, w come from L2 after the first tile reads them.
//   - It reads only the leaf's rows: the chunk's row_leaf (16 KB) once,
//     turned into the in-order list of the leaf's rows (a mask a thread
//     and a block prefix), then, in segments of kSeg list entries,
//     double buffered, each entry's g, h, w and the 4-byte word of each
//     tile feature's bin, copied with cp.async. A dense leaf's list is
//     consecutive rows, so its copies coalesce as whole-row staging
//     would; a sparse leaf's touch one sector a row. One path serves
//     every leaf.
//   - Warp u walks feature f0 + u's list in 32-entry steps with
//     chunk_hist.cuh's peer masks and leader accumulation: the chain of
//     every cell is its rows in row order, so its bits are the plain
//     version's (ops/hist_kernels.py chunk_partials_plain). The serial
//     depth is ceil(leaf rows / 32) steps a chunk instead of 128.
//   - The fold is in the same launch: each block writes its partial
//     (rows padded to float4s) to the scratch, fences, and counts
//     itself on its tile; the tile's last blocks to count fold its cells
//     in slices (at most kFoldBytes of partials each, staged with
//     16-byte cp.async, a thread a cell), the last without waiting, the
//     others once every block of the tile has counted. The bits do not
//     depend on which blocks fold. No float atomics.
// Bound per call: row_leaf read once (4 bytes a row), the leaf's rows'
// bins and statistics (F * bin bytes + 12 a leaf row) and the carry read
// and written once (2 x 2 x F*B*12 bytes). On top, the design writes
// and reads back the partials, chunks*F*pad*4 bytes (5.5 MB at 262,144
// rows x 28 x 255, L2-resident), each tile reads the chunk's row_leaf
// and the leaf's statistics again from L2, and a gathered row costs a
// 32-byte sector a feature. A sparse leaf's call is a chain of
// dependent steps (row_leaf, the gathers, the walk, the partial and its
// count, the slice's staging and fold) of about a microsecond each;
// a dense leaf's is the walk, one warp's 32-row steps (PERF.md).
//
// masked_hist's block takes every feature up to 32 (kFeatureTile, one
// warp each): a chunk's g, h, w and row_leaf are then staged once.
// Smaller tiles stage them once per tile and measured slower on a small
// leaf, which is 62 of a tree's 63 launches (PERF.md).
//
// Bound of masked_hist on this card. Each call must read the bins (F*N bytes at
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
  static constexpr bool kGather = false;
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

  __device__ int bin(const unsigned char* units_s, const int*, int f,
                     int r) const {
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

// ------------------------------------------------------ hist_pair_fold

constexpr int kFoldThreads = 256;
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kScanRows = kChunk / kFoldThreads;  // row_leaf a thread
constexpr int kSeg = 512;             // list entries staged at once
constexpr int kMaxTile = kFoldWarps;  // features a block, one warp each
constexpr int kResident = 4;          // blocks an SM (64 registers a thread)
constexpr int kFoldBytes = 65536;     // partials a slice's fold stages
constexpr int kMisc = 64;             // scan sums and flags, first
constexpr int kTagWords = 1;          // peer masks from tag words (if they fit)

// A feature's chunk partial row, padded to whole float4s.
__host__ __device__ constexpr int row_pad(int num_bins) {
  return (3 * num_bins + 3) & ~3;
}

// Byte offsets in dynamic shared memory of a block of `ft` features,
// after the kMisc bytes: the (ft, pad) partial, the leaf's rows of the
// chunk (uint16 offsets, in row order), two staged segments (g, h, w and
// each feature's 4-byte bin words) and each feature's tag words (with
// tags). A fold stages its slice's partials from kMisc on.
struct SumSmem {
  int hist, list, stats, words, tags, bytes;
  __host__ __device__ SumSmem(int ft, int num_bins, bool tags_on) {
    hist = kMisc;
    list = hist + ft * row_pad(num_bins) * 4;
    stats = list + kChunk * 2;
    words = stats + 2 * 3 * kSeg * 4;
    tags = words + 2 * ft * kSeg * 4;
    bytes = tags + (tags_on ? ft * num_bins * 4 : 0);
  }
};

// The launch, planned on the host (fold_plan): a block a (chunk,
// feature tile of ft), tile-minor; a feature's padded row folds in
// `slices` slices of `slice` float4 groups. With `helpers` the tile's
// last blocks to count its partials fold one slice each; without, its
// last block folds them all.
struct FoldPlan {
  int chunks, ft, tiles, slice, slices, smem;
  bool tags, helpers;
};

// The counters of the caller's int32 scratch (2F ints, all zero between
// calls), per tile: its blocks that have counted their partial, and
// those that are done with the counters. The tile's last block to be
// done sets both back to zero.
struct FoldWords {
  int *arrived, *exited;
  __device__ FoldWords(int* w, int num_feat)
      : arrived(w), exited(w + num_feat) {}
};

// Exclusive prefix of `own` over the block's threads in order, and the
// block's total. warp_s (kFoldWarps ints) is free again after the
// caller's next barrier.
__device__ __forceinline__ int fold_scan(int own, int* warp_s, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_s[warp] = x;
  __syncthreads();
  int run = x - own;
  total = 0;
#pragma unroll
  for (int w = 0; w < kFoldWarps; ++w) {
    const int s = warp_s[w];
    run += w < warp ? s : 0;
    total += s;
  }
  return run;
}

// Issue the copies of list entries [lo, lo + cnt): each entry's g, h, w
// and, for the tile's nf features, the aligned 4-byte word that holds
// its bin (4-byte cp.async: a gathered row has no 16-byte run).
template <typename BinT>
__device__ __forceinline__ void stage_segment(
    const BinT* __restrict__ bins, const float* __restrict__ ghc_t, long n,
    long base, int f0, int nf, const unsigned short* list_s, int lo, int cnt,
    float* stats, unsigned* words) {
  for (int j = threadIdx.x; j < cnt; j += kFoldThreads) {
    const long row = base + list_s[lo + j];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      cp_async4(stats + a * kSeg + j, ghc_t + a * n + row);
    for (int u = 0; u < nf; ++u) {
      const uintptr_t at =
          reinterpret_cast<uintptr_t>(bins + (long)(f0 + u) * n + row);
      cp_async4(words + u * kSeg + j,
                reinterpret_cast<const void*>(at & ~uintptr_t(3)));
    }
  }
}

// The chunk partial of one (chunk, feature tile), in hist_s:
//   1. the chunk's row_leaf (16-byte loads) becomes the in-order list of
//      the leaf's rows (a mask a thread and a block prefix);
//   2. the list in segments of kSeg entries, double buffered: each
//      entry's g, h, w and bin words copied into shared memory, then
//      warp u walks feature f0 + u's entries in 32-entry steps with the
//      peer masks and leader accumulation of chunk_hist.cuh, so each
//      cell is the row-order f32 sum of its rows from +0.0 (a bin
//      outside [0, num_bins) is dropped).
template <typename BinT>
__device__ __forceinline__ void chunk_sum(
    const BinT* __restrict__ bins, const float* __restrict__ ghc_t,
    const int* __restrict__ row_leaf, int leaf, int n, int num_bins,
    const FoldPlan& p, const SumSmem& L, long base, int f0, int nf,
    unsigned char* smem) {
  int* misc = reinterpret_cast<int*>(smem);
  float* hist_s = reinterpret_cast<float*>(smem + L.hist);
  unsigned short* list_s = reinterpret_cast<unsigned short*>(smem + L.list);
  float* stats_s = reinterpret_cast<float*>(smem + L.stats);
  unsigned* words_s = reinterpret_cast<unsigned*>(smem + L.words);
  unsigned* tags = reinterpret_cast<unsigned*>(smem + L.tags);
  const int pad = row_pad(num_bins);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // 1. the leaf's rows, in row order
  int total;
  {
    const int4* src =
        reinterpret_cast<const int4*>(row_leaf + base) + t * (kScanRows / 4);
    int4 v[kScanRows / 4];
#pragma unroll
    for (int q = 0; q < kScanRows / 4; ++q) v[q] = __ldg(src + q);
    for (int i = t; i < nf * pad; i += kFoldThreads) hist_s[i] = 0.0f;
    if (p.tags)
      for (int i = t; i < nf * num_bins; i += kFoldThreads) tags[i] = 0u;
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < kScanRows / 4; ++q)
      m |= (unsigned)(v[q].x == leaf) << (4 * q) |
           (unsigned)(v[q].y == leaf) << (4 * q + 1) |
           (unsigned)(v[q].z == leaf) << (4 * q + 2) |
           (unsigned)(v[q].w == leaf) << (4 * q + 3);
    int pos = fold_scan(__popc(m), misc, total);
    for (; m != 0u; m &= m - 1u)
      list_s[pos++] = (unsigned short)(t * kScanRows + __ffs(m) - 1);
  }
  __syncthreads();  // the list is in; hist and tags zeroed

  // 2. the segments
  const int segs = (total + kSeg - 1) / kSeg;
  if (segs > 0) {
    stage_segment(bins, ghc_t, n, base, f0, nf, list_s, 0, min(kSeg, total),
                  stats_s, words_s);
    cp_async_commit();
  }
  for (int s = 0; s < segs; ++s) {
    const int cur = s & 1;
    if (s + 1 < segs) {
      const int lo = (s + 1) * kSeg;
      stage_segment(bins, ghc_t, n, base, f0, nf, list_s, lo,
                    min(kSeg, total - lo), stats_s + (cur ^ 1) * 3 * kSeg,
                    words_s + (cur ^ 1) * p.ft * kSeg);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this segment landed for every thread
    if (warp < nf) {
      const int lo = s * kSeg;
      const int cnt = min(kSeg, total - lo);
      const float* g_s = stats_s + cur * 3 * kSeg;
      const float* h_s = g_s + kSeg;
      const float* w_s = h_s + kSeg;
      const unsigned* wd = words_s + (cur * p.ft + warp) * kSeg;
      float* hist_f = hist_s + warp * pad;
      unsigned* tag_w = tags + warp * num_bins;
      for (int j0 = 0; j0 < cnt; j0 += 32) {
        const int j = j0 + lane;
        int bin = -1;
        if (j < cnt) {
          const unsigned shift =
              8u * (((unsigned)list_s[lo + j] * sizeof(BinT)) & 3u);
          bin = sizeof(BinT) == 1 ? (int)((wd[j] >> shift) & 0xFFu)
                                  : (int)(short)((wd[j] >> shift) & 0xFFFFu);
        }
        const bool valid = j < cnt && (unsigned)bin < (unsigned)num_bins;
        const unsigned any = __ballot_sync(kFull, valid);
        if (any == 0u) continue;  // warp-uniform
        unsigned peers = any;     // one row: its own lane
        if (any & (any - 1u)) {   // warp-uniform
          if (p.tags) {           // block-uniform
            if (valid) atomicOr(tag_w + bin, 1u << lane);
            __syncwarp();
            if (valid) peers = tag_w[bin];
            __syncwarp();
            if (valid && __ffs(peers) - 1 == lane) tag_w[bin] = 0u;
          } else {
            peers = __match_any_sync(kFull, valid ? bin : -1);
          }
        }
        leader_add(hist_f, valid, peers, bin * 3, g_s[j], h_s[j], w_s[j],
                   lane);
      }
    }
    __syncthreads();  // consumed before the buffer is staged again
  }
}

// One slice of feature f's padded partial row folded over every chunk
// in chunk order into the carry, a thread a cell: kahan_fold's
// arithmetic seeded from (acc, comp) and written back in place. The
// slice's partials of every chunk are staged with 16-byte cp.async and
// folded from shared memory. With `wait`, the carry is read first and
// the fold starts once the tile's blocks have all counted.
__device__ __forceinline__ void fold_slice(
    int num_feat, int num_bins, const FoldPlan& p, int f, int slice,
    bool wait, const int* arrived, unsigned char* smem,
    const float* __restrict__ partials, float* __restrict__ acc,
    float* __restrict__ comp) {
  const int t = threadIdx.x;
  const int pad = row_pad(num_bins);
  const int row_len = 3 * num_bins;
  const int g0 = slice * p.slice;
  const int groups = min(p.slice, pad / 4 - g0);
  const int e = 4 * g0 + t;  // this thread's cell in the padded row
  const bool mine = t < 4 * groups && e < row_len;
  float a = 0.0f, k = 0.0f;
  if (mine) {
    a = acc[(long)f * row_len + e];
    k = comp[(long)f * row_len + e];
  }
  if (wait && t == 0) {
    while (*reinterpret_cast<const volatile int*>(arrived) < p.chunks)
      __nanosleep(32);
  }
  __syncthreads();  // every chunk's partial counted; smem free
  __threadfence();
  float* buf = reinterpret_cast<float*>(smem + kMisc);
  const float* src = partials + (long)f * pad + 4 * g0;
  for (int i = t; i < p.chunks * groups; i += kFoldThreads) {
    const int c = i / groups;
    cp_async16(buf + 4 * i,
               src + (long)c * num_feat * pad + 4 * (i - c * groups));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (mine) {
    const int stride = 4 * groups;
#pragma unroll 8
    for (int c = 0; c < p.chunks; ++c) {
      const float y = buf[c * stride + t] - k;
      const float s = a + y;
      k = (s - a) - y;
      a = s;
    }
    acc[(long)f * row_len + e] = a;
    comp[(long)f * row_len + e] = k;
  }
  __syncthreads();  // the staging buffer is free again
}

// One launch of hist_pair_fold, a block a (chunk, feature tile): the
// chunk partial written to the scratch, a fence, and one count on the
// tile. A tile's cells fold in S = nf * slices slices, by the blocks
// that count last: the one that counts k-th from last (k < S) folds
// slice S - 1 - k after waiting for the others to count; the last folds
// slice S - 1 and, where the tile has fewer than S blocks, the slices
// no block counts for. The blocks a helper waits for hold an SM or will
// get one: the plan keeps the helpers of the whole grid below the blocks
// the card holds at once (else the last block folds every slice), so
// helpers never fill the card. The tile's last block to be done sets its
// counters back to zero. No float atomics: two launches give the same
// bits, whichever blocks fold.
template <typename BinT>
__global__ void __launch_bounds__(kFoldThreads, kResident)
    pair_fold_kernel(const BinT* __restrict__ bins,
                     const float* __restrict__ ghc_t,
                     const int* __restrict__ row_leaf,
                     const int* __restrict__ leaf_id, int num_feat, int n,
                     int num_bins, FoldPlan p, float* __restrict__ partials,
                     int* __restrict__ words, float* __restrict__ acc,
                     float* __restrict__ comp) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* misc = reinterpret_cast<int*>(smem);
  const FoldWords w(words, num_feat);
  const int tile = blockIdx.x % p.tiles;
  const int chunk = blockIdx.x / p.tiles;
  const int f0 = tile * p.ft;
  const int nf = min(p.ft, num_feat - f0);
  const int t = threadIdx.x;
  const SumSmem L(p.ft, num_bins, p.tags);
  chunk_sum(bins, ghc_t, row_leaf, __ldg(leaf_id), n, num_bins, p, L,
            (long)chunk * kChunk, f0, nf, smem);

  // the partial, then one count on the tile
  const int pad = row_pad(num_bins);
  float4* dst = reinterpret_cast<float4*>(
      partials + ((long)chunk * num_feat + f0) * pad);
  const float4* h4 = reinterpret_cast<const float4*>(smem + L.hist);
  for (int i = t; i < nf * pad / 4; i += kFoldThreads) __stcg(dst + i, h4[i]);
  __threadfence();
  __syncthreads();
  if (t == 0) misc[kFoldWarps] = atomicAdd(w.arrived + tile, 1);
  __syncthreads();
  const int from_last = p.chunks - 1 - misc[kFoldWarps];
  const int folds = nf * p.slices;
  if (from_last == 0) {
    // the last to count: slice S - 1, and those no block counts for
    for (int s = folds - 1; s >= 0; --s)
      if (s == folds - 1 || !p.helpers || s < folds - p.chunks)
        fold_slice(num_feat, num_bins, p, f0 + s / p.slices, s % p.slices,
                   false, nullptr, smem, partials, acc, comp);
  } else if (p.helpers && from_last < folds) {
    const int s = folds - 1 - from_last;
    fold_slice(num_feat, num_bins, p, f0 + s / p.slices, s % p.slices, true,
               w.arrived + tile, smem, partials, acc, comp);
  }
  if (t == 0 && atomicAdd(w.exited + tile, 1) == p.chunks - 1) {
    // every block of the tile is done with the counters
    w.arrived[tile] = 0;
    w.exited[tile] = 0;
  }
}

// The launch's plan. A block takes the fewest features (one warp each,
// at most kMaxTile) that let the grid run in one wave of the blocks the
// card holds at once (kResident an SM, fewer where shared memory runs
// out); a slice's fold stages at most kFoldBytes of partials, one cell
// a thread. Returns a status.
int fold_plan(int num_feat, int n, int num_bins, FoldPlan* p) {
  static int sms = 0, max_smem = 0, sm_smem = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  if (num_feat < 1 || n < kChunk || n % kChunk != 0 || num_bins < 1)
    return kBadShape;
  const int chunks = n / kChunk;
  const int groups = row_pad(num_bins) / 4;
  int slice = kFoldBytes / (chunks * 16);
  slice = slice < 1 ? 1 : (slice > kFoldThreads / 4 ? kFoldThreads / 4 : slice);
  const int slices = (groups + slice - 1) / slice;
  slice = (groups + slices - 1) / slices;  // balance
  const int fold_bytes = kMisc + chunks * slice * 16;
  const bool tags = kTagWords && SumSmem(1, num_bins, true).bytes <= max_smem;
  int ft = 0;
  for (int f = 1; f <= kMaxTile && f <= num_feat; ++f) {
    const int sum_bytes = SumSmem(f, num_bins, tags).bytes;
    if (sum_bytes > max_smem) break;
    ft = f;
    const int smem = sum_bytes > fold_bytes ? sum_bytes : fold_bytes;
    int resident = sm_smem / (smem + 1024);
    resident = resident < kResident ? resident : kResident;
    if ((long)chunks * ((num_feat + f - 1) / f) <= (long)resident * sms)
      break;
  }
  if (ft == 0 || fold_bytes > max_smem) return kNoFit;
  const int tiles = (num_feat + ft - 1) / ft;
  ft = (num_feat + tiles - 1) / tiles;  // balance
  const int sum_bytes = SumSmem(ft, num_bins, tags).bytes;
  const int smem = sum_bytes > fold_bytes ? sum_bytes : fold_bytes;
  int resident = sm_smem / (smem + 1024);
  resident = resident < kResident ? resident : kResident;
  // helpers wait; they must never fill the card
  const bool helpers = (long)num_feat * slices < (long)resident * sms;
  *p = FoldPlan{chunks, ft, tiles, slice, slices, smem, tags, helpers};
  return kOk;
}

template <typename BinT>
int run_pair_fold(const void* bins, const float* ghc_t, const int* row_leaf,
                  const int* leaf_id, int num_feat, int n, int num_bins,
                  float* partials, int* words, float* acc, float* comp,
                  cudaStream_t stream) {
  if (((reinterpret_cast<uintptr_t>(bins) |
        reinterpret_cast<uintptr_t>(row_leaf) |
        reinterpret_cast<uintptr_t>(ghc_t) |
        reinterpret_cast<uintptr_t>(partials)) & 15) != 0)
    return kBadShape;
  FoldPlan p;
  const int status = fold_plan(num_feat, n, num_bins, &p);
  if (status != kOk) return status;
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || p.smem > allowed[dev]) {
    err = cudaFuncSetAttribute(pair_fold_kernel<BinT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) allowed[dev] = p.smem;
  }
  pair_fold_kernel<BinT><<<(unsigned)(p.chunks * p.tiles), kFoldThreads,
                           p.smem, stream>>>(
      static_cast<const BinT*>(bins), ghc_t, row_leaf, leaf_id, num_feat, n,
      num_bins, p, partials, words, acc, comp);
  return (int)cudaGetLastError();
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

// One out-of-core block of R rows (R % 4096 == 0) folded into the
// running (F, B, 3) Kahan carry of the rows with row_leaf == *leaf_id:
// acc and comp are read and written in place, in one launch.
// partials: (R / 4096) * F * pad floats of scratch, pad = 3B rounded up
// to a multiple of 4 (16-byte aligned); words: 2F int32 (two a feature
// tile), zero before the first call and left zero by every call. Calls
// that share the scratch run in stream order.
int hist_pair_fold(const void* bins, int bin_bytes, const float* ghc_t,
                   const int* row_leaf, const int* leaf_id, int num_feat,
                   int n, int num_bins, float* partials, int* words,
                   float* acc, float* comp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return run_pair_fold<uint8_t>(bins, ghc_t, row_leaf, leaf_id, num_feat,
                                  n, num_bins, partials, words, acc, comp, s);
  if (bin_bytes == 2)
    return run_pair_fold<int16_t>(bins, ghc_t, row_leaf, leaf_id, num_feat,
                                  n, num_bins, partials, words, acc, comp, s);
  return kBadShape;
}

// hist_pair_fold's plan on the current card for R rows, into out[0..4]:
// the features a block takes, the blocks, the fold slices a feature, the
// float4 groups of a slice and the dynamic shared memory of a block.
// Returns a status.
int hist_pair_fold_plan(int n, int num_feat, int num_bins, int* out) {
  FoldPlan p;
  const int status = fold_plan(num_feat, n, num_bins, &p);
  if (status != kOk) return status;
  out[0] = p.ft;
  out[1] = p.chunks * p.tiles;
  out[2] = p.slices;
  out[3] = p.slice;
  out[4] = p.smem;
  return kOk;
}

const char* hist_status_string(int status) {
  if (status == kBadShape) return "unsupported shape, bin width or alignment";
  if (status == kNoFit) return "one feature's histogram does not fit in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int hist_max_leaves() { return kMaxSlots; }

}  // extern "C"
