// The chunk accumulator shared by hist.cu (masked_hist, frontier_hist),
// seg_hist.cu (seg_hist) and compact_hist.cu (compacted_hist), for
// Hopper (sm_90a).
//
// Every kernel of the three files computes, for each slot s (a leaf of
// the frontier, the one segment, or the one compacted leaf), feature f
// and bin b,
//   hist[s, f, b, :] = sum over rows c of slot s with bin(f, c) == b
//                      of (g[c], h[c], w[c])
// as a (value, residual) pair, in two passes:
//   1. chunk_partials: one block per (feature tile, HIST_CHUNK = 4096-row
//      chunk) writes the chunk's (slots, f_tile, B, 3) f32 partial to a
//      (chunks, slots, F, B, 3) scratch buffer. The tiles of one chunk
//      have adjacent block indices, so the chunk's g, h, w come from L2
//      after the first tile reads them.
//   2. kahan_fold: one thread per output cell folds the chunk partials
//      in chunk order with the f32 Kahan arithmetic of
//      lightgbm_tpu/ops/histogram.py build_histograms_pair (:263-274),
//      over the chunks [c_first, c_last], and returns the (value,
//      residual) pair, residual = -comp with a +0.0 for a zero
//      compensation. For one block of an out-of-core pass
//      (hist.cu hist_pair_fold), kahan_fold_carry folds the block's
//      chunks into the running (acc, comp) carry instead, in place.
// The files differ only in a `Rows` policy: where a row's bins come
// from (uint8/int16 feature rows, int32 words of four uint8 features,
// or uint8/int16 feature rows gathered through a compacted index
// buffer) and what its slot is (its row_leaf among the frontier's leaf
// ids, its position inside [begin, begin + cnt), or its position below
// the compacted count). A policy with kGather stages its sub-chunks
// itself (Rows::gather: 4-byte cp.async copies through the chunk's
// index buffer, which Rows::load_index brings into shared memory once a
// block; a gathered row has no 16-byte run); the others are staged by
// `stage` below.
//
// Design against what bounds a 32-row step of one feature:
// - Staging. A block walks its chunk in sub-chunks of kSub rows. For
//   each it copies g, h, w, the slot source (row_leaf) and the tile's
//   bin rows into shared memory with 16-byte cp.async copies, double
//   buffered: the next sub-chunk loads while this one is summed. The
//   inner loop reads shared memory only, and each bin or packed word is
//   read from device memory once per block.
// - Feature tiles. One warp per feature and up to Rows::kFeatureTile
//   features a block, a constant of each policy: small tiles spread a
//   short segment over the card, large ones stage a chunk's g, h, w and
//   row_leaf fewer times.
// - Empty steps. Where a policy's rows are scattered over the slots
//   (kSkipEmptySteps: a small leaf leaves most 32-row steps without a
//   row of the frontier), the block marks once per staged sub-chunk
//   which steps hold such a row, and every feature's warp skips the
//   others without reading them. A segment's rows are contiguous, so
//   there the marks would cost a barrier and save nothing.
// - Peer masks. Lanes hold consecutive rows. A step that holds one row
//   of a slot adds it alone. Otherwise each lane with a row ORs its bit
//   into its key's word of the warp's tag array in shared memory (one
//   word per (slot, bin), zero between steps), reads the word back as
//   the mask of lanes that share its key, and the group's first lane
//   clears it. This is the mask __match_any_sync gives (and a ballot
//   per key bit), which the card computes more slowly when many keys
//   are distinct. Where the tag words do not fit in shared memory beside
//   the partial (wide int16 bins, or many leaves), __match_any_sync gives
//   the mask: the same mask, so the same bits.
// - Leader accumulation. The lowest lane of each group (the leader)
//   reads its cell once, adds its own values and then its peers' in
//   lane order, fetched with __shfl_sync in a warp-uniform loop over
//   ranks, and writes the cell once. ((cell + v0) + v1) + ... in lane
//   order is the sequence of f32 adds of a one-row-at-a-time loop, so
//   every cell of a chunk partial is the row-order f32 sum of its rows,
//   bit for bit, whatever the launch order.
// No float atomics anywhere: two launches give the same bits, and the
// result equals the plain PyTorch versions (ops/hist_kernels.py) run on
// the CPU.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace chunk_hist {

constexpr int kChunk = 4096;      // HIST_CHUNK rows per chunk partial
constexpr int kSub = 256;         // rows staged in shared memory at once
constexpr int kMaxSlots = 8;      // frontier width limit
constexpr int kMaxWarps = 32;     // one warp per feature of a tile
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Status {
  kOk = 0,
  // negative codes are these files' own; positive ones are cudaError_t
  kBadShape = -1,
  kNoFit = -2,
};

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// A 4-byte copy (the size a gathered value or bin word takes).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ------------------------------------------------------------ the cover

struct Cover {
  long lo, hi;          // row range [lo, hi)
  int c_first, c_last;  // covered chunks, inclusive
};

// ordered_hist.py cover_index's arithmetic on device-resident bounds
// [begin, cnt]: an empty segment covers one chunk (cnt clamped to >= 1
// for the cover, to >= 0 for the rows), both ends clamped into the array.
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

// The cover of the first `*count` rows of a compacted buffer: chunks
// 0 .. max(ceil(count / kChunk), 1) - 1 (an empty buffer covers one
// chunk, whose partial is zero), clamped into the array.
__device__ __forceinline__ Cover read_count_cover(const int* count,
                                                  int chunks) {
  const long cnt = count[0] > 0 ? count[0] : 0;
  Cover c;
  c.lo = 0;
  c.hi = cnt;
  const long last = ((cnt > 0 ? cnt : 1) - 1) / kChunk;
  c.c_first = 0;
  c.c_last = (int)(last > chunks - 1 ? chunks - 1 : last);
  return c;
}

// ------------------------------------------------------------- staging

// Bytes of one staged sub-chunk: g, h, w (f32), the slot source (int32,
// where the policy has one) and `units` bin rows of kSub values each.
template <class Rows>
__host__ __device__ constexpr int stage_bytes(int units) {
  return kSub * (3 * 4 + (Rows::kAux ? 4 : 0) + units * Rows::kUnitBytes);
}

// Issue the 16-byte copies of the sub-chunk at row `base` into `dst`;
// unit rows unit0 .. unit0 + units - 1 of the policy's (units, n) array.
template <class Rows>
__device__ __forceinline__ void stage(const Rows& rows, const float* ghc_t,
                                      long n, long base, int unit0, int units,
                                      unsigned char* dst) {
  if constexpr (Rows::kGather) {
    rows.gather(ghc_t, n, base, unit0, units, dst);
    return;
  }
  constexpr int kPerRow = kSub * 4 / 16;                   // pieces of an f32 row
  constexpr int kPerUnit = kSub * Rows::kUnitBytes / 16;   // pieces of a bin row
  constexpr int kArrays = Rows::kAux ? 4 : 3;
  const int total = kArrays * kPerRow + units * kPerUnit;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const char* src;
    if (i < kArrays * kPerRow) {
      const int a = i / kPerRow;
      const int j = i - a * kPerRow;
      const void* row = a < 3 ? static_cast<const void*>(ghc_t + a * n + base)
                              : static_cast<const void*>(rows.aux + base);
      src = static_cast<const char*>(row) + 16 * j;
    } else {
      const int k = i - kArrays * kPerRow;
      const int u = k / kPerUnit;
      const int j = k - u * kPerUnit;
      src = reinterpret_cast<const char*>(rows.units) +
            ((unit0 + u) * n + base) * Rows::kUnitBytes + 16 * j;
    }
    cp_async16(dst + 16 * i, src);
  }
}

// ------------------------------------------------------ the accumulator

// One 32-row step of one feature: lane `lane` holds a row with cell
// offset `cell` (when valid), statistics g, h, w, and `peers`, the lanes
// whose rows share its (slot, bin) key. The leader of each group adds
// the group's values to its cell in lane order and writes it once.
__device__ __forceinline__ void leader_add(float* hist, bool valid,
                                           unsigned peers, int cell, float g,
                                           float h, float w, int lane) {
  const unsigned rounds =
      __reduce_max_sync(kFull, valid ? (unsigned)__popc(peers) : 0u);
  const bool lead = valid && __ffs(peers) - 1 == lane;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  if (lead) {
    a0 = hist[cell] + g;
    a1 = hist[cell + 1] + h;
    a2 = hist[cell + 2] + w;
  }
  unsigned rest = peers & (peers - 1u);  // the peers after the leader
  for (unsigned k = 1; k < rounds; ++k) {
    const bool more = rest != 0u;
    const int src = more ? __ffs(rest) - 1 : lane;
    rest &= rest - 1u;
    const float vg = __shfl_sync(kFull, g, src);
    const float vh = __shfl_sync(kFull, h, src);
    const float vw = __shfl_sync(kFull, w, src);
    if (lead && more) {
      a0 += vg;
      a1 += vh;
      a2 += vw;
    }
  }
  if (lead) {
    hist[cell] = a0;
    hist[cell + 1] = a1;
    hist[cell + 2] = a2;
  }
  __syncwarp();  // the next step's leaders read what this one wrote
}

// ------------------------------------------------------------- kernels

// Block (tile, chunk) = (blockIdx.x % tiles, blockIdx.x / tiles); blockDim
// = 32 * f_tile. Shared memory: the (slots, f_tile, B, 3) partial, the
// chunk's kChunk-entry index buffer (kGather only), two staging
// buffers, each warp's (slots, B) tag words (with use_tags), then the
// sub-chunk's kSub / 32 step masks.
template <class Rows>
__global__ void chunk_partials(Rows rows, const float* __restrict__ ghc_t,
                               int n, int num_bins, int num_slots,
                               int num_feat, int f_tile, int tiles,
                               bool use_tags, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x % tiles;
  const int chunk = blockIdx.x / tiles;
  int s_first, s_last;
  if (!rows.prepare(chunk, n, s_first, s_last)) return;  // block-uniform

  const int f0 = tile * f_tile;
  const int nf = min(f_tile, num_feat - f0);
  const int units = (nf + Rows::kFeatPerUnit - 1) / Rows::kFeatPerUnit;
  const int tile_units = (f_tile + Rows::kFeatPerUnit - 1) / Rows::kFeatPerUnit;
  const int row_len = num_bins * 3;
  const int slot_len = f_tile * row_len;
  const int cells = num_slots * slot_len;
  float* hist_s = reinterpret_cast<float*>(smem);
  unsigned char* index_s = smem + ((cells * 4 + 15) & ~15);
  unsigned char* buf[2];
  buf[0] = index_s + (Rows::kGather ? kChunk * 4 : 0);
  buf[1] = buf[0] + stage_bytes<Rows>(tile_units);
  const int keys = num_slots * num_bins;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = blockDim.x >> 5;
  const long chunk_base = (long)chunk * kChunk;
  const int unit0 = f0 / Rows::kFeatPerUnit;
  unsigned* tags = reinterpret_cast<unsigned*>(buf[1] + stage_bytes<Rows>(tile_units));
  unsigned* tag_w = tags + warp * keys;
  unsigned* step_any = tags + (use_tags ? num_warps * keys : 0);

  for (int i = tid; i < cells; i += blockDim.x) hist_s[i] = 0.0f;
  if (use_tags)
    for (int i = tid; i < num_warps * keys; i += blockDim.x) tags[i] = 0u;
  if constexpr (Rows::kGather) rows.load_index(chunk, index_s);
  if (s_first <= s_last) {
    stage(rows, ghc_t, n, chunk_base + (long)s_first * kSub, unit0, units,
          buf[0]);
    cp_async_commit();
  }
  for (int s = s_first; s <= s_last; ++s) {
    unsigned char* cur = buf[(s - s_first) & 1];
    if (s < s_last) {
      stage(rows, ghc_t, n, chunk_base + (long)(s + 1) * kSub, unit0, units,
            buf[(s + 1 - s_first) & 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this sub-chunk landed for every thread; hist zeroed
    const float* g_s = reinterpret_cast<const float*>(cur);
    const float* h_s = g_s + kSub;
    const float* w_s = h_s + kSub;
    const int* aux_s = reinterpret_cast<const int*>(w_s + kSub);
    const unsigned char* units_s = cur + kSub * (Rows::kAux ? 16 : 12);
    const long base = chunk_base + (long)s * kSub;
    if constexpr (Rows::kSkipEmptySteps) {
      for (int it = warp; it < kSub / 32; it += num_warps) {
        const int r = it * 32 + lane;
        const unsigned m =
            __ballot_sync(kFull, rows.slot(aux_s, r, base + r) >= 0);
        if (lane == 0) step_any[it] = m;
      }
      __syncthreads();  // step masks written
    }
    for (int f = warp; f < nf; f += num_warps) {
      float* hist_f = hist_s + f * row_len;
      for (int it = 0; it < kSub / 32; ++it) {
        if (Rows::kSkipEmptySteps && step_any[it] == 0u) continue;
        const int r = it * 32 + lane;
        int slot = rows.slot(aux_s, r, base + r);
        const int bin = rows.bin(units_s, aux_s, f, r);
        if ((unsigned)bin >= (unsigned)num_bins) slot = -1;  // dropped row
        const bool valid = slot >= 0;
        const unsigned any = __ballot_sync(kFull, valid);
        if (any == 0u) continue;  // warp-uniform
        const int key = slot * num_bins + bin;
        unsigned peers = any;     // one row: its own lane
        if (any & (any - 1u)) {   // warp-uniform
          if (use_tags) {         // block-uniform
            if (valid) atomicOr(tag_w + key, 1u << lane);
            __syncwarp();
            if (valid) peers = tag_w[key];
            __syncwarp();
            if (valid && __ffs(peers) - 1 == lane) tag_w[key] = 0u;
          } else {
            peers = __match_any_sync(kFull, valid ? key : -1);
          }
        }
        leader_add(hist_f, valid, peers, slot * slot_len + bin * 3, g_s[r],
                   h_s[r], w_s[r], lane);
      }
    }
    __syncthreads();  // consumed before the buffer is staged again
  }
  if (s_first > s_last) __syncthreads();  // nothing staged: hist zeroed

  const int span = nf * row_len;
  for (int i = tid; i < num_slots * span; i += blockDim.x) {
    const int l = i / span;
    const int j = i - l * span;
    partials[(((long)chunk * num_slots + l) * num_feat + f0) * row_len + j] =
        hist_s[l * slot_len + j];
  }
}

// One thread per output cell; chunks c_first..c_last (all chunks when
// `bounds` is null; the cover of [begin, cnt] bounds, or with
// count_bounds of a compacted count), kAhead chunk partials loaded
// before they are added so that many loads are in flight.
template <int kAhead>
__global__ void kahan_fold(const float* __restrict__ partials,
                           const int* __restrict__ bounds, bool count_bounds,
                           int chunks, long cells, float* __restrict__ hi,
                           float* __restrict__ lo) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cells) return;
  int c = 0, c_last = chunks - 1;
  if (bounds != nullptr) {
    const Cover cov = count_bounds ? read_count_cover(bounds, chunks)
                                   : read_cover(bounds, chunks);
    c = cov.c_first;
    c_last = cov.c_last;
  }
  float acc = 0.0f, comp = 0.0f;
  for (; c + kAhead - 1 <= c_last; c += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) v[i] = partials[(long)(c + i) * cells + e];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const float y = v[i] - comp;
      const float t = acc + y;
      comp = (t - acc) - y;
      acc = t;
    }
  }
  for (; c <= c_last; ++c) {
    const float y = partials[(long)c * cells + e] - comp;
    const float t = acc + y;
    comp = (t - acc) - y;
    acc = t;
  }
  hi[e] = acc;
  lo[e] = comp == 0.0f ? 0.0f : -comp;  // +0.0 residual, as the CPU path
}

// The fold of one block of an out-of-core pass: the same chunk-order
// Kahan arithmetic as kahan_fold over all `chunks` chunk partials, but
// seeded from the running carry (acc, comp) of the blocks before it
// (comp in Kahan's sign, the negative residual) and writing the carry
// back in place, so that folding a pass's blocks in row order walks the
// chunk sequence of one fold over the whole array.
template <int kAhead>
__global__ void kahan_fold_carry(const float* __restrict__ partials,
                                 int chunks, long cells,
                                 float* __restrict__ acc_io,
                                 float* __restrict__ comp_io) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cells) return;
  float acc = acc_io[e], comp = comp_io[e];
  int c = 0;
  for (; c + kAhead - 1 < chunks; c += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) v[i] = partials[(long)(c + i) * cells + e];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const float y = v[i] - comp;
      const float t = acc + y;
      comp = (t - acc) - y;
      acc = t;
    }
  }
  for (; c < chunks; ++c) {
    const float y = partials[(long)c * cells + e] - comp;
    const float t = acc + y;
    comp = (t - acc) - y;
    acc = t;
  }
  acc_io[e] = acc;
  comp_io[e] = comp;
}

// ----------------------------------------------------------------- host

inline int max_shared_bytes() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&cached, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return cached;
}

// Raise the kernel's dynamic shared-memory limit once per (device,
// size): a launch needing no more than was allowed before sets nothing.
template <class Rows>
cudaError_t allow_shared(int bytes) {
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(chunk_partials<Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

// Launch the chunk partials. A block takes Rows::kFeatureTile features
// (fewer when there are fewer, shrunk by whole units until the block
// fits in shared memory, then balanced over the tiles). The staged
// inputs must be 16-byte aligned.
template <class Rows>
int launch_partials(const Rows& rows, const float* ghc_t, int n,
                    int num_bins, int num_slots, int num_feat,
                    float* partials, cudaStream_t stream) {
  constexpr int kU = Rows::kFeatPerUnit;
  static_assert(Rows::kFeatureTile % kU == 0 &&
                    Rows::kFeatureTile <= kMaxWarps,
                "a tile is whole units of at most kMaxWarps features");
  if (num_slots < 1 || num_slots > kMaxSlots || num_feat < 1 ||
      num_feat % kU != 0 || n < kChunk || n % kChunk != 0 || num_bins < 1 ||
      ((reinterpret_cast<uintptr_t>(rows.units) |
        reinterpret_cast<uintptr_t>(rows.aux) |
        reinterpret_cast<uintptr_t>(ghc_t)) & 15) != 0)
    return kBadShape;
  const int keys = num_slots * num_bins;
  // partial, index buffer, staging, tag words (one per key and warp),
  // step masks
  auto need = [&](int ft, bool tags) {
    return ((ft * keys * 12 + 15) & ~15) + (Rows::kGather ? kChunk * 4 : 0) +
           2 * stage_bytes<Rows>((ft + kU - 1) / kU) +
           (tags ? ft * keys * 4 : 0) + kSub / 32 * 4;
  };
  const int max_smem = max_shared_bytes();
  // tag words where a one-unit tile fits with them, else __match_any_sync
  const bool use_tags = need(kU, true) <= max_smem;
  int ft = Rows::kFeatureTile < num_feat ? Rows::kFeatureTile : num_feat;
  while (ft > kU && need(ft, use_tags) > max_smem) ft -= kU;
  if (need(ft, use_tags) > max_smem) return kNoFit;
  const int tiles = (num_feat + ft - 1) / ft;
  ft = ((num_feat + tiles - 1) / tiles + kU - 1) / kU * kU;  // balance
  const int smem = need(ft, use_tags);
  cudaError_t err = allow_shared<Rows>(smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = n / kChunk;
  chunk_partials<Rows><<<(unsigned)(chunks * tiles), 32 * ft, smem, stream>>>(
      rows, ghc_t, n, num_bins, num_slots, num_feat, ft, tiles, use_tags,
      partials);
  return (int)cudaGetLastError();
}

// Launch both passes; `bounds` (device [begin, cnt], with count_bounds a
// device count of compacted rows, or null) picks the chunks the fold
// reads.
template <class Rows>
int launch(const Rows& rows, const float* ghc_t, const int* bounds, int n,
           int num_bins, int num_slots, int num_feat, float* partials,
           float* hi, float* lo, cudaStream_t stream,
           bool count_bounds = false) {
  const int status = launch_partials(rows, ghc_t, n, num_bins, num_slots,
                                     num_feat, partials, stream);
  if (status != 0) return status;
  const int chunks = n / kChunk;
  const long cells = (long)num_slots * num_feat * num_bins * 3;
  const int threads = 128;
  kahan_fold<32><<<(unsigned)((cells + threads - 1) / threads), threads, 0,
                  stream>>>(partials, bounds, count_bounds, chunks, cells,
                            hi, lo);
  return (int)cudaGetLastError();
}

// Launch the chunk partials of one out-of-core block and their carry
// fold into (acc, comp), in place.
template <class Rows>
int launch_carry(const Rows& rows, const float* ghc_t, int n, int num_bins,
                 int num_feat, float* partials, float* acc, float* comp,
                 cudaStream_t stream) {
  const int status = launch_partials(rows, ghc_t, n, num_bins, 1, num_feat,
                                     partials, stream);
  if (status != 0) return status;
  const long cells = (long)num_feat * num_bins * 3;
  const int threads = 128;
  kahan_fold_carry<32><<<(unsigned)((cells + threads - 1) / threads),
                         threads, 0, stream>>>(partials, n / kChunk, cells,
                                               acc, comp);
  return (int)cudaGetLastError();
}

}  // namespace chunk_hist
