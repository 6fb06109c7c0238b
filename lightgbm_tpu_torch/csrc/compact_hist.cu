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
// bits). A bin of num_bins or more is dropped. That is the chunking of
// _compacted_bincount; its partials are float64 sums cast to float32,
// these are float32 row-order sums, so the two agree to float32
// rounding, not in bits. The host never learns the count (it would be
// a host sync per split): the kernel reads it from device memory.
//
// Two routes, chosen by shape before the launch (compacted_hist_route):
//
// The sorted route (num_bins <= kMaxSortBins), one launch,
// gather_sort_hist. A chunk partial cell is the f32 sum of its rows in
// row order, ((0 + v0) + v1) + ...; any schedule that performs exactly
// those adds gives its bits. So for one (chunk, feature) the rows are
// sorted by bin, stably, with integer work only, and one thread a bin
// adds its rows in row order: the serial depth is the most populous
// bin's row count (about 16 at 255 uniform bins) instead of a chain of
// 128 32-row steps, each a round of shared-memory trips.
//   - A persistent grid (the blocks that run at once, two an SM) works
//     through a queue of jobs by an integer ticket, the next ticket taken
//     while a job runs. Every block reads the count and derives the same
//     plan (make_plan): the C = max(ceil(count / 4096), 1) covered
//     chunks, and nothing for chunks past them. A job waits only on jobs
//     with lower tickets, which running blocks hold, so the queue needs
//     no co-resident grid; its counters (caller scratch) are reset by the
//     last job to read each, and the ticket by the last block to take one.
//   - Gather jobs (a quarter to a sixteenth of a chunk): each row's
//     position, then its g, h, w and its bins from the caller's row-major
//     copy of the matrix (`rows`: one sector a row at 28 uint8 features,
//     where the feature-major matrix costs a sector a feature), copied to
//     gathered arrays in compacted order. A leaf's rows are scattered
//     over the array, so these reads are what the card's DRAM does
//     slowest; spreading them over every SM and reading each row once is
//     what the route gains most from.
//   - Sum jobs (a chunk and one or two features), `lag` chunks behind
//     the chunk's gathers, so sorting overlaps gathering: the chunk's
//     statistics and each feature's bins staged with 16-byte cp.async
//     (the next feature's during this one); thread t holds rows 16t ..
//     16t + 15, and each 4-bit digit of the bin, least significant first,
//     is one stable counting pass (a thread's counts in registers, its
//     column of a (16 digits, 256 threads) counter array, an exclusive
//     scan in (digit, thread) order, the rows and their bins scattered to
//     their ranks); dropped rows (past the count, or a bin of num_bins or
//     more) are left out. Two passes at 255 bins, three at 256-2048. Each
//     bin's run is read off the sorted bins; one thread a bin adds its
//     rows' g, h, w in row order, eight rows' loads ahead, into the chunk
//     partial (a feature's row padded to whole float4s).
//   - Fold jobs (one a feature) wait for the tile's C sum jobs and fold
//     its chunk partials in chunk order with kahan_fold's arithmetic
//     (chunk_hist.cuh), four cells a thread, sixteen chunks' loads ahead.
//   No float atomics: two launches give the same bits.
// Shared memory: g, h, w 48 KB, two bin buffers, two (rows, bins) sort
// buffers 32 KB, counters 8 KB, two uint16 a bin: 97 KB at 255 uint8
// bins, two blocks an SM.
//
// The accumulator route (num_bins > kMaxSortBins, where the run bounds
// and the sort's passes grow), two launches:
// chunk_hist.cuh's chunk_partials (staged double-buffered sub-chunks,
// shared-memory peer masks, leader accumulation) with the GatherRows
// policy below, then its kahan_fold. Same function, same bits.
//
// Layout. The accumulator route gathers from the feature-major (F, N)
// matrix: a warp's 32 gathered rows of one feature touch min(32, 1 +
// 1/d) sectors, d the leaf's share of the rows in their span. The sorted
// route gathers from the row-major copy, a second copy of the matrix
// that its caller keeps (28 MB at 1M x 28 uint8), one or two sectors a
// row (PERF.md).
//
// Bound on this card. The function must read src (4 bytes a row) and
// the count, the leaf's bins and statistics (F * bin bytes + 12 a row)
// once and write the (value, residual) pair: at 1M x 28 uint8 and 255
// bins, (4 + 28 + 12) * count + 171 KB bytes.

#include "chunk_hist.cuh"

using namespace chunk_hist;

namespace {

// ------------------------------------------------- the accumulator route

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
int run_accumulator(const void* bins, const float* ghc_t, const int* src,
                    const int* count, int num_feat, int n, int num_bins,
                    float* partials, float* hi, float* lo,
                    cudaStream_t stream) {
  GatherRows<BinT> rows{static_cast<const BinT*>(bins), src, src, count, 0,
                        0, nullptr};
  return launch(rows, ghc_t, count, n, num_bins, 1, num_feat, partials, hi,
                lo, stream, true);
}

// ------------------------------------------------------ the sorted route

constexpr int kThreads = 256;
constexpr int kPerThread = kChunk / kThreads;  // 16 rows a thread, blocked
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kDigitBits = 4;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxSortBins = 2048;
constexpr int kMinGatherParts = 4;   // pieces a chunk's gather splits into
constexpr int kMaxGatherParts = 16;  // (1024 to 256 rows, 4 to 1 a thread)
constexpr int kGatherRows = kChunk / kMinGatherParts / kThreads;  // 4
constexpr int kJobsPerBlock = 4;    // gather jobs, and sum jobs, a block
constexpr int kMaxTile = 2;         // features a sum job, at most
constexpr int kFoldAhead = 16;      // partials loaded ahead in the fold

// A feature's chunk partial row, padded to whole float4s.
__host__ __device__ constexpr int row_pad(int num_bins) {
  return (3 * num_bins + 3) & ~3;
}

// Byte offsets in dynamic shared memory; the run bounds (two uint16 a
// bin) go last. At 255 uint8 bins 97 KB, at 2048 int16 bins 112 KB: two
// blocks an SM.
template <typename BinT>
struct Smem {
  static constexpr int kStats = 0;                             // float[3][4096]
  static constexpr int kRaw = kStats + 3 * kChunk * 4;         // BinT[2][4096]
  static constexpr int kRows = kRaw + 2 * kChunk * (int)sizeof(BinT);  // u16[2][4096]
  static constexpr int kKeys = kRows + 2 * kChunk * 2;         // u16[2][4096]
  static constexpr int kCount = kKeys + 2 * kChunk * 2;        // u16[16][256]
  static constexpr int kMisc = kCount + kDigits * kThreads * 2;  // int[16]
  static constexpr int kBounds = kMisc + 64;                   // u16[2][B]
  static constexpr int bytes(int num_bins) {
    return kBounds + ((4 * num_bins + 15) & ~15);
  }
};

// The counters of the caller's int32 scratch (`words`), all zero between
// calls: the ticket; per chunk, its finished gather jobs and the sum
// jobs that have seen them; per tile, its finished sum jobs and the fold
// jobs that have seen them. Each is reset by the last job to read it.
struct Words {
  unsigned* ticket;
  int *ready, *consumed, *done, *released;
  __device__ Words(int* w, int chunks, int num_feat)
      : ticket(reinterpret_cast<unsigned*>(w)),
        ready(w + 1),
        consumed(w + 1 + chunks),
        done(w + 1 + 2 * chunks),
        released(w + 1 + 2 * chunks + num_feat) {}
};

// The plan every block derives from the count. Jobs in ticket order, a
// chunk's sum jobs `lag` chunks behind its gather jobs, so that sorting
// overlaps gathering:
//   [gathers of chunks 0 .. lag - 1]
//   [gathers of chunk c, sums of chunk c - lag] for c = lag .. C - 1
//   [sums of chunks C - lag .. C - 1]
//   [folds: tile by tile, one a feature of the widest tile]
// A job waits only on jobs with lower tickets (a sum on its chunk's
// gathers, a fold on its tile's sums), which blocks that are running
// have taken, so the queue needs no co-resident grid.
struct Plan {
  int chunks, parts, tiles, tile_w, lag;
  int gathers;  // gather jobs a chunk
  int head, body, tail, jobs;  // ticket bounds of the four parts
};

struct Job {
  int kind;  // 0 gather, 1 sum, 2 fold
  int chunk, a, b;  // gather: (-, part); sum: (tile, -); fold: (tile, i)
};

__device__ __forceinline__ Job decode(const Plan& p, int q) {
  Job j;
  if (q < p.head) {
    j = {0, q / p.gathers, 0, q % p.gathers};
  } else if (q < p.body) {
    const int r = q - p.head;
    const int step = r / (p.gathers + p.tiles);
    const int o = r - step * (p.gathers + p.tiles);
    j = o < p.gathers ? Job{0, p.lag + step, 0, o}
                      : Job{1, step, o - p.gathers, 0};
  } else if (q < p.tail) {
    const int r = q - p.body;
    j = {1, p.chunks - p.lag + r / p.tiles, r % p.tiles, 0};
  } else {
    const int r = q - p.tail;
    return {2, 0, r / p.tile_w, r % p.tile_w};
  }
  return j;
}

__device__ __forceinline__ Plan make_plan(long cnt, int n, int num_feat,
                                          int grid) {
  const int all = n / kChunk;
  int c = (int)((cnt + kChunk - 1) / kChunk);
  c = c < 1 ? 1 : (c > all ? all : c);
  Plan p;
  p.chunks = c;
  const long slots = (long)grid * kJobsPerBlock;
  long q = (slots + c - 1) / c;
  p.parts = (int)(q < kMinGatherParts ? kMinGatherParts
                                      : (q > kMaxGatherParts ? kMaxGatherParts
                                                             : q));
  long ft = ((long)c * num_feat + slots - 1) / slots;
  ft = ft < 1 ? 1 : (ft > kMaxTile ? kMaxTile : ft);
  ft = ft > num_feat ? num_feat : ft;
  p.tiles = (int)((num_feat + ft - 1) / ft);
  p.tile_w = (num_feat + p.tiles - 1) / p.tiles;  // the widest tile
  p.gathers = p.parts;
  // about one grid of gather jobs ahead of the first sum job
  const int lag = (grid + p.gathers - 1) / p.gathers;
  p.lag = lag < 1 ? 1 : (lag > c ? c : lag);
  p.head = p.lag * p.gathers;
  p.body = p.head + (c - p.lag) * (p.gathers + p.tiles);
  p.tail = p.body + p.lag * p.tiles;
  p.jobs = p.tail + p.tiles * p.tile_w;
  return p;
}

__device__ __forceinline__ int tile_lo(int tile, int tiles, int num_feat) {
  return (int)((long)tile * num_feat / tiles);
}

// Thread 0 waits until *counter reaches `target` (written by jobs with
// lower tickets), then the block reads what they wrote.
__device__ __forceinline__ void wait_for(const int* counter, int target) {
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<const volatile int*>(counter) < target)
      __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
}

// Every thread's writes, then one count on `counter`.
__device__ __forceinline__ void publish(int* counter) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(counter, 1);
}

// Exclusive prefix of `own` over the block's threads in order, and the
// block's total. One barrier; warp_s (8 ints) is free again after the
// caller's next barrier.
__device__ __forceinline__ int block_scan(int own, int* warp_s, int& total) {
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
  for (int w = 0; w < kWarpsPerBlock; ++w) {
    const int s = warp_s[w];
    run += w < warp ? s : 0;
    total += s;
  }
  return run;
}

// Entries r0 .. r0 + 15 of a uint16 array: two 16-byte loads.
__device__ __forceinline__ void load16(const unsigned short* a, int r0,
                                       unsigned short (&out)[kPerThread]) {
  const uint4* v = reinterpret_cast<const uint4*>(a + r0);
  const uint4 x = v[0], y = v[1];
  const unsigned w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
    out[i] = (unsigned short)(w[i >> 1] >> (16 * (i & 1)));
}

// One stable counting pass over entries in blocked order: this thread's
// entry i is ent[i] = row | bin << 16, kept where bit i of `keep` is set;
// its digit is (ent[i] >> shift) & 15. Each kept entry goes to position
// rank(digit, thread, i) of out_row and out_key. A thread counts its
// digits in registers (8 bits each, four to a word; its entries' ranks
// among them likewise), writes its column of the (16 digits, 256
// threads) counters, and an exclusive scan in (digit, thread) order turns
// them into starts. Returns the number kept. Ends with a barrier.
__device__ __forceinline__ int scatter_by_digit(
    const unsigned (&ent)[kPerThread], unsigned keep, int shift,
    unsigned short* out_row, unsigned short* out_key, unsigned short* cnt_s,
    int* warp_s) {
  const int t = threadIdx.x;
  unsigned c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  unsigned loc[kPerThread / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int d = (int)((ent[i] >> shift) & (kDigits - 1));
    const int q = d >> 2;
    const unsigned sh = 8u * (d & 3);
    const unsigned cur = q == 0 ? c0 : (q == 1 ? c1 : (q == 2 ? c2 : c3));
    loc[i >> 2] |= ((cur >> sh) & 0xFFu) << (8 * (i & 3));
    const unsigned inc = (keep >> i) & 1u ? 1u << sh : 0u;
    c0 += q == 0 ? inc : 0u;
    c1 += q == 1 ? inc : 0u;
    c2 += q == 2 ? inc : 0u;
    c3 += q == 3 ? inc : 0u;
  }
  const unsigned cw[4] = {c0, c1, c2, c3};
#pragma unroll
  for (int d = 0; d < kDigits; ++d)
    cnt_s[d * kThreads + t] = (unsigned short)((cw[d >> 2] >> (8 * (d & 3))) & 0xFFu);
  __syncthreads();
  // thread t rakes entries 16t .. 16t + 15 of the (digit, thread) order
  uint4* c4 = reinterpret_cast<uint4*>(cnt_s) + 2 * t;
  const uint4 x = c4[0], y = c4[1];
  unsigned w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  int own = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) own += (int)(w[k] & 0xFFFFu) + (int)(w[k] >> 16);
  int total;
  int run = block_scan(own, warp_s, total);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned lo = (unsigned)run;
    run += (int)(w[k] & 0xFFFFu);
    const unsigned hi = (unsigned)run;
    run += (int)(w[k] >> 16);
    w[k] = lo | hi << 16;
  }
  c4[0] = make_uint4(w[0], w[1], w[2], w[3]);
  c4[1] = make_uint4(w[4], w[5], w[6], w[7]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if ((keep >> i) & 1u) {
      const int d = (int)((ent[i] >> shift) & (kDigits - 1));
      const int pos = cnt_s[d * kThreads + t] +
                      (int)((loc[i >> 2] >> (8 * (i & 3))) & 0xFFu);
      out_row[pos] = (unsigned short)ent[i];
      out_key[pos] = (unsigned short)(ent[i] >> 16);
    }
  }
  __syncthreads();
  return total;
}

// Bins of rows r0 .. r0 + 15 from a staged array: one (uint8) or two
// (int16) 16-byte shared-memory loads.
template <typename BinT>
__device__ __forceinline__ void load_blocked(const BinT* raw, int r0,
                                             int (&b)[kPerThread]) {
  const uint4* v = reinterpret_cast<const uint4*>(raw + r0);
  if constexpr (sizeof(BinT) == 1) {
    const uint4 x = v[0];
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      b[i] = (int)((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
  } else {
    const uint4 x = v[0], y = v[1];
    const unsigned w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      b[i] = (int)(short)((w[i >> 1] >> (16 * (i & 1))) & 0xFFFFu);
  }
}

// 16-byte cp.async copies of `bytes` bytes (rounded up to 16) from
// device to shared memory, by the whole block.
__device__ __forceinline__ void stage16(void* dst, const void* src,
                                        int bytes) {
  for (int i = threadIdx.x; i < (bytes + 15) / 16; i += kThreads)
    cp_async16(static_cast<char*>(dst) + 16 * i,
               static_cast<const char*>(src) + 16 * i);
}

// Gather job: rows [lo, hi) of the compacted buffer (at most 1024, so
// four a thread), each row's position read once, then its g, h, w and
// its bins from the row-major copy (`rows`: a row's F bins padded to
// whole 16-byte pieces, one sector for 28 uint8 features, where the
// feature-major matrix costs a sector a feature), all loads in flight
// before the stores, copied into the gathered arrays in compacted order
// (feature-major: a warp stores 32 consecutive rows of each feature).
template <typename BinT>
__device__ __forceinline__ void gather_rows(
    const BinT* __restrict__ rows, int row_w, const float* __restrict__ ghc_t,
    const int* __restrict__ src, long n, int num_feat, long lo, long hi,
    BinT* __restrict__ gbins, float* __restrict__ gstats) {
  constexpr int kPerPiece = 16 / sizeof(BinT);
  int pos[kGatherRows];
  float g[kGatherRows], h[kGatherRows], wt[kGatherRows];
#pragma unroll
  for (int i = 0; i < kGatherRows; ++i) {
    const long r = lo + threadIdx.x + i * kThreads;
    pos[i] = r < hi ? src[r] : -1;
  }
#pragma unroll
  for (int i = 0; i < kGatherRows; ++i) {
    if (pos[i] < 0) continue;
    g[i] = __ldg(ghc_t + pos[i]);
    h[i] = __ldg(ghc_t + n + pos[i]);
    wt[i] = __ldg(ghc_t + 2 * n + pos[i]);
  }
  for (int f0 = 0; f0 < num_feat; f0 += kPerPiece) {
    uint4 piece[kGatherRows];
#pragma unroll
    for (int i = 0; i < kGatherRows; ++i)
      if (pos[i] >= 0)
        piece[i] = __ldg(reinterpret_cast<const uint4*>(
            rows + (long)pos[i] * row_w + f0));
#pragma unroll
    for (int i = 0; i < kGatherRows; ++i) {
      if (pos[i] < 0) continue;
      const long r = lo + threadIdx.x + i * kThreads;
      const unsigned wd[4] = {piece[i].x, piece[i].y, piece[i].z, piece[i].w};
#pragma unroll
      for (int k = 0; k < kPerPiece; ++k) {
        if (f0 + k < num_feat)
          gbins[(f0 + k) * n + r] =
              (BinT)(wd[k / (kPerPiece / 4)] >>
                     (8 * sizeof(BinT) * (k % (kPerPiece / 4))));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kGatherRows; ++i) {
    if (pos[i] < 0) continue;
    const long r = lo + threadIdx.x + i * kThreads;
    gstats[r] = g[i];
    gstats[n + r] = h[i];
    gstats[2 * n + r] = wt[i];
  }
}

// The next K rows of a bin's sorted run added to its sums in row order,
// every load in flight before the first add.
template <int K>
__device__ __forceinline__ void add_rows(const unsigned short* ord,
                                         const float* g_s, const float* h_s,
                                         const float* w_s, float& ag,
                                         float& ah, float& aw) {
  int r[K];
#pragma unroll
  for (int q = 0; q < K; ++q) r[q] = ord[q];
  float vg[K], vh[K], vw[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    vg[q] = g_s[r[q]];
    vh[q] = h_s[r[q]];
    vw[q] = w_s[r[q]];
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    ag += vg[q];
    ah += vh[q];
    aw += vw[q];
  }
}

// kahan_fold's arithmetic (chunk_hist.cuh) for one feature's padded
// partial row, four cells a thread: partials at p + c * stride for
// chunks c = 0 .. chunks - 1; cells past 3B are padding, not written.
__device__ __forceinline__ void fold_row(const float* p, long stride,
                                         int chunks, int cells, float* hi,
                                         float* lo) {
  for (int e = 4 * threadIdx.x; e < cells; e += 4 * kThreads) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float comp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < chunks; c += kFoldAhead) {
      float4 v[kFoldAhead];
#pragma unroll
      for (int i = 0; i < kFoldAhead; ++i)
        if (c + i < chunks)
          v[i] = __ldcg(reinterpret_cast<const float4*>(
              p + (long)(c + i) * stride + e));
#pragma unroll
      for (int i = 0; i < kFoldAhead; ++i) {
        if (c + i >= chunks) break;
        const float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float y = x[k] - comp[k];
          const float t = acc[k] + y;
          comp[k] = (t - acc[k]) - y;
          acc[k] = t;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e + k < cells) {
        hi[e + k] = acc[k];
        lo[e + k] = comp[k] == 0.0f ? 0.0f : -comp[k];  // +0.0, as the CPU
      }
    }
  }
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads, 2)
    gather_sort_hist(const BinT* __restrict__ rows, int row_w,
                     const float* __restrict__ ghc_t,
                     const int* __restrict__ src,
                     const int* __restrict__ count, int n, int num_feat,
                     int num_bins, int passes, float* __restrict__ partials,
                     int* __restrict__ words, BinT* __restrict__ gbins,
                     float* __restrict__ gstats, float* __restrict__ hi,
                     float* __restrict__ lo) {
  using L = Smem<BinT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* g_s = reinterpret_cast<float*>(smem + L::kStats);
  float* h_s = g_s + kChunk;
  float* w_s = h_s + kChunk;
  BinT* raw_s = reinterpret_cast<BinT*>(smem + L::kRaw);  // two buffers
  unsigned short* rows_s = reinterpret_cast<unsigned short*>(smem + L::kRows);
  unsigned short* keys_s = reinterpret_cast<unsigned short*>(smem + L::kKeys);
  unsigned short* cnt_s = reinterpret_cast<unsigned short*>(smem + L::kCount);
  int* misc = reinterpret_cast<int*>(smem + L::kMisc);  // warp sums, ticket
  unsigned short* start_s = reinterpret_cast<unsigned short*>(smem + L::kBounds);
  unsigned short* end_s = start_s + num_bins;
  const int t = threadIdx.x;
  const int r0 = t * kPerThread;

  long cnt = count[0];
  cnt = cnt < 0 ? 0 : (cnt > n ? n : cnt);
  const Plan plan = make_plan(cnt, n, num_feat, gridDim.x);
  const Words w(words, n / kChunk, num_feat);
  const long row_len = (long)num_bins * 3;
  const int pad = row_pad(num_bins);
  const long chunk_len = (long)num_feat * pad;  // a chunk's padded partial

  // tickets: the next one is taken while this job runs
  unsigned next = 0;
  if (t == 0) next = atomicAdd(w.ticket, 1u);
  for (;;) {
    if (t == 0) misc[kWarpsPerBlock] = (int)next;
    __syncthreads();
    const int job = misc[kWarpsPerBlock];
    __syncthreads();
    if (job >= plan.jobs) break;  // block-uniform
    if (t == 0) next = atomicAdd(w.ticket, 1u);

    const Job jb = decode(plan, job);
    if (jb.kind == 0) {
      // ---- gather: (chunk, part)
      const int chunk = jb.chunk, part = jb.b;
      const long lo_r = (long)chunk * kChunk + part * kChunk / plan.parts;
      long hi_r = (long)chunk * kChunk + (part + 1) * kChunk / plan.parts;
      hi_r = hi_r < cnt ? hi_r : cnt;
      gather_rows(rows, row_w, ghc_t, src, n, num_feat, lo_r, hi_r, gbins,
                  gstats);
      publish(w.ready + chunk);
      continue;
    }
    const int tile = jb.a;
    const int f_lo = tile_lo(tile, plan.tiles, num_feat);
    const int f_hi = tile_lo(tile + 1, plan.tiles, num_feat);

    if (jb.kind == 2) {
      // ---- fold: one feature of the tile, once all its chunks are in
      const int f = f_lo + jb.b;
      wait_for(w.done + tile, plan.chunks);
      if (f < f_hi)
        fold_row(partials + (long)f * pad, chunk_len, plan.chunks,
                 (int)row_len, hi + f * row_len, lo + f * row_len);
      if (t == 0 && atomicAdd(w.released + tile, 1) == plan.tile_w - 1) {
        w.done[tile] = 0;  // every fold job of the tile has seen it
        w.released[tile] = 0;
      }
      continue;
    }

    // ---- sum: the tile's features over one chunk, once it is gathered
    const int chunk = jb.chunk;
    wait_for(w.ready + chunk, plan.gathers);
    if (t == 0 && atomicAdd(w.consumed + chunk, 1) == plan.tiles - 1) {
      w.ready[chunk] = 0;  // every sum job of the chunk has seen it
      w.consumed[chunk] = 0;
    }
    const long base = (long)chunk * kChunk;
    const int rows = (int)(cnt - base < kChunk ? cnt - base : kChunk);
    // copy groups: the first feature's bins, the statistics (they land
    // while it is sorted), then each next feature's bins during this one
    stage16(raw_s, gbins + (long)f_lo * n + base, rows * (int)sizeof(BinT));
    cp_async_commit();
    stage16(g_s, gstats + base, rows * 4);
    stage16(h_s, gstats + n + base, rows * 4);
    stage16(w_s, gstats + 2L * n + base, rows * 4);
    cp_async_commit();
    for (int f = f_lo; f < f_hi; ++f) {
      const BinT* raw = raw_s + ((f - f_lo) & 1) * kChunk;
      if (f + 1 < f_hi)
        stage16(raw_s + ((f + 1 - f_lo) & 1) * kChunk,
                gbins + (long)(f + 1) * n + base, rows * (int)sizeof(BinT));
      cp_async_commit();
      if (f == f_lo)
        cp_async_wait<2>();  // this feature's bins
      else
        cp_async_wait<1>();
      for (int b = t; b < num_bins; b += kThreads) start_s[b] = end_s[b] = 0;
      __syncthreads();
      // this thread's rows 16t .. 16t + 15; dropped ones are left out
      unsigned ent[kPerThread];
      unsigned keep = 0;
      {
        int b[kPerThread];
        load_blocked(raw, r0, b);
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          if (r0 + i < rows && (unsigned)b[i] < (unsigned)num_bins)
            keep |= 1u << i;
          ent[i] = (unsigned)(r0 + i) | (unsigned)(b[i] & 0xFFFF) << 16;
        }
      }
      // stable passes, least significant digit first; each carries the
      // rows and their bins
      const int kept =
          scatter_by_digit(ent, keep, 16, rows_s, keys_s, cnt_s, misc);
      int cur = 0;  // the arrays last written: + cur * kChunk
      for (int pass = 1; pass < passes; ++pass) {
        unsigned short row[kPerThread], key[kPerThread];
        load16(rows_s + cur * kChunk, r0, row);
        load16(keys_s + cur * kChunk, r0, key);
        keep = 0;
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          ent[i] = row[i] | (unsigned)key[i] << 16;
          if (r0 + i < kept) keep |= 1u << i;
        }
        cur ^= 1;
        scatter_by_digit(ent, keep, 16 + kDigitBits * pass,
                         rows_s + cur * kChunk, keys_s + cur * kChunk, cnt_s,
                         misc);
      }
      // each bin's run [start, end) of the sorted rows, from the sorted
      // bins this thread holds and their neighbours
      const unsigned short* ord = rows_s + cur * kChunk;
      const unsigned short* sk = keys_s + cur * kChunk;
      if (r0 < kept) {
        unsigned short key[kPerThread];
        load16(sk, r0, key);
        const int before = r0 > 0 ? sk[r0 - 1] : -1;
        const int after = r0 + kPerThread < kept ? sk[r0 + kPerThread] : -1;
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          const int j = r0 + i;
          if (j >= kept) break;
          const int prev = i > 0 ? key[i - 1] : before;
          const int nxt = j + 1 >= kept ? -1
                          : (i + 1 < kPerThread ? key[i + 1] : after);
          if (key[i] != prev) start_s[key[i]] = (unsigned short)j;
          if (key[i] != nxt) end_s[key[i]] = (unsigned short)(j + 1);
        }
      }
      if (f == f_lo) cp_async_wait<1>();  // this thread's statistics
      __syncthreads();
      // one thread a bin: its rows' values added in row order
      float* part = partials + chunk * chunk_len + (long)f * pad;
      for (int b = t; b < num_bins; b += kThreads) {
        const int e = end_s[b];
        int j = start_s[b];
        float ag = 0.0f, ah = 0.0f, aw = 0.0f;
        for (; j + 8 <= e; j += 8)
          add_rows<8>(ord + j, g_s, h_s, w_s, ag, ah, aw);
        if (j + 4 <= e) {
          add_rows<4>(ord + j, g_s, h_s, w_s, ag, ah, aw);
          j += 4;
        }
        for (; j < e; ++j) add_rows<1>(ord + j, g_s, h_s, w_s, ag, ah, aw);
        part[3 * b] = ag;
        part[3 * b + 1] = ah;
        part[3 * b + 2] = aw;
      }
      __syncthreads();  // the sort buffers and run bounds are reused
    }
    publish(w.done + tile);
  }
  // the last ticket: every block has taken its last job
  if (t == 0 && next == (unsigned)plan.jobs + gridDim.x - 1) *w.ticket = 0u;
}

// Raise gather_sort_hist's shared-memory limit once per (device, size)
// and return the blocks that run at once on the card (the grid).
template <typename BinT>
int prepare_sorted(int smem, int* grid) {
  static int allowed[kMaxDevices] = {};
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return kBadShape;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(gather_sort_hist<BinT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
    resident[dev] = 0;
  }
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_sort_hist<BinT>, kThreads, allowed[dev]);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return kNoFit;
    resident[dev] = sms * per_sm;
  }
  *grid = resident[dev];
  return kOk;
}

template <typename BinT>
int run_sorted(const void* rows, int row_w, const float* ghc_t,
               const int* src, const int* count, int num_feat, int n,
               int num_bins, float* partials, int* words, void* gathered,
               float* hi, float* lo, cudaStream_t stream) {
  if (rows == nullptr || words == nullptr || gathered == nullptr ||
      row_w < num_feat || (row_w * sizeof(BinT)) % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(rows) |
        reinterpret_cast<uintptr_t>(gathered) |
        reinterpret_cast<uintptr_t>(partials)) & 15) != 0)
    return kBadShape;
  // key bits of the largest kept bin: 4 a pass, one pass at least
  int top = num_bins - 1;
  if (sizeof(BinT) == 1 && top > 255) top = 255;
  int bits = 0;
  while ((top >> bits) != 0) ++bits;
  const int passes = bits > kDigitBits ? (bits + kDigitBits - 1) / kDigitBits
                                       : 1;
  const int smem = Smem<BinT>::bytes(num_bins);
  int grid = 0;
  const int status = prepare_sorted<BinT>(smem, &grid);
  if (status != kOk) return status;
  // the gathered statistics (3, n) float, then the gathered bins (F, n)
  float* gstats = static_cast<float*>(gathered);
  BinT* gbins = reinterpret_cast<BinT*>(gstats + 3L * n);
  gather_sort_hist<BinT><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(rows), row_w, ghc_t, src, count, n,
      num_feat, num_bins, passes, partials, words, gbins, gstats, hi, lo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The route compacted_hist takes at num_bins: 0 the sorted route (one
// launch), 1 the accumulator route (two launches).
int compacted_hist_route(int num_bins) {
  return num_bins <= kMaxSortBins ? 0 : 1;
}

// Scratch compacted_hist needs for n rows of num_feat features: the
// chunk partials (floats), the counters (int32, zeroed once and left
// zero by every call) and the gathered rows (bytes, 16-byte aligned).
long compacted_hist_partials(int n, int num_feat, int num_bins) {
  return (long)(n / kChunk) * num_feat * row_pad(num_bins);
}
int compacted_hist_words(int n, int num_feat) {
  return 1 + 2 * (n / kChunk) + 2 * num_feat;
}
long compacted_hist_gathered(int n, int num_feat, int bin_bytes) {
  return 12L * n + (long)num_feat * n * bin_bytes;
}

// ((num_feat, B, 3) value, residual) over the rows src[0 .. *count) of
// the (num_feat, n) bins (bin_bytes 1 or 2) and the (3, n) statistics;
// src: (n,) int32 positions, count: one int32 in device memory; rows:
// the same bins row-major, (n, row_w), a row padded to a multiple of
// 16 bytes (the sorted route reads these, the accumulator route the
// feature-major ones); the scratch sized by the three functions above
// (words and gathered are the sorted route's; the accumulator route
// uses the partials only).
int compacted_hist(const void* bins, const void* rows, int row_w,
                   int bin_bytes, const float* ghc_t, const int* src,
                   const int* count, int num_feat, int n, int num_bins,
                   float* partials, int* words, void* gathered, float* hi,
                   float* lo, void* stream) {
  if (num_feat < 1 || n < kChunk || n % kChunk != 0 || num_bins < 1 ||
      (bin_bytes != 1 && bin_bytes != 2))
    return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compacted_hist_route(num_bins) == 0) {
    if (bin_bytes == 1)
      return run_sorted<uint8_t>(rows, row_w, ghc_t, src, count, num_feat,
                                 n, num_bins, partials, words, gathered, hi,
                                 lo, s);
    return run_sorted<int16_t>(rows, row_w, ghc_t, src, count, num_feat, n,
                               num_bins, partials, words, gathered, hi, lo,
                               s);
  }
  if (bin_bytes == 1)
    return run_accumulator<uint8_t>(bins, ghc_t, src, count, num_feat, n,
                                    num_bins, partials, hi, lo, s);
  return run_accumulator<int16_t>(bins, ghc_t, src, count, num_feat, n,
                                  num_bins, partials, hi, lo, s);
}

const char* compact_hist_status_string(int status) {
  if (status == kBadShape) return "unsupported shape, bin width or alignment";
  if (status == kNoFit) return "one feature's histogram does not fit in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
