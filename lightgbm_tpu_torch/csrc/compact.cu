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
// One launch, one pass over the keys, no float work (compact_lookback):
//   - A block takes 4096-row tiles by an integer ticket (not blockIdx),
//     so a tile only ever waits on tiles that were handed out before it,
//     to blocks that are running.
//   - It loads its tile's keys once (16 coalesced int32 loads a thread,
//     kept in registers as one bit each), counts them with a ballot per
//     warp and 16-row step, and publishes the count in its flag.
//   - Decoupled look-back: warp 0 reads the flags of the 32 tiles before
//     it at a time, adds their counts until it meets one that holds its
//     inclusive prefix, and publishes its own inclusive prefix. Integer
//     sums: the same offsets whatever the order the tiles run in.
//   - It writes its rows at its offset in row order, each row's rank in
//     the tile from the step's ballot and the (step, warp) counts.
//   - The tile with the last index writes the count. A block out of
//     tiles waits for the last tile's prefix (the count) and writes the
//     sentinel over its share of [count, size).
// Each tile's rows land in their order and the tiles in theirs, so the
// result is the plain version's (cumsum rank, scatter with drop) element
// for element.
//
// The flags live in caller-owned scratch (compact_scratch_ints(n) int32,
// zeroed once): a ticket, an epoch and one 64-bit flag a tile holding
// (epoch << 2 | status, value). A flag counts only when it carries this
// call's epoch, so flags left by an earlier call (or an earlier graph
// replay) are never read as ready and nothing clears them. The block
// that takes the last ticket (all blocks have then ended their tiles and
// read the epoch) advances the epoch and rewinds the ticket for the next
// call. Two callers sharing one scratch must not run concurrently.
//
// Bound on this card. The function must read the keys (4 bytes a row)
// and write the (size,) buffer and the count once: 8 MB at 1M rows, 2.5
// us at 3.35 TB/s. The design reads each key once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 16;
constexpr int kTile = kThreads * kSteps;  // 4096 rows a tile
constexpr int kWarps = kThreads / 32;
constexpr int kHeaderInts = 4;            // ticket, epoch, two spare
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBadShape = -1;
constexpr int kMaxDevices = 64;

// a flag's status (its low two bits of the high word)
constexpr unsigned kPending = 0u;
constexpr unsigned kAggregate = 1u;  // the tile's own count
constexpr unsigned kPrefix = 2u;     // the count of the tiles up to it

__device__ __forceinline__ unsigned long long make_flag(unsigned epoch,
                                                        unsigned status,
                                                        unsigned value) {
  return ((unsigned long long)((epoch << 2) | status) << 32) | value;
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Exclusive prefix of tile t (t > 0) from the flags before it, by warp 0:
// 32 flags a round, nearest first, until one holds an inclusive prefix.
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* flags, int t, unsigned epoch, int lane) {
  unsigned excl = 0;
  for (int p = t - 1;; p -= 32) {
    const int q = p - lane;
    unsigned status, val;
    bool ready;
    do {
      if (q < 0) {  // before the first tile: a prefix of 0
        status = kPrefix;
        val = 0;
        ready = true;
      } else {
        const unsigned long long f = load_flag(flags + q);
        const unsigned hi = (unsigned)(f >> 32);
        status = hi & 3u;
        val = (unsigned)f;
        ready = (hi & ~3u) == (epoch << 2) && status != kPending;
      }
    } while (!__all_sync(kFull, ready));
    const unsigned pm = __ballot_sync(kFull, status == kPrefix);
    if (pm != 0u) {
      const int k = __ffs(pm) - 1;
      return excl + __reduce_add_sync(kFull, lane <= k ? val : 0u);
    }
    excl += __reduce_add_sync(kFull, val);
  }
}

__global__ void __launch_bounds__(kThreads)
    compact_lookback(const int* __restrict__ keys,
                     const int* __restrict__ value, int n, int tiles,
                     int* __restrict__ src, int size, int* __restrict__ count,
                     unsigned* __restrict__ scratch) {
  __shared__ int step_off[kSteps * kWarps];  // (step, warp) -> offset
  __shared__ unsigned s_ticket, s_word, s_epoch;
  unsigned* ticket = scratch;
  unsigned* epoch_p = scratch + 1;
  unsigned long long* flags =
      reinterpret_cast<unsigned long long*>(scratch + kHeaderInts);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int v = *value;
  if (tid == 0) {
    s_epoch = *reinterpret_cast<volatile unsigned*>(epoch_p);
    __threadfence();  // read before this block's first ticket
  }
  unsigned t;
  for (;;) {
    if (tid == 0) s_ticket = atomicAdd(ticket, 1u);
    __syncthreads();
    t = s_ticket;
    const unsigned epoch = s_epoch;
    if (t >= (unsigned)tiles) break;  // block-uniform
    const long base = (long)t * kTile;
    unsigned sel = 0;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const long row = base + k * kThreads + tid;
      sel |= (row < n && keys[row] == v ? 1u : 0u) << k;
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const unsigned m = __ballot_sync(kFull, (sel >> k) & 1u);
      if (lane == 0) step_off[k * kWarps + warp] = __popc(m);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the 128 (step, warp) counts, 4 a lane
      int c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = step_off[4 * lane + i];
      const int own = c[0] + c[1] + c[2] + c[3];
      int x = own;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      int run = x - own;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        step_off[4 * lane + i] = run;
        run += c[i];
      }
      const unsigned agg = (unsigned)__shfl_sync(kFull, x, 31);
      if (lane == 0)
        store_flag(flags + t,
                   make_flag(epoch, t == 0 ? kPrefix : kAggregate, agg));
      const unsigned excl = t > 0 ? look_back(flags, (int)t, epoch, lane) : 0u;
      if (lane == 0) {
        if (t > 0) store_flag(flags + t, make_flag(epoch, kPrefix, excl + agg));
        if (t == (unsigned)tiles - 1) *count = (int)(excl + agg);
        s_word = excl;
      }
    }
    __syncthreads();
    const unsigned excl = s_word;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const bool s = (sel >> k) & 1u;
      const unsigned m = __ballot_sync(kFull, s);
      if (s) {
        const unsigned dst = excl + step_off[k * kWarps + warp] +
                             __popc(m & below);
        if (dst < (unsigned)size)  // rows past `size` are dropped
          src[dst] = (int)(base + k * kThreads + tid);
      }
    }
    __syncthreads();  // step_off and s_ticket are written again
  }
  const unsigned epoch = s_epoch;
  if (tid == 0) {
    // the last ticket: every block has ended its tiles and read the epoch
    if (t == (unsigned)tiles + gridDim.x - 1) {
      atomicExch(ticket, 0u);
      atomicExch(epoch_p, epoch + 1u);
    }
    // the count, once the last tile's prefix is out
    unsigned long long f;
    while ((unsigned)((f = load_flag(flags + tiles - 1)) >> 32) !=
           ((epoch << 2) | kPrefix))
      __nanosleep(64);
    s_word = (unsigned)f;
  }
  __syncthreads();
  for (long q = (long)s_word + (long)blockIdx.x * kThreads + tid; q < size;
       q += (long)gridDim.x * kThreads)
    src[q] = n;
}

// Blocks of the grid: one a tile, at most as many as run at once.
int grid_blocks(int tiles) {
  static int resident[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return tiles;
  if (dev >= kMaxDevices || resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_lookback,
                                                  kThreads, 0);
    const int r = sms * per_sm > 0 ? sms * per_sm : 1;
    if (dev >= kMaxDevices) return tiles < r ? tiles : r;
    resident[dev] = r;
  }
  return tiles < resident[dev] ? tiles : resident[dev];
}

}  // namespace

extern "C" {

// Tiles of n rows (one flag each).
int compact_tiles(int n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

// int32 words of the scratch compact_rows needs for n rows: the ticket,
// the epoch, two spare, and a 64-bit flag a tile. Zero it once.
int compact_scratch_ints(int n) { return kHeaderInts + 2 * compact_tiles(n); }

// src (size,) int32 and *count (one int32) from keys (n,) int32 and one
// key value, all in device memory; scratch: compact_scratch_ints(n)
// int32 (8-byte aligned), zeroed before its first call.
int compact_rows(const int* keys, const int* value, int n, int* src,
                 int size, int* count, int* scratch, void* stream) {
  if (n < 0 || size < 0 || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0)
    return kBadShape;
  const int tiles = compact_tiles(n);
  compact_lookback<<<grid_blocks(tiles), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, value, n, tiles, src, size, count,
      reinterpret_cast<unsigned*>(scratch));
  return (int)cudaGetLastError();
}

const char* compact_status_string(int status) {
  if (status == kBadShape)
    return "negative row count or buffer size, or misaligned scratch";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
