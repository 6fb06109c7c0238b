// Tree-ensemble traversal for Hopper (sm_90a): the serving hot loop.
//
// Replaces the lockstep XLA traversal of the JAX package, which has no
// Pallas kernel: device_traverse (lightgbm_tpu/models/gbdt.py:65) under
// the jitted serving kernels of lightgbm_tpu/serving/compiled_model.py
//   _leaf_kernel (:76)                              -> tree_leaf
//   _raw_kernel, _transformed_kernel (:86, :95)     -> tree_raw<float>
//   _raw16_kernel, _transformed16_kernel (:110, :124) -> tree_raw<bf16>
//   _linraw_kernel, _lintransformed_kernel (:170, :183) -> tree_lin_raw
//     (with _linear_leaf_values :138, f32 or bf16 storage)
// and the port's plain PyTorch walk (lightgbm_tpu_torch/models/gbdt.py
// device_traverse), about 14 small ops per depth step.
//
//   tree_leaf: leaf[r, t] = the leaf row r reaches in tree t   (B, T) int32
//   tree_raw:  raw[r, c]  = sum over trees t with t % K == c of
//                           leaf_value[t, leaf[r, t]], in tree order, f32
//   tree_lin_raw: the same sum of each lane's linear leaf value
//                           const + sum_{j < cnt} coef_j * x[r, feat_j]
//                           (slots added in order 0..7, f32, a product
//                           rounded before its add), or the constant
//                           leaf value where cnt is 0 or a live feature
//                           is NaN; with the transform, sigmoid or
//                           softmax of the row's sums in the same launch
//
// A node is one 16-byte record packed at freeze time
// (ops/traverse_kernels.py pack_nodes, then interleave): x = the split
// feature times 4 (a byte offset in a row) with the categorical flag in
// bit 31, y = the f32-safe threshold's bits, z / w = the left / right
// child, as the child record's byte offset in its tree's column of the
// tile (node x 512) or ~leaf for a leaf. The decision is
// device_traverse's for every input: numeric `x <= thr` (NaN goes
// right), categorical `!isnan(x) && int(x) == int(thr)` with the cast
// saturating at +-inf (__float2int_rz; category ids are small and
// non-negative, so the decision equals the JAX package's and the plain
// version's). A walk cut short by `depth` (not a valid model) gives
// tree_leaf ~node, as the lockstep walk does, and tree_raw leaf 0.
//
// Bound on this card. A 4096-row bucket of 28 features through 100
// trees of 62 node slots reads x once (0.46 MB) and the records once
// (0.10 MB) and writes 4096 x 100 int32 leaves (1.6 MB): 0.66 us at 3.35
// TB/s. What the time follows is the walk: a chain of up to `depth`
// dependent loads (record, then the feature value) a (row, tree) pair,
// 410k pairs a bucket, about 0.6 us a link from device memory once L2
// is cold. The design keeps every link in shared memory:
//
// 1. Trees walked from shared memory. The records of 32 trees are
//    interleaved into a tile (record n of tree j at [n][j]); a block
//    copies its tiles into dynamic shared memory with TMA bulk copies
//    (cp.async.bulk completing on an mbarrier), issued by one thread:
//    the whole group of tiles at once when it fits (and the grid is
//    under a wave), else a ring of two one-tile windows, the next copy
//    running while the current window is walked. Each window's roots
//    and, where they fit, the block's rows are staged too. A tile larger
//    than shared memory is walked from device memory, and rows too wide
//    to stage are read from device memory, so every shape the wrappers
//    accept runs. A wait for a copy has no time limit: the host checks
//    rule out a copy that could never land (and a trap would end the
//    process's CUDA context).
// 2. A warp walks one row through one tile: lane j takes tree j, so the
//    32 record loads of a step hit 32 consecutive 16-byte words (no bank
//    conflict), the feature loads one row (a broadcast where they
//    agree), and the 32 leaves are one row-contiguous store. A step is
//    a record load, a feature load, a compare and a select; the records'
//    byte offsets leave no index arithmetic, and a forest without
//    categorical nodes takes an instantiation without the categorical
//    rule. Latency is hidden by warps (up to 1024 threads a block, about
//    two (tile, row) items a warp): walks of one thread do not overlap,
//    since the compiler runs one walk's load-compare-select chain after
//    the other's (measured: four walks a thread were slower than one).
// 3. Small batches spread over blocks. tree_leaf's grid is (row blocks,
//    tiles): a tile a block, so the 1-row bucket of the bench model is 4
//    blocks of 32 trees.
// 4. Fixed-order sums. tree_raw walks the whole forest in each block
//    (one tile group); each (row, class) cell adds its class's trees of
//    a window in tree order from shared memory into an accumulator that
//    lives across windows, so each sum is the plain version's sequential
//    f32 adds and two launches and the plain version give the same bits.
//    A block's rows shrink until their (rows, K) sums fit in shared
//    memory (one row holds K of about 50,000).
// 5. Linear leaves (tree_lin_raw) are tree_raw's walk with another value
//    stage: a lane that reached its leaf reads the leaf's 64-byte record
//    (LinRecord: intercept, 8 coefficients, 8 column ids of 20 bits, the
//    leaf's constant value and the live count; f32, which holds a bf16
//    model's values exactly) as four 16-byte loads issued together, then
//    the row's 8 values (staged in shared memory) together, and dots
//    them in slot order; the value goes into the window's values as the
//    leaf value does in tree_raw, so the class sums keep tree order. A
//    lane's chain is the walk, one round trip for the record and one
//    shared-memory round for the row. Where the intercepts,
//    coefficients, columns, counts and leaf values were five arrays, a
//    lane's loads came back one after another: the count, then the
//    block, then the row, then the leaf value, which the compiler sank
//    to its use (on the H100 the value stage took about 2.5 us a lane
//    against the walk's 0.9, bench/lin_profile.py; PERF.md).
//    Loading the leaf's value from its own array beside the record cost
//    0.5 us of a 4096-row call's 18; overlapping a lane's value stage
//    with its next walk, an L2 prefetch of the records and two blocks an
//    SM were each measured no faster.
// The launch plan (rows, tiles a block and a window, slots, staged rows,
// threads) is made by traverse_kernels.plan; this file checks it, lays
// out shared memory (layout()) and opts each kernel in to the card's
// largest dynamic shared memory once a device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxThreads = 1024;  // a walk block (Plan::threads)
constexpr int kTile = 32;  // trees a tile interleaves (a warp's lanes)
constexpr int kBadShape = -1;
constexpr int kNoFit = -2;
constexpr int kMaxDevices = 64;
constexpr int kMaxGridY = 65535;
constexpr int kCoefPad = 8;  // coefficient slots a linear leaf (COEF_PAD)

// tree_lin_raw's output transform
enum Transform { kRawSums = 0, kSigmoid = 1, kSoftmax = 2 };

// A launch plan (ops/traverse_kernels.py plan): rows a block, tiles a
// block (group), tiles a window, shared-memory window slots (0: records
// read from device memory), rows staged in shared memory or not,
// whether the forest has categorical nodes, and threads a block.
struct Plan {
  int rows, group, window, slots, stage_rows, categorical, threads;
};

// Byte offsets in dynamic shared memory. A 128-byte head (two mbarriers)
// comes first, so that the tiles start on a 128-byte boundary: bulk
// copies into a 16- or 32-byte-aligned buffer made the walks measurably
// slower on the H100.
struct Layout {
  size_t tiles, roots, xs, vals, acc, total;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// A group of more than one window keeps two buffers of roots (and, for
// sums, of leaf values): the next window's fill while this one is read.
Layout layout(const Plan& p, int f, int s, int k, bool sums) {
  Layout l;
  const size_t win_trees = (size_t)p.window * kTile;
  const size_t bufs = p.group > p.window ? 2 : 1;
  l.tiles = 128;
  l.roots = l.tiles + align16((size_t)p.slots * win_trees * s * 16);
  l.xs = l.roots + align16(bufs * win_trees * 4);
  l.vals = l.xs + (p.stage_rows ? align16((size_t)p.rows * (f | 1) * 4) : 0);
  l.acc = l.vals +
          (sums ? align16(bufs * p.rows * (win_trees | 1) * 4) : 0);
  l.total = l.acc + (sums ? align16((size_t)p.rows * k * 4) : 0);
  return l;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A linear leaf's record (ops/traverse_kernels.py pack_linear), 16
// 32-bit words: 0 the intercept and 1..8 the coefficients (f32 bits;
// bf16 storage widened, which is exact), 9..12 the low 16 bits of the 8
// column ids (two a word, slot 2q in the low half), 13 their bits 16..19
// (a nibble a slot, slot j at bit 4j), 14 the leaf's constant value (f32
// bits, widened likewise), 15 the live count.
struct LinRecord {
  int4 w[4];
};

// The linear leaves of tree_lin_raw, indexed by tree * L + leaf; the
// output transform and, for the sigmoid, -2 * sigmoid rounded to f32.
struct Lin {
  const LinRecord* rec;
  int xform;
  float neg2sig;
};

// the record's four 16-byte loads, issued together where they stand (a
// volatile asm is not moved below the count's test or into a later
// iteration)
__device__ __forceinline__ LinRecord load_record(const LinRecord* p) {
  LinRecord r;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.w[i].x), "=r"(r.w[i].y), "=r"(r.w[i].z),
                   "=r"(r.w[i].w)
                 : "l"(reinterpret_cast<const int4*>(p) + i));
  return r;
}

// word k of a record (k a constant once the loops are unrolled)
__device__ __forceinline__ unsigned rec_word(const LinRecord& r, int k) {
  const int4 v = r.w[k >> 2];
  const int c = k & 3;
  return static_cast<unsigned>(c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z
                                                                   : v.w);
}

// slot j's column
__device__ __forceinline__ unsigned rec_col(const LinRecord& r, int j) {
  return ((rec_word(r, 9 + (j >> 1)) >> ((j & 1) * 16)) & 0xffffu) |
         (((rec_word(r, 13) >> (4 * j)) & 0xfu) << 16);
}

// One lane's linear leaf value from its leaf's record for the row at xr
// (shared or device memory): the plain version's arithmetic, every slot
// added in order (a dead or NaN slot adds 0.0), each product rounded
// before its add, and the leaf's constant value where the leaf is
// constant or a live feature is NaN.
__device__ __forceinline__ float lin_dot(const LinRecord& rec,
                                         const float* xr) {
  const int cn = static_cast<int>(rec_word(rec, 15));
  const float base = __uint_as_float(rec_word(rec, 14));
  if (cn <= 0) return base;
  // the row's 8 values loaded together, before any is tested (a dead
  // slot's column is 0, a valid one)
  float xv[kCoefPad];
#pragma unroll
  for (int j = 0; j < kCoefPad; ++j) xv[j] = xr[rec_col(rec, j)];
  float a = __uint_as_float(rec_word(rec, 0));
  bool nan = false;
#pragma unroll
  for (int j = 0; j < kCoefPad; ++j) {
    const bool live = j < cn, missing = xv[j] != xv[j];
    nan |= live && missing;
    a = __fadd_rn(a, live && !missing
                         ? __fmul_rn(__uint_as_float(rec_word(rec, 1 + j)),
                                     xv[j])
                         : 0.0f);
  }
  return nan ? base : a;
}

// the same at (tree, leaf) index li, the record loaded here
__device__ __forceinline__ float linear_value(const Lin& lin, size_t li,
                                              const float* xr) {
  const LinRecord rec = load_record(lin.rec + li);
  return lin_dot(rec, xr);
}

// ------------------------------------------------- mbarrier and TMA copy

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
}

// make the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// order this block's earlier shared-memory accesses before a TMA write
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) that completes the barrier's current phase
__device__ __forceinline__ void tile_copy(uint64_t* bar, void* dst,
                                          const void* src, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for a window's copy (the host's checks rule out one that cannot
// land)
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  while (!bar_try(bar, parity)) {
  }
}

// the leaf values of `count` trees from `first` pulled into L2 while the
// trees are walked (one 32-byte sector a thread at a time)
template <typename V>
__device__ __forceinline__ void prefetch_values(const V* lv, int l,
                                                int first, int count) {
  const char* base = reinterpret_cast<const char*>(lv + (size_t)first * l);
  const size_t bytes = (size_t)count * l * sizeof(V);
  for (size_t o = (size_t)threadIdx.x * 32; o < bytes; o += blockDim.x * 32)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + o));
}

// the roots of `count` trees from `first`, as byte offsets (or ~leaf)
__device__ __forceinline__ void stage_roots(int* dst, const int* node0,
                                            int first, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int n = __ldg(node0 + first + i);
    dst[i] = n >= 0 ? n * kTile * 16 : n;
  }
}

// ------------------------------------------------------------ the walks

// A walk's loads. From shared memory they take 32-bit shared addresses
// (base + byte offset: the records hold byte offsets, so a step computes
// no index).
template <bool kShared>
__device__ __forceinline__ int4 load_record(const char* base, uint32_t sbase,
                                            int off) {
  if (!kShared) return *reinterpret_cast<const int4*>(base + off);
  int4 r;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(sbase + off));
  return r;
}

template <bool kShared>
__device__ __forceinline__ float load_value(const char* base, uint32_t sbase,
                                            int off) {
  if (!kShared) return *reinterpret_cast<const float*>(base + off);
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(sbase + off));
  return v;
}

// One step of a walk at `node` (a record's byte offset in its tree's
// column `tree`) of the row at `xrow`; returns the next state (a child's
// byte offset, or ~leaf). kCat: the forest has categorical nodes (else
// the numeric rule alone, with no mask or conversion on the chain).
template <bool kShared, bool kCat>
__device__ __forceinline__ int step(int node, const char* tree,
                                    uint32_t tree_s, const char* xrow,
                                    uint32_t xrow_s) {
  const int4 rec = load_record<kShared>(tree, tree_s, node);
  const float v = load_value<kShared>(xrow, xrow_s,
                                      kCat ? (rec.x & 0x7fffffff) : rec.x);
  const float thr = __int_as_float(rec.y);
  bool left = v <= thr;
  if (kCat)
    left = rec.x < 0
               ? ((v == v) & (__float2int_rz(v) == __float2int_rz(thr)))
               : left;
  return left ? rec.z : rec.w;
}

// One walk from `node` through the tree whose column starts at `tree`,
// reading the row at `xrow`, until a leaf or `depth` steps; returns the
// final state.
template <bool kShared, bool kCat>
__device__ __forceinline__ int walk(int node, const char* tree,
                                    const char* xrow, int depth) {
  const uint32_t tree_s = kShared ? smem_addr(tree) : 0u;
  const uint32_t xrow_s = kShared ? smem_addr(xrow) : 0u;
  for (int d = 0; d < depth && node >= 0; ++d)
    node = step<kShared, kCat>(node, tree, tree_s, xrow, xrow_s);
  return node;
}

// One block: rows [row0, row0 + rows) through the trees of tiles [gt0,
// gt0 + group). The group's tiles are walked a window of `window` tiles
// at a time, each window copied into one of `slots` shared-memory slots
// (slots 0: walked from device memory). A warp takes (tile, row) items
// of the window: lane j walks tree j of the tile for the row, so the 32
// lanes read 32 consecutive 16-byte words (no bank conflict), one row's
// features (a broadcast where they agree), and store 32 consecutive
// outputs. Many warps a SM hide the chain's latency: the compiler runs
// several walks of one thread one after another, not overlapped.
// kRaw false writes leaves to out (B, T) int32; kRaw true (one tile
// group, the whole forest) the class sums to out (B, K) f32, of the leaf
// values or, kLin, of the linear leaf values (transformed as lin.xform
// says). kFast: the records and rows are both in shared memory, so
// every load of the walk is a shared one. kLin's bounds aim at one
// block an SM: its record takes 16 registers, and under two blocks' cap
// of 32 registers it spilled and ran slower.
template <bool kRaw, typename V, bool kFast, bool kCat, bool kLin>
__global__ void __launch_bounds__(kMaxThreads, kLin ? 1 : 2)
walk_kernel(const float* __restrict__ x, int b, int f,
            const int4* __restrict__ tiles, const int* __restrict__ node0,
            int t, int s, int depth, const V* __restrict__ lv, int l, int k,
            Lin lin, Plan p, Layout lay, void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int4* buf = reinterpret_cast<int4*>(smem + lay.tiles);
  int* roots = reinterpret_cast<int*>(smem + lay.roots);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* vals = reinterpret_cast<float*>(smem + lay.vals);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * p.rows;
  const int nrows = min(p.rows, b - row0);
  const int ntiles = (t + kTile - 1) / kTile;
  const int gt0 = blockIdx.y * p.group;      // first tile of the group
  const int gtn = min(p.group, ntiles - gt0);
  const int g0 = gt0 * kTile;                // first tree of the group
  const int gn = min(gtn * kTile, t - g0);
  const int nwin = (gtn + p.window - 1) / p.window;
  const size_t tile_recs = (size_t)s * kTile;
  const size_t win_recs = tile_recs * p.window;
  const bool ring = kFast || p.slots > 0;
  const int win_trees = p.window * kTile;
  const bool two = p.group > p.window;       // two root / value buffers
  const int pitch = win_trees | 1;
  const bool staged = kFast || p.stage_rows;
  const int xstride = staged ? (f | 1) : f;

  if (ring && tid == 0) {
    // the same thread initialises the barriers and issues the copies
    for (int i = 0; i < p.slots; ++i) bar_init(bars + i);
    bar_init_fence();
    for (int i = 0; i < p.slots && i < nwin; ++i) {
      const int wt = min(p.window, gtn - i * p.window);
      tile_copy(bars + i, buf + i * win_recs,
                tiles + (gt0 + (size_t)i * p.window) * tile_recs,
                static_cast<uint32_t>(wt * tile_recs * 16));
    }
  }
  // while the first windows arrive: the first window's roots, the rows,
  // the first values
  stage_roots(roots, node0, g0, min(win_trees, gn));
  const float* xg = x + (size_t)row0 * f;
  if (staged) {
    for (int i = tid; i < nrows * f; i += nthreads) {
      const int r = i / f;
      xs[r * xstride + (i - r * f)] = __ldg(xg + i);
    }
  }
  if (kRaw) {
    for (int q = tid; q < nrows * k; q += nthreads) acc[q] = 0.0f;
    if (!kLin) prefetch_values(lv, l, g0, min(win_trees, gn));
  }
  __syncthreads();
  const char* xbase = reinterpret_cast<const char*>(staged ? xs : xg);

  for (int wi = 0; wi < nwin; ++wi) {
    const int wt0 = wi * p.window;           // first tile, from gt0
    const int wtiles = min(p.window, gtn - wt0);
    const int wtrees0 = wt0 * kTile;         // first tree, from g0
    const int wtn = min(wtiles * kTile, gn - wtrees0);
    const int next = wtrees0 + wtiles * kTile;  // the next window's
    const int slot = ring ? wi % p.slots : 0;
    const int* wroots = roots + (two ? (wi & 1) * win_trees : 0);
    float* wvals = vals + (two ? (wi & 1) * p.rows * pitch : 0);
    if (kRaw && !kLin && wi + 1 < nwin)
      prefetch_values(lv, l, g0 + next, min(win_trees, gn - next));
    if (ring) bar_wait(bars + slot, (wi / p.slots) & 1);
    const int4* wbuf = ring ? buf + slot * win_recs
                            : tiles + (gt0 + (size_t)wt0) * tile_recs;
    // A warp's (tile, row) items u = warp, warp + 8, ...: lane j walks
    // tree j of the item's tile for the row. (A lane that took its next
    // item as soon as its walk ended was measured twice as slow: the
    // store-and-restart path runs divergent within the warp.)
    for (int u = warp; u < wtiles * nrows; u += nthreads / 32) {
      const int r = u / wtiles;
      const int tl = u - r * wtiles;         // tile of the window
      const int jw = tl * kTile + lane;      // tree of the window
      if (jw >= wtn) continue;
      int node = walk<kFast, kCat>(
          wroots[jw],
          reinterpret_cast<const char*>(wbuf + tl * tile_recs + lane),
          xbase + (size_t)r * xstride * 4, depth);
      if (node >= 0) node /= kTile * 16;     // cut short: the node index
      const int tree = g0 + wtrees0 + jw;    // in the forest
      if (kRaw) {
        const size_t li = (size_t)tree * l + (node < 0 ? ~node : 0);
        float v;
        if constexpr (kLin)
          v = linear_value(lin, li,
                           reinterpret_cast<const float*>(
                               xbase + (size_t)r * xstride * 4));
        else
          v = widen(lv[li]);
        wvals[r * pitch + jw] = v;
      } else
        static_cast<int*>(out)[(size_t)(row0 + r) * t + tree] = ~node;
    }
    // the next window's roots, into the buffer the window before this
    // one read (its walks ended at the last barrier)
    if (wi + 1 < nwin)
      stage_roots(roots + ((wi + 1) & 1) * win_trees, node0, g0 + next,
                  min(win_trees, gn - next));
    __syncthreads();  // the window is walked: its slot is free
    if (ring && tid == 0 && wi + p.slots < nwin) {
      const int wn = wi + p.slots;
      const int wt = min(p.window, gtn - wn * p.window);
      async_proxy_fence();
      tile_copy(bars + slot, buf + slot * win_recs,
                tiles + (gt0 + (size_t)wn * p.window) * tile_recs,
                static_cast<uint32_t>(wt * tile_recs * 16));
    }
    if (kRaw) {
      // each (row, class) cell adds its class's trees of the window in
      // tree order (g0 is 0: one tree group); vals is double-buffered, so
      // the next window's walks do not wait for these adds
      for (int q = tid; q < nrows * k; q += nthreads) {
        const int rr = q / k;
        const int c = q - rr * k;
        const float* vr = wvals + rr * pitch;
        float a = acc[q];
        int j = ((c - wtrees0) % k + k) % k;
        for (; j + 3 * k < wtn; j += 4 * k) {  // four loads, then the adds
          const float v0 = vr[j], v1 = vr[j + k], v2 = vr[j + 2 * k],
                      v3 = vr[j + 3 * k];
          a += v0;
          a += v1;
          a += v2;
          a += v3;
        }
        for (; j < wtn; j += k) a += vr[j];
        acc[q] = a;
      }
    }
  }
  if (kRaw) {
    float* dst = static_cast<float*>(out) + (size_t)row0 * k;
    if (kLin && lin.xform == kSoftmax) {
      // a row's K sums were added by several threads: each row's softmax
      // in the plain version's order (max, exp of the differences, their
      // sum from class 0 up, each exp over the sum)
      __syncthreads();
      for (int rr = tid; rr < nrows; rr += nthreads) {
        const float* ar = acc + rr * k;
        float m = ar[0];
        for (int c = 1; c < k; ++c) m = fmaxf(m, ar[c]);
        float sum = expf(__fsub_rn(ar[0], m));
        for (int c = 1; c < k; ++c)
          sum = __fadd_rn(sum, expf(__fsub_rn(ar[c], m)));
        for (int c = 0; c < k; ++c)
          dst[rr * k + c] = __fdiv_rn(expf(__fsub_rn(ar[c], m)), sum);
      }
    } else {
      // each thread stores the cells it added
      for (int q = tid; q < nrows * k; q += nthreads) {
        float v = acc[q];
        if (kLin && lin.xform == kSigmoid)
          v = __fdiv_rn(1.0f,
                        __fadd_rn(1.0f, expf(__fmul_rn(lin.neg2sig, v))));
        dst[q] = v;
      }
    }
  }
}

// ---------------------------------------------------------------- host

std::mutex g_opt_in_lock;

int smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Opt a kernel in to the device's largest dynamic shared memory, once a
// device (the batcher's worker and the HTTP threads launch at once).
template <bool kRaw, typename V, bool kFast, bool kCat, bool kLin>
int opt_in(int device) {
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return kBadShape;
  std::lock_guard<std::mutex> guard(g_opt_in_lock);
  if (done[device]) return 0;
  int bytes = 0;
  int status = smem_optin(device, &bytes);
  if (status != 0) return status;
  status = static_cast<int>(cudaFuncSetAttribute(
      walk_kernel<kRaw, V, kFast, kCat, kLin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (status != 0) return status;
  done[device] = true;
  return 0;
}

int check_launch() { return static_cast<int>(cudaGetLastError()); }

template <bool kRaw, typename V, bool kFast, bool kCat, bool kLin>
int launch_one(dim3 grid, const Layout& lay, cudaStream_t stream, int device,
               const float* x, int b, int f, const void* nodes,
               const int* node0, int t, int s, int depth, const V* lv, int l,
               int k, const Lin& lin, const Plan& p, void* out) {
  const int status = opt_in<kRaw, V, kFast, kCat, kLin>(device);
  if (status != 0) return status;
  walk_kernel<kRaw, V, kFast, kCat, kLin>
      <<<grid, p.threads, lay.total, stream>>>(
          x, b, f, static_cast<const int4*>(nodes), node0, t, s, depth, lv,
          l, k, lin, p, lay, out);
  return check_launch();
}

template <bool kRaw, typename V, bool kLin>
int launch_walk(const float* x, int b, int f, const void* nodes,
                const int* node0, int t, int s, int depth, const V* lv,
                int l, int k, const Lin& lin, const int* plan, void* out,
                void* stream) {
  if (b < 0 || f < 1 || t < 1 || s < 1 || depth < 0 || l < 1 || k < 1)
    return kBadShape;
  if (b == 0) return 0;
  const Plan p{plan[0], plan[1], plan[2], plan[3],
               plan[4], plan[5], plan[6]};
  const long long ntiles = (t + kTile - 1) / kTile;
  if (p.rows < 1 || p.group < 1 || p.window < 1 || p.window > p.group ||
      p.slots < 0 || p.slots > 2 || (kRaw && p.group < ntiles) ||
      p.threads < 32 || p.threads > kMaxThreads || p.threads % 32)
    return kBadShape;
  const long long groups = (ntiles + p.group - 1) / p.group;
  // an mbarrier counts at most 2^20 - 1 bytes of one window's copy; a
  // child's byte offset (node x 512) must fit an int
  if (groups > kMaxGridY || (long long)s * kTile * 16 > 0x7fffffffLL ||
      (p.slots > 0 && (long long)p.window * s * kTile * 16 >= (1 << 20)))
    return kBadShape;
  if (p.slots > 0 && (reinterpret_cast<uintptr_t>(nodes) & 15))
    return kBadShape;  // TMA copies need 16-byte-aligned records
  if (kLin && (lin.xform < kRawSums || lin.xform > kSoftmax ||
               (reinterpret_cast<uintptr_t>(lin.rec) & 15)))
    return kBadShape;
  const Layout lay = layout(p, f, s, k, kRaw);
  int device = 0, limit = 0;
  int status = static_cast<int>(cudaGetDevice(&device));
  if (status == 0) status = smem_optin(device, &limit);
  if (status != 0) return status;
  if (lay.total > static_cast<size_t>(limit)) return kNoFit;
  const dim3 grid((b + p.rows - 1) / p.rows, static_cast<int>(groups));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fast = p.slots > 0 && p.stage_rows;
  if (fast && p.categorical)
    return launch_one<kRaw, V, true, true, kLin>(grid, lay, st, device, x, b,
                                                 f, nodes, node0, t, s, depth,
                                                 lv, l, k, lin, p, out);
  if (fast)
    return launch_one<kRaw, V, true, false, kLin>(grid, lay, st, device, x, b,
                                                  f, nodes, node0, t, s, depth,
                                                  lv, l, k, lin, p, out);
  if (p.categorical)
    return launch_one<kRaw, V, false, true, kLin>(grid, lay, st, device, x, b,
                                                  f, nodes, node0, t, s, depth,
                                                  lv, l, k, lin, p, out);
  return launch_one<kRaw, V, false, false, kLin>(grid, lay, st, device, x, b,
                                                 f, nodes, node0, t, s, depth,
                                                 lv, l, k, lin, p, out);
}

}  // namespace

extern "C" {

// (B, T) int32 leaf indices of B rows of x (B, F) f32 row-major through T
// trees of S node slots each (nodes: the (ceil(T / 32), S, 32) int4 tiles
// of traverse_kernels.interleave; node0 (T,) int32), launched by `plan`
// (7 ints, traverse_kernels.Plan.args).
int tree_leaf(const float* x, int b, int f, const void* nodes,
              const int* node0, int t, int s, int depth, const int* plan,
              int* out, void* stream) {
  return launch_walk<false, float, false>(x, b, f, nodes, node0, t, s, depth,
                                          nullptr, 1, 1, Lin{}, plan, out,
                                          stream);
}

// (B, K) f32 class sums of the T trees' leaf values, lv (T, L) float32:
// tree t adds to class t % K, in tree order (the plan's one tile group).
int tree_raw_f32(const float* x, int b, int f, const void* nodes,
                 const int* node0, int t, int s, int depth, const float* lv,
                 int l, int k, const int* plan, float* out, void* stream) {
  return launch_walk<true, float, false>(x, b, f, nodes, node0, t, s, depth,
                                         lv, l, k, Lin{}, plan, out, stream);
}

// The same with bfloat16 leaf values, accumulated in f32.
int tree_raw_bf16(const float* x, int b, int f, const void* nodes,
                  const int* node0, int t, int s, int depth, const void* lv,
                  int l, int k, const int* plan, float* out, void* stream) {
  return launch_walk<true, __nv_bfloat16, false>(
      x, b, f, nodes, node0, t, s, depth,
      static_cast<const __nv_bfloat16*>(lv), l, k, Lin{}, plan, out, stream);
}

// (B, K) f32 class sums of the T trees' linear leaf values (tree_raw's
// order), transformed by xform (0 none, 1 sigmoid with neg2sig = -2 *
// sigmoid, 2 softmax over the K sums): rec the (T, L) 64-byte records
// (LinRecord), 16-byte aligned, which hold every value the sums read
// (float32, or a bfloat16 model's values widened).
int tree_lin_raw(const float* x, int b, int f, const void* nodes,
                 const int* node0, int t, int s, int depth, const void* rec,
                 int l, int k, int xform, float neg2sig, const int* plan,
                 float* out, void* stream) {
  const Lin lin{static_cast<const LinRecord*>(rec), xform, neg2sig};
  return launch_walk<true, float, true>(x, b, f, nodes, node0, t, s, depth,
                                        nullptr, l, k, lin, plan, out,
                                        stream);
}

// The dynamic shared memory a block may opt in to on `device` (bytes), or
// a negative CUDA status.
int traverse_smem_optin(int device) {
  int bytes = 0;
  const int status = smem_optin(device, &bytes);
  return status != 0 ? -status : bytes;
}

const char* traverse_status_string(int status) {
  if (status == kBadShape) return "unsupported shape or launch plan";
  if (status == kNoFit)
    return "the launch plan needs more shared memory than the card has";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
