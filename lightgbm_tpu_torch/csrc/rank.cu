// LambdaRank pair gradients for Hopper (sm_90a): every query's O(n_q^2)
// pairs on the card, one block a query.
//
// Replaces the JAX package's make_lambdarank_gradfn
// (lightgbm_tpu/objectives/rank_device.py:54-140), an XLA program with no
// Pallas kernel that pads the queries to a (Q, M) rectangle and builds
// (block, M, M) pair tensors. For each query q (rows [qb[q], qb[q+1])),
// in float32:
//   rank_i   the position of row i in the stable argsort of -score over
//            the query's rows (NaN after every number);
//   disc_i = disc_lut[min(rank_i, disc_len - 1)];
//   best / worst the scores at ranks 0 and cnt - 1, worst taken from
//            rank cnt - 2 when it is -inf and cnt > 1 (rank_objective.hpp's
//            kMinScore rule); norm = best != worst;
//   for each ordered pair (h, l) with gain_h > gain_l:
//     ds = s_h - s_l, delta = ((gain_h - gain_l) * |disc_h - disc_l|) * inv_q,
//     delta /= 0.01 + |ds| where norm,
//     p = 2 * (1 / (1 + exp((2 * clamp(ds, lo, hi)) * sig))),
//     lam = (-p) * delta, hes = (2 * (p * (2 - p))) * delta;
//   g_i = rowsum_i(lam) - colsum_i(lam), h_i = rowsum_i(hes) + colsum_i(hes)
//   (row i's pairs (i, j) and (j, i), each sum over j in row order from
//   +0.0), times the row's weight where there is one, plus 0.0.
// Rows in no query get 0. The plain PyTorch version
// (ops/rank_kernels.py lambdarank_grad_plain) computes every term with the
// same float32 operations and sums in the same order, so the two agree
// bit for bit on the card: every operation here is an _rn intrinsic, which
// nvcc never contracts into an FMA (the library expf's own FMAs are those
// of torch's exp on the card), and p is a correctly rounded reciprocal
// times 2, as torch computes 2.0 / t.
//
// Bound on this card: the pair arithmetic. At the bench shape (7,966
// queries of 50-200 documents) about 0.56e8 pairs have unequal gains, ~27
// float32 operations each; the bytes (score, gains, weights, query bounds,
// grad and hess: 24 bytes a row) are a few microseconds. Design:
// 1. One block a query, reading its own rows [qb[q], qb[q+1]): no padded
//    layout, no row -> slot gather. The block stages each row's score,
//    gain and discount as one float4 in shared memory (16 bytes a row) for
//    queries of up to kSmemDocs rows; a longer query stages them in a
//    device scratch array (the wrapper's, 16 bytes a row) and reads them
//    back through L1/L2.
// 2. Ranks by counting, not by sorting: rank_i = #{j : s_j > s_i} +
//    #{j < i : s_j == s_i} (+-0.0 compare equal), NaN after every number
//    and in row order among NaNs: the integers of the stable argsort of
//    -s. O(n_q^2) compares, the order of the pair work, one barrier.
//    The threads holding ranks 0, cnt - 1 and cnt - 2 publish best and
//    the two worst scores.
// 3. One thread a row i walks j = 0 .. cnt - 1 in row order and keeps two
//    pairs of accumulators: the pairs (i, j) (row sums) and (j, i)
//    (column sums). Each unordered pair is evaluated by both of its rows:
//    twice the arithmetic, but no atomics and no reduction across
//    threads, and the bits do not depend on the launch. A thread adds
//    +0.0 where a pair is not its own (no branch), as the plain version
//    does: that leaves a sum that started at +0.0 as it was.
// The block stages and ranks with all its threads, then a thread owns
// rows tid, tid + blockDim, ...; one extra block (blockIdx.x ==
// num_queries) writes the zeros of the rows outside every query. No host
// sync, fixed arguments: a CUDA graph captures the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// threads a block at most (a thread takes rows tid, tid + blockDim, ...);
// of 64, 128, 256 and 512 timed on an H100, 256 and 512 tied fastest
constexpr int kMaxThreads = 256;
// queries of up to this many rows keep their rows in shared memory:
// 16 bytes a row, with the block's three static floats within the 48 KB
// a block takes without opting in
constexpr int kSmemDocs = 3000;

enum Status {
  kOk = 0,
  kBadArgs = 1,
  kNeedScratch = 2,
  kLaunch = 3,
};

// Row j ranks ahead of row i in the stable argsort of -s.
__device__ __forceinline__ bool ahead(float sj, int j, float si, int i,
                                      bool nan_i) {
  if (nan_i) return sj == sj || j < i;   // NaN last, in row order
  return sj > si || (sj == si && j < i);
}

__device__ __forceinline__ void pair_term(float sh, float sl, float gh,
                                          float gl, float dh, float dl,
                                          float inv, bool norm, float sig,
                                          float lo, float hi, float& lam,
                                          float& hes) {
  const float ds = __fsub_rn(sh, sl);
  const float gap = __fsub_rn(gh, gl);
  const float pd = fabsf(__fsub_rn(dh, dl));
  float delta = __fmul_rn(__fmul_rn(gap, pd), inv);
  if (norm) delta = __fdiv_rn(delta, __fadd_rn(0.01f, fabsf(ds)));
  // clamp that keeps a NaN (torch.clamp's rule)
  float x = ds < lo ? lo : ds;
  x = x > hi ? hi : x;
  const float e = expf(__fmul_rn(__fmul_rn(2.0f, x), sig));
  const float p = __fmul_rn(__frcp_rn(__fadd_rn(1.0f, e)), 2.0f);
  const float ph = __fmul_rn(p, __fsub_rn(2.0f, p));
  lam = __fmul_rn(-p, delta);
  hes = __fmul_rn(__fmul_rn(2.0f, ph), delta);
}

// One query's rows [row0, row0 + cnt) staged in `docs` (shared memory,
// or the device scratch for a long query): ranks, then the pair walk.
// Inlined once for each address space.
__device__ __forceinline__ void query_walk(
    float4* docs, int row0, int cnt, const float* __restrict__ score,
    const float* __restrict__ gain, float inv,
    const float* __restrict__ weight, const float* __restrict__ disc_lut,
    int disc_len, float sig, float lo, float hi, float* __restrict__ grad,
    float* __restrict__ hess) {
  __shared__ float s_best, s_worst, s_worst2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < cnt; i += nt) {
    docs[i] = make_float4(score[row0 + i], gain[row0 + i], 0.0f, 0.0f);
  }
  __syncthreads();
  // ranks by counting; this phase reads only the scores (.x) and each
  // thread writes only its rows' discounts (.z)
  float* words = reinterpret_cast<float*>(docs);
  for (int i = tid; i < cnt; i += nt) {
    const float si = words[4 * i];
    const bool nan_i = si != si;
    int rank = 0;
    for (int j = 0; j < cnt; ++j) rank += ahead(words[4 * j], j, si, i, nan_i);
    words[4 * i + 2] = disc_lut[rank < disc_len - 1 ? rank : disc_len - 1];
    if (rank == 0) s_best = si;
    if (rank == cnt - 1) s_worst = si;
    if (rank == cnt - 2) s_worst2 = si;
  }
  __syncthreads();
  float worst = s_worst;
  if (worst == -CUDART_INF_F && cnt > 1) worst = s_worst2;
  const bool norm = s_best != worst;
  for (int i = tid; i < cnt; i += nt) {
    const float4 di = docs[i];
    float rg = 0.0f, cg = 0.0f, rh = 0.0f, ch = 0.0f;
    for (int j = 0; j < cnt; ++j) {
      const float4 dj = docs[j];
      const bool row = __fsub_rn(di.y, dj.y) > 0.0f;   // the pair (i, j)
      const bool col = __fsub_rn(dj.y, di.y) > 0.0f;   // the pair (j, i)
      // the high row's values first: no branch, one term a j
      float lam, hes;
      pair_term(row ? di.x : dj.x, row ? dj.x : di.x,
                row ? di.y : dj.y, row ? dj.y : di.y,
                row ? di.z : dj.z, row ? dj.z : di.z,
                inv, norm, sig, lo, hi, lam, hes);
      // +0.0 for the other sum (and for both when the gains are equal):
      // a sum that starts at +0.0 never becomes -0.0, so adding +0.0
      // leaves its bits as they are
      rg = __fadd_rn(rg, row ? lam : 0.0f);
      rh = __fadd_rn(rh, row ? hes : 0.0f);
      cg = __fadd_rn(cg, col ? lam : 0.0f);
      ch = __fadd_rn(ch, col ? hes : 0.0f);
    }
    float g = __fsub_rn(rg, cg);
    float h = __fadd_rn(rh, ch);
    if (weight != nullptr) {
      const float w = weight[row0 + i];
      g = __fmul_rn(g, w);
      h = __fmul_rn(h, w);
    }
    grad[row0 + i] = __fadd_rn(g, 0.0f);   // -0.0 -> +0.0
    hess[row0 + i] = __fadd_rn(h, 0.0f);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lambdarank_pairs_kernel(const float* __restrict__ score,
                        const int* __restrict__ qb, int num_queries,
                        const float* __restrict__ gain,
                        const float* __restrict__ inv_max_dcg,
                        const float* __restrict__ weight,
                        const float* __restrict__ disc_lut, int disc_len,
                        float sig, float lo, float hi, int smem_docs,
                        float4* scratch, int n, float* __restrict__ grad,
                        float* __restrict__ hess) {
  extern __shared__ float4 sdocs[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (blockIdx.x == num_queries) {       // rows outside every query
    const int first = qb[0], last = qb[num_queries];
    for (int r = tid; r < first; r += nt) grad[r] = hess[r] = 0.0f;
    for (int r = last + tid; r < n; r += nt) grad[r] = hess[r] = 0.0f;
    return;
  }
  const int q = blockIdx.x;
  const int row0 = qb[q];
  const int cnt = qb[q + 1] - row0;
  if (cnt <= 0) return;
  const float inv = inv_max_dcg[q];
  if (cnt <= smem_docs) {
    query_walk(sdocs, row0, cnt, score, gain, inv, weight, disc_lut,
               disc_len, sig, lo, hi, grad, hess);
  } else if (scratch != nullptr) {
    query_walk(scratch + row0, row0, cnt, score, gain, inv, weight,
               disc_lut, disc_len, sig, lo, hi, grad, hess);
  } else {                                // max_docs understated
    for (int i = tid; i < cnt; i += nt) {
      grad[row0 + i] = hess[row0 + i] = CUDART_NAN_F;
    }
  }
}

}  // namespace

extern "C" {

// The rows a query may hold and still stage in shared memory; a longer
// query needs `scratch` (16 bytes a row of the whole array).
int rank_smem_docs() { return kSmemDocs; }

// score, gain, weight (nullable), grad, hess: (n,) float32; qb
// (num_queries + 1,) int32 non-decreasing row bounds within [0, n);
// inv_max_dcg (num_queries,) float32; disc_lut (disc_len,) float32;
// max_docs: the longest query's rows; scratch: (n, 4) float32, needed
// (non-null) only when max_docs > rank_smem_docs(). Launches on
// `stream`; returns a Status.
int lambdarank_pairs(const float* score, const int* qb, int num_queries,
                     const float* gain, const float* inv_max_dcg,
                     const float* weight, const float* disc_lut,
                     int disc_len, float sig, float lo, float hi,
                     int max_docs, void* scratch, int n, float* grad,
                     float* hess, cudaStream_t stream) {
  if (score == nullptr || qb == nullptr || gain == nullptr ||
      inv_max_dcg == nullptr || disc_lut == nullptr || grad == nullptr ||
      hess == nullptr || num_queries < 0 || n <= 0 || disc_len <= 0 ||
      max_docs < 0) {
    return kBadArgs;
  }
  if (max_docs > kSmemDocs && scratch == nullptr) return kNeedScratch;
  const int staged = max_docs < kSmemDocs ? max_docs : kSmemDocs;
  int threads = ((max_docs > 1 ? max_docs : 1) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)(staged > 0 ? staged : 1) * sizeof(float4);
  lambdarank_pairs_kernel<<<num_queries + 1, threads, smem, stream>>>(
      score, qb, num_queries, gain, inv_max_dcg, weight, disc_lut, disc_len,
      sig, lo, hi, staged > 0 ? staged : 1,
      static_cast<float4*>(scratch), n, grad, hess);
  return cudaGetLastError() == cudaSuccess ? kOk : kLaunch;
}

const char* rank_status_string(int status) {
  switch (status) {
    case kOk: return "ok";
    case kBadArgs: return "bad arguments";
    case kNeedScratch:
      return "a query longer than the shared-memory cut needs scratch";
    case kLaunch: return "kernel launch failed (cudaGetLastError)";
    default: return "unknown status";
  }
}

}  // extern "C"
