"""Device LambdaRank: the pair gradients of every query on the device
(port of lightgbm_tpu/objectives/rank_device.py).

Reference: src/objective/rank_objective.hpp:19-227 (GetGradientsForOneQuery)
sweeps each query's O(n_q^2) pairs on the CPU. On a card the sweep is
one CUDA kernel, csrc/rank.cu (ops/rank_kernels.lambdarank_pairs: a
block a query, ranks by counting, a thread a row summing its pairs in
row order); on the CPU its plain version pads the queries to a rectangle
(Qp, M) as the JAX package does and computes a block of queries' pairs
as one (block, M, M) float32 tensor, PaddedQueryLayout's blocks of at
most _PAIR_BUDGET pair elements, with the kernel's operations and sum
order. Three properties the trainer relies on:
- ranks: the stable argsort of -score over a query's rows, as the JAX
  package's (its padded slots rank after them, so the ranks agree for
  every score but NaN, which here ranks after every number of its own
  query);
- determinism: no float scatter-add, no atomics; adding 0.0 turns a
  -0.0 into the +0.0 the JAX package's add into zeros gives;
- capture: no host sync and fixed shapes, so the fused trainer captures
  the kernel in its CUDA graph.

The reference's 1M-entry sigmoid lookup table is replaced by the exact
expression with the same clamp (as in the JAX package); the pair math is
float32, the objective's host float64 path is the accuracy reference.
"""

import numpy as np
import torch

from ..metrics.dcg_calculator import DCGCalculator, K_MAX_POSITION
from ..ops import rank_kernels

# max f32 elements in one (block, M, M) pair tensor (~64 MB)
_PAIR_BUDGET = 16 * 1024 * 1024


class PaddedQueryLayout:
    """Static padded-query indexing shared by the objective and metric
    (host numpy; rank_device.py:29-51)."""

    def __init__(self, query_boundaries, num_data):
        qb = np.asarray(query_boundaries, dtype=np.int64)
        self.counts = np.diff(qb)
        self.num_queries = len(self.counts)
        self.num_data = int(num_data)
        self.max_docs = int(self.counts.max()) if len(self.counts) else 1
        # query block size under the pair-tensor budget
        qb_rows = max(1, _PAIR_BUDGET // (self.max_docs * self.max_docs))
        qb_rows = min(qb_rows, max(self.num_queries, 1))
        self.block_queries = qb_rows
        self.num_blocks = -(-self.num_queries // qb_rows)
        self.padded_queries = self.num_blocks * qb_rows
        # (Qp, M) row indices; padded slots point at the sink row N
        idx = np.full((self.padded_queries, self.max_docs), self.num_data,
                      dtype=np.int32)
        for q in range(self.num_queries):
            lo, hi = qb[q], qb[q + 1]
            idx[q, : hi - lo] = np.arange(lo, hi, dtype=np.int32)
        self.idx = idx
        self.mask = idx < self.num_data
        self.boundaries = qb


def make_lambdarank_gradfn(layout: PaddedQueryLayout, label, label_gain,
                           sigmoid, max_position, weights, device):
    """The (score (1, N) float32 tensor) -> (grad, hess), each (1, N)
    float32, on `device` (rank_device.py:54-140): the lambdarank_pairs
    kernel for a CUDA score, its plain version (in the layout's blocks)
    for a CPU one."""
    dcg = DCGCalculator(label_gain)
    lab = np.asarray(label, dtype=np.int64)
    inv = np.zeros(layout.num_queries)
    for q in range(layout.num_queries):
        maxdcg = dcg.cal_maxdcg_at_k(
            max_position, lab[layout.idx[q][layout.mask[q]]])
        inv[q] = 1.0 / maxdcg if maxdcg > 0 else 0.0

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    qb = dev(layout.boundaries, torch.int32)
    gain = dev(dcg.label_gain[lab], torch.float32)
    inv_d = dev(inv, torch.float32)
    w = None if weights is None else dev(np.asarray(weights, np.float32),
                                         torch.float32)
    disc = dev(dcg.discount, torch.float32)
    inputs = dict(qb=qb, gain=gain, inv=inv_d, weight=w, disc=disc,
                  sigmoid=float(sigmoid), max_docs=layout.max_docs)

    def grad_fn(score):
        return rank_kernels.lambdarank_pairs(
            score, **inputs, block_queries=layout.block_queries)

    grad_fn.inputs = inputs    # the wrapper's arguments but the score
    return grad_fn


def ndcg_eval_padded(layout: PaddedQueryLayout, label, label_gain, eval_at,
                     score, query_weights=None):
    """Vectorized padded NDCG@k (rank_metric.hpp:16-165), host numpy:
    one argsort over (Q, M) instead of a loop over queries
    (rank_device.py:143-176)."""
    dcg = DCGCalculator(label_gain)
    lab = np.asarray(label, dtype=np.int64)
    Q, M = layout.num_queries, layout.max_docs
    idx = layout.idx[:Q]
    mask = layout.mask[:Q]
    s = np.where(mask, np.asarray(score, dtype=np.float64)[
        np.minimum(idx, layout.num_data - 1)], -np.inf)
    lg = dcg.label_gain[np.where(mask, lab[np.minimum(idx, layout.num_data - 1)], 0)]
    order = np.argsort(-s, axis=1, kind="stable")
    gains_ranked = np.take_along_axis(lg * mask, order, axis=1)     # (Q, M)
    # positions beyond the discount LUT clamp to its last entry (the
    # gradient path applies the same clamp on ranks)
    disc_m = dcg.discount[np.minimum(np.arange(M), K_MAX_POSITION - 1)]
    cum = np.cumsum(gains_ranked * disc_m[None, :], axis=1)
    # ideal ordering for maxdcg
    ideal = np.sort(lg * mask, axis=1)[:, ::-1]
    cum_ideal = np.cumsum(ideal * disc_m[None, :], axis=1)
    cnt = mask.sum(axis=1)
    qw = (np.ones(Q) if query_weights is None
          else np.asarray(query_weights, dtype=np.float64))
    out = []
    for k in eval_at:
        kk = np.minimum(int(k), cnt) - 1                            # (Q,)
        kk_safe = np.maximum(kk, 0)
        dcg_k = np.take_along_axis(cum, kk_safe[:, None], 1)[:, 0]
        max_k = np.take_along_axis(cum_ideal, kk_safe[:, None], 1)[:, 0]
        ndcg = np.where(max_k > 0, dcg_k / np.maximum(max_k, 1e-300), 1.0)
        ndcg = np.where(cnt > 0, ndcg, 1.0)
        out.append(float(np.sum(qw * ndcg) / np.sum(qw)))
    return out
