"""Device LambdaRank: padded-query pair gradients as a torch program
(port of lightgbm_tpu/objectives/rank_device.py).

Reference: src/objective/rank_objective.hpp:19-227 (GetGradientsForOneQuery)
sweeps each query's O(n_q^2) pairs on the CPU. Here the queries are
padded to a rectangle (Qp, M) (M = the largest query) and the pairs of
a block of queries are one (block, M, M) float32 tensor on the device:
the ranks of a stable argsort of -score, the NDCG deltas and the sigmoid
responses, summed over each row's pairs. Blocks hold at most
_PAIR_BUDGET pair elements, so peak memory is O(block * M^2) whatever
the query count.

Three properties the trainer relies on:
- ranks: the JAX package's second argsort is the inverse permutation;
  here it is a scatter of an arange through the order, the same
  integers;
- determinism: every real row owns exactly one padded slot, so the
  gradients come back by a gather through the row -> slot map (no
  float scatter-add, whose atomics would make the bits run-dependent);
  adding 0.0 turns a -0.0 into the +0.0 the JAX package's add into
  zeros gives;
- capture: no host sync, no data-dependent shape, a fixed loop over the
  blocks, so the fused trainer captures it in its CUDA graph.

The reference's 1M-entry sigmoid lookup table is replaced by the exact
expression with the same clamp (as in the JAX package); the pair math is
float32, the objective's host float64 path is the accuracy reference.
"""

import numpy as np
import torch

from ..metrics.dcg_calculator import DCGCalculator, K_MAX_POSITION

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
        # row -> its flat slot in (Qp * M); a row in no query reads the
        # zero slot appended after the last one
        slot = np.full(self.num_data, idx.size, dtype=np.int64)
        flat = idx.reshape(-1)
        real = np.nonzero(flat < self.num_data)[0]
        slot[flat[real]] = real
        self.row_slot = slot


def make_lambdarank_gradfn(layout: PaddedQueryLayout, label, label_gain,
                           sigmoid, max_position, weights, device):
    """The (score (1, N) float32 tensor) -> (grad, hess), each (1, N)
    float32, on `device` (rank_device.py:54-140)."""
    dcg = DCGCalculator(label_gain)
    lab = np.asarray(label, dtype=np.int64)
    qp, m = layout.idx.shape
    n = layout.num_data
    safe = np.minimum(layout.idx, n - 1)
    lab_p = np.where(layout.mask, lab[safe], 0)
    lg_p = dcg.label_gain[lab_p] * layout.mask                     # (Qp, M)
    inv = np.zeros(qp)
    for q in range(layout.num_queries):
        maxdcg = dcg.cal_maxdcg_at_k(
            max_position, lab[layout.idx[q][layout.mask[q]]])
        inv[q] = 1.0 / maxdcg if maxdcg > 0 else 0.0
    w_p = None
    if weights is not None:
        w = np.asarray(weights, dtype=np.float32)
        w_p = np.where(layout.mask, w[safe], 0.0)

    nb, qb = layout.num_blocks, layout.block_queries

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    idx_d = dev(layout.idx.reshape(nb, qb, m), torch.int64)
    mask_d = dev(layout.mask.reshape(nb, qb, m), torch.bool)
    lg_d = dev(lg_p.reshape(nb, qb, m), torch.float32)
    inv_d = dev(inv.reshape(nb, qb), torch.float32)
    w_d = None if w_p is None else dev(w_p.reshape(nb, qb, m), torch.float32)
    disc_lut = dev(dcg.discount, torch.float32)
    row_slot = dev(layout.row_slot, torch.int64)
    arange_m = torch.arange(m, device=device).expand(qb, m)
    sig = float(sigmoid)
    min_in = -50.0 / sig / 2.0
    max_in = -min_in

    def one_block(b, s_flat):
        mask_b, lg_b, inv_b = mask_d[b], lg_d[b], inv_d[b]
        s = torch.where(mask_b, s_flat[idx_d[b]], -np.inf)   # (qb, M)
        order = torch.argsort(-s, dim=1, stable=True)
        ranks = torch.empty_like(order).scatter_(1, order, arange_m)
        disc = disc_lut[ranks.clamp(max=K_MAX_POSITION - 1)]
        cnt = mask_b.sum(dim=1)
        best = torch.gather(s, 1, order[:, :1])[:, 0]
        wpos = (cnt - 1).clamp(min=0)[:, None]
        worst = torch.gather(s, 1, torch.gather(order, 1, wpos))[:, 0]
        # rank_objective.hpp: skip a kMinScore sentinel at the bottom
        worst2 = torch.gather(s, 1, torch.gather(
            order, 1, (wpos - 1).clamp(min=0)))[:, 0]
        worst = torch.where(torch.isneginf(worst) & (cnt > 1), worst2, worst)
        norm = best != worst

        sm = torch.where(mask_b, s, 0.0)
        ds = sm[:, :, None] - sm[:, None, :]                       # (qb, M, M)
        dcg_gap = lg_b[:, :, None] - lg_b[:, None, :]
        pmask = (dcg_gap > 0) & mask_b[:, :, None] & mask_b[:, None, :]
        pd = torch.abs(disc[:, :, None] - disc[:, None, :])
        delta = dcg_gap * pd * inv_b[:, None, None]
        delta = torch.where(norm[:, None, None],
                            delta / (0.01 + torch.abs(ds)), delta)
        x = torch.clamp(ds, min_in, max_in)
        p = 2.0 / (1.0 + torch.exp(2.0 * x * sig))
        ph = p * (2.0 - p)
        lam = torch.where(pmask, -p * delta, 0.0)
        hes = torch.where(pmask, 2.0 * ph * delta, 0.0)
        g = lam.sum(dim=2) - lam.sum(dim=1)
        h = hes.sum(dim=2) + hes.sum(dim=1)
        if w_d is not None:
            g = g * w_d[b]
            h = h * w_d[b]
        return g * mask_b, h * mask_b

    zero = torch.zeros(1, dtype=torch.float32, device=device)

    def grad_fn(score):
        s_flat = torch.cat([score[0].to(torch.float32), zero])
        parts = [one_block(b, s_flat) for b in range(nb)]
        g_flat = torch.cat([p[0].reshape(-1) for p in parts] + [zero])
        h_flat = torch.cat([p[1].reshape(-1) for p in parts] + [zero])
        grad = g_flat[row_slot] + 0.0
        hess = h_flat[row_slot] + 0.0
        return grad[None, :], hess[None, :]

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
