"""LambdaRank pair-gradient kernel: its CUDA wrapper and its plain
PyTorch version.

Port of the JAX package's device LambdaRank, an XLA program with no
Pallas kernel: make_lambdarank_gradfn
(lightgbm_tpu/objectives/rank_device.py:54-140). For a score (1, N) and
queries that are contiguous row ranges [qb[q], qb[q+1]),

  lambdarank_pairs  (grad, hess), each (1, N) float32: every query's
                    pair sums (csrc/rank.cu states the function term by
                    term); 0 for rows in no query.

The inputs are the function's own: the score, each row's label gain
(N,) and weight (N,) or None, the query bounds (Q + 1,) int32, each
query's inverse max DCG (Q,), the discount table, the sigmoid and the
longest query's row count (a host int: it sets the launch's block and
shared memory, and the plain version's padded width).

The kernel is csrc/rank.cu (design and bound are noted there), built by
hist_kernels.build with the other sources and loaded with ctypes. It
launches on PyTorch's current stream with no host sync, so the fused
trainer captures it in its CUDA graph; its launches count in
`KERNELS["lambdarank_pairs"].launches` (hist_kernels' registry, so a
graph's replays count them too). Dispatch is by the score's device
only: a CPU tensor takes the plain version, a CUDA tensor the kernel or
an exception; there is no fallback.

The plain version pads the queries to a (Q, M) rectangle, as the JAX
package does, computes the pair terms of a block of queries as
(block, M, M) float32 tensors with the kernel's operations in the
kernel's order, and sums each row's and each column's terms in column
order from +0.0, one (block, M) slice at a time: on the card it gives
the kernel's bits. The CPU tests and the objective on the CPU use it;
chip_smoke.py holds the kernel against it.
"""

import torch

from . import hist_kernels

KERNELS = {"lambdarank_pairs": hist_kernels.KERNELS["lambdarank_pairs"]}
# max f32 elements in one (block, M, M) pair tensor of the plain version
# (~64 MB)
PAIR_BUDGET = 16 * 1024 * 1024


def clamp_bounds(sigmoid):
    """The clamp of the sigmoid's input (rank_objective.hpp: -50 / sig /
    2 and its negative), as Python floats."""
    lo = -50.0 / float(sigmoid) / 2.0
    return lo, -lo


def _check(score, qb, gain, inv, weight, disc, max_docs):
    if score.dim() != 2 or score.shape[0] != 1:
        raise ValueError("lambdarank_pairs: score must be (1, N)")
    n = score.shape[1]
    if n == 0:
        raise ValueError("lambdarank_pairs: no rows")
    if qb.dim() != 1 or qb.dtype != torch.int32 or qb.shape[0] < 1:
        raise ValueError("lambdarank_pairs: qb must be a (Q + 1,) int32 "
                         "tensor")
    for name, t, size in (("gain", gain, n), ("inv", inv, qb.shape[0] - 1),
                          ("weight", weight, n), ("disc", disc, None)):
        if t is None and name == "weight":
            continue
        if t.dim() != 1 or t.dtype != torch.float32 or (
                size is not None and t.shape[0] != size):
            raise ValueError(f"lambdarank_pairs: {name} must be a 1-D "
                             f"float32 tensor" + (f" of {size}" if size
                                                  is not None else ""))
        if t.device != score.device:
            raise ValueError("lambdarank_pairs: inputs on different devices")
    if qb.device != score.device:
        raise ValueError("lambdarank_pairs: inputs on different devices")
    if disc.shape[0] < 1 or int(max_docs) < 0:
        raise ValueError("lambdarank_pairs: empty discount table or "
                         "negative max_docs")


def pair_terms(ds, gap, pd, inv, norm, sigmoid):
    """(lam, hes) of pairs whose high row's minus low row's score is ds,
    gain difference gap > 0 and discount distance pd; inv and norm
    broadcast. The kernel's float32 operations in its order."""
    lo, hi = clamp_bounds(sigmoid)
    delta = gap * pd * inv
    delta = torch.where(norm, delta / (0.01 + torch.abs(ds)), delta)
    x = torch.clamp(ds, lo, hi)
    p = torch.reciprocal(1.0 + torch.exp(2.0 * x * float(sigmoid))) * 2.0
    ph = p * (2.0 - p)
    return -p * delta, 2.0 * ph * delta


def lambdarank_grad_plain(score, qb, gain, inv, weight, disc, sigmoid,
                          max_docs, block_queries=None):
    """Plain version of lambdarank_pairs: ((1, N) grad, (1, N) hess)
    float32. Queries are padded to M = max_docs columns and taken
    `block_queries` at a time (default: a block's pair tensor within
    PAIR_BUDGET elements); the bits do not depend on the blocking."""
    _check(score, qb, gain, inv, weight, disc, max_docs)
    dev = score.device
    s_flat = score.reshape(-1).to(torch.float32)
    n = s_flat.shape[0]
    nq = qb.shape[0] - 1
    m = max(int(max_docs), 1)
    if block_queries is None:
        block_queries = max(1, PAIR_BUDGET // (m * m))
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    s_pad = torch.cat([s_flat, zero])
    g_pad = torch.cat([gain, zero])
    lo = qb[:-1].long()
    cnt = (qb[1:] - qb[:-1]).long()
    cols = torch.arange(m, device=dev)
    mask_all = cols[None, :] < cnt[:, None]                       # (Q, M)
    idx_all = torch.where(mask_all, lo[:, None] + cols[None, :], n)
    k_max = disc.shape[0] - 1
    g_parts, h_parts = [], []
    for b0 in range(0, nq, block_queries):
        idx = idx_all[b0:b0 + block_queries]
        mask = mask_all[b0:b0 + block_queries]
        c = cnt[b0:b0 + block_queries]
        s = s_pad[idx]                                            # (qb, M)
        lg = g_pad[idx]
        # the stable argsort of -s over each query's rows (NaN after
        # every number), the padded slots after them all
        key = torch.where(mask, -s, torch.nan)
        order = torch.argsort(key, dim=1, stable=True)
        ranks = torch.empty_like(order).scatter_(
            1, order, cols.expand_as(order).contiguous())
        d = disc[ranks.clamp(max=k_max)]
        best = torch.gather(s, 1, order[:, :1])[:, 0]
        wpos = (c - 1).clamp(min=0)[:, None]
        worst = torch.gather(s, 1, torch.gather(order, 1, wpos))[:, 0]
        worst2 = torch.gather(s, 1, torch.gather(
            order, 1, (wpos - 1).clamp(min=0)))[:, 0]
        # rank_objective.hpp: skip a kMinScore sentinel at the bottom
        worst = torch.where(torch.isneginf(worst) & (c > 1), worst2, worst)
        norm = (best != worst)[:, None, None]
        ds = s[:, :, None] - s[:, None, :]                        # (qb, M, M)
        gap = lg[:, :, None] - lg[:, None, :]
        pmask = (gap > 0) & mask[:, :, None] & mask[:, None, :]
        pd = torch.abs(d[:, :, None] - d[:, None, :])
        lam, hes = pair_terms(ds, gap, pd,
                              inv[b0:b0 + block_queries][:, None, None],
                              norm, sigmoid)
        lam = torch.where(pmask, lam, 0.0)
        hes = torch.where(pmask, hes, 0.0)
        # each row's pairs (i, j) and (j, i), summed in column order
        rg, cg = torch.zeros_like(s), torch.zeros_like(s)
        rh, ch = torch.zeros_like(s), torch.zeros_like(s)
        for j in range(m):
            rg = rg + lam[:, :, j]
            cg = cg + lam[:, j, :]
            rh = rh + hes[:, :, j]
            ch = ch + hes[:, j, :]
        g_parts.append((rg - cg).reshape(-1))
        h_parts.append((rh + ch).reshape(-1))
    g_flat = torch.cat(g_parts + [zero])
    h_flat = torch.cat(h_parts + [zero])
    # each row's slot in the (Q, M) rectangle; a row in no query reads
    # the zero slot after the last one (a gather: no float scatter)
    rows = torch.arange(n, device=dev, dtype=torch.int32)
    q_of = torch.searchsorted(qb, rows, right=True).long() - 1
    inside = (q_of >= 0) & (q_of < nq)
    qc = q_of.clamp(0, max(nq - 1, 0))
    lo_pad = torch.cat([lo, lo.new_zeros(1)])
    slot = torch.where(inside, qc * m + rows.long() - lo_pad[qc], nq * m)
    grad, hess = g_flat[slot], h_flat[slot]
    if weight is not None:
        grad, hess = grad * weight, hess * weight
    return (grad + 0.0)[None, :], (hess + 0.0)[None, :]


def _library():
    return hist_kernels._library("rank.cu")


def lambdarank_pairs(score, qb, gain, inv, weight, disc, sigmoid, max_docs,
                     block_queries=None):
    """LambdaRank (grad, hess), each (1, N) float32, of the score (1, N)
    over the queries `qb`. A CPU score takes the plain version (with
    `block_queries`); a CUDA score the kernel. `max_docs` must be the
    longest query's row count."""
    if score.device.type == "cpu":
        return lambdarank_grad_plain(score, qb, gain, inv, weight, disc,
                                     sigmoid, max_docs, block_queries)
    if score.device.type != "cuda":
        raise ValueError(f"lambdarank_pairs: unsupported device "
                         f"{score.device}")
    _check(score, qb, gain, inv, weight, disc, max_docs)
    if score.dtype != torch.float32:
        raise ValueError("lambdarank_pairs: score must be float32")
    tensors = [score, qb, gain, inv, disc] + ([weight] if weight is not None
                                              else [])
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("lambdarank_pairs: inputs must be contiguous")
    lib = _library()
    n = score.shape[1]
    grad = torch.empty((1, n), dtype=torch.float32, device=score.device)
    hess = torch.empty((1, n), dtype=torch.float32, device=score.device)
    scratch = (torch.empty((n, 4), dtype=torch.float32, device=score.device)
               if int(max_docs) > lib.rank_smem_docs() else None)
    lo, hi = clamp_bounds(sigmoid)
    status = lib.lambdarank_pairs(
        score.data_ptr(), qb.data_ptr(), qb.shape[0] - 1, gain.data_ptr(),
        inv.data_ptr(), None if weight is None else weight.data_ptr(),
        disc.data_ptr(), disc.shape[0], float(sigmoid), lo, hi,
        int(max_docs), None if scratch is None else scratch.data_ptr(),
        n, grad.data_ptr(), hess.data_ptr(),
        hist_kernels._stream(score.device))
    if status != 0:
        raise RuntimeError("lambdarank_pairs launch failed: "
                           f"{lib.rank_status_string(status).decode()}")
    hist_kernels._count("lambdarank_pairs")
    return grad, hess
