"""Piece-wise linear leaf models (linear_tree=true); port of
lightgbm_tpu/models/linear_leaves.py, host float64 numpy as there, so
the same inputs give equal arrays.

Shi et al. (arXiv:1802.05640): after the histogram split search fixes a
tree's STRUCTURE, refit each leaf as a small ridge model over the
features on the leaf's root->leaf path instead of a single constant.
The second-order boosting objective makes this a weighted least-squares
problem per leaf — with hessian weights w_i and gradients g_i the leaf
model beta minimizes

    sum_i w_i (x_i . beta)^2 + 2 g_i (x_i . beta) + lambda |beta_f|^2

whose normal equations are (X^T W X + lambda I_f) beta = -X^T W' g
(x_i carries a leading 1 for the intercept; the intercept dimension is
NOT regularized; W' applies the in-bag mask to the gradient side).

Precision contract: accumulation runs on HOST in float64, over a fixed
`fit_chunk`-aligned row grid combined in ascending order — the same
chunk-grid discipline the histogram fold uses for its serial==streamed
bit-parity contract — so the resident (serial) and block-streamed
(out-of-core) learners accumulate the IDENTICAL normal equations and
the whole frontier solves as ONE stacked np.linalg.solve. Training data
lives as bins; features enter the fit as their bin representative
values (Feature::BinToValue), the same quantization the split search
saw.

Fallback rules (each leaf independently; `is_linear[leaf]=False` keeps
the builder's constant Newton value):

- no path features (the root leaf of a 0-split tree);
- fewer in-bag rows than `len(features) + 2`;
- zero accumulated hessian mass;
- a singular or non-finite solve (e.g. linear_lambda=0 on a leaf whose
  feature slice is constant).
"""

import numpy as np

from ..utils.log import Log


def leaf_path_features(split_feature, left_child, right_child,
                       leaf_parent, num_leaves, max_features):
    """Per-leaf distinct split features on the root->leaf path.

    Root-first order, deduplicated, capped at `max_features` (the first
    N distinct features seen walking DOWN from the root). Feature ids
    stay in whatever space `split_feature` uses (inner indices during
    training). Returns a list of (k_leaf,) int32 arrays, one per leaf.
    """
    n_splits = int(num_leaves) - 1
    if n_splits <= 0:
        return [np.zeros(0, np.int32)]
    parent = np.full(n_splits, -1, np.int32)
    for node in range(n_splits):
        for child in (int(left_child[node]), int(right_child[node])):
            if child >= 0:
                parent[child] = node
    out = []
    for leaf in range(int(num_leaves)):
        path = []
        node = int(leaf_parent[leaf])
        while node >= 0:
            path.append(int(split_feature[node]))
            node = parent[node]
        path.reverse()
        seen, feats = set(), []
        for f in path:
            if f not in seen:
                seen.add(f)
                feats.append(f)
                if len(feats) >= int(max_features):
                    break
        out.append(np.asarray(feats, np.int32))
    return out


def _leaf_segments(row_leaf_chunk):
    """(leaf_id, local_row_indices) groups for one chunk, rows ascending
    within each group (stable sort on the leaf key)."""
    order = np.argsort(row_leaf_chunk, kind="stable")
    sorted_rl = row_leaf_chunk[order]
    uniq, starts = np.unique(sorted_rl, return_index=True)
    bounds = np.append(starts, len(order))
    return [(int(uniq[i]), order[bounds[i]:bounds[i + 1]])
            for i in range(len(uniq))]


def fit_linear_leaves(leaf_feats, leaf_value, leaf_count, bin_value_table,
                      row_leaf, grad, hess, inbag, chunks, fit_chunk,
                      linear_lambda):
    """Fit every eligible leaf of one tree's frontier; one stacked solve.

    leaf_feats: list of per-leaf (k,) inner-feature arrays
        (`leaf_path_features` output, already capped).
    leaf_value/leaf_count: the builder's UNSHRUNK constant values and
        in-bag row counts, (L,).
    bin_value_table: (F, max_bin) float64 bin representative values.
    row_leaf: (N,) host row->leaf partition; grad/hess: (N,) float32.
    inbag: (N,) float in-bag weights or None (all-ones).
    chunks: RE-ITERABLE of (lo, hi, bins, base) host blocks covering
        rows [lo, hi) in ascending contiguous order; `bins` is
        [feat_arr, row_arr]-indexable with rows given relative to
        `base`. Block boundaries must land on the `fit_chunk` grid
        (the block store guarantees block_rows % device_row_chunk == 0;
        the resident path is one block).
    fit_chunk: canonical accumulation grid (device_row_chunk) — both
        learner paths MUST pass the same value for bit-parity.

    Returns (leaf_const, leaf_coeffs, is_linear, train_values), all in
    UNSHRUNK value space: intercepts (L,) f64, per-leaf coefficient
    arrays (list of (k,) f64), the per-leaf linear mask, and the (N,)
    f64 per-row tree output (linear where fitted, the constant value
    elsewhere).
    """
    num_leaves = len(leaf_feats)
    leaf_value = np.asarray(leaf_value, np.float64)
    counts = np.asarray(leaf_count, np.int64)
    kmax = max((len(f) for f in leaf_feats), default=0)
    n = int(row_leaf.shape[0])
    fit_chunk = max(1, int(fit_chunk))

    coeffs = [np.zeros(0, np.float64) for _ in range(num_leaves)]
    is_linear = np.zeros(num_leaves, bool)
    const = leaf_value.copy()
    cand = np.asarray([
        len(leaf_feats[l]) > 0 and counts[l] >= len(leaf_feats[l]) + 2
        for l in range(num_leaves)])
    if kmax == 0 or not cand.any():
        return const, coeffs, is_linear, leaf_value[row_leaf]

    grad = np.asarray(grad, np.float64)
    hess = np.asarray(hess, np.float64)
    if inbag is None:
        weight, gw = hess, grad
    else:
        inbag = np.asarray(inbag, np.float64)
        weight, gw = hess * inbag, grad * inbag

    # ---- pass 1: f64 normal equations over the canonical chunk grid
    norm = np.zeros((num_leaves, kmax + 1, kmax + 1), np.float64)
    rhs = np.zeros((num_leaves, kmax + 1), np.float64)
    for lo, hi, bins, base in chunks:
        for c0 in range(int(lo), int(hi), fit_chunk):
            c1 = min(c0 + fit_chunk, int(hi))
            for leaf, local in _leaf_segments(row_leaf[c0:c1]):
                if leaf >= num_leaves or not cand[leaf]:
                    continue
                rows = local + c0
                feats = leaf_feats[leaf]
                k = len(feats)
                ids = np.asarray(bins[feats[:, None],
                                      (rows - base)[None, :]])
                xs = bin_value_table[feats[:, None], ids]      # (k, m)
                xa = np.concatenate(
                    [np.ones((1, xs.shape[1]), np.float64), xs], axis=0)
                norm[leaf, :k + 1, :k + 1] += (xa * weight[rows]) @ xa.T
                rhs[leaf, :k + 1] += xa @ (-gw[rows])

    # zero hessian mass (fully bagged-out leaf): nothing to fit
    cand &= norm[:, 0, 0] > 0.0

    # ---- one stacked solve across the frontier
    idx = np.nonzero(cand)[0]
    if len(idx):
        mats = norm[idx].copy()
        vecs = rhs[idx].copy()
        lam = float(linear_lambda)
        for j, leaf in enumerate(idx):
            k = len(leaf_feats[leaf])
            diag = np.arange(1, k + 1)
            mats[j, diag, diag] += lam
            pad = np.arange(k + 1, kmax + 1)
            mats[j, pad, pad] = 1.0
        try:
            betas = np.linalg.solve(mats, vecs[..., None])[..., 0]
        except np.linalg.LinAlgError:
            # a singular leaf poisons the batched call: re-solve leaf
            # by leaf so only the degenerate ones fall back
            betas = np.full((len(idx), kmax + 1), np.nan)
            for j in range(len(idx)):
                try:
                    betas[j] = np.linalg.solve(mats[j], vecs[j])
                except np.linalg.LinAlgError:
                    pass
        for j, leaf in enumerate(idx):
            k = len(leaf_feats[leaf])
            beta = betas[j, :k + 1]
            if np.all(np.isfinite(beta)):
                const[leaf] = beta[0]
                coeffs[leaf] = beta[1:].copy()
                is_linear[leaf] = True

    if not is_linear.any():
        return const, coeffs, is_linear, leaf_value[row_leaf]

    # ---- pass 2: per-row tree output (chunk layout is free here — a
    # per-row dot over k terms reduces identically however rows batch)
    values = np.empty(n, np.float64)
    for lo, hi, bins, base in chunks:
        rl = row_leaf[int(lo):int(hi)]
        vals = leaf_value[rl]
        for leaf, local in _leaf_segments(rl):
            if leaf >= num_leaves or not is_linear[leaf]:
                continue
            rows = local + int(lo)
            feats = leaf_feats[leaf]
            ids = np.asarray(bins[feats[:, None], (rows - base)[None, :]])
            xs = bin_value_table[feats[:, None], ids]
            vals[local] = const[leaf] + coeffs[leaf] @ xs
        values[int(lo):int(hi)] = vals
    n_fit = int(is_linear.sum())
    Log.debug("linear leaves: fitted %d/%d leaves (kmax=%d)",
              n_fit, num_leaves, kmax)
    return const, coeffs, is_linear, values
