"""Best-split search: vectorized cumulative scan over (feature, bin).

Port of lightgbm_tpu/ops/split.py:60-209 to PyTorch tensors.
Reference: src/treelearner/feature_histogram.hpp:116-246 (right-to-left
threshold scan with min_data / min_sum_hessian / min_gain constraints)
and :290-313 (L1/L2-regularized gain and leaf-output formulas).

Every (feature, threshold) candidate is evaluated at once with a
reversed cumulative sum; constraints become masks; the argmax keeps the
reference's tie-breaks: among equal gains the LARGEST threshold wins
within a feature, and the SMALLEST feature id wins across features
(torch.argmax, like jnp.argmax, returns the first maximal index).

The functions accept any number of leading batch dimensions on `hist`
(..., F, B, 3) and on the scalar leaf totals (...): the builder scans
both children of a split in one call. Arithmetic is float32 throughout,
as in the JAX package; Python floats (the SplitParams) stay weak
scalars, so they never promote a tensor to float64.

Epsilon conventions replicated from the reference:
  - parent sum_hessians gets +2*kEpsilon (feature_histogram.hpp:59)
  - the right-side hessian accumulator starts at kEpsilon (:123)
  - categorical uses the raw per-bin hessian for the "current" side (:197)
"""

from typing import NamedTuple

import torch

from .reduce_order import ordered_cumsum

K_EPSILON = 1e-15
K_MIN_SCORE = float("-inf")


class SplitParams(NamedTuple):
    """Static split constraints (TreeConfig, config.h:166-186)."""
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    lambda_l1: float
    lambda_l2: float
    min_gain_to_split: float


class SplitInfo(NamedTuple):
    """Best split of one leaf (src/treelearner/split_info.hpp:17-104);
    each field is a tensor of the batch shape."""
    gain: torch.Tensor
    feature: torch.Tensor
    threshold: torch.Tensor
    left_sum_gradient: torch.Tensor
    left_sum_hessian: torch.Tensor
    left_count: torch.Tensor
    right_sum_gradient: torch.Tensor
    right_sum_hessian: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def _threshold_l1(s, l1):
    return torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_split_gain(sum_g, sum_h, l1, l2):
    """GetLeafSplitGain (feature_histogram.hpp:290-298)."""
    reg = _threshold_l1(sum_g, l1)
    return torch.where(reg > 0.0, reg * reg / (sum_h + l2),
                       torch.zeros_like(reg))


def leaf_output(sum_g, sum_h, l1, l2):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:306-313)."""
    reg = _threshold_l1(sum_g, l1)
    return torch.where(reg > 0.0, -torch.sign(sum_g) * reg / (sum_h + l2),
                       torch.zeros_like(reg))


def _rcum(x):
    """rcum[..., j] = sum_{b >= j} x[..., b] (float32; on the CPU in the
    JAX package's order, ops/reduce_order.py)."""
    return torch.flip(ordered_cumsum(torch.flip(x, [-1])), [-1])


def per_feature_best(hist, sum_g, sum_h, num_data,
                     num_bin_per_feature, is_categorical, feature_mask,
                     params: SplitParams):
    """Best (gain, threshold) of every feature for one leaf (or a batch).

    Args:
      hist: (..., F, B, 3) float32 — per (feature, bin) [grad, hess, count].
      sum_g, sum_h, num_data: (...) leaf totals (in-bag).
      num_bin_per_feature: (F,) int32 (unused by the scan, kept for the
        reference signature).
      is_categorical: (F,) bool.
      feature_mask: (F,) bool — feature_fraction sampling for this tree.
      params: SplitParams.

    Returns (best_gain_f, best_t): two (..., F) tensors.
    """
    b = hist.shape[-2]
    g = hist[..., 0]
    h = hist[..., 1]
    c = hist[..., 2]
    sum_g = sum_g[..., None, None]
    num_data = num_data[..., None, None]
    sum_h_eps = sum_h[..., None, None] + 2.0 * K_EPSILON
    gain_shift = leaf_split_gain(sum_g, sum_h_eps, params.lambda_l1,
                                 params.lambda_l2)
    min_gain_shift = gain_shift + params.min_gain_to_split
    neg_inf = torch.full_like(g, K_MIN_SCORE)

    # ---------------- numerical: thresholds t in [0, B-2], left = bin <= t
    right_g = _rcum(g)[..., 1:]
    right_h = _rcum(h)[..., 1:] + K_EPSILON           # accumulator seed
    right_c = _rcum(c)[..., 1:]
    left_c = num_data - right_c
    left_h = sum_h_eps - right_h
    left_g = sum_g - right_g

    num_valid = ((right_c >= params.min_data_in_leaf)
                 & (left_c >= params.min_data_in_leaf)
                 & (right_h >= params.min_sum_hessian_in_leaf)
                 & (left_h >= params.min_sum_hessian_in_leaf))
    num_gain = (leaf_split_gain(left_g, left_h, params.lambda_l1,
                                params.lambda_l2)
                + leaf_split_gain(right_g, right_h, params.lambda_l1,
                                  params.lambda_l2))
    num_valid &= num_gain >= min_gain_shift
    num_score = torch.where(num_valid, num_gain, neg_inf[..., 1:])

    # tie-break: largest threshold -> argmax over the reversed axis
    t_rev = torch.argmax(torch.flip(num_score, [-1]), dim=-1)
    num_best_t = (b - 2) - t_rev
    num_best_gain = torch.gather(num_score, -1, num_best_t[..., None])[..., 0]

    # ---------------- categorical: one-vs-rest on bin t (hpp:187-246)
    oth_c = num_data - c
    oth_h = sum_h_eps - h
    oth_g = sum_g - g
    cat_valid = ((c >= params.min_data_in_leaf)
                 & (oth_c >= params.min_data_in_leaf)
                 & (h >= params.min_sum_hessian_in_leaf)
                 & (oth_h >= params.min_sum_hessian_in_leaf))
    cat_gain = (leaf_split_gain(g, h, params.lambda_l1, params.lambda_l2)
                + leaf_split_gain(oth_g, oth_h, params.lambda_l1,
                                  params.lambda_l2))
    cat_valid &= cat_gain >= min_gain_shift
    cat_score = torch.where(cat_valid, cat_gain, neg_inf)
    cat_best_t = (b - 1) - torch.argmax(torch.flip(cat_score, [-1]), dim=-1)
    cat_best_gain = torch.gather(cat_score, -1, cat_best_t[..., None])[..., 0]

    # ---------------- merge numerical/categorical per feature
    best_t = torch.where(is_categorical, cat_best_t, num_best_t).to(torch.int32)
    best_gain_f = torch.where(is_categorical, cat_best_gain, num_best_gain)
    best_gain_f = torch.where(feature_mask, best_gain_f,
                              torch.full_like(best_gain_f, K_MIN_SCORE))
    return best_gain_f, best_t


def find_best_split(hist, sum_g, sum_h, num_data,
                    num_bin_per_feature, is_categorical, feature_mask,
                    params: SplitParams) -> SplitInfo:
    """Best split over all features of one leaf (see per_feature_best)."""
    best_gain_f, best_t = per_feature_best(
        hist, sum_g, sum_h, num_data, num_bin_per_feature, is_categorical,
        feature_mask, params)
    # across features: first max = smallest feature id
    best_f = torch.argmax(best_gain_f, dim=-1)
    thr = torch.gather(best_t, -1, best_f[..., None])[..., 0]
    gain = torch.gather(best_gain_f, -1, best_f[..., None])[..., 0]
    return split_info_at(hist, sum_g, sum_h, num_data, is_categorical,
                         params, best_f.to(torch.int32), thr, gain)


def _at(x, f, t):
    """x[..., f, t] for batched index tensors f, t of shape (...)."""
    row = torch.gather(x, -2, f.long()[..., None, None].expand(
        *f.shape, 1, x.shape[-1]))[..., 0, :]
    return torch.gather(row, -1, t.long()[..., None])[..., 0]


def split_info_at(hist, sum_g, sum_h, num_data, is_categorical, params,
                  best_f, best_thr, best_gain) -> SplitInfo:
    """Reconstruct the full SplitInfo of a chosen (feature, threshold)."""
    g = hist[..., 0]
    h = hist[..., 1]
    c = hist[..., 2]
    sum_h_eps = sum_h + 2.0 * K_EPSILON
    gain_shift = leaf_split_gain(sum_g, sum_h_eps, params.lambda_l1,
                                 params.lambda_l2)
    b = hist.shape[-2]
    is_cat = is_categorical.index_select(
        0, best_f.long().reshape(-1)).reshape(best_f.shape)
    # numerical left/right at (best_f, best_thr)
    thr_next = torch.clamp(best_thr + 1, max=b - 1)
    n_right_g = _at(_rcum(g), best_f, thr_next)
    n_right_h = _at(_rcum(h), best_f, thr_next) + K_EPSILON
    n_right_c = _at(_rcum(c), best_f, thr_next)
    n_left_g = sum_g - n_right_g
    n_left_h = sum_h_eps - n_right_h
    n_left_c = num_data - n_right_c
    # categorical: left = the chosen bin, right = rest
    c_left_g = _at(g, best_f, best_thr)
    c_left_h = _at(h, best_f, best_thr)
    c_left_c = _at(c, best_f, best_thr)
    c_right_g = sum_g - c_left_g
    c_right_h = sum_h_eps - c_left_h
    c_right_c = num_data - c_left_c

    lg = torch.where(is_cat, c_left_g, n_left_g)
    lh = torch.where(is_cat, c_left_h, n_left_h)
    lc = torch.where(is_cat, c_left_c, n_left_c)
    rg = torch.where(is_cat, c_right_g, n_right_g)
    rh = torch.where(is_cat, c_right_h, n_right_h)
    rc = torch.where(is_cat, c_right_c, n_right_c)

    lout = leaf_output(lg, lh, params.lambda_l1, params.lambda_l2)
    rout = leaf_output(rg, rh, params.lambda_l1, params.lambda_l2)

    found = best_gain > K_MIN_SCORE
    out_gain = torch.where(found, best_gain - gain_shift,
                           torch.full_like(best_gain, K_MIN_SCORE))
    return SplitInfo(
        gain=out_gain, feature=best_f, threshold=best_thr,
        left_sum_gradient=lg, left_sum_hessian=lh, left_count=lc,
        right_sum_gradient=rg, right_sum_hessian=rh, right_count=rc,
        left_output=lout, right_output=rout)
