"""Model-quality accounting: the coefficient importance of linear-leaf
trees (lightgbm_tpu/telemetry/quality.py:64-90 tree_coeff_importance,
copied; the JAX module's split ledger and quality tracker belong to the
training telemetry, ROADMAP queue 1 item 7)."""

import numpy as np


def tree_coeff_importance(tree, num_features):
    """Per-feature coefficient importance of one tree's linear leaves
    (models/linear_leaves.py): for every linear leaf l and coefficient
    j, importance[feature(l, j)] += |coef[l, j]| * gain(parent(l)), the
    magnitude of the leaf model's use of the feature weighted by the
    gain of the split that carved the leaf out. Constant-leaf trees
    contribute an all-zero vector."""
    out = np.zeros(int(num_features), np.float64)
    if not tree.is_linear:
        return out
    gain = np.asarray(tree.split_gain, np.float64)
    for leaf in range(int(tree.num_leaves)):
        k = int(tree.leaf_coeff_count[leaf])
        if k == 0:
            continue
        parent = int(tree.leaf_parent[leaf])
        w = gain[parent] if parent >= 0 else 0.0
        np.add.at(out, tree.leaf_coeff_feat[leaf, :k],
                  np.abs(tree.leaf_coeff[leaf, :k]) * w)
    return out
