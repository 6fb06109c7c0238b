"""Tree model: flat-array binary tree + text serialization.

Copy of lightgbm_tpu/models/tree.py, numpy on the host: the model text
both packages read and write must stay byte-identical. Reads and writes
format versions 1 and 2 (linear-leaf coefficient blocks).

Reference: include/LightGBM/tree.h:18-198, src/io/tree.cpp:24-231.
Leaves are encoded as `~leaf_index` (negative) in the child arrays.
The device builder (models/tree_learner.py) materializes a whole tree's
arrays at once; this class wraps them for serialization and host-side
prediction.
"""

import numpy as np

from ..utils import common
from ..utils.log import Log


def linear_leaf_values(x, const, coef, feat, cnt, fallback):
    """Linear-leaf outputs on raw feature values; host f64. x is (N, F);
    const, cnt and fallback (N, ...) and coef, feat (N, ..., C) are the
    leaf models gathered at each row's leaves (one tree: (N,); a
    stacked forest: (N, T)). A row whose leaf model touches a NaN
    feature falls back to the leaf's constant value (a missing value
    has no coordinate to enter the dot product).

    The slots are added left to right (not np.sum): np.sum's pairwise
    association depends on the axis LENGTH, so a COEF_PAD-padded copy
    would round differently. In a chain, trailing zero slots are exact
    no-ops, so a tree's own width and the serving predictor's padded
    blocks give the same bits."""
    rows = np.arange(x.shape[0]).reshape((-1,) + (1,) * (feat.ndim - 1))
    xf = x[rows, feat]                                   # (N, ..., C)
    valid = np.arange(coef.shape[-1]) < cnt[..., None]
    live = valid & ~np.isnan(xf)
    lin = np.array(const, dtype=np.float64)
    for j in range(coef.shape[-1]):
        lin += np.where(live[..., j], coef[..., j] * xf[..., j], 0.0)
    return np.where((cnt > 0) & ~np.any(valid & np.isnan(xf), axis=-1),
                    lin, fallback)


class Tree:
    NUMERICAL = 0
    CATEGORICAL = 1

    def __init__(self, num_leaves=1):
        n = max(int(num_leaves), 1)
        self.num_leaves = n
        self.split_feature = np.zeros(max(n - 1, 0), dtype=np.int32)       # inner idx
        self.split_feature_real = np.zeros(max(n - 1, 0), dtype=np.int32)  # column idx
        self.threshold_in_bin = np.zeros(max(n - 1, 0), dtype=np.int32)
        self.threshold = np.zeros(max(n - 1, 0), dtype=np.float64)
        self.decision_type = np.zeros(max(n - 1, 0), dtype=np.int8)
        self.split_gain = np.zeros(max(n - 1, 0), dtype=np.float64)
        self.left_child = np.zeros(max(n - 1, 0), dtype=np.int32)
        self.right_child = np.zeros(max(n - 1, 0), dtype=np.int32)
        self.leaf_parent = np.full(n, -1, dtype=np.int32)
        self.leaf_value = np.zeros(n, dtype=np.float64)
        self.leaf_count = np.zeros(n, dtype=np.int32)
        self.internal_value = np.zeros(max(n - 1, 0), dtype=np.float64)
        self.internal_count = np.zeros(max(n - 1, 0), dtype=np.int32)
        # piece-wise linear leaves (models/linear_leaves.py, format
        # version 2): per-leaf ridge models over the leaf's path
        # features. `leaf_value` keeps the constant Newton fit — it is
        # the prediction for non-linear leaves AND the fallback for
        # rows with missing values in a linear leaf's feature slice.
        self.is_linear = False
        self.leaf_coeff_count = None    # (L,) int32
        self.leaf_const = None          # (L,) float64 intercepts
        self.leaf_coeff = None          # (L, C) float64, zero-padded
        self.leaf_coeff_feat = None     # (L, C) int32 real column idx
        self.leaf_coeff_feat_inner = None  # (L, C) int32 inner idx

    # ------------------------------------------------------------- training
    def shrinkage(self, rate):
        """Scale leaf outputs by the learning rate (tree.h:103-107).
        A linear leaf's output is linear in its coefficients, so the
        whole model block scales too (DART's drop/normalize relies on
        shrinkage being exactly multiplicative)."""
        self.leaf_value *= rate
        if self.is_linear:
            self.leaf_const *= rate
            self.leaf_coeff *= rate

    def set_linear(self, const, coeffs, is_linear, feats_inner,
                   real_feature_idx=None):
        """Attach per-leaf linear models (UN-scaled; call before
        shrinkage). coeffs/feats_inner are per-leaf ragged lists;
        leaves with is_linear False keep count 0 and predict their
        constant `leaf_value`. real_feature_idx maps inner -> column
        ids (None = identity, e.g. for loaded models)."""
        n = self.num_leaves
        width = max([len(c) for c in coeffs] + [1])
        self.leaf_coeff_count = np.zeros(n, np.int32)
        self.leaf_const = np.asarray(const, np.float64).copy()
        self.leaf_coeff = np.zeros((n, width), np.float64)
        self.leaf_coeff_feat = np.zeros((n, width), np.int32)
        self.leaf_coeff_feat_inner = np.zeros((n, width), np.int32)
        for leaf in range(n):
            if not is_linear[leaf]:
                continue
            k = len(coeffs[leaf])
            self.leaf_coeff_count[leaf] = k
            self.leaf_coeff[leaf, :k] = coeffs[leaf]
            inner = np.asarray(feats_inner[leaf], np.int32)
            self.leaf_coeff_feat_inner[leaf, :k] = inner
            self.leaf_coeff_feat[leaf, :k] = (
                inner if real_feature_idx is None
                else np.asarray(real_feature_idx)[inner].astype(np.int32))
        self.is_linear = bool(np.any(np.asarray(is_linear)))

    @property
    def max_depth(self):
        """Longest root->leaf path (for bounding vectorized traversal)."""
        if self.num_leaves <= 1:
            return 0
        depth = np.zeros(self.num_leaves - 1, dtype=np.int32)
        best = 1
        for node in range(self.num_leaves - 1):
            d = depth[node]
            for child in (self.left_child[node], self.right_child[node]):
                if child >= 0:
                    depth[child] = d + 1
                    best = max(best, d + 2)
                else:
                    best = max(best, d + 1)
        return best

    # ----------------------------------------------------------- prediction
    def get_leaf(self, x):
        """Vectorized leaf lookup on raw feature values.

        x: (N, num_total_features) float array. Returns (N,) leaf indices.
        Equivalent to tree.h:226-238 per row.
        """
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)
        active = node >= 0
        for _ in range(self.max_depth + 1):
            if not active.any():
                break
            nd = node[active]
            feat = self.split_feature_real[nd]
            thr = self.threshold[nd]
            dt = self.decision_type[nd]
            fval = x[active, feat]
            # NaN routes RIGHT everywhere: numeric via `<=` being False,
            # categorical explicitly (a missing value is not a category
            # id — without the isnan mask the nan_to_num cast would
            # silently match category 0)
            go_left = np.where(dt == self.CATEGORICAL,
                               (np.nan_to_num(fval).astype(np.int64)
                                == thr.astype(np.int64)) & ~np.isnan(fval),
                               fval <= thr)
            nxt = np.where(go_left, self.left_child[nd], self.right_child[nd])
            node[active] = nxt
            active = node >= 0
        return (~node).astype(np.int32)

    def predict(self, x):
        leaf = self.get_leaf(x)
        base = self.leaf_value[leaf]
        if not self.is_linear:
            return base
        return self._linear_values(np.asarray(x, np.float64), leaf, base)

    def _linear_values(self, x, leaf, fallback):
        """Per-row linear-leaf outputs on raw feature values; host f64
        (linear_leaf_values at each row's leaf)."""
        return linear_leaf_values(
            x, self.leaf_const[leaf], self.leaf_coeff[leaf],
            self.leaf_coeff_feat[leaf], self.leaf_coeff_count[leaf],
            fallback)

    def get_leaf_by_bins(self, bins):
        """Leaf lookup on a binned (F, N) matrix in the virtual feature
        space (CoreDataset.traversal_bins(); tree.h:211-224)."""
        n = bins.shape[1]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)
        active = node >= 0
        for _ in range(self.max_depth + 1):
            if not active.any():
                break
            nd = node[active]
            feat = self.split_feature[nd]
            thr = self.threshold_in_bin[nd]
            dt = self.decision_type[nd]
            fval = bins[feat, np.nonzero(active)[0]].astype(np.int64)
            go_left = np.where(dt == self.CATEGORICAL, fval == thr,
                               fval <= thr)
            node[active] = np.where(go_left, self.left_child[nd],
                                    self.right_child[nd])
            active = node >= 0
        return (~node).astype(np.int32)

    def predict_by_bins(self, bins, bin_values=None):
        """Per-row f64 outputs on a binned (F, N) matrix. Linear leaves
        need `bin_values`, the dataset's (F, max_bin) f64 bin
        representative table (CoreDataset.bin_value_table()): a dot
        product needs values, not bin ids. Feature ids here are inner
        indices (leaf_coeff_feat_inner), as split_feature's are."""
        leaf = self.get_leaf_by_bins(bins)
        base = self.leaf_value[leaf]
        if not self.is_linear:
            return base
        if bin_values is None:
            Log.fatal("scoring a linear tree in bin space needs the "
                      "dataset's bin_value_table")
        cnt = self.leaf_coeff_count[leaf]                     # (N,)
        feats = self.leaf_coeff_feat_inner[leaf]              # (N, C)
        coef = self.leaf_coeff[leaf]                          # (N, C)
        rows = np.arange(leaf.shape[0])
        ids = np.asarray(bins[feats, rows[:, None]])          # (N, C)
        xf = bin_values[feats, ids]
        valid = np.arange(coef.shape[1])[None, :] < cnt[:, None]
        lin = self.leaf_const[leaf] + np.sum(
            np.where(valid, coef * xf, 0.0), axis=1)
        return np.where(cnt > 0, lin, base)

    # -------------------------------------------------------- serialization
    def to_string(self):
        """Text block (tree.cpp ToString)."""
        n = self.num_leaves
        lines = [
            f"num_leaves={n}",
            "split_feature=" + common.array_to_string(self.split_feature_real[:n - 1]),
            "split_gain=" + common.array_to_string(self.split_gain[:n - 1].astype(np.float64)),
            "threshold=" + common.array_to_string(self.threshold[:n - 1].astype(np.float64)),
            "decision_type=" + common.array_to_string(self.decision_type[:n - 1]),
            "left_child=" + common.array_to_string(self.left_child[:n - 1]),
            "right_child=" + common.array_to_string(self.right_child[:n - 1]),
            "leaf_parent=" + common.array_to_string(self.leaf_parent[:n]),
            "leaf_value=" + common.array_to_string(self.leaf_value[:n].astype(np.float64)),
            "leaf_count=" + common.array_to_string(self.leaf_count[:n]),
            "internal_value=" + common.array_to_string(self.internal_value[:n - 1].astype(np.float64)),
            "internal_count=" + common.array_to_string(self.internal_count[:n - 1]),
        ]
        if self.is_linear:
            # format version 2 coefficient block (docs/Linear-Trees.md):
            # ragged per-leaf models flattened in leaf order; repr-
            # precision doubles make save->load bit-exact like
            # leaf_value above
            flat_feat, flat_coef = [], []
            for leaf in range(n):
                k = int(self.leaf_coeff_count[leaf])
                flat_feat.extend(int(v) for v in self.leaf_coeff_feat[leaf, :k])
                flat_coef.extend(float(v) for v in self.leaf_coeff[leaf, :k])
            lines.append("is_linear=1")
            lines.append("leaf_const=" + common.array_to_string(
                self.leaf_const[:n].astype(np.float64)))
            lines.append("num_leaf_coeff=" + common.array_to_string(
                self.leaf_coeff_count[:n]))
            lines.append("leaf_coeff_feature=" + common.array_to_string(
                np.asarray(flat_feat, np.int32)))
            lines.append("leaf_coeff=" + common.array_to_string(
                np.asarray(flat_coef, np.float64)))
        return "\n".join(lines) + "\n"

    REQUIRED_KEYS = ("num_leaves", "split_feature", "split_gain", "threshold",
                     "left_child", "right_child", "leaf_parent", "leaf_value",
                     "internal_value", "internal_count", "leaf_count",
                     "decision_type")
    LINEAR_KEYS = ("is_linear", "leaf_const", "num_leaf_coeff",
                   "leaf_coeff_feature", "leaf_coeff")

    @classmethod
    def from_string(cls, s, format_version=1):
        """Parse a `Tree=i` block (tree.cpp:192-230).

        Forward-compat contract: an unknown key is a hard error — a
        newer writer's section must never be silently dropped (the
        model would load and mis-predict). Coefficient blocks are only
        legal when the file header declared format_version >= 2."""
        kv = {}
        for line in s.split("\n"):
            parts = line.split("=", 1)
            if len(parts) == 2 and parts[0].strip() and parts[1].strip():
                kv[parts[0].strip()] = parts[1].strip()
        required = cls.REQUIRED_KEYS
        for key in required:
            if key not in kv:
                Log.fatal("Tree model string format error: missing %s", key)
        for key in kv:
            if key not in required and key not in cls.LINEAR_KEYS:
                Log.fatal("Tree model string format error: unknown section "
                          "%r — this model was written by a newer format "
                          "version than this reader supports", key)
            if key in cls.LINEAR_KEYS and format_version < 2:
                Log.fatal("Tree model string format error: coefficient "
                          "section %r requires format_version>=2 but the "
                          "model header declares version %d", key,
                          format_version)
        n = int(kv["num_leaves"])
        t = cls(n)
        if n > 1:
            t.left_child = common.string_to_array(kv["left_child"], int)
            t.right_child = common.string_to_array(kv["right_child"], int)
            t.split_feature_real = common.string_to_array(kv["split_feature"], int)
            t.split_feature = t.split_feature_real.copy()  # inner map unknown after load
            t.threshold = common.string_to_array(kv["threshold"], float)
            t.split_gain = common.string_to_array(kv["split_gain"], float)
            t.internal_count = common.string_to_array(kv["internal_count"], int)
            t.internal_value = common.string_to_array(kv["internal_value"], float)
            t.decision_type = common.string_to_array(kv["decision_type"], int).astype(np.int8)
        t.leaf_count = common.string_to_array(kv["leaf_count"], int)
        t.leaf_parent = common.string_to_array(kv["leaf_parent"], int)
        t.leaf_value = common.string_to_array(kv["leaf_value"], float)
        if kv.get("is_linear") == "1":
            counts = common.string_to_array(kv["num_leaf_coeff"], int)
            if len(counts) != n:
                Log.fatal("Tree model string format error: num_leaf_coeff "
                          "has %d entries for %d leaves", len(counts), n)
            flat_feat = (common.string_to_array(kv["leaf_coeff_feature"], int)
                         if "leaf_coeff_feature" in kv
                         else np.zeros(0, np.int32))
            flat_coef = (common.string_to_array(kv["leaf_coeff"], float)
                         if "leaf_coeff" in kv else np.zeros(0, np.float64))
            total = int(counts.sum())
            if len(flat_feat) != total or len(flat_coef) != total:
                Log.fatal("Tree model string format error: coefficient "
                          "block length mismatch (%d features, %d coeffs, "
                          "counts sum %d)", len(flat_feat), len(flat_coef),
                          total)
            const = common.string_to_array(kv["leaf_const"], float)
            offs = np.concatenate([[0], np.cumsum(counts)])
            coeffs = [flat_coef[offs[i]:offs[i + 1]] for i in range(n)]
            feats = [flat_feat[offs[i]:offs[i + 1]] for i in range(n)]
            # inner map unknown after load (same convention as
            # split_feature above): inner ids default to column ids
            t.set_linear(const, coeffs, counts > 0, feats)
        return t

    def to_json(self):
        out = [f'"num_leaves":{self.num_leaves},']
        out.append(f'"tree_structure":{self._node_to_json(0 if self.num_leaves > 1 else ~0)}')
        return "\n".join(out) + "\n"

    def _node_to_json(self, index):
        if index >= 0 and self.num_leaves > 1:
            dt = "no_greater" if self.decision_type[index] == 0 else "is"
            return (
                "{\n"
                f'"split_index":{index},\n'
                f'"split_feature":{int(self.split_feature_real[index])},\n'
                f'"split_gain":{self.split_gain[index]:g},\n'
                f'"threshold":{self.threshold[index]:g},\n'
                f'"decision_type":"{dt}",\n'
                f'"internal_value":{self.internal_value[index]:g},\n'
                f'"internal_count":{int(self.internal_count[index])},\n'
                f'"left_child":{self._node_to_json(self.left_child[index])},\n'
                f'"right_child":{self._node_to_json(self.right_child[index])}\n'
                "}"
            )
        index = ~index if index < 0 else index
        linear = ""
        if self.is_linear and self.leaf_coeff_count[index] > 0:
            k = int(self.leaf_coeff_count[index])
            coefs = ",".join(f"{v:g}" for v in self.leaf_coeff[index, :k])
            feats = ",".join(str(int(v))
                             for v in self.leaf_coeff_feat[index, :k])
            linear = (f',\n"leaf_const":{self.leaf_const[index]:g},\n'
                      f'"leaf_coeff":[{coefs}],\n'
                      f'"leaf_coeff_feature":[{feats}]')
        return (
            "{\n"
            f'"leaf_index":{index},\n'
            f'"leaf_parent":{int(self.leaf_parent[index])},\n'
            f'"leaf_value":{self.leaf_value[index]:g},\n'
            f'"leaf_count":{int(self.leaf_count[index])}'
            f"{linear}\n"
            "}"
        )
