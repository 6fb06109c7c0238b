"""Model-quality ledger: per-tree split records and feature importance
(the port of lightgbm_tpu/telemetry/quality.py).

Every learner path of the port materializes plain `Tree` objects
carrying (split_feature_real, split_gain, threshold, decision_type,
internal_count, leaf_count, leaf_value), so a ledger derived from the
model list is identical across engines by construction.

- `tree_coeff_importance`: the "coeff" importance of linear-leaf trees
  (the booster's `feature_importance_values("coeff")`);
- the `quality_telemetry` knob attaches a `QualityTracker` to the
  booster, which consumes newly appended trees at every iteration or
  block boundary and journals one `quality` record (splits and gain
  deltas, top features by gain, the new trees' leaf-value
  distribution, importance drift) next to the run's iteration records.

numpy only.
"""

import threading

import numpy as np

IMPORTANCE_TYPES = ("split", "gain", "coeff")


def _materialize(tree):
    """A tree-like object with `materialize()` (the JAX package's
    LazyTree) or a Tree -> Tree."""
    return tree.materialize() if hasattr(tree, "materialize") else tree


def tree_split_records(tree):
    """One tree's per-split ledger rows as a dict of aligned arrays:
    feature (real column idx), gain, threshold (real-valued),
    decision_type (0 numerical / 1 categorical), count (rows through
    the split node), left/right child. Missing values route RIGHT on
    every node in this build (reference default-direction semantics),
    so the default direction is a constant, not a per-split field."""
    tree = _materialize(tree)
    ns = max(int(tree.num_leaves) - 1, 0)
    return {
        "feature": np.asarray(tree.split_feature_real[:ns], np.int64),
        "gain": np.asarray(tree.split_gain[:ns], np.float64),
        "threshold": np.asarray(tree.threshold[:ns], np.float64),
        "decision_type": np.asarray(tree.decision_type[:ns], np.int64),
        "count": np.asarray(tree.internal_count[:ns], np.int64),
        "left_child": np.asarray(tree.left_child[:ns], np.int64),
        "right_child": np.asarray(tree.right_child[:ns], np.int64),
    }


def tree_coeff_importance(tree, num_features):
    """Per-feature coefficient importance of one tree's linear leaves
    (models/linear_leaves.py): for every linear leaf l and coefficient
    j, importance[feature(l, j)] += |coef[l, j]| * gain(parent(l)) —
    the magnitude of the leaf model's use of the feature, weighted by
    the gain of the split that carved the leaf out, so coefficients in
    high-signal regions count more than equal-magnitude ones in noise
    leaves. Derived from the materialized Tree's arrays only, so it is
    bit-identical across engines by the same contract as split/gain.
    Constant-leaf trees contribute an all-zero vector."""
    out = np.zeros(int(num_features), np.float64)
    tree = _materialize(tree)
    if not getattr(tree, "is_linear", False):
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


class SplitLedger:
    """Per-feature split/gain/coeff accumulator with reference
    semantics: `split` importance counts how many splits used the
    feature, `gain` sums split_gain over them, `coeff` sums gain-
    weighted linear-leaf coefficient magnitudes (tree_coeff_importance).
    add_tree() is pure numpy over one tree's flat arrays —
    O(num_leaves) per tree."""

    def __init__(self, num_features):
        self.num_features = int(num_features)
        self.split_counts = np.zeros(self.num_features, np.int64)
        self.gain_sums = np.zeros(self.num_features, np.float64)
        self.coeff_sums = np.zeros(self.num_features, np.float64)
        self.n_trees = 0
        self.n_splits = 0

    def add_tree(self, tree):
        rec = tree_split_records(tree)
        feat = rec["feature"]
        if len(feat):
            np.add.at(self.split_counts, feat, 1)
            np.add.at(self.gain_sums, feat, rec["gain"])
        if getattr(tree, "is_linear", False):
            self.coeff_sums += tree_coeff_importance(tree,
                                                     self.num_features)
        self.n_trees += 1
        self.n_splits += len(feat)
        return rec

    def importance(self, importance_type="split"):
        if importance_type == "split":
            return self.split_counts.copy()
        if importance_type == "gain":
            return self.gain_sums.copy()
        if importance_type == "coeff":
            return self.coeff_sums.copy()
        raise ValueError(
            f"Unknown importance type {importance_type!r} "
            f"(expected one of {IMPORTANCE_TYPES})")


def feature_importance_from_models(models, num_features,
                                   importance_type="split"):
    """Reference-semantics importance vector over a model list (any
    mix of Tree/LazyTree): int64 split counts or float64 gain sums,
    length `num_features` (total feature space)."""
    ledger = SplitLedger(num_features)
    for tree in models:
        ledger.add_tree(tree)
    return ledger.importance(importance_type)


def _normalized(vec):
    total = float(vec.sum())
    return vec / total if total > 0 else np.zeros_like(vec, np.float64)


class QualityTracker:
    """Incremental quality telemetry over a booster's model list.

    `sync(models)` consumes trees appended since the last call and
    returns one journal-ready delta dict (None when nothing changed).
    A shrunk list (rollback / early-stop truncation) rebuilds the
    ledger from scratch — rare, and O(total trees). The tracker also
    keeps the previous normalized gain-importance vector so each sync
    reports `importance_shift`: the L1 distance between consecutive
    normalized importance vectors, the "is the model still learning
    the same features" drift signal."""

    TOP_K = 5

    def __init__(self, num_features, feature_names=()):
        self.num_features = int(num_features)
        self.feature_names = list(feature_names)
        self.ledger = SplitLedger(self.num_features)
        self._n_seen = 0
        self._version_seen = None
        self._prev_norm = np.zeros(self.num_features, np.float64)
        # sync() runs on the training thread while snapshot() serves
        # /trainz scrapes from HTTP threads — guard against torn reads
        self._lock = threading.Lock()

    def _name(self, idx):
        if idx < len(self.feature_names) and self.feature_names[idx]:
            return str(self.feature_names[idx])
        return f"Column_{idx}"

    def sync(self, models):
        with self._lock:
            return self._sync_locked(models)

    def _sync_locked(self, models):
        version = getattr(models, "version", None)
        if (len(models) < self._n_seen
                or (len(models) == self._n_seen
                    and version != self._version_seen)):
            # rollback / truncation dropped trees (possibly already
            # retrained back to the SAME length — the _VersionedList
            # mutation counter catches that): rebuild the ledger
            # against the surviving list SILENTLY (no delta — the
            # dropped trees' deltas were already journaled, and the
            # timeline shows the truncate event next to them; totals
            # and gauges snap to the surviving model)
            ledger = SplitLedger(self.num_features)
            for tree in models:
                ledger.add_tree(tree)
            self.ledger = ledger
            self._n_seen = len(models)
            self._version_seen = version
            self._prev_norm = _normalized(self.ledger.gain_sums)
            return None
        if len(models) == self._n_seen:
            return None
        gain_before = self.ledger.gain_sums.copy()
        splits_before = self.ledger.n_splits
        leaf_vals = []
        new_trees = 0
        for idx in range(self._n_seen, len(models)):
            self.ledger.add_tree(models[idx])
            tree = _materialize(models[idx])
            leaf_vals.append(
                np.asarray(tree.leaf_value[:tree.num_leaves], np.float64))
            new_trees += 1
        self._n_seen = len(models)
        self._version_seen = version
        gain_delta = self.ledger.gain_sums - gain_before
        order = np.argsort(-gain_delta)[:self.TOP_K]
        top_gain = {self._name(int(i)): round(float(gain_delta[i]), 6)
                    for i in order if gain_delta[i] > 0}
        lv = (np.concatenate(leaf_vals) if leaf_vals
              else np.zeros(0, np.float64))
        leaf_values = ({"min": float(lv.min()), "max": float(lv.max()),
                        "mean": float(lv.mean()),
                        "rms": float(np.sqrt(np.mean(lv * lv)))}
                       if lv.size else {})
        norm = _normalized(self.ledger.gain_sums)
        shift = float(np.abs(norm - self._prev_norm).sum())
        self._prev_norm = norm
        return {
            "trees": int(new_trees),
            "splits": int(self.ledger.n_splits - splits_before),
            "gain_total": float(gain_delta.sum()),
            "top_gain": top_gain,
            "leaf_values": leaf_values,
            "importance_shift": round(shift, 6),
        }

    def snapshot(self):
        """JSON-ready cumulative view (the /trainz `quality` source):
        totals plus the current top features by gain and split count.
        Locked against a concurrent training-thread sync()."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self):
        gain = self.ledger.gain_sums
        splits = self.ledger.split_counts
        order = np.argsort(-gain)[:self.TOP_K]
        return {
            "trees": int(self.ledger.n_trees),
            "splits": int(self.ledger.n_splits),
            "gain_total": float(gain.sum()),
            "top_features": [
                {"feature": self._name(int(i)),
                 "gain": round(float(gain[i]), 6),
                 "splits": int(splits[i])}
                for i in order if gain[i] > 0],
        }
