"""lightgbm_tpu_torch's DART boosting against lightgbm_tpu, on the CPU.

The fixture is tests/test_core_training.py:121's (breast cancer, 15
leaves, drop_rate 0.1), trained per iteration by both packages with the
histogram chunk at the port's HIST_CHUNK. Held here:

- the drop sets: both packages draw them from Random(drop_seed) in the
  same order, so every iteration drops the same trees;
- the trees: structure equal to the JAX package's, leaf values within
  LEAF_TOL. A dropped tree goes into the train score as its float64
  leaves rounded to float32 on both sides (the port through its device
  traversal of the rounded leaves, the same bits), so DART adds nothing
  to the frameworks' last-ulp gradient difference of
  test_torch_train.py; the bound is that file's 1e-6 (the largest
  difference measured here is 2.2e-7, after ten iterations of drops and
  rescales; predictions 7.4e-8). Where two features cut the rows
  identically their gains tie exactly and an ulp picks the feature or
  the threshold (_assert_same_tree); there the two gains are held to
  the float32 rounding bound of the node's sums (_tie_bound);
- valid-set scores within 1e-6 of the JAX package's and of a fresh
  scoring of the final model; rollback_one_iter subtracts the last
  trees at their current (rescaled) values;
- predict after training equals predict after a reload from the model
  text, including after an iteration that stops with no tree, whose drop
  and normalization rescale the trees without changing their count (the
  stale-model-cache case).
"""

import numpy as np
import pytest
from sklearn import datasets

import lightgbm_tpu as lgj
from lightgbm_tpu.models.dart import DART as JDART

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models.dart import DART as TDART
from lightgbm_tpu_torch.models.gbdt import create_boosting
from lightgbm_tpu_torch.models.tree_learner import SerialTreeLearner as TSerial

CPU = "cpu"
PARAMS = {"objective": "binary", "boosting_type": "dart", "num_leaves": 15,
          "learning_rate": 0.1, "min_data_in_leaf": 10, "drop_rate": 0.1,
          "verbose": -1, "device_row_chunk": 4096,
          "partitioned_build": "false", "hist_compaction": "false"}
ROUNDS = 10
LEAF_TOL = 1e-6


def _data():
    x, y = datasets.load_breast_cancer(return_X_y=True)
    return x.astype(np.float64), y.astype(np.float64)


def _record_drops(cls):
    """Wrap cls._dropping_trees so each instance records its drop sets."""
    orig = cls._dropping_trees

    def wrapped(self):
        orig(self)
        self.drop_log = getattr(self, "drop_log", []) + [list(self.drop_index)]
    return orig, wrapped


@pytest.fixture(scope="module")
def trained():
    x, y = _data()
    xv, yv = x[::3], y[::3]
    out = {"torch_grads": []}
    saved = []
    for cls in (JDART, TDART):
        orig, wrapped = _record_drops(cls)
        saved.append((cls, orig))
        cls._dropping_trees = wrapped
    learn = TSerial.train_device

    def record(self, g, h, *args, **kwargs):
        out["torch_grads"].append((g.detach().cpu().numpy().copy(),
                                   h.detach().cpu().numpy().copy()))
        return learn(self, g, h, *args, **kwargs)
    saved.append((TSerial, learn))
    try:
        TSerial.train_device = record
        dtr = lgj.Dataset(x, y)
        out["jax"] = lgj.train(dict(PARAMS), dtr, ROUNDS,
                               valid_sets=[lgj.Dataset(xv, yv,
                                                       reference=dtr)],
                               verbose_eval=False)
        dtr = lgt.Dataset(x, y)
        out["torch"] = lgt.train(dict(PARAMS), dtr, ROUNDS,
                                 valid_sets=[lgt.Dataset(xv, yv,
                                                         reference=dtr)],
                                 verbose_eval=False, device=CPU)
    finally:
        for cls, orig in saved[:2]:
            cls._dropping_trees = orig
        TSerial.train_device = learn
    return out, x, xv


def test_drop_sets_equal_jax(trained):
    out, _, _ = trained
    j, t = out["jax"].gbdt, out["torch"].gbdt
    assert type(t).__name__ == "DART"
    assert t.drop_log == j.drop_log
    assert len(t.drop_log) == ROUNDS
    assert sum(len(d) for d in t.drop_log[1:]) >= ROUNDS - 1


def _subtree_leaves(tree, node):
    out, stack = [], [node]
    while stack:
        n = stack.pop()
        for child in (tree.left_child[n], tree.right_child[n]):
            if child < 0:
                out.append(~child)
            else:
                stack.append(child)
    return out


def _tie_bound(tree, node, leaf_of_row, grad, hess):
    """Float32 rounding bound on the gain of a node whose split ties
    (two candidates cut its rows identically).

    The gain is GL^2/HL + GR^2/HR - G^2/H over the node's float32 sums,
    a difference of terms thousands of times larger than itself. Each
    package's sums of n rows carry a relative error of at most
    k = ceil(log2 n) + 1 units of float32 rounding u against sum |x|
    (one ulp of the gradients, which the packages' objectives part by,
    and the blocked summation's depth); to first order that moves a term
    G^2/H by (2 |G| / H * sum |g| + (G / H)^2 * H) * k * u, and the
    gain's own float32 arithmetic by 4 u of each term. Both packages
    err, so the bound is twice that."""
    u = 2.0 ** -24
    rows = np.isin(leaf_of_row, _subtree_leaves(tree, node))
    left_child = tree.left_child[node]
    left = (np.isin(leaf_of_row, _subtree_leaves(tree, left_child))
            if left_child >= 0 else leaf_of_row == ~left_child)
    g = grad.reshape(-1)[:leaf_of_row.size].astype(np.float64)
    h = hess.reshape(-1)[:leaf_of_row.size].astype(np.float64)
    k = np.ceil(np.log2(rows.sum())) + 1
    bound = 0.0
    for side in (rows & left, rows & ~left, rows):
        sg, sh, sa = g[side].sum(), h[side].sum(), np.abs(g[side]).sum()
        bound += ((2 * abs(sg) / sh * sa + (sg / sh) ** 2 * sh) * k * u
                  + 4 * u * sg * sg / sh)
    return 2 * bound


def _assert_same_tree(a, b, x, grads):
    """Structure equal: the same shape, counts and row partition. Two
    split candidates that cut the rows identically tie exactly in gain
    (this fixture's columns 20 and 23, worst radius and worst area, do
    at tree 3; so do two thresholds of one column around an empty bin),
    and there the last ulp of the gradients, which the frameworks'
    float32 objectives move, picks the candidate: a node whose feature
    or threshold differs must be such a tie (the same rows through it,
    gains within the float32 rounding bound of its sums, _tie_bound)."""
    assert a.num_leaves == b.num_leaves
    for key in ("left_child", "right_child", "leaf_parent", "leaf_count",
                "internal_count"):
        np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                      err_msg=key)
    leaf_of_row = b.get_leaf(x)
    np.testing.assert_array_equal(leaf_of_row, a.get_leaf(x))
    tie = ((b.split_feature_real != a.split_feature_real)
           | (b.threshold_in_bin != a.threshold_in_bin))
    for node in np.nonzero(tie)[0]:
        bound = _tie_bound(b, node, leaf_of_row, *grads)
        assert abs(b.split_gain[node] - a.split_gain[node]) <= bound, (
            node, b.split_gain[node], a.split_gain[node], bound)
    np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                               atol=LEAF_TOL)
    return int(tie.sum())


def test_trees_match_jax(trained):
    out, x, _ = trained
    jt, tt = out["jax"].gbdt.models, out["torch"].gbdt.models
    assert len(jt) == len(tt) == ROUNDS
    grads = out["torch_grads"]
    assert len(grads) == ROUNDS
    ties = sum(_assert_same_tree(a.materialize() if hasattr(a, "materialize")
                                 else a, b, x, g)
               for a, b, g in zip(jt, tt, grads))
    assert ties <= 2
    np.testing.assert_allclose(out["torch"].predict(x), out["jax"].predict(x),
                               rtol=0, atol=LEAF_TOL)
    text = out["torch"].model_to_string()
    assert text.splitlines()[0] == "dart"


def test_valid_scores(trained):
    out, _, xv = trained
    j, t = out["jax"].gbdt, out["torch"].gbdt
    got = t.valid_score_updaters[0].host_score()
    want = np.asarray(j.valid_score_updaters[0].score, np.float64).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=LEAF_TOL)
    fresh = t.predict_raw(xv)[:, 0]
    np.testing.assert_allclose(got, fresh, rtol=0, atol=LEAF_TOL)
    np.testing.assert_allclose(t.train_score_updater.host_score(),
                               t.predict_raw(trained[1])[:, 0], rtol=0,
                               atol=LEAF_TOL)


def test_rollback_subtracts_current_trees():
    x, y = _data()
    b = lgt.train(dict(PARAMS), lgt.Dataset(x, y), 6, verbose_eval=False,
                  device=CPU)
    jb = lgj.train(dict(PARAMS), lgj.Dataset(x, y), 6, verbose_eval=False)
    b.rollback_one_iter()
    jb.rollback_one_iter()
    g = b.gbdt
    assert len(g.models) == 5
    np.testing.assert_allclose(g.train_score_updater.host_score(),
                               g.predict_raw(x)[:, 0], rtol=0, atol=LEAF_TOL)
    np.testing.assert_allclose(
        g.train_score_updater.host_score(),
        np.asarray(jb.gbdt.train_score_updater.score,
                   np.float64).reshape(-1), rtol=0, atol=LEAF_TOL)


def _reloaded(booster):
    g = create_boosting("gbdt", CPU)
    text = booster.model_to_string()
    assert text.splitlines()[0] == "dart"
    g2 = create_boosting(text.splitlines()[0], CPU)
    g2.load_model_from_string(text)
    assert type(g2).__name__ == "DART" and type(g).__name__ == "GBDT"
    assert g2.save_model_to_string() == text
    return g2


def test_predict_after_training_equals_reload():
    x, y = _data()
    b = lgt.train(dict(PARAMS), lgt.Dataset(x, y), 5, verbose_eval=False,
                  device=CPU)
    np.testing.assert_array_equal(b.gbdt.predict(x), _reloaded(b).predict(x))
    # a stop iteration: DART drops and re-normalizes trees, rescaling
    # them, but appends none; the cached stacked arrays must go
    b.gbdt.device_predict = "false"
    before = b.gbdt.predict(x)
    b.reset_parameter({"min_gain_to_split": 1e9})
    assert b.update() is True
    assert len(b.gbdt.models) == 5
    after = b.gbdt.predict(x)
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, _reloaded(b).predict(x))
