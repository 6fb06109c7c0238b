"""lightgbm_tpu_torch's linear leaves against lightgbm_tpu, on the CPU.

The fixture is tests/test_linear_trees.py's piece-wise linear problem
(3,000 x 10, seed 7), trained by both packages with the histogram chunk
at the port's HIST_CHUNK (device_row_chunk=4096, which is also the fit's
chunk grid on both sides). The contract held here:

- leaf_path_features and fit_linear_leaves give arrays equal to the JAX
  functions' on the same inputs (both are host float64 numpy);
- trained models have the JAX package's structure (splits, thresholds,
  counts, which leaves are linear and on which features), constant leaf
  values within 1e-6 (test_torch_train.py's bound) and intercepts and
  coefficients within COEF_TOL: the first tree's fit gets equal inputs
  and gives equal bits; later trees fit float32 gradients whose last
  bit the frameworks' exp rounds apart, and the ridge solve carries
  that as a difference of at most 1.2e-8 of the tree's largest
  intercept or coefficient (measured over this file's fixtures, the
  multiclass one the largest; the bound leaves 8x);
- format-version-2 text crosses the packages both ways byte for byte,
  a constant model stays version 1, and the loader refuses what the JAX
  loader refuses;
- host predict (NaN rows included), coeff importance, the serving exact
  path and the bf16 bound on one model text equal the JAX package's bit
  for bit; tree_lin_raw's plain version is within the class-sum bound
  T x eps x sum_t max|value| of the JAX _linraw_kernel (which sums on
  its matrix unit, in another order);
- the fit composes with DART, bagging, feature_fraction, multiclass and
  a bundled dataset (its path features decode to the unbundled bins).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
from lightgbm_tpu.models import linear_leaves as jlin
from lightgbm_tpu.models.gbdt import create_boosting as jcreate
from lightgbm_tpu.serving import CompiledPredictor as JaxPredictor
from lightgbm_tpu.telemetry.quality import tree_coeff_importance as jcoeff

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models import linear_leaves as tlin
from lightgbm_tpu_torch.models.gbdt import create_boosting as tcreate
from lightgbm_tpu_torch.ops import traverse_kernels as tk
from lightgbm_tpu_torch.serving import CompiledPredictor
from lightgbm_tpu_torch.telemetry.quality import \
    tree_coeff_importance as tcoeff
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = "cpu"
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "learning_rate": 0.1, "verbose": -1, "device_row_chunk": 4096,
        "linear_tree": True, "partitioned_build": "false",
        "hist_compaction": "false"}
COEF_TOL = 1e-7


def _data(n=3000, f=10, seed=7):
    """tests/test_linear_trees.py _data."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    lin = x[:, 0] * 1.5 - x[:, 1] * 0.8 + 0.3 * x[:, 2] * x[:, 3]
    y = (lin + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    return np.asarray(x, np.float64), y


def _train_both(params, rounds=4, n=3000, x=None, y=None):
    if x is None:
        x, y = _data(n=n)
    jb = lgj.train(dict(params), lgj.Dataset(x, y, params=dict(params)),
                   rounds, verbose_eval=False)
    tb = lgt.train(dict(params), lgt.Dataset(x, y, params=dict(params)),
                   rounds, verbose_eval=False, device=CPU)
    return jb, tb


def _trees(booster):
    return [t.materialize() if hasattr(t, "materialize") else t
            for t in booster.gbdt.models]


def _assert_same_linear_model(jb, tb, coef_tol=COEF_TOL):
    jt, tt = _trees(jb), _trees(tb)
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        for key in ("split_feature_real", "threshold_in_bin", "left_child",
                    "right_child", "leaf_parent", "leaf_count"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                          err_msg=key)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)
        assert a.is_linear == b.is_linear
        if not a.is_linear:
            continue
        np.testing.assert_array_equal(b.leaf_coeff_count, a.leaf_coeff_count)
        np.testing.assert_array_equal(b.leaf_coeff_feat, a.leaf_coeff_feat)
        for got, want in ((b.leaf_const, a.leaf_const),
                          (b.leaf_coeff, a.leaf_coeff)):
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=coef_tol * scale)


@pytest.fixture(scope="module")
def trained():
    return _train_both(BASE, rounds=4)


@pytest.fixture(scope="module")
def jax_text(trained):
    return trained[0].gbdt.save_model_to_string(-1)


def _port_gbdt(text):
    g = tcreate(text.splitlines()[0], CPU)
    g.load_model_from_string(text)
    return g


def _jax_gbdt(text):
    g = jcreate(text.splitlines()[0])
    g.load_model_from_string(text)
    return g


# ------------------------------------------------------------- the fit
def test_path_features_and_fit_equal_jax(trained):
    """The same tree, gradients, bag and bins through both fits: equal
    arrays."""
    jb, _ = trained
    x, _ = _data()
    tree = _trees(jb)[2]
    rng = np.random.RandomState(3)
    n = len(x)
    for cap in (1, 3, 8):
        args = (tree.split_feature, tree.left_child, tree.right_child,
                tree.leaf_parent, tree.num_leaves, cap)
        jf, tf = jlin.leaf_path_features(*args), tlin.leaf_path_features(
            *args)
        assert len(jf) == len(tf)
        for a, b in zip(jf, tf):
            np.testing.assert_array_equal(b, a)
        ds = jb.gbdt.train_data
        row_leaf = tree.get_leaf_by_bins(ds.traversal_bins())
        grad = rng.randn(n).astype(np.float32)
        hess = (rng.rand(n) + 0.1).astype(np.float32)
        inbag = (rng.rand(n) < 0.8).astype(np.float32)
        for bag in (None, inbag):
            common = (tree.leaf_value, tree.leaf_count,
                      ds.bin_value_table(), row_leaf, grad, hess, bag,
                      [(0, n, ds.traversal_bins(), 0)], 512, 0.01)
            want = jlin.fit_linear_leaves(jf, *common)
            got = tlin.fit_linear_leaves(tf, *common)
            for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
                np.testing.assert_array_equal(g, w)
            for g, w in zip(got[1], want[1]):
                np.testing.assert_array_equal(g, w)
            assert got[2].any()


def test_trained_models_match_jax(trained):
    jb, tb = trained
    _assert_same_linear_model(jb, tb)
    assert any(t.is_linear for t in _trees(tb))
    x, _ = _data(n=500, seed=3)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0,
                               atol=1e-5)


def test_degenerate_leaves_fall_back_to_constants():
    """test_linear_trees.py:85: tiny leaves and zero-variance fits fall
    back to constants, as in the JAX package."""
    params = dict(BASE, min_data_in_leaf=2, num_leaves=31)
    jb, tb = _train_both(params, rounds=3, n=200)
    # which leaves fall back is the JAX package's (leaf_coeff_count)
    _assert_same_linear_model(jb, tb)
    assert np.isfinite(tb.predict(_data(n=50)[0])).all()


# ------------------------------------------------------------ model text
def test_v2_text_crosses_packages(trained, jax_text):
    jb, tb = trained
    text = tb.model_to_string()
    assert text.splitlines()[1] == "format_version=2"
    assert _port_gbdt(text).save_model_to_string() == text
    assert _jax_gbdt(text).save_model_to_string(-1) == text
    assert _port_gbdt(jax_text).save_model_to_string() == jax_text


def test_constant_model_stays_v1():
    x, y = _data(n=600)
    params = dict(BASE, linear_tree=False)
    tb = lgt.train(params, lgt.Dataset(x, y), 3, verbose_eval=False,
                   device=CPU)
    text = tb.model_to_string()
    assert "format_version" not in text
    assert _port_gbdt(text).save_model_to_string() == text


@pytest.mark.parametrize("case", ["newer", "linear_under_v1", "unknown"])
def test_loader_refusals(jax_text, case):
    """test_linear_trees.py:157-173: the port's loader refuses what the
    JAX loader refuses."""
    if case == "newer":
        bad = jax_text.replace("format_version=2", "format_version=99", 1)
    elif case == "linear_under_v1":
        lines = jax_text.splitlines()
        assert lines[1] == "format_version=2"
        del lines[1]
        bad = "\n".join(lines)
    else:
        bad = jax_text.replace("leaf_count=",
                               "leaf_frobnication=7\nleaf_count=", 1)
    match = "unknown section" if case == "unknown" else "format_version"
    with pytest.raises(LightGBMError, match=match):
        tcreate("gbdt", CPU).load_model_from_string(bad)


# ------------------------------------------------------------ prediction
def _nan_rows():
    x, _ = _data(n=400, seed=3)
    x = x.astype(np.float32)
    x[:40, 0] = np.nan
    x[40:60, 3] = np.nan
    return x


def test_host_predict_with_nan_equals_jax(jax_text):
    x = _nan_rows().astype(np.float64)
    t, j = _port_gbdt(jax_text), _jax_gbdt(jax_text)
    assert np.array_equal(t.predict_raw(x), j.predict_raw(x))
    assert np.array_equal(t.predict(x), j.predict(x))
    # device_predict=true keeps a linear model on the host
    t.device_predict = "true"
    assert np.array_equal(t.predict_raw(x), j.predict_raw(x))


def test_coeff_importance_equals_jax(jax_text, trained):
    t, j = _port_gbdt(jax_text), _jax_gbdt(jax_text)
    got = t.feature_importance_values("coeff")
    assert np.array_equal(got, j.feature_importance_values("coeff"))
    assert got.sum() > 0
    for tree in t.models:
        assert np.array_equal(tcoeff(tree, 10), jcoeff(tree, 10))
    b = trained[1]
    assert b.feature_importance("coeff").sum() > 0
    assert b.feature_importance("gain").sum() > 0
    with pytest.raises(LightGBMError, match="importance type"):
        b.feature_importance("nope")


def test_serving_exact_path_equals_host_and_jax(jax_text):
    t = _port_gbdt(jax_text)
    x = _nan_rows()
    p = CompiledPredictor.from_booster(t, max_batch_rows=256, device=CPU)
    jp = JaxPredictor.from_booster(_jax_gbdt(jax_text), max_batch_rows=256)
    assert p.describe()["is_linear"] is True
    host_raw = t.predict_raw(x.astype(np.float64))
    assert np.array_equal(p.predict_raw(x), host_raw)
    assert np.array_equal(p.predict(x), t.predict(x.astype(np.float64)))
    assert np.array_equal(p.predict_raw(x), jp.predict_raw(x))
    assert np.array_equal(p.predict_leaf_index(x), jp.predict_leaf_index(x))


def _class_sum_bound(p):
    """T x eps x sum over trees of the largest value a lane can add (the
    JAX kernel sums on its matrix unit, the port in tree order)."""
    mag = np.maximum(np.abs(p._lv64).max(axis=1),
                     (np.abs(p._lin_const64) + np.abs(p._lin_coef64).sum(
                         axis=2) * 4.0).max(axis=1))
    return p.num_trees * float(np.finfo(np.float32).eps) * float(mag.sum())


def test_bf16_bound_and_device_variants_match_jax(jax_text):
    x = _nan_rows()
    t = _port_gbdt(jax_text)
    host_raw = t.predict_raw(x.astype(np.float64))
    host_p = t.predict(x.astype(np.float64))
    p16 = CompiledPredictor.from_booster(t, max_batch_rows=256, device=CPU,
                                         serving_precision="bf16")
    jp16 = JaxPredictor.from_booster(_jax_gbdt(jax_text), max_batch_rows=256,
                                     serving_precision="bf16")
    assert p16.accuracy_bound == jp16.accuracy_bound > 0
    assert np.abs(p16.predict_raw(x) - host_raw).max() <= p16.accuracy_bound
    assert np.abs(p16.predict(x) - host_p).max() <= p16.accuracy_bound
    p = CompiledPredictor.from_booster(t, max_batch_rows=256, device=CPU)
    jp = JaxPredictor.from_booster(_jax_gbdt(jax_text), max_batch_rows=256)
    xf = x[:, :p.num_features]
    bound = _class_sum_bound(p)
    assert np.abs(p.predict_raw_device(x) - jp.predict_raw_device(xf)).max() \
        <= bound
    assert np.abs(p.predict_device(x) - jp.predict_device(xf)).max() <= bound
    assert np.abs(p.predict_raw_device(x) - host_raw).max() <= bound
    # the bf16 kernels' plain versions against the JAX bf16 kernels
    assert np.abs(p16.predict_raw(x) - jp16.predict_raw(x)).max() <= bound


def test_serving_refuses_overwide_leaf_models(trained):
    g = trained[1].gbdt
    const, coef, cfeat, ccnt = g._stacked_linear_arrays(len(g.models))
    pad = ((0, 0), (0, 0), (0, 9 - coef.shape[2]))
    g2 = _port_gbdt(trained[1].model_to_string())
    g2._stacked_linear_arrays = lambda n: (const, np.pad(coef, pad),
                                           np.pad(cfeat, pad), ccnt)
    with pytest.raises(ValueError, match="COEF_PAD"):
        CompiledPredictor.from_booster(g2, device=CPU)
    with pytest.raises(ValueError, match="COEF_PAD"):
        tk.freeze_linear(const, np.pad(coef, pad), np.pad(cfeat, pad), ccnt,
                         torch.float32, CPU)


def test_lin_raw_plain_against_jax_kernel(jax_text):
    """tree_lin_raw_plain on the frozen arrays against the JAX
    _linraw_kernel / _lintransformed_kernel through the JAX predictor's
    own dispatch, raw and transformed, on the same rows."""
    x = _nan_rows()
    p = CompiledPredictor.from_booster(_port_gbdt(jax_text), device=CPU,
                                       max_batch_rows=512, warmup=False)
    jp = JaxPredictor.from_booster(_jax_gbdt(jax_text), max_batch_rows=512,
                                   warmup=False)
    xb = torch.from_numpy(np.pad(x, ((0, 512 - len(x)), (0, 0))))
    bound = _class_sum_bound(p)
    for transform in (False, True):
        got = tk.tree_lin_raw_plain(xb, p._forest, p._f32_values(),
                                    p._lin_dev, 1, transform, p.sigmoid)
        want = np.asarray((jp._dispatch_lintransformed if transform
                           else jp._dispatch_linraw)(xb.numpy()))
        assert np.abs(got.numpy() - want).max() <= bound
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(tk.tree_lin_raw(xb, p._forest, p._f32_values(),
                                       p._lin_dev, 1),
                       tk.tree_lin_raw_plain(xb, p._forest, p._f32_values(),
                                             p._lin_dev, 1))


# ------------------------------------------------------------ composition
@pytest.mark.parametrize("extra", [
    {"boosting_type": "dart", "drop_rate": 0.5},
    {"objective": "multiclass", "num_class": 3},
    {"bagging_fraction": 0.7, "bagging_freq": 2, "feature_fraction": 0.6},
], ids=["dart", "multiclass", "bagging-ff"])
def test_linear_composes_with_sampling_and_boosting(extra):
    """test_linear_trees.py:117: every prediction finite and the model
    text round-trips; without bagging (whose bits the packages do not
    share) the trees are the JAX package's. min_gain_to_split keeps the
    comparison to real splits: from the second iteration on this
    fixture's class trees split leaves whose best gains are noise (about
    5e-5 against a parent gain of 82, float32 cancellation), and there an
    ulp of gradient, which the frameworks' exp round apart, picks
    another bin."""
    params = dict(BASE, min_gain_to_split=1e-3, **extra)
    x, y = _data(n=800)
    if extra.get("objective") == "multiclass":
        y = (np.asarray(y, int) + (x[:, 2] > 0.5)).astype(np.float64)
    if "bagging_fraction" in extra:
        tb = lgt.train(params, lgt.Dataset(x, y, params=dict(params)), 4,
                       verbose_eval=False, device=CPU)
    else:
        jb, tb = _train_both(params, rounds=4, x=x, y=y)
        _assert_same_linear_model(jb, tb)
    text = tb.model_to_string()
    assert np.isfinite(tb.predict(x[:64])).all()
    assert _port_gbdt(text).save_model_to_string() == text


def _onehot_data():
    """tests/test_torch_bundling.py's fixture (three 12-wide one-hot
    groups and 4 dense columns), with a linear response in the dense
    columns."""
    rng = np.random.RandomState(7)
    n = 3000
    cols = []
    for _ in range(3):
        onehot = np.zeros((n, 12), np.float32)
        onehot[np.arange(n), rng.randint(0, 12, size=n)] = 1.0
        cols.append(onehot)
    dense = rng.randn(n, 4).astype(np.float32)
    x = np.concatenate(cols + [dense], axis=1)
    logit = (x[:, 0] + x[:, 12] - x[:, 24] + 0.8 * dense[:, 0]
             - 0.5 * dense[:, 1] + 0.3 * rng.randn(n))
    return x, (logit > 0.4).astype(np.float32)


def test_linear_on_bundled_dataset():
    x, y = _onehot_data()
    params = dict(BASE, min_data_in_leaf=10)
    jb, tb = _train_both(params, rounds=3, x=x, y=y)
    learner = tb.gbdt.tree_learner
    assert learner.bundle is not None
    _assert_same_linear_model(jb, tb)
    # the fit's bins decode to the unbundled dataset's
    chunks, table, _ = learner.linear_fit_context()
    unbundled = dict(params, is_enable_sparse=False)
    plain = lgt.train(unbundled, lgt.Dataset(x, y, params=unbundled), 1,
                      verbose_eval=False, device=CPU)
    pl = plain.gbdt.tree_learner
    assert pl.bundle is None
    feats = np.arange(x.shape[1])
    rows = np.arange(len(x))
    np.testing.assert_array_equal(
        chunks[0][2][feats[:, None], rows[None, :]],
        pl.linear_fit_context()[0][0][2])
    np.testing.assert_array_equal(table, pl.linear_fit_context()[1])
    assert any(t.is_linear for t in _trees(tb))
