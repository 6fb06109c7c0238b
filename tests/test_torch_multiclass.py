"""lightgbm_tpu_torch multiclass training and the metrics it adds,
against lightgbm_tpu on the CPU.

Both packages train on the same numpy data with the masked engine (or
the leaf-contiguous one where named) and K trees an iteration in
class-major order. Trees must have the same structure; leaf values and
predictions agree within 1e-6 absolute, the port-vs-JAX bound of
test_torch_train.py (the frameworks' float32 exp differ in the last bit
inside the softmax, nothing more). The port's fused trainer must equal
its own per-iteration loop byte for byte in the model text: it runs the
same K tree builds in the same order. (The JAX package's fused path
vmaps the class axis and is held to its per-iteration path only
structurally, tests/test_multiclass_fused.py; the port is held to the
JAX per-iteration path.) Metrics agree with the JAX package's to 1e-12.
"""

import numpy as np
import pytest
from sklearn import datasets

import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.metrics import create_metric as jmetric
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.metrics import create_metric as tmetric
from test_torch_train import _trees

CPU = "cpu"
BASE = {"objective": "multiclass", "verbose": -1, "metric_freq": 0,
        "partitioned_build": "false", "hist_compaction": "false",
        "device_row_chunk": 4096}
ATOL = 1e-6


def _assert_same_model(jb, tb, x, atol=ATOL):
    """Structure exact; leaf values and predictions within `atol`."""
    jt, tt = _trees(jb), _trees(tb)
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        for key in ("split_feature_real", "threshold_in_bin", "left_child",
                    "right_child", "leaf_parent", "leaf_count",
                    "internal_count"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                          err_msg=key)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=atol)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0,
                               atol=atol)


def _digits():
    x, y = datasets.load_digits(return_X_y=True)
    return x.astype(np.float32), y.astype(np.float32)


def _three_class(seed=13, n=1500, f=10):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    return x, ((x[:, 0] * 3 + x[:, 1] * 2).astype(np.int32) % 3).astype(
        np.float32)


def _jax(params, x, y):
    return lgj.Booster(params, lgj.Dataset(x, y, params=params))


def _port(params, x, y):
    """A port Booster; the Dataset gets the params too, as the JAX
    package's test builds its Dataset from the training config
    (max_bin, is_enable_sparse)."""
    return lgt.Booster(params, lgt.Dataset(x, y, params=params), device=CPU)


def _loop(booster, rounds):
    """The per-iteration loop, stopping where train_one_iter does."""
    for _ in range(rounds):
        if booster.gbdt.train_one_iter(is_eval=False):
            break
    return booster


# tests/test_multiclass_fused.py's two cases: K = 10 with 7 leaves on
# digits, and K = 3 with feature_fraction 0.6. On digits:
# - its sparse columns are stored unbundled (bundling is a later slice
#   of the port);
# - min_gain_to_split=1e-3 drops the splits whose gain is float32 noise
#   (1e-4 against a root gain of 514), which the two packages' sums
#   order differently;
# - the bound is 2e-6: at iteration 0 both packages see the same
#   gradients, and a 0.5 leaf that is a parent's sums minus its smaller
#   child's (an f32 cancellation that puts both 5e-4 from the exact
#   0.5) differs by 1.5e-6 between the JAX package's float64-bincount
#   chunk sums and the port's float32 row-order ones.
CASES = {
    "digits-k10": (_digits, {"num_class": 10, "num_leaves": 7,
                             "min_data_in_leaf": 5,
                             "is_enable_sparse": False,
                             "min_gain_to_split": 1e-3}, 2, 2e-6),
    "ff0.6-k3": (_three_class, {"num_class": 3, "num_leaves": 7,
                                "max_bin": 32, "feature_fraction": 0.6,
                                "min_data_in_leaf": 10}, 3, ATOL),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_iteration_and_fused_match_jax(case):
    make, extra, rounds, atol = CASES[case]
    x, y = make()
    params = dict(BASE, **extra)
    k = params["num_class"]
    jb = _loop(_jax(params, x, y), rounds)
    tb = _loop(_port(params, x, y), rounds)
    tf = _port(params, x, y)
    assert tf.gbdt._fused_eligible()
    assert not tf.gbdt.train_many(rounds)
    assert len(tb.gbdt.models) == len(tf.gbdt.models) == rounds * k
    assert tf.model_to_string() == tb.model_to_string()
    _assert_same_model(jb, tb, x, atol)
    # predict is the softmax of the class sums
    assert tb.predict(x, raw_score=True).shape == (len(x), k)
    np.testing.assert_allclose(tb.predict(x).sum(axis=1), 1.0, atol=1e-12)


def _stop_data():
    """Classes 0 and 1 split on x1 with noise; class 2 is x0 > 0.5,
    learnt in a few rounds, after which its hessians fall below
    min_sum_hessian_in_leaf and its tree cannot split while the other
    classes still do (min_gain_to_split drops float-noise splits)."""
    rng = np.random.RandomState(3)
    x = rng.rand(1200, 5).astype(np.float32)
    y = (x[:, 1] + 0.3 * rng.randn(1200) > 0.5).astype(np.int64)
    y[x[:, 0] > 0.5] = 2
    return x, y.astype(np.float32)


STOP = dict(BASE, num_class=3, num_leaves=4, min_data_in_leaf=5,
            min_sum_hessian_in_leaf=40.0, min_gain_to_split=0.5,
            learning_rate=1.0)


def test_natural_stop_mid_block_keeps_the_partial_iteration():
    """A class tree with no split mid-block: the classes before it in
    that iteration are kept (k_stop > 0), as the per-iteration loop
    appends them, in both packages."""
    x, y = _stop_data()
    jb = _loop(_jax(STOP, x, y), 8)
    tb = _loop(_port(STOP, x, y), 8)
    tf = _port(STOP, x, y)
    assert tf.gbdt.train_many(8)
    n = len(tf.gbdt.models)
    assert n % 3 == 2 and n < 8 * 3          # k_stop = 2
    assert tf.model_to_string() == tb.model_to_string()
    assert tf.gbdt.iter == tb.gbdt.iter == n // 3
    np.testing.assert_array_equal(tf.gbdt.get_training_score(),
                                  tb.gbdt.get_training_score())
    _assert_same_model(jb, tb, x)


def test_rollback_one_iter_matches_jax():
    x, y = _three_class(seed=4, n=1200)
    params = dict(BASE, num_class=3, num_leaves=7, min_data_in_leaf=10)
    jb = _loop(_jax(params, x, y), 3)
    tb = _loop(_port(params, x, y), 3)
    for b in (jb, tb):
        b.rollback_one_iter()
        assert b.current_iteration() == 2 and len(b.gbdt.models) == 6
    # the dropped trees' scores are gone: the score is the kept trees'
    np.testing.assert_allclose(
        tb.gbdt.get_training_score(),
        tb.predict(x, raw_score=True).T.reshape(-1), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tb.gbdt.get_training_score(),
                               jb.gbdt.get_training_score(), rtol=0,
                               atol=ATOL)
    for b in (jb, tb):
        b.update()
    _assert_same_model(jb, tb, x)


def test_partitioned_builder_matches_jax():
    """partitioned_build=true, per-iteration and fused, against the JAX
    package's leaf-contiguous builder (hist_mode=segment: the float32
    row-order sums the port reproduces, test_torch_partitioned.py)."""
    x, y = _three_class(seed=5, n=2000, f=8)
    params = dict(BASE, num_class=3, num_leaves=7, min_data_in_leaf=10,
                  partitioned_build="true", hist_mode="segment")
    jb = _loop(_jax(params, x, y), 3)
    tb = _loop(_port(params, x, y), 3)
    tf = _port(params, x, y)
    tf.gbdt.train_many(3)
    assert tb.gbdt.tree_learner.use_partitioned
    assert tf.model_to_string() == tb.model_to_string()
    _assert_same_model(jb, tb, x)


def test_multiclass_objective_accepts_multiclass_metrics():
    """Config.check_param_conflict: multi_* metrics go with the
    multiclass objective only, in both packages."""
    for cfg in (JConfig, TConfig):
        c = cfg.from_params({"objective": "multiclass", "num_class": 3,
                             "metric": "multi_logloss,multi_error"})
        assert c.metric == ("multi_logloss", "multi_error")
        with pytest.raises(Exception):
            cfg.from_params({"objective": "multiclass", "num_class": 3,
                             "metric": "auc"})
        with pytest.raises(Exception):
            cfg.from_params({"objective": "binary",
                             "metric": "multi_error"})
    x, y = _three_class(seed=6, n=600)
    ev = {}
    lgt.train(dict(BASE, num_class=3, num_leaves=4, metric_freq=1,
                   metric="multi_logloss,multi_error"),
              ds := lgt.Dataset(x, y), 2, valid_sets=[ds],
              evals_result=ev, verbose_eval=False, device=CPU)
    assert len(ev["training"]["multi_logloss"]) == 2
    assert ev["training"]["multi_logloss"][1] < ev["training"][
        "multi_logloss"][0]


class _Meta:
    def __init__(self, label, weights):
        self.label = label
        self.weights = weights


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("name,num_class", [
    ("l1", 1), ("binary_error", 1), ("multi_logloss", 4),
    ("multi_error", 4)])
def test_new_metrics_match_jax(name, num_class, weighted):
    rng = np.random.RandomState(7)
    n = 500
    if num_class > 1:
        label = rng.randint(0, num_class, n).astype(np.float32)
    elif name == "binary_error":
        label = (rng.rand(n) > 0.4).astype(np.float32)
    else:
        label = rng.randn(n).astype(np.float32)
    weights = (rng.rand(n).astype(np.float32) + 0.5) if weighted else None
    score = rng.randn(n * num_class)
    params = {"num_class": num_class, "sigmoid": 1.5}
    if num_class > 1:
        params["objective"] = "multiclass"
    got, want = (m.eval(score) for m in (
        _init(tmetric(name, TConfig.from_params(params)), label, weights),
        _init(jmetric(name, JConfig.from_params(params)), label, weights)))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _init(metric, label, weights):
    metric.init(_Meta(label, weights), len(label))
    return metric


def test_softmax_gradients_match_jax():
    """MulticlassLogloss on the same (K, N) scores, with weights."""
    import jax.numpy as jnp
    import torch
    from lightgbm_tpu.objectives import create_objective as jobj
    from lightgbm_tpu_torch.objectives import create_objective as tobj
    rng = np.random.RandomState(8)
    n, k = 400, 5
    meta = _Meta(rng.randint(0, k, n).astype(np.float32),
                 rng.rand(n).astype(np.float32) + 0.5)
    score = (3 * rng.randn(k, n)).astype(np.float32)
    cfg = {"objective": "multiclass", "num_class": k}
    j = jobj("multiclass", JConfig.from_params(cfg))
    j.init(meta, n)
    t = tobj("multiclass", TConfig.from_params(cfg))
    t.init(meta, n, torch.device(CPU))
    jg, jh = (np.asarray(a) for a in j.get_gradients(jnp.asarray(score)))
    tg, th = (a.numpy() for a in t.get_gradients(torch.from_numpy(score)))
    np.testing.assert_allclose(tg, jg, rtol=0, atol=ATOL)
    np.testing.assert_allclose(th, jh, rtol=0, atol=ATOL)
    with pytest.raises(Exception):
        bad = _Meta(np.full(n, k, np.float32), None)
        tobj("multiclass", TConfig.from_params(cfg)).init(
            bad, n, torch.device(CPU))
