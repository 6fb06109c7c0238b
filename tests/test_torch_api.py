"""The rest of lightgbm_tpu_torch's training API against lightgbm_tpu,
on the CPU: Dataset setters and getters, subset, dump_model, custom
objectives and metrics, continued training, reset_parameter, cv, and
the binary objective's class weights.

Trees are held as in test_torch_train.py: structure exact, leaf values
and predictions within 1e-6 absolute, unless a test states its own
bound. Metric values from the same scores agree to 1e-12; cv means and
standard deviations within 1e-6.
"""

import json
import os
import re
import tempfile

import numpy as np
import pytest

import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.application import Application
from test_torch_multiclass import _assert_same_model, _loop

CPU = "cpu"
BASE = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 20,
        "verbose": -1, "partitioned_build": "false",
        "hist_compaction": "false", "device_row_chunk": 4096}


def _data(seed=0, n=1200, f=6):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    logit = x[:, 0] + 0.5 * x[:, 1] - 0.7 * x[:, 2] + 0.3 * rng.randn(n)
    return x, (logit > 0.4).astype(np.float32)


@pytest.mark.parametrize("when", ["before", "after"])
def test_setters_and_getters(when):
    """set_weight / set_init_score / set_group before and after
    construction land in the metadata the JAX package's do; training
    on them grows the JAX package's trees."""
    x, y = _data(seed=1)
    n = len(y)
    rng = np.random.RandomState(2)
    w = (rng.rand(n) + 0.5).astype(np.float32)
    init = (0.2 * rng.randn(n)).astype(np.float64)
    group = np.full(n // 50, 50)
    boosters = []
    for pkg, kw in ((lgj, {}), (lgt, {"device": CPU})):
        ds = pkg.Dataset(x, y, free_raw_data=False)
        if when == "after":
            ds.construct()
        ds.set_weight(w)
        ds.set_init_score(init)
        ds.set_group(group)
        np.testing.assert_array_equal(ds.get_weight(), w)
        np.testing.assert_array_equal(ds.get_init_score(), init)
        np.testing.assert_array_equal(ds.get_group(), group)
        ds.construct()
        meta = ds._core.metadata
        np.testing.assert_array_equal(meta.query_boundaries,
                                      np.arange(0, n + 1, 50))
        boosters.append(_loop(pkg.Booster(BASE, ds, **kw), 3))
    jb, tb = boosters
    np.testing.assert_array_equal(tb.gbdt.train_data.metadata.query_weights,
                                  jb.gbdt.train_data.metadata.query_weights)
    _assert_same_model(jb, tb, x)
    # the trees start from the init score
    np.testing.assert_allclose(
        tb.gbdt.get_training_score(),
        init + tb.predict(x, raw_score=True), rtol=0, atol=1e-6)


def test_create_valid_with_group_and_init_score():
    x, y = _data(seed=3)
    ds = lgt.Dataset(x, y)
    va = ds.create_valid(x[:400], y[:400], group=[100] * 4,
                         init_score=np.full(400, 0.5))
    va.construct()
    assert va._core.metadata.num_queries == 4
    np.testing.assert_array_equal(va.get_init_score(), np.full(400, 0.5))


def test_subset_matches_jax():
    x, y = _data(seed=4)
    w = np.random.RandomState(5).rand(len(y)).astype(np.float32)
    idx = np.random.RandomState(6).choice(len(y), 700, replace=False)
    idx.sort()
    subs = []
    for pkg in (lgj, lgt):
        full = pkg.Dataset(x, y, weight=w)
        sub = full.subset(idx)
        assert sub.num_data() == 700
        subs.append(sub._core)
    js, ts = subs
    np.testing.assert_array_equal(ts.bins, js.bins)
    np.testing.assert_array_equal(ts.metadata.label, js.metadata.label)
    np.testing.assert_array_equal(ts.metadata.weights, js.metadata.weights)
    assert ts.bin_mappers is subs[1].bin_mappers      # shared, not rebuilt
    jb = _loop(lgj.Booster(BASE, lgj.Dataset(x, y).subset(idx)), 3)
    tb = _loop(lgt.Booster(BASE, lgt.Dataset(x, y).subset(idx), device=CPU),
               3)
    _assert_same_model(jb, tb, x)


def test_dump_model_equals_jax(tmp_path):
    x, y = _data(seed=7)
    tb = lgt.train(BASE, lgt.Dataset(x, y), 3, verbose_eval=False,
                   device=CPU)
    path = str(tmp_path / "m.txt")
    tb.save_model(path)
    dump = tb.dump_model()
    assert dump == lgj.Booster(model_file=path).dump_model()
    assert dump == lgt.Booster(model_file=path, device=CPU).dump_model()
    doc = json.loads(dump)
    assert doc["num_class"] == 1 and len(doc["tree_info"]) == 3


def _logloss_fobj(preds, dataset):
    """Binary logloss by hand on raw scores (objective none: preds are
    raw), sigmoid 1."""
    y = dataset.get_label()
    sign = np.where(y == 1, 1.0, -1.0)
    response = -2.0 * sign / (1.0 + np.exp(2.0 * sign * preds))
    return response, np.abs(response) * (2.0 - np.abs(response))


def test_fobj_trains_the_binary_objectives_trees():
    x, y = _data(seed=8)
    ref = _loop(lgt.Booster(BASE, lgt.Dataset(x, y), device=CPU), 4)
    custom = dict(BASE, objective="none")
    tb = lgt.train(custom, lgt.Dataset(x, y), 4, fobj=_logloss_fobj,
                   verbose_eval=False, device=CPU)
    jb = lgj.train(custom, lgj.Dataset(x, y), 4, fobj=_logloss_fobj,
                   verbose_eval=False)
    assert not tb.gbdt._fused_eligible()
    _assert_same_model(jb, tb, x)
    for a, b in zip(ref.gbdt.models, tb.gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_in_bin, b.threshold_in_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-6)


def _mean_pred(preds, dataset):
    return "mean_pred", float(np.mean(preds)), False


def test_feval_lands_in_evals_result_and_eval():
    x, y = _data(seed=9)
    runs = {}
    for name, pkg, kw in (("jax", lgj, {}), ("torch", lgt, {"device": CPU})):
        ds = pkg.Dataset(x, y)
        va = ds.create_valid(x[:500], y[:500])
        ev = {}
        b = pkg.train(dict(BASE, metric="binary_logloss"), ds, 4,
                      valid_sets=[ds, va], valid_names=["train", "va"],
                      feval=_mean_pred, evals_result=ev, verbose_eval=False,
                      **kw)
        runs[name] = (b, ev, ds, va)
    (jb, jev, _, _), (tb, tev, tds, tva) = runs["jax"], runs["torch"]
    for data in ("train", "va"):
        assert sorted(tev[data]) == sorted(jev[data]) == ["logloss",
                                                          "mean_pred"]
        for key in ("logloss", "mean_pred"):
            assert len(tev[data][key]) == 4
            np.testing.assert_allclose(tev[data][key], jev[data][key],
                                       rtol=0, atol=1e-6)
    got = tb.eval(tva, "va", _mean_pred)
    assert [e[1] for e in got] == ["logloss", "mean_pred"]
    assert got[1][2] == pytest.approx(tev["va"]["mean_pred"][-1], abs=1e-12)
    assert tb.eval(tds, "train", _mean_pred)[0][0] == "train"
    with pytest.raises(lgt.LightGBMError):
        tb.eval(lgt.Dataset(x, y), "other")


@pytest.mark.parametrize("source", ["jax_file", "port_booster"])
def test_init_model_continues_as_jax(source, tmp_path):
    """Three rounds, then three more from the saved model: the port
    chains a JAX-saved file, or its own Booster, into the JAX package's
    trees (the old trees first, init scores from their predictions)."""
    x, y = _data(seed=10)
    path = str(tmp_path / "init.txt")
    if source == "jax_file":
        lgj.train(BASE, lgj.Dataset(x, y), 3, verbose_eval=False).save_model(
            path)
        init_t = path
    else:
        init_t = lgt.train(BASE, lgt.Dataset(x, y), 3, verbose_eval=False,
                           device=CPU)
        init_t.save_model(path)
    jb = lgj.train(BASE, lgj.Dataset(x, y, free_raw_data=False), 3,
                   init_model=path, verbose_eval=False,
                   callbacks=[lambda env: None])
    tb = lgt.train(BASE, lgt.Dataset(x, y, free_raw_data=False), 3,
                   init_model=init_t, verbose_eval=False, device=CPU)
    assert tb.gbdt.num_init_iteration == 3 and tb.current_iteration() == 6
    # the three new trees as the JAX package grows them; the whole
    # chain predicts as the JAX package's
    jt, tt = jb.gbdt.models[3:], tb.gbdt.models[3:]
    for a, b in zip([t.materialize() for t in jt], tt):
        for key in ("split_feature_real", "threshold_in_bin", "left_child",
                    "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0,
                               atol=1e-6)
    text = tb.model_to_string()
    with open(path) as f:
        old = f.read()
    assert text.split("Tree=3")[0].split("Tree=0")[1] == \
        old.split("Tree=0")[1].split("\n\nfeature importances")[0] + "\n"


def test_reset_parameter_learning_rate_schedule():
    x, y = _data(seed=11)
    rates = [0.3, 0.2, 0.1, 0.05]
    jb = lgj.train(BASE, lgj.Dataset(x, y), 4, learning_rates=rates,
                   verbose_eval=False)
    tb = lgt.train(BASE, lgt.Dataset(x, y), 4, learning_rates=rates,
                   verbose_eval=False, device=CPU)
    tc = lgt.train(BASE, lgt.Dataset(x, y), 4, verbose_eval=False,
                   device=CPU, callbacks=[lgt.reset_parameter(
                       learning_rate=lambda i: rates[i])])
    _assert_same_model(jb, tb, x)
    assert tc.model_to_string() == tb.model_to_string()
    assert tb.gbdt.shrinkage_rate == 0.05
    # another parameter rebuilds the config on the same data
    tb.reset_parameter({"num_leaves": 3, "learning_rate": 0.1})
    tb.update()
    assert tb.gbdt.models[-1].num_leaves <= 3
    assert tb.config.num_leaves == 3


@pytest.mark.parametrize("stratified", [False, True],
                         ids=["plain", "stratified"])
def test_cv_matches_jax(stratified):
    x, y = _data(seed=12, n=900)
    params = dict(BASE, metric="binary_logloss,auc")
    jr = lgj.cv(params, lgj.Dataset(x, y), 2, nfold=3,
                stratified=stratified, seed=4)
    tr = lgt.cv(params, lgt.Dataset(x, y), 2, nfold=3,
                stratified=stratified, seed=4, device=CPU)
    assert sorted(tr) == sorted(jr)
    for key in jr:
        assert len(tr[key]) == 2
        np.testing.assert_allclose(tr[key], jr[key], rtol=0, atol=1e-6)


def test_stratified_folds_equal_sklearn():
    from sklearn.model_selection import StratifiedKFold
    from lightgbm_tpu_torch.engine import _stratified_folds
    y = np.random.RandomState(13).randint(0, 4, 301)
    want = [t for _, t in StratifiedKFold(5, shuffle=True,
                                          random_state=7).split(y, y)]
    got = _stratified_folds(y, 5, True, 7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra,atol", [
    ({"scale_pos_weight": 3.0}, 2e-6), ({"is_unbalance": True}, 1e-6)],
    ids=["scale_pos_weight3", "is_unbalance"])
def test_class_weights_match_jax(extra, atol):
    """Bound 2e-6 with scale_pos_weight=3: the frameworks' float32 exp
    differ in the last bit on a few percent of gradients, and the 3x
    weight scales that gap (a leaf differed by 1.45e-6)."""
    x, y = _data(seed=14)
    y[:700] = 0.0                                   # unbalanced
    params = dict(BASE, **extra)
    jb = _loop(lgj.Booster(params, lgj.Dataset(x, y)), 4)
    tb = _loop(lgt.Booster(params, lgt.Dataset(x, y), device=CPU), 4)
    _assert_same_model(jb, tb, x, atol)


def _write_wide_libsvm(path):
    """A LibSVM file with feature ids past 1024 (the O(nnz) streaming
    route) whose sparse columns are bundling candidates; returns its
    dense matrix."""
    rng = np.random.RandomState(3)
    x = np.zeros((200, 1100), np.float32)
    with open(path, "w") as f:
        for i in range(200):
            cols = np.unique(rng.choice(1100, 5, replace=False))
            vals = [float(f"{rng.rand():.6g}") for _ in cols]
            x[i, cols] = vals
            f.write(" ".join([str(i % 2)] + [f"{c}:{v:.6g}" for c, v
                                             in zip(cols, vals)]) + "\n")
    return x


def test_wide_libsvm_bundling_trains_as_jax():
    """Dataset(path) on the wide LibSVM file bundles its sparse columns
    as the JAX package does (same plan, same slot matrix) and trains to
    the JAX package's trees."""
    params = dict(BASE, min_data_in_leaf=5, verbose=-1)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "wide.svm")
        x = _write_wide_libsvm(path)
        jd = lgj.Dataset(path, params=params).construct()
        td = lgt.Dataset(path, params=params).construct()
        jc, tc = jd._core, td._core
        assert tc.bundle_plan is not None
        assert tc.bins.shape[0] < tc.num_features
        for k, v in jc.bundle_plan.to_dict().items():
            np.testing.assert_array_equal(tc.bundle_plan.to_dict()[k], v)
        np.testing.assert_array_equal(tc.bins, jc.bins)
        jb = _loop(lgj.Booster(params, jd), 3)
        tb = _loop(lgt.Booster(params, td, device=CPU), 3)
    _assert_same_model(jb, tb, x)


def _train_dart():
    b = lgt.train(dict(BASE, boosting_type="dart"),
                  lgt.Dataset(*_data(n=300)), 1, device=CPU)
    assert type(b.gbdt).__name__ == "DART"
    assert b.current_iteration() == 1


def _cli_snapshots():
    app = Application(["task=train", "snapshot_freq=2"], device=CPU)
    assert app.config.snapshot_freq == 2


def _resume_from():
    with tempfile.TemporaryDirectory() as d:
        b = lgt.train(BASE, lgt.Dataset(*_data(n=300)), 1, device=CPU,
                      resume_from=d)     # no snapshot: a cold start
    assert b.current_iteration() == 1


def _train_out_of_core():
    params = dict(BASE, out_of_core=True)
    b = lgt.train(params, lgt.Dataset(*_data(n=300), params=params), 1,
                  device=CPU)
    assert b.gbdt.tree_learner.name == "out_of_core"
    assert b.current_iteration() == 1


@pytest.mark.parametrize("call", [
    _cli_snapshots, _resume_from, _train_dart, _train_out_of_core,
    # the in-process mesh trains (tests/test_torch_parallel.py); a
    # machine list is the multi-process runtime's
    lambda: lgt.train(dict(BASE, tree_learner="data", num_machines=2,
                           machine_list_file="mlist.txt"),
                      lgt.Dataset(*_data(n=300)), 1, device=CPU),
], ids=["cli_snapshots", "resume_from", "dart",
        "out_of_core", "parallel"])
def test_remaining_refusals_name_their_roadmap_item(call):
    if call in (_cli_snapshots, _resume_from, _train_dart,
                _train_out_of_core):
        # the port's now: each runs (its refusal went)
        call()
        return
    with pytest.raises(NotImplementedError) as err:
        call()
    msg = str(err.value)
    assert "ROADMAP" in msg and "queue 1" in msg
    assert re.search(r"item \d", msg), msg
