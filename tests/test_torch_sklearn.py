"""lightgbm_tpu_torch's scikit-learn estimators against lightgbm_tpu's,
on the CPU.

The same splits of load_breast_cancer (binary), load_diabetes
(regression) and load_digits (multiclass) go through both packages'
estimators with an eval set and early stopping (the blockwise route):
trees structurally equal (features, thresholds, leaf counts),
best_iteration equal, predictions within 1e-6 absolute. min_split_gain
drops the noise-level splits (gains of 3e-5 on 512 rows) whose order the
two packages' float32 sums can swap (ROADMAP queue 3's near-ties). The
ranker, the routes, a custom objective, clone, GridSearchCV and
`device` are checked on the port alone, and the estimators without
scikit-learn in a subprocess.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from sklearn.base import clone
from sklearn.datasets import load_breast_cancer, load_diabetes, load_digits
from sklearn.model_selection import GridSearchCV, train_test_split

import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models.gbdt import GBDT
from test_torch_train import _trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ATOL = 1e-6
CASES = {
    "breast_cancer": (load_breast_cancer, "LGBMClassifier",
                      dict(n_estimators=40, num_leaves=15,
                           min_child_samples=10, min_split_gain=1e-2,
                           learning_rate=0.3)),
    "diabetes": (load_diabetes, "LGBMRegressor",
                 dict(n_estimators=40, num_leaves=15, min_child_samples=10,
                      learning_rate=0.3)),
    "digits": (load_digits, "LGBMClassifier",
               dict(n_estimators=10, num_leaves=7, min_child_samples=10,
                    min_split_gain=1e-2)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split(name):
    loader, est, _ = CASES[name]
    x, y = loader(return_X_y=True)
    return train_test_split(x, y, test_size=0.1, random_state=42,
                            stratify=None if est == "LGBMRegressor" else y)


def _fit(pkg, name, **kw):
    _, est, params = CASES[name]
    xtr, xte, ytr, yte = _split(name)
    model = getattr(pkg, est)(**params, **kw)
    model.fit(xtr, ytr, eval_set=[(xte, yte)], early_stopping_rounds=5,
              verbose=False)
    return model, xte


@pytest.fixture(scope="module")
def jax_fits():
    # one JAX fit a dataset: each new shape compiles for 20-40 s
    return {name: _fit(lgj, name)[0] for name in CASES}


def _answer(model, x):
    return (model.predict_proba(x) if hasattr(model, "predict_proba")
            else model.predict(x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_estimator_matches_jax(jax_fits, name):
    jm = jax_fits[name]
    tm, xte = _fit(lgt, name, device=CPU)
    assert tm.best_iteration == jm.best_iteration
    jt, tt = _trees(jm.booster()), _trees(tm.booster())
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        for key in ("split_feature_real", "threshold_in_bin", "leaf_count"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                          err_msg=key)
    np.testing.assert_allclose(_answer(tm, xte), _answer(jm, xte), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(tm.predict(xte), jm.predict(xte))
    assert tm.evals_result_.keys() == jm.evals_result_.keys()


def _routes(monkeypatch):
    calls = []
    for meth in ("train_many", "train_many_eval"):
        orig = getattr(GBDT, meth)

        def spy(self, *a, _orig=orig, _meth=meth, **k):
            calls.append(_meth)
            return _orig(self, *a, **k)
        monkeypatch.setattr(GBDT, meth, spy)
    return calls


def _objective_ls(y_true, y_pred):
    return y_pred - y_true, np.ones(len(y_true))


@pytest.mark.parametrize("route", ["fast", "blockwise", "custom"])
def test_fit_takes_the_engine_route(monkeypatch, route):
    """No eval set: one fused block; an eval set with early stopping:
    the blockwise path; a callable objective: the per-iteration loop."""
    xtr, xte, ytr, yte = _split("diabetes")
    calls = _routes(monkeypatch)
    kw = {"objective": _objective_ls} if route == "custom" else {}
    model = lgt.LGBMRegressor(n_estimators=4, num_leaves=7, device=CPU, **kw)
    fit_kw = ({"eval_set": [(xte, yte)], "early_stopping_rounds": 2}
              if route == "blockwise" else {})
    model.fit(xtr, ytr, verbose=False, **fit_kw)
    assert calls == {"fast": ["train_many"], "blockwise": ["train_many_eval"],
                     "custom": []}[route]
    assert model.booster().current_iteration() == 4
    assert np.isfinite(model.predict(xte)).all()


def _logloss(y_true, y_pred):
    """Binary logloss by hand on raw scores, the binary objective's
    sigmoid of 1 (tests/test_torch_api.py _logloss_fobj)."""
    sign = np.where(y_true == 1, 1.0, -1.0)
    response = -2.0 * sign / (1.0 + np.exp(2.0 * sign * y_pred))
    return response, np.abs(response) * (2.0 - np.abs(response))


def test_custom_objective_grows_the_binary_objectives_trees():
    xtr, xte, ytr, yte = _split("breast_cancer")
    kw = dict(n_estimators=5, num_leaves=7, min_split_gain=1e-2, device=CPU)
    ref = lgt.LGBMClassifier(**kw).fit(xtr, ytr, verbose=False)
    custom = lgt.LGBMClassifier(objective=_logloss, **kw).fit(
        xtr, ytr, verbose=False)
    for a, b in zip(_trees(ref.booster()), _trees(custom.booster())):
        np.testing.assert_array_equal(a.split_feature_real,
                                      b.split_feature_real)
        np.testing.assert_array_equal(a.threshold_in_bin, b.threshold_in_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=ATOL)


def test_ranker_trains_and_ranks():
    rng = np.random.RandomState(7)
    n_q, per_q = 40, 12
    x = rng.rand(n_q * per_q, 5)
    relevance = (x[:, 0] * 3).astype(int).clip(0, 3)
    group = np.full(n_q, per_q)
    model = lgt.LGBMRanker(n_estimators=6, min_child_samples=5, device=CPU)
    model.fit(x, relevance, group=group, eval_set=[(x, relevance)],
              eval_group=[group], eval_at=[1, 3], verbose=False)
    assert model.booster().current_iteration() == 6
    ndcg = model.evals_result_["training"]
    assert ndcg["ndcg@1"][-1] > ndcg["ndcg@1"][0] - 1e-12
    # the ranking follows the relevance in every query
    score = model.predict(x).reshape(n_q, per_q)
    rel = relevance.reshape(n_q, per_q)
    top = rel[np.arange(n_q), score.argmax(1)]
    assert top.mean() > rel.mean()
    with pytest.raises(ValueError):
        lgt.LGBMRanker(device=CPU).fit(x, relevance)


def test_device_is_an_estimator_parameter():
    model = lgt.LGBMRegressor(n_estimators=3, device=CPU)
    assert model.get_params()["device"] == CPU
    assert clone(model).device == CPU
    assert model.set_params(device="cuda").device == "cuda"
    xtr, xte, ytr, yte = _split("diabetes")
    grid = GridSearchCV(lgt.LGBMRegressor(num_leaves=7, device=CPU),
                        {"n_estimators": [2, 4]}, cv=2)
    grid.fit(xtr, ytr)
    assert grid.best_params_["n_estimators"] in (2, 4)
    assert grid.best_estimator_.device == CPU
    assert grid.best_estimator_.booster().device.type == CPU


NO_SKLEARN = r"""
import sys
sys.modules["sklearn"] = None      # import sklearn raises ImportError
import numpy as np
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import sklearn as sk
assert not sk.SKLEARN_INSTALLED and "sklearn.base" not in sys.modules
x, y = np.load(sys.argv[1])["x"], np.load(sys.argv[1])["y"]
labels = np.array(["no", "yes"])[y.astype(int)]
m = lgt.LGBMClassifier(n_estimators=3, num_leaves=7, device="cpu")
assert m.get_params()["device"] == "cpu"
assert m.set_params(num_leaves=7) is m
m.fit(x, labels, verbose=False)
assert set(m.predict(x)) <= {"no", "yes"}
np.savez(sys.argv[2], proba=m.predict_proba(x),
         text=np.array(m.booster().model_to_string()))
"""


def test_estimators_run_without_sklearn(tmp_path):
    """The estimator surface on a machine without scikit-learn (the H100
    machine has none): bases of object, get_params from the signature,
    labels encoded by np.unique — the model of the sklearn-based
    estimator, byte for byte."""
    xtr, _, ytr, _ = _split("breast_cancer")
    np.savez(tmp_path / "data.npz", x=xtr, y=ytr)
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", NO_SKLEARN, str(tmp_path /
                    "data.npz"), str(tmp_path / "out.npz")], check=True,
                   env=env, cwd=str(tmp_path), timeout=300)
    out = np.load(tmp_path / "out.npz")
    labels = np.array(["no", "yes"])[ytr.astype(int)]
    ref = lgt.LGBMClassifier(n_estimators=3, num_leaves=7, device=CPU)
    ref.fit(xtr, labels, verbose=False)
    assert str(out["text"]) == ref.booster().model_to_string()
    np.testing.assert_array_equal(out["proba"], ref.predict_proba(xtr))
