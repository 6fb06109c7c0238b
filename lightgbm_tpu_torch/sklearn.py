"""Scikit-learn wrapper interface (port of lightgbm_tpu/sklearn.py).

Reference: python-package/lightgbm/sklearn.py:27-622. The same estimator
surface (LGBMModel / LGBMRegressor / LGBMClassifier / LGBMRanker), the
same parameter names (sklearn names -> native names through the alias
table), the same custom-objective wrapper translating
``(y_true, y_pred[, group]) -> (grad, hess)`` into the engine's
``fobj(preds, dataset)`` contract, and label encoding for classifiers.

Every constructor takes ``device`` (None: the CUDA card, raising when
there is none; "cpu" for the kernels' plain versions). It is a plain
estimator parameter, so ``get_params``, ``clone`` and ``GridSearchCV``
carry it, and ``fit`` trains on it (``train(..., device=)``), never as
a native training parameter.

Where scikit-learn imports, the bases are its BaseEstimator and mixins,
as in the JAX package. Where it does not, the estimators stand on
``object``: ``get_params``/``set_params`` come from the constructor's
signature and the classifier's labels are encoded by ``np.unique``.

``fit`` takes one of the engine's three routes (engine.py): with no
eval set the fast path (one fused block, GBDT.train_many); with an eval
set, early stopping or a callable metric the blockwise path; with a
callable objective the per-iteration loop.
"""

import inspect

import numpy as np

from .basic import Dataset, LightGBMError
from .engine import train

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    from sklearn.preprocessing import LabelEncoder
    SKLEARN_INSTALLED = True
except ImportError:
    SKLEARN_INSTALLED = False


class _ParamsBase:
    """get_params / set_params from the constructor's signature: the
    BaseEstimator surface where scikit-learn is absent."""

    @classmethod
    def _get_param_names(cls):
        sig = inspect.signature(cls.__init__)
        return sorted(p.name for p in sig.parameters.values()
                      if p.name != "self" and p.kind not in (
                          p.VAR_POSITIONAL, p.VAR_KEYWORD))

    def get_params(self, deep=True):
        return {name: getattr(self, name) for name in self._get_param_names()}

    def set_params(self, **params):
        valid = self._get_param_names()
        for key, value in params.items():
            if key not in valid:
                raise ValueError(f"Invalid parameter {key!r} for estimator "
                                 f"{type(self).__name__}")
            setattr(self, key, value)
        return self


class _UniqueLabelEncoder:
    """LabelEncoder's fit / transform / inverse_transform over
    np.unique(..., return_inverse=True)."""

    def fit(self, y):
        self.classes_ = np.unique(np.asarray(y).reshape(-1))
        return self

    def transform(self, y):
        y = np.asarray(y).reshape(-1)
        classes, inverse = np.unique(y, return_inverse=True)
        unseen = np.setdiff1d(classes, self.classes_)
        if len(unseen):
            raise ValueError(f"y contains previously unseen labels: "
                             f"{unseen.tolist()}")
        return np.searchsorted(self.classes_, classes)[inverse]

    def inverse_transform(self, y):
        return self.classes_[np.asarray(y, dtype=np.int64)]


if SKLEARN_INSTALLED:
    LGBMModelBase = BaseEstimator
    LGBMRegressorBase = RegressorMixin
    LGBMClassifierBase = ClassifierMixin
    LGBMLabelEncoder = LabelEncoder
else:
    LGBMModelBase = _ParamsBase
    LGBMRegressorBase = object
    LGBMClassifierBase = object
    LGBMLabelEncoder = _UniqueLabelEncoder


def _objective_function_wrapper(func):
    """sklearn.py:27-84: wrap (y_true, y_pred[, group]) -> grad, hess into
    fobj(preds, dataset); weights multiply grad/hess."""

    argc = len(inspect.getfullargspec(func).args)

    def inner(preds, dataset):
        labels = dataset.get_label()
        if argc == 2:
            grad, hess = func(labels, preds)
        elif argc == 3:
            grad, hess = func(labels, preds, dataset.get_group())
        else:
            raise TypeError("Self-defined objective function should have 2 or "
                            "3 arguments, got %d" % argc)
        weight = dataset.get_weight()
        if weight is not None:
            grad = np.asarray(grad, dtype=np.float64)
            hess = np.asarray(hess, dtype=np.float64)
            if len(weight) == len(grad):
                grad = grad * weight
                hess = hess * weight
            else:
                num_data = len(weight)
                num_class = len(grad) // num_data
                if num_class * num_data != len(grad):
                    raise ValueError("Length of grad and hess should equal to "
                                     "num_class * num_data")
                w = np.tile(np.asarray(weight), num_class)
                grad = grad * w
                hess = hess * w
        return grad, hess
    return inner


def _eval_function_wrapper(func):
    """sklearn.py:86-131: wrap (y_true, y_pred[, weight[, group]]) ->
    (name, value, bigger_better) into feval(preds, dataset)."""

    argc = len(inspect.getfullargspec(func).args)

    def inner(preds, dataset):
        labels = dataset.get_label()
        if argc == 2:
            return func(labels, preds)
        if argc == 3:
            return func(labels, preds, dataset.get_weight())
        if argc == 4:
            return func(labels, preds, dataset.get_weight(), dataset.get_group())
        raise TypeError("Self-defined eval function should have 2, 3 or 4 "
                        "arguments, got %d" % argc)
    return inner


class LGBMModel(LGBMModelBase):
    """Base estimator (sklearn.py:133-455)."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=10, max_bin=255,
                 silent=True, objective="regression",
                 nthread=-1, min_split_gain=0, min_child_weight=5,
                 min_child_samples=10, subsample=1, subsample_freq=1,
                 colsample_bytree=1, reg_alpha=0, reg_lambda=0,
                 scale_pos_weight=1, is_unbalance=False, seed=0,
                 device=None):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.max_bin = max_bin
        self.silent = silent
        self.objective = objective
        self.nthread = nthread
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.scale_pos_weight = scale_pos_weight
        self.is_unbalance = is_unbalance
        self.seed = seed
        self.device = device
        self._Booster = None
        self.best_iteration = -1
        self.evals_result_ = None
        if callable(self.objective):
            self.fobj = _objective_function_wrapper(self.objective)
        else:
            self.fobj = None

    def booster(self):
        if self._Booster is None:
            raise LightGBMError("Need to call fit beforehand")
        return self._Booster

    def get_params(self, deep=False):
        params = super().get_params(deep=deep)
        params.pop("silent", None)
        if params.get("nthread", 1) <= 0:
            params.pop("nthread", None)
        return params

    def fit(self, X, y,
            sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None,
            eval_metric=None,
            early_stopping_rounds=None, verbose=True,
            feature_name=None, categorical_feature=None,
            other_params=None):
        """sklearn.py:265-395."""
        evals_result = {}
        params = self.get_params()
        params["verbose"] = 0 if self.silent else 1
        # the estimator's device is where train() runs, not a native
        # training parameter
        params.pop("device", None)

        if self.fobj:
            params["objective"] = "none"
        else:
            params["objective"] = self.objective
        if other_params is not None:
            params.update(other_params)
        # get_params returns the estimator's constructor kwargs; drop the
        # ones that are not native training parameters
        params.pop("n_estimators", None)

        if callable(eval_metric):
            feval = _eval_function_wrapper(eval_metric)
        elif isinstance(eval_metric, (str, list)):
            feval = None
            params.update({"metric": eval_metric})
        else:
            feval = None

        def _construct_dataset(X, y, sample_weight, init_score, group, params):
            ret = Dataset(X, label=y, max_bin=self.max_bin,
                          weight=sample_weight, group=group, params=params)
            ret.set_init_score(init_score)
            return ret

        train_set = _construct_dataset(X, y, sample_weight, init_score,
                                       group, params)

        valid_sets = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, valid_data in enumerate(eval_set):
                if valid_data[0] is X and valid_data[1] is y:
                    valid_set = train_set
                else:
                    def get_meta(collection, i):
                        if collection is None:
                            return None
                        if isinstance(collection, dict):
                            return collection.get(i, None)
                        return collection[i]
                    valid_set = _construct_dataset(
                        valid_data[0], valid_data[1],
                        get_meta(eval_sample_weight, i),
                        get_meta(eval_init_score, i),
                        get_meta(eval_group, i), params)
                valid_sets.append(valid_set)

        if not valid_sets:
            # with no eval set nothing evaluates a training metric:
            # metric_freq 0 says so, and with no valid set and no history
            # recorder train() takes its fast path (one fused block)
            params.setdefault("metric_freq", 0)
        self._Booster = train(params, train_set, self.n_estimators,
                              valid_sets=valid_sets or None,
                              early_stopping_rounds=early_stopping_rounds,
                              evals_result=evals_result if valid_sets else None,
                              fobj=self.fobj, feval=feval,
                              verbose_eval=verbose,
                              feature_name=feature_name,
                              categorical_feature=categorical_feature,
                              device=self.device)

        if evals_result:
            self.evals_result_ = evals_result
        if early_stopping_rounds is not None:
            self.best_iteration = self._Booster.best_iteration
        return self

    def predict(self, data, raw_score=False, num_iteration=0):
        return self.booster().predict(data, raw_score=raw_score,
                                      num_iteration=num_iteration)

    def apply(self, X, num_iteration=0):
        """Predicted leaf index of every tree for each sample."""
        return self.booster().predict(X, pred_leaf=True,
                                      num_iteration=num_iteration)

    def evals_result(self):
        if self.evals_result_:
            return self.evals_result_
        raise LightGBMError("No results found.")

    def feature_importance(self):
        """Normalized split-count importances (sklearn.py:448-455)."""
        importance = self._Booster.feature_importance().astype(np.float32)
        return importance / importance.sum()

    @property
    def feature_importances_(self):
        """Raw split-count importances (the reference sklearn surface;
        `booster().feature_importance(importance_type='gain')` for the
        gain variant)."""
        return self.booster().feature_importance(importance_type="split")


class LGBMRegressor(LGBMModel, LGBMRegressorBase):

    def fit(self, X, y,
            sample_weight=None, init_score=None,
            eval_set=None, eval_sample_weight=None,
            eval_init_score=None,
            eval_metric="l2",
            early_stopping_rounds=None, verbose=True,
            feature_name=None, categorical_feature=None,
            other_params=None):
        super().fit(X, y, sample_weight, init_score, None,
                    eval_set, eval_sample_weight, eval_init_score, None,
                    eval_metric, early_stopping_rounds, verbose,
                    feature_name, categorical_feature, other_params)
        return self


class LGBMClassifier(LGBMModel, LGBMClassifierBase):

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=10, max_bin=255,
                 silent=True, objective="binary",
                 nthread=-1, min_split_gain=0, min_child_weight=5,
                 min_child_samples=10, subsample=1, subsample_freq=1,
                 colsample_bytree=1, reg_alpha=0, reg_lambda=0,
                 scale_pos_weight=1, is_unbalance=False, seed=0,
                 device=None):
        super().__init__(boosting_type, num_leaves, max_depth, learning_rate,
                         n_estimators, max_bin, silent, objective, nthread,
                         min_split_gain, min_child_weight, min_child_samples,
                         subsample, subsample_freq, colsample_bytree,
                         reg_alpha, reg_lambda, scale_pos_weight,
                         is_unbalance, seed, device)

    def fit(self, X, y,
            sample_weight=None, init_score=None,
            eval_set=None, eval_sample_weight=None,
            eval_init_score=None,
            eval_metric="binary_logloss",
            early_stopping_rounds=None, verbose=True,
            feature_name=None, categorical_feature=None,
            other_params=None):
        self.classes_ = np.unique(y)
        self.n_classes_ = len(self.classes_)
        other_params = {} if other_params is None else dict(other_params)
        if self.n_classes_ > 2:
            # the reference mutates self.objective here (sklearn.py:512),
            # which breaks refitting the same estimator on binary data;
            # the override goes through params instead
            if self.fobj is None:
                other_params["objective"] = "multiclass"
            other_params["num_class"] = self.n_classes_
            # with or without an eval set: the JAX package keeps
            # binary_logloss without one, which its config refuses
            # beside the multiclass objective
            if eval_metric == "binary_logloss":
                eval_metric = "multi_logloss"

        self._le = LGBMLabelEncoder().fit(y)
        training_labels = self._le.transform(y)
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            eval_set = [(x[0], self._le.transform(x[1])) for x in eval_set]

        super().fit(X, training_labels, sample_weight, init_score, None,
                    eval_set, eval_sample_weight, eval_init_score, None,
                    eval_metric, early_stopping_rounds, verbose,
                    feature_name, categorical_feature, other_params)
        return self

    def predict(self, data, raw_score=False, num_iteration=0):
        class_probs = self.booster().predict(data, raw_score=raw_score,
                                             num_iteration=num_iteration)
        if len(class_probs.shape) > 1:
            column_indexes = np.argmax(class_probs, axis=1)
        else:
            column_indexes = np.repeat(0, class_probs.shape[0])
            column_indexes[class_probs > 0.5] = 1
        return self._le.inverse_transform(column_indexes)

    def predict_proba(self, data, raw_score=False, num_iteration=0):
        class_probs = self.booster().predict(data, raw_score=raw_score,
                                             num_iteration=num_iteration)
        if self.n_classes_ > 2:
            return class_probs
        classone_probs = class_probs
        classzero_probs = 1.0 - classone_probs
        return np.vstack((classzero_probs, classone_probs)).transpose()


class LGBMRanker(LGBMModel):

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=10, max_bin=255,
                 silent=True, objective="lambdarank",
                 nthread=-1, min_split_gain=0, min_child_weight=5,
                 min_child_samples=10, subsample=1, subsample_freq=1,
                 colsample_bytree=1, reg_alpha=0, reg_lambda=0,
                 scale_pos_weight=1, is_unbalance=False, seed=0,
                 device=None):
        super().__init__(boosting_type, num_leaves, max_depth, learning_rate,
                         n_estimators, max_bin, silent, objective, nthread,
                         min_split_gain, min_child_weight, min_child_samples,
                         subsample, subsample_freq, colsample_bytree,
                         reg_alpha, reg_lambda, scale_pos_weight,
                         is_unbalance, seed, device)

    def fit(self, X, y,
            sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None,
            eval_metric="ndcg", eval_at=1,
            early_stopping_rounds=None, verbose=True,
            feature_name=None, categorical_feature=None,
            other_params=None):
        """sklearn.py:570-622. `eval_at`: NDCG evaluation positions."""
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None:
            if eval_group is None:
                raise ValueError("Eval_group cannot be None when eval_set "
                                 "is not None")
            if len(eval_group) != len(eval_set):
                raise ValueError("Length of eval_group should equal to "
                                 "eval_set")
            for inner_group in (eval_group.values()
                                if isinstance(eval_group, dict) else eval_group):
                if inner_group is None:
                    raise ValueError("Should set group for all eval dataset "
                                     "for ranking task")
        if eval_at is not None:
            other_params = {} if other_params is None else other_params
            if isinstance(eval_at, int):
                eval_at = [eval_at]
            other_params["ndcg_eval_at"] = list(eval_at)
        super().fit(X, y, sample_weight, init_score, group,
                    eval_set, eval_sample_weight, eval_init_score, eval_group,
                    eval_metric, early_stopping_rounds, verbose,
                    feature_name, categorical_feature, other_params)
        return self
