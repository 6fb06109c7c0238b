"""Public Dataset / Booster API (port of lightgbm_tpu/basic.py :92, :303).

Reference: python-package/lightgbm/basic.py. The same public surface
delegates to the PyTorch core (io.dataset.CoreDataset, models.gbdt.GBDT).
A Booster lives on one torch.device: CUDA unless the caller passes
device="cpu"; with no card and no device it raises.

This slice binds in-memory matrices, with categorical columns by index
or by name (`categorical_feature`). Text files, init-model chaining,
subsets and custom objectives through `update(fobj=...)` are later
slices.
"""

import numpy as np

from .config import Config, key_alias_transform
from .io.dataset import DatasetLoader
from .metrics import create_metric
from .models.gbdt import GBDT, create_boosting
from .objectives import create_objective
from .utils.log import LightGBMError, Log


def _coerce_2d(data):
    """numpy 2-D / pandas / list-of-rows -> float32 ndarray."""
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values
    arr = np.asarray(data, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return np.ascontiguousarray(arr)


def _coerce_label(label):
    if label is None:
        return None
    if hasattr(label, "values") and not isinstance(label, np.ndarray):
        label = label.values
    return np.asarray(label, dtype=np.float32).reshape(-1)


class Dataset:
    """Lazy dataset (basic.py:893-1183): stores raw inputs and bins them
    on first use, so `reference=` alignment can be attached first."""

    def __init__(self, data, label=None, max_bin=255, reference=None,
                 weight=None, silent=False, feature_name=None,
                 categorical_feature=None, params=None, free_raw_data=True):
        if isinstance(data, str):
            raise NotImplementedError("loading text files is a later slice "
                                      "of lightgbm_tpu_torch")
        self.data = data
        self.label = _coerce_label(label)
        self.max_bin = max_bin
        self.reference = reference
        self.weight = weight
        self.silent = silent
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self.free_raw_data = free_raw_data
        self._core = None

    def construct(self) -> "Dataset":
        if self._core is not None:
            return self
        params = key_alias_transform(dict(self.params))
        params.setdefault("max_bin", self.max_bin)
        if self.silent:
            params.setdefault("verbose", 0)
        loader = DatasetLoader(Config.from_params(params))
        ref_core = None
        if self.reference is not None:
            if not isinstance(self.reference, Dataset):
                raise TypeError("Reference dataset should be None or dataset")
            ref_core = self.reference.construct()._core
        self._core = loader.construct_from_matrix(
            _coerce_2d(self.data), label=self.label, reference=ref_core,
            categorical_features=self._resolve_categorical())
        if self.feature_name is not None:
            self._core.feature_names = list(self.feature_name)
        if self.weight is not None:
            self._core.metadata.set_weights(
                np.asarray(self.weight, dtype=np.float32).reshape(-1))
        if self.free_raw_data:
            self.data = None
        return self

    def _resolve_categorical(self):
        """Categorical column indices; names resolve through
        feature_name (lightgbm_tpu basic.py _resolve_categorical)."""
        cats = []
        for c in self.categorical_feature or ():
            if isinstance(c, str):
                if not self.feature_name:
                    raise LightGBMError(
                        "categorical_feature by name needs feature_name")
                cats.append(list(self.feature_name).index(c))
            else:
                cats.append(int(c))
        return cats

    def set_categorical_feature(self, categorical_feature):
        """basic.py set_categorical_feature: only before construction."""
        if categorical_feature is None:
            return
        if self._core is not None:
            Log.warning("categorical_feature set after Dataset was "
                        "constructed; ignoring")
            return
        self.categorical_feature = categorical_feature

    def create_valid(self, data, label=None, weight=None, silent=False,
                     params=None):
        """New Dataset aligned with self (basic.py:947-971)."""
        return Dataset(data, label=label, max_bin=self.max_bin,
                       reference=self, weight=weight, silent=silent,
                       params=params)

    def set_feature_name(self, feature_name):
        if feature_name is not None:
            self.feature_name = list(feature_name)
            if self._core is not None:
                self._core.feature_names = list(feature_name)

    def get_label(self):
        if self._core is not None:
            return self._core.metadata.label
        return self.label

    def num_data(self):
        return self.construct()._core.num_data

    def num_feature(self):
        return self.construct()._core.num_features


class Booster:
    """Training/prediction handle (basic.py:1184-1677)."""

    def __init__(self, params=None, train_set=None, model_file=None,
                 silent=False, device=None):
        self.best_iteration = -1
        self._attr = {}
        self._train_data_name = "training"
        self._train_dataset = None
        self._valid_datasets = []
        self._name_valid_sets = []
        self.config = None
        self.objective = None
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            params = dict(params) if params else {}
            if silent:
                params.setdefault("verbose", 0)
            self.config = Config.from_params(params)
            self.config.check_slice()
            self.gbdt = create_boosting(self.config.boosting_type, device)
            train_set.construct()
            core = train_set._core
            self.objective = create_objective(self.config.objective,
                                              self.config)
            if self.objective is None:
                Log.warning("Using self-defined objective function")
            else:
                self.objective.init(core.metadata, core.num_data,
                                    self.gbdt.device)
            self.gbdt.init(self.config, core, self.objective,
                           self._create_metrics(core))
            self._train_dataset = train_set
        elif model_file is not None:
            self.gbdt = GBDT(device)
            with open(model_file) as f:
                self.gbdt.load_model_from_string(f.read())
        else:
            raise TypeError("At least need training dataset or model file "
                            "to create booster instance")

    @property
    def device(self):
        return self.gbdt.device

    def _create_metrics(self, core):
        metrics = []
        for name in (self.config.metric or ()):
            m = create_metric(name, self.config)
            if m is None:
                continue
            m.init(core.metadata, core.num_data)
            metrics.append(m)
        return metrics

    def set_train_data_name(self, name):
        self._train_data_name = name

    def add_valid(self, data, name):
        """basic.py:1252-1280."""
        data.construct()
        self.gbdt.add_valid_dataset(data._core,
                                    self._create_metrics(data._core))
        self._valid_datasets.append(data)
        self._name_valid_sets.append(name)

    # ------------------------------------------------------------- training
    def update(self, fobj=None):
        """One boosting iteration (basic.py:1304-1341). Returns True when
        no further splits are possible."""
        if fobj is not None:
            raise NotImplementedError("custom objectives are a later slice "
                                      "of lightgbm_tpu_torch")
        return self.gbdt.train_one_iter(is_eval=False)

    def rollback_one_iter(self):
        """Drop the last iteration's trees and their scores
        (basic.py:434)."""
        self.gbdt.rollback_one_iter()

    def current_iteration(self):
        return len(self.gbdt.models) // max(self.gbdt.num_class, 1)

    # ----------------------------------------------------------- evaluation
    def _inner_eval(self, data_name, data_idx):
        names = self.gbdt.get_eval_names(data_idx)
        values = self.gbdt.get_eval_at(data_idx)
        metrics = (self.gbdt.training_metrics if data_idx == 0
                   else self.gbdt.valid_metrics[data_idx - 1])
        factors = [m.factor_to_bigger_better for m in metrics
                   for _ in m.names]
        return [(data_name, name, value, fac > 0)
                for name, value, fac in zip(names, values, factors)]

    def eval_train(self):
        return self._inner_eval(self._train_data_name, 0)

    def eval_valid(self):
        out = []
        for i, name in enumerate(self._name_valid_sets):
            out.extend(self._inner_eval(name, i + 1))
        return out

    # ----------------------------------------------------------- prediction
    def predict(self, data, num_iteration=-1, raw_score=False,
                pred_leaf=False, is_reshape=True):
        """Predictions of raw rows on the booster's device."""
        data = _coerce_2d(data)
        if pred_leaf:
            return self.gbdt.predict_leaf_index(data, num_iteration)
        if raw_score:
            out = self.gbdt.predict_raw(data, num_iteration)
        else:
            out = self.gbdt.predict(data, num_iteration)
        if is_reshape and self.gbdt.num_class == 1:
            return out.reshape(-1)
        return out if is_reshape else out.reshape(-1, order="F")

    # -------------------------------------------------------- serialization
    def save_model(self, filename, num_iteration=-1):
        self.gbdt.save_model_to_file(num_iteration, filename)

    def model_to_string(self, num_iteration=-1):
        return self.gbdt.save_model_to_string(num_iteration)

    def feature_importance(self, importance_type="split"):
        if importance_type not in ("split", "gain"):
            raise LightGBMError(f"Unknown importance type {importance_type!r}")
        return self.gbdt.feature_importance_values(importance_type)

    def attr(self, key):
        return self._attr.get(key)

    def set_attr(self, **kwargs):
        for key, value in kwargs.items():
            if value is None:
                self._attr.pop(key, None)
            else:
                self._attr[key] = str(value)
