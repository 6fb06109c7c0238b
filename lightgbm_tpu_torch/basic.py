"""Public Dataset / Booster API (port of lightgbm_tpu/basic.py).

Reference: python-package/lightgbm/basic.py. The same public surface
delegates to the PyTorch core (io.dataset.CoreDataset, models.gbdt.GBDT).
A Booster lives on one torch.device: CUDA unless the caller passes
device="cpu"; with no card and no device it raises.

A Dataset takes an in-memory matrix, a scipy sparse matrix (binned one
column at a time through CscColumns, never densified), or a path: a
CSV/TSV/LibSVM file or a binary cache (`save_binary`). It is built
lazily, on the device of the Booster that first uses it
(construct(device=)): there a dense float32 matrix is binned on the
card. Categorical columns go by index or by name (`categorical_feature`),
with weights, query groups and init scores, row subsets sharing their
parent's bins (`subset`, for cv), and continued training: a predictor
attached to a Dataset seeds its init scores and the new Booster merges
the predictor's trees (basic.py:182-390, 1227-1231). Custom objectives
run through `update(fobj=...)`, custom metrics through
`eval*(feval=...)`.
"""

import numpy as np

from .config import Config, key_alias_transform
from .io.dataset import CscColumns, DatasetLoader, is_column_source
from .io.parser import parse_text_file
from .metrics import create_metric
from .models.gbdt import create_boosting
from .objectives import create_objective
from .utils.log import LightGBMError, Log


def _coerce_2d(data):
    """numpy 2-D / pandas / scipy sparse / list-of-rows -> float32
    ndarray."""
    if hasattr(data, "toarray"):          # scipy sparse
        data = data.toarray()
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values
    arr = np.asarray(data, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return np.ascontiguousarray(arr)


def _matrix_source(data):
    """What the loader bins: a column source as it is, a scipy sparse
    matrix as CSC columns (one column dense at a time, as the JAX
    package's column sources), anything else as a float32 ndarray."""
    if is_column_source(data):
        return data
    if hasattr(data, "tocsr"):            # scipy sparse
        csr = data.tocsr()
        return CscColumns.from_csr(csr.indptr, csr.indices, csr.data,
                                   csr.shape[1])
    return _coerce_2d(data)


def _parse_features(path, has_header=False, label_column=""):
    """The feature matrix of a data file (the label column dropped)."""
    _, feats, _, _, _ = parse_text_file(path, has_header=has_header,
                                        label_column=label_column)
    return feats


def _coerce_label(label):
    if label is None:
        return None
    if hasattr(label, "values") and not isinstance(label, np.ndarray):
        label = label.values
    return np.asarray(label, dtype=np.float32).reshape(-1)


def load_model_file(model_file, device=None):
    """A model file loaded into a booster of the class its first line
    names (gbdt, dart or goss) on `device` (the predictor of continued
    training, basic.py:182-390)."""
    gbdt = create_boosting("gbdt", device, input_model=model_file)
    with open(model_file) as f:
        gbdt.load_model_from_string(f.read())
    return gbdt


class Dataset:
    """Lazy dataset (basic.py:893-1183): stores raw inputs and bins them
    on first use, so `reference=` alignment and the predictor for
    continued training (a GBDT whose raw scores seed the init scores)
    can be attached first."""

    def __init__(self, data, label=None, max_bin=255, reference=None,
                 weight=None, group=None, silent=False, feature_name=None,
                 categorical_feature=None, params=None, free_raw_data=True):
        self.data = data
        self.label = _coerce_label(label)
        self.max_bin = max_bin
        self.reference = reference
        self.weight = weight
        self.group = group
        self.silent = silent
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self.free_raw_data = free_raw_data
        self.init_score = None
        self._predictor = None
        self._core = None
        self._used_indices = None      # set by subset()
        self._parent = None

    def construct(self, device=None) -> "Dataset":
        """Bin the data once. A Booster passes its device: there a dense
        float32 matrix of numerical features is binned (the card's
        kernel, or its plain version on the CPU); with no device the
        host pass bins it. Either gives the same bins."""
        if self._core is not None:
            return self
        if self._parent is not None:   # subset path (basic.py:1012-1035)
            self._core = self._parent.construct(device)._core.subset(
                self._used_indices)
            self._apply_fields()
            return self
        cfg = self._config()
        loader = DatasetLoader(cfg, device=device)
        ref_core = None
        if self.reference is not None:
            if not isinstance(self.reference, Dataset):
                raise TypeError("Reference dataset should be None or dataset")
            ref_core = self.reference.construct(device)._core
            self._set_predictor(self.reference._predictor)
        if isinstance(self.data, str):
            if ref_core is not None:
                self._core = loader.load_from_file_align_with_other_dataset(
                    self.data, ref_core)
            elif cfg.out_of_core and cfg.num_machines > 1:
                # a rank of a process group trains its owned blocks of
                # the gang's shared store (io/dataset.py load_from_file)
                from .parallel import distributed
                self._core = loader.load_from_file(
                    self.data, rank=distributed.process_rank(),
                    num_machines=cfg.num_machines)
            else:
                self._core = loader.load_from_file(self.data)
        else:
            self._core = loader.construct_from_matrix(
                _matrix_source(self.data), label=self.label,
                reference=ref_core,
                categorical_features=self._resolve_categorical())
        if self.feature_name is not None:
            self._core.feature_names = list(self.feature_name)
        self._apply_fields()
        self._apply_predictor_init_score()
        if self.free_raw_data and not isinstance(self.data, str):
            self.data = None
        return self

    def _config(self):
        params = key_alias_transform(dict(self.params))
        params.setdefault("max_bin", self.max_bin)
        if self.silent:
            params.setdefault("verbose", 0)
        return Config.from_params(params)

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

    def _apply_fields(self):
        meta = self._core.metadata
        if self.weight is not None:
            meta.set_weights(np.asarray(self.weight,
                                        dtype=np.float32).reshape(-1))
        if self.group is not None:
            meta.set_query(np.asarray(self.group, dtype=np.int64).reshape(-1))
        if self.init_score is not None:
            meta.set_init_score(
                np.asarray(self.init_score, dtype=np.float64).reshape(-1))

    def _apply_predictor_init_score(self):
        """Seed init scores from the chained predictor, class-major
        (basic.py:523-536)."""
        if self._predictor is None or self._core.metadata.init_score is not None:
            return
        if self.data is None:
            raise LightGBMError(
                "Cannot set predictor after freed raw data, "
                "Set free_raw_data=False when construct Dataset to avoid this.")
        if isinstance(self.data, str):
            # the file's features as the loader reads them (its header
            # and label column), the model's feature space
            cfg = self._config()
            data = _parse_features(self.data, cfg.has_header,
                                   cfg.label_column)
        else:
            data = self.data
        raw = self._predictor.predict_raw(_coerce_2d(data))
        self._core.metadata.set_init_score(raw.T.reshape(-1))

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, silent=False, params=None):
        """New Dataset aligned with self (basic.py:947-971)."""
        ret = Dataset(data, label=label, max_bin=self.max_bin,
                      reference=self, weight=weight, group=group,
                      silent=silent, params=params)
        ret.init_score = init_score
        return ret

    def subset(self, used_indices, params=None):
        """Row subset sharing this dataset's bin mappers
        (basic.py:1012-1035)."""
        ret = Dataset(None, max_bin=self.max_bin, params=params or self.params)
        ret._parent = self
        ret._used_indices = np.asarray(used_indices, dtype=np.int64)
        ret._predictor = self._predictor
        return ret

    def set_reference(self, reference):
        self.reference = reference
        self._set_predictor(reference._predictor)

    def _set_predictor(self, predictor):
        if predictor is self._predictor:
            return
        self._predictor = predictor
        if self._core is not None and predictor is not None:
            self._apply_predictor_init_score()

    def set_categorical_feature(self, categorical_feature):
        """basic.py set_categorical_feature: only before construction."""
        if categorical_feature is None:
            return
        if self._core is not None:
            Log.warning("categorical_feature set after Dataset was "
                        "constructed; ignoring")
            return
        self.categorical_feature = categorical_feature

    def set_feature_name(self, feature_name):
        if feature_name is not None:
            self.feature_name = list(feature_name)
            if self._core is not None:
                self._core.feature_names = list(feature_name)

    def set_label(self, label):
        self.label = _coerce_label(label)
        if self._core is not None and self.label is not None:
            self._core.metadata.set_label(self.label)

    def set_weight(self, weight):
        self.weight = weight
        if self._core is not None and weight is not None:
            self._core.metadata.set_weights(
                np.asarray(weight, dtype=np.float32).reshape(-1))

    def set_init_score(self, init_score):
        self.init_score = init_score
        if self._core is not None and init_score is not None:
            self._core.metadata.set_init_score(
                np.asarray(init_score, dtype=np.float64).reshape(-1))

    def set_group(self, group):
        self.group = group
        if self._core is not None and group is not None:
            self._core.metadata.set_query(
                np.asarray(group, dtype=np.int64).reshape(-1))

    def get_label(self):
        if self._core is not None:
            return self._core.metadata.label
        return self.label

    def get_weight(self):
        if self._core is not None:
            return self._core.metadata.weights
        return self.weight

    def get_init_score(self):
        if self._core is not None:
            return self._core.metadata.init_score
        return self.init_score

    def get_group(self):
        if (self._core is not None
                and self._core.metadata.query_boundaries is not None):
            return np.diff(self._core.metadata.query_boundaries)
        return self.group

    def num_data(self):
        return self.construct()._core.num_data

    def num_feature(self):
        return self.construct()._core.num_features

    def save_binary(self, filename):
        """The binary cache of the constructed dataset
        (lightgbm_tpu basic.py save_binary): its bins, mappers and
        metadata, in the JAX package's format."""
        self.construct()._core.save_binary(filename)


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
        self._init_predictor = None
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
            train_set.construct(self.gbdt.device)
            core = train_set._core
            self.objective = self._make_objective(core)
            self.gbdt.init(self.config, core, self.objective,
                           self._create_metrics(core))
            self._train_dataset = train_set
            self._init_predictor = train_set._predictor
            if self._init_predictor is not None:
                self.gbdt.merge_from(self._init_predictor)
        elif model_file is not None:
            self.gbdt = load_model_file(model_file, device)
        else:
            raise TypeError("At least need training dataset or model file "
                            "to create booster instance")

    @property
    def device(self):
        return self.gbdt.device

    def _make_objective(self, core):
        """The config's objective, initialised on `core` (None: custom
        objectives through update(fobj=))."""
        objective = create_objective(self.config.objective, self.config)
        if objective is None:
            Log.warning("Using self-defined objective function")
        else:
            objective.init(core.metadata, core.num_data, self.gbdt.device)
        return objective

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
        if data._predictor is not self._init_predictor:
            raise LightGBMError("Add validation data failed, you should use "
                                "same predictor for these data")
        data.construct(self.gbdt.device)
        self.gbdt.add_valid_dataset(data._core,
                                    self._create_metrics(data._core))
        self._valid_datasets.append(data)
        self._name_valid_sets.append(name)

    def reset_parameter(self, params):
        """basic.py:1282-1302. Only the learning rate: the shrinkage
        changes in place (a schedule calls this every round); anything
        else rebuilds the config and objective on the same data."""
        params = key_alias_transform(dict(params))
        if set(params) <= {"learning_rate"}:
            if "learning_rate" in params:
                lr = float(params["learning_rate"])
                self.config.learning_rate = lr
                self.gbdt.shrinkage_rate = lr
            return
        from dataclasses import fields
        merged = {f.name: getattr(self.config, f.name)
                  for f in fields(self.config)
                  if f.name not in ("is_parallel", "is_parallel_find_bin",
                                    "seed")}
        self.config = Config.from_params({**merged, **params})
        if self.objective is not None:
            self.objective = self._make_objective(self.gbdt.train_data)
        self.gbdt.reset_config(self.config, self.objective)

    # ------------------------------------------------------------- training
    def update(self, fobj=None):
        """One boosting iteration (basic.py:1304-1341); with `fobj`, its
        (grad, hess) of the transformed train predictions and the
        training Dataset, class-major, drive the iteration. Returns
        True when no further splits are possible."""
        if fobj is None:
            return self.gbdt.train_one_iter(is_eval=False)
        grad, hess = fobj(self.gbdt.get_predict_at(0), self._train_dataset)
        grad = np.asarray(grad, dtype=np.float32).reshape(-1)
        hess = np.asarray(hess, dtype=np.float32).reshape(-1)
        n = self.gbdt.num_data * self.gbdt.num_class
        if len(grad) != n or len(hess) != n:
            raise ValueError("Length of grad and hess should be equal with "
                             "num_data * num_class")
        return self.gbdt.train_one_iter(grad, hess, is_eval=False)

    def rollback_one_iter(self):
        """Drop the last iteration's trees and their scores
        (basic.py:434)."""
        self.gbdt.rollback_one_iter()

    def current_iteration(self):
        return len(self.gbdt.models) // max(self.gbdt.num_class, 1)

    # ----------------------------------------------------------- evaluation
    def _inner_eval(self, data_name, data_idx, feval=None):
        names = self.gbdt.get_eval_names(data_idx)
        values = self.gbdt.get_eval_at(data_idx)
        metrics = (self.gbdt.training_metrics if data_idx == 0
                   else self.gbdt.valid_metrics[data_idx - 1])
        factors = [m.factor_to_bigger_better for m in metrics
                   for _ in m.names]
        ret = [(data_name, name, value, fac > 0)
               for name, value, fac in zip(names, values, factors)]
        if feval is not None:
            dataset = (self._train_dataset if data_idx == 0
                       else self._valid_datasets[data_idx - 1])
            out = feval(self.gbdt.get_predict_at(data_idx), dataset)
            for name, value, bigger in (out if isinstance(out, list)
                                        else [out]):
                ret.append((data_name, name, value, bigger))
        return ret

    def eval(self, data, name, feval=None):
        """Metrics of a Dataset bound to this booster (basic.py:1378)."""
        if data is self._train_dataset:
            return self.eval_train(feval)
        for i, vd in enumerate(self._valid_datasets):
            if data is vd:
                return self._inner_eval(name, i + 1, feval)
        raise LightGBMError("Cannot evaluate Dataset that was not used "
                            "during training")

    def eval_train(self, feval=None):
        return self._inner_eval(self._train_data_name, 0, feval)

    def eval_valid(self, feval=None):
        out = []
        for i, name in enumerate(self._name_valid_sets):
            out.extend(self._inner_eval(name, i + 1, feval))
        return out

    # ----------------------------------------------------------- prediction
    def predict(self, data, num_iteration=-1, raw_score=False,
                pred_leaf=False, data_has_header=False, is_reshape=True):
        """Predictions of raw rows on the booster's device; `data` may be
        a data file's path, whose first column is the label
        (lightgbm_tpu basic.py:74-80)."""
        if isinstance(data, str):
            data = _parse_features(data, has_header=data_has_header)
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

    def dump_model(self):
        """The model as JSON text (basic.py:501, gbdt.cpp:431-466)."""
        return self.gbdt.dump_model()

    def feature_importance(self, importance_type="split"):
        """Per-feature importance: `split` int64 counts, `gain` float64
        gain sums, `coeff` float64 gain-weighted |coefficient| sums over
        linear leaves (all zeros for a constant-leaf model)."""
        if importance_type not in ("split", "gain", "coeff"):
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
