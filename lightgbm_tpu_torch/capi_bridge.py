"""Python side of the port's C API shim (port of
lightgbm_tpu/capi_bridge.py).

Reference: src/c_api.cpp (the `Booster` wrapper class and the 38
`LGBM_*` exports, c_api.cpp:26-240 and below). The native shim
(native/c_api_shim.cpp, built into lib_lightgbm_torch.so) embeds
CPython and forwards every C call here with raw pointer addresses; this
module does all the marshalling with ctypes/numpy and implements the
handle objects on top of the public Python API (basic.Booster /
basic.Dataset). Handles passed back to C are plain Python objects; the
shim holds a strong reference until the matching *Free call.

The device. The C API's parameter strings name no device: every
dataset is binned, and every booster trains and predicts, on the
module's DEVICE. None (the default) is the CUDA card, raising where
there is none, as everywhere in the port; a host process that wants the
kernels' plain versions sets `capi_bridge.DEVICE = "cpu"` before its
first call (`native.load_library(device="cpu")` does it).

LGBM_BoosterResetTrainingData replaces the training data and trains
nothing (c_api.cpp ResetTrainingData); the round after it is the
caller's LGBM_BoosterUpdateOneIter.
"""

import ctypes

import numpy as np

from .basic import Booster, Dataset, _coerce_2d
from .config import str2map
from .utils.device import resolve_device

DEVICE = None

C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_DTYPE_INT32 = 2
C_API_DTYPE_INT64 = 3

C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2

_CTYPES = {
    C_API_DTYPE_FLOAT32: ctypes.c_float,
    C_API_DTYPE_FLOAT64: ctypes.c_double,
    C_API_DTYPE_INT32: ctypes.c_int32,
    C_API_DTYPE_INT64: ctypes.c_int64,
}
_NPTYPES = {
    C_API_DTYPE_FLOAT32: np.float32,
    C_API_DTYPE_FLOAT64: np.float64,
    C_API_DTYPE_INT32: np.int32,
    C_API_DTYPE_INT64: np.int64,
}


def _read_array(addr, dtype_code, n):
    if addr == 0 or n == 0:
        return np.zeros(0, dtype=_NPTYPES[dtype_code])
    buf = (_CTYPES[dtype_code] * n).from_address(addr)
    return np.frombuffer(buf, dtype=_NPTYPES[dtype_code]).copy()


def _write_array(addr, dtype_code, values):
    values = np.ascontiguousarray(values, dtype=_NPTYPES[dtype_code])
    values = values.reshape(-1)
    ctypes.memmove(addr, values.ctypes.data, values.nbytes)
    return len(values)


def _write_scalar(addr, dtype_code, value):
    _CTYPES[dtype_code].from_address(addr).value = value


def _read_matrix(data_addr, data_type, nrow, ncol, is_row_major):
    """The caller's dense matrix as a float32 row-major array, the
    Python API's input type (its float32 features are binned by
    bin_dense on the card)."""
    flat = _read_array(data_addr, data_type, nrow * ncol)
    mat = flat.reshape((nrow, ncol) if is_row_major else (ncol, nrow))
    if not is_row_major:
        mat = mat.T
    return np.ascontiguousarray(mat, dtype=np.float32)


class _CDataset:
    """DatasetHandle payload: a public Dataset, constructed at once on
    the module's device (on the card a float32 matrix is binned by
    bin_dense, as a Booster's own dataset is)."""

    def __init__(self, dataset: Dataset):
        self.dataset = dataset
        self.dataset.construct(resolve_device(DEVICE))
        self._field_refs = {}

    @property
    def core(self):
        return self.dataset._core


class _CBooster:
    """BoosterHandle payload (the reference's `Booster` wrapper,
    c_api.cpp:26-240)."""

    def __init__(self, booster: Booster, train_cd=None):
        self.booster = booster
        self.train_cd = train_cd
        self.num_valid = 0


def _params_to_dict(parameters):
    return str2map(parameters or "")


def _dataset(source, parameters, reference):
    ref = reference.dataset if reference is not None else None
    return _CDataset(Dataset(source, reference=ref,
                             params=_params_to_dict(parameters),
                             free_raw_data=False))


# --------------------------------------------------------------- datasets
def dataset_create_from_file(filename, parameters, reference):
    return _dataset(filename, parameters, reference)


def dataset_create_from_mat(data_addr, data_type, nrow, ncol, is_row_major,
                            parameters, reference):
    return _dataset(_read_matrix(data_addr, data_type, nrow, ncol,
                                 is_row_major), parameters, reference)


def dataset_create_from_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                            data_type, nindptr, nelem, num_col, parameters,
                            reference):
    """Sparse rows stay sparse until binning (c_api.cpp:317-376): the
    CSR triplets transpose to a column source in O(nnz) and each column
    densifies one at a time inside the loader."""
    from .io.dataset import CscColumns
    indptr = _read_array(indptr_addr, indptr_type, nindptr)
    indices = _read_array(indices_addr, C_API_DTYPE_INT32, nelem)
    vals = _read_array(data_addr, data_type, nelem)
    return _dataset(CscColumns.from_csr(indptr, indices, vals, num_col),
                    parameters, reference)


def dataset_create_from_csc(colptr_addr, colptr_type, indices_addr, data_addr,
                            data_type, ncolptr, nelem, num_row, parameters,
                            reference):
    """Column-major sparse input binned without densifying
    (c_api.cpp:378-427)."""
    from .io.dataset import CscColumns
    colptr = _read_array(colptr_addr, colptr_type, ncolptr)
    indices = _read_array(indices_addr, C_API_DTYPE_INT32, nelem)
    vals = _read_array(data_addr, data_type, nelem)
    return _dataset(CscColumns(colptr, indices, vals, num_row, ncolptr - 1),
                    parameters, reference)


def dataset_get_subset(cd, indices_addr, num_indices, parameters):
    indices = _read_array(indices_addr, C_API_DTYPE_INT32, num_indices)
    sub = cd.dataset.subset(indices, params=_params_to_dict(parameters))
    return _CDataset(sub)


def dataset_set_feature_names(cd, names):
    cd.dataset.set_feature_name(list(names))


def dataset_save_binary(cd, filename):
    cd.dataset.save_binary(filename)


def dataset_set_field(cd, field_name, data_addr, num_element, dtype_code):
    arr = _read_array(data_addr, dtype_code, num_element)
    meta = cd.core.metadata
    if field_name == "label":
        meta.set_label(arr.astype(np.float32))
    elif field_name == "weight":
        meta.set_weights(arr.astype(np.float32))
    elif field_name == "group" or field_name == "query":
        meta.set_query(arr.astype(np.int64))
    elif field_name == "init_score":
        meta.set_init_score(arr.astype(np.float64))
    else:
        raise ValueError(f"Unknown field name: {field_name}")


def dataset_get_field(cd, field_name, out_len_addr, out_ptr_addr,
                      out_type_addr):
    meta = cd.core.metadata
    if field_name == "label":
        arr, code = meta.label, C_API_DTYPE_FLOAT32
        arr = None if arr is None else np.asarray(arr, np.float32)
    elif field_name == "weight":
        arr, code = meta.weights, C_API_DTYPE_FLOAT32
        arr = None if arr is None else np.asarray(arr, np.float32)
    elif field_name == "group" or field_name == "query":
        qb = meta.query_boundaries
        arr = None if qb is None else np.diff(qb).astype(np.int32)
        code = C_API_DTYPE_INT32
    elif field_name == "init_score":
        arr = meta.init_score
        arr = None if arr is None else np.asarray(arr, np.float64)
        code = C_API_DTYPE_FLOAT64
    else:
        raise ValueError(f"Unknown field name: {field_name}")
    if arr is None:
        _write_scalar(out_len_addr, C_API_DTYPE_INT64, 0)
        _write_scalar(out_ptr_addr, C_API_DTYPE_INT64, 0)
        _write_scalar(out_type_addr, C_API_DTYPE_INT32, code)
        return
    arr = np.ascontiguousarray(arr)
    cd._field_refs[field_name] = arr  # keep alive while C reads it
    _write_scalar(out_len_addr, C_API_DTYPE_INT64, len(arr))
    _write_scalar(out_ptr_addr, C_API_DTYPE_INT64, arr.ctypes.data)
    _write_scalar(out_type_addr, C_API_DTYPE_INT32, code)


def dataset_get_num_data(cd):
    return cd.core.num_data


def dataset_get_num_feature(cd):
    return cd.core.num_features


# --------------------------------------------------------------- boosters
def booster_create(train_cd, parameters):
    booster = Booster(params=_params_to_dict(parameters),
                      train_set=train_cd.dataset, device=DEVICE)
    return _CBooster(booster, train_cd)


def booster_create_from_modelfile(filename, out_num_iterations_addr):
    booster = Booster(model_file=filename, device=DEVICE)
    _write_scalar(out_num_iterations_addr, C_API_DTYPE_INT64,
                  booster.current_iteration())
    return _CBooster(booster)


def booster_merge(cb, other_cb):
    cb.booster.gbdt.merge_from(other_cb.booster.gbdt)


def booster_add_valid_data(cb, valid_cd):
    cb.num_valid += 1
    valid_cd.dataset._predictor = cb.booster._init_predictor
    cb.booster.add_valid(valid_cd.dataset, f"valid_{cb.num_valid}")


def booster_reset_training_data(cb, train_cd):
    cb.booster._replace_train_set(train_cd.dataset)
    cb.train_cd = train_cd


def booster_reset_parameter(cb, parameters):
    cb.booster.reset_parameter(_params_to_dict(parameters))


def booster_get_num_classes(cb):
    return cb.booster.gbdt.num_class


def booster_update_one_iter(cb, is_finished_addr):
    finished = cb.booster.update()
    _write_scalar(is_finished_addr, C_API_DTYPE_INT32, 1 if finished else 0)


def booster_update_one_iter_custom(cb, grad_addr, hess_addr,
                                   is_finished_addr):
    gbdt = cb.booster.gbdt
    n = gbdt.num_data * gbdt.num_class
    grad = _read_array(grad_addr, C_API_DTYPE_FLOAT32, n)
    hess = _read_array(hess_addr, C_API_DTYPE_FLOAT32, n)
    finished = gbdt.train_one_iter(grad, hess, is_eval=False)
    _write_scalar(is_finished_addr, C_API_DTYPE_INT32, 1 if finished else 0)


def booster_rollback_one_iter(cb):
    cb.booster.rollback_one_iter()


def booster_get_current_iteration(cb):
    return cb.booster.current_iteration()


def booster_get_eval_counts(cb):
    return sum(len(m.names) for m in cb.booster.gbdt.training_metrics)


def booster_get_eval_names(cb, out_strs_addr):
    """Writes each name into the caller's pre-allocated char* slots
    (the reference python wrapper allocates 255-byte buffers)."""
    names = cb.booster.gbdt.get_eval_names(0)
    # the char** read as raw pointer values: indexing a c_char_p array
    # yields a copied bytes object, so memmove through it would write
    # into the copy, never the caller's buffers
    ptrs = (ctypes.c_void_p * max(len(names), 1)).from_address(out_strs_addr)
    for i, name in enumerate(names):
        raw = name.encode() + b"\0"
        ctypes.memmove(ptrs[i], raw, len(raw))
    return len(names)


def booster_get_eval(cb, data_idx, out_results_addr):
    vals = cb.booster.gbdt.get_eval_at(data_idx)
    return _write_array(out_results_addr, C_API_DTYPE_FLOAT32, vals)


def booster_get_predict(cb, data_idx, out_result_addr):
    vals = cb.booster.gbdt.get_predict_at(data_idx)
    return _write_array(out_result_addr, C_API_DTYPE_FLOAT32, vals)


def _predict_matrix(cb, mat, predict_type, num_iteration):
    """Booster.predict's answer on `mat`, flat in row-major order."""
    out = cb.booster.predict(
        mat, num_iteration=num_iteration,
        raw_score=predict_type == C_API_PREDICT_RAW_SCORE,
        pred_leaf=predict_type == C_API_PREDICT_LEAF_INDEX)
    return np.asarray(out, dtype=np.float64).reshape(-1)


def _write_predictions(out, out_len_addr, out_result_addr):
    n = _write_array(out_result_addr, C_API_DTYPE_FLOAT64, out)
    _write_scalar(out_len_addr, C_API_DTYPE_INT64, n)


def booster_predict_for_file(cb, data_filename, data_has_header,
                             predict_type, num_iteration, result_filename):
    from .application import Predictor
    predictor = Predictor(
        cb.booster.gbdt,
        is_raw_score=predict_type == C_API_PREDICT_RAW_SCORE,
        is_predict_leaf_index=predict_type == C_API_PREDICT_LEAF_INDEX,
        num_iteration=num_iteration)
    predictor.predict_file(data_filename, result_filename,
                           has_header=bool(data_has_header))


def booster_predict_for_mat(cb, data_addr, data_type, nrow, ncol,
                            is_row_major, predict_type, num_iteration,
                            out_len_addr, out_result_addr):
    mat = _read_matrix(data_addr, data_type, nrow, ncol, is_row_major)
    _write_predictions(_predict_matrix(cb, mat, predict_type, num_iteration),
                       out_len_addr, out_result_addr)


def booster_predict_for_csr(cb, indptr_addr, indptr_type, indices_addr,
                            data_addr, data_type, nindptr, nelem, num_col,
                            predict_type, num_iteration, out_len_addr,
                            out_result_addr):
    indptr = _read_array(indptr_addr, indptr_type, nindptr)
    indices = _read_array(indices_addr, C_API_DTYPE_INT32, nelem)
    vals = _read_array(data_addr, data_type, nelem)
    nrow = nindptr - 1
    ncol = num_col if num_col > 0 else (int(indices.max()) + 1 if nelem else 0)
    mat = np.zeros((nrow, ncol), dtype=np.float64)
    rows = np.repeat(np.arange(nrow), np.diff(indptr))
    mat[rows, indices] = vals
    _write_predictions(
        _predict_matrix(cb, _coerce_2d(mat), predict_type, num_iteration),
        out_len_addr, out_result_addr)


def booster_save_model(cb, num_iteration, filename):
    cb.booster.save_model(filename, num_iteration)


def booster_dump_model(cb, buffer_len, out_len_addr, out_str_addr):
    """out_str_addr is the caller's pre-allocated char buffer; out_len is
    always written so the caller can re-allocate and retry."""
    dumped = cb.booster.dump_model().encode() + b"\0"
    _write_scalar(out_len_addr, C_API_DTYPE_INT64, len(dumped))
    if len(dumped) <= buffer_len and out_str_addr:
        ctypes.memmove(out_str_addr, dumped, len(dumped))


def booster_get_leaf_value(cb, tree_idx, leaf_idx, out_val_addr):
    tree = cb.booster.gbdt.models[tree_idx]
    _write_scalar(out_val_addr, C_API_DTYPE_FLOAT32,
                  float(tree.leaf_value[leaf_idx]))


def booster_set_leaf_value(cb, tree_idx, leaf_idx, val):
    # the stacked and frozen prediction models are cached per model
    # count: an edited leaf drops them
    gbdt = cb.booster.gbdt
    gbdt.models[tree_idx].leaf_value[leaf_idx] = float(val)
    gbdt._device_model_cache = None
