"""lightgbm_tpu_torch's C API (lib_lightgbm_torch.so over capi_bridge.py)
and its training-data reset, on the CPU.

The library is built with g++ from lightgbm_tpu_torch/native/
c_api_shim.cpp at first use and loaded with ctypes (RTLD_LOCAL: its
LGBM_* names are also the JAX package's lib_lightgbm.so's); the tests
skip only when it cannot build or load, as tests/test_c_api.py does.
The bridge's device is the CPU here (native.load_library(device="cpu")).
Data comes from numpy, files are written to tmp_path.

- datasets from a matrix, CSR, CSC and a file bin alike; fields set and
  read back; the binary cache reloads to the same bins;
- a booster trained, evaluated (AUC), stepped with custom gradients,
  rolled back, reset onto other data, saved and reloaded, predicting
  from a matrix and a file: its model text byte-equal to the port's
  Python API doing the same, its predictions bit-equal to
  Booster.predict's;
- the reset (GBDT.reset_training_data) against the JAX package's
  Booster.update(train_set=), with the port's fused path on: trees
  structurally equal, leaves and predictions within 1e-6 (the
  port-vs-JAX bound of tests/test_torch_train.py).
"""

import ctypes

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from test_torch_multiclass import _assert_same_model

CPU = "cpu"
F32, F64, I32 = 0, 1, 2
PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 20,
          "verbose": -1, "hist_compaction": "false", "max_bin": 63}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lib():
    from lightgbm_tpu_torch import native
    try:
        return native.load_library(device=CPU)
    except (RuntimeError, OSError) as e:
        pytest.skip(f"cannot build or load lib_lightgbm_torch.so: {e}")


def _params_str(params):
    return " ".join(f"{k}={v}" for k, v in params.items()).encode()


def _check(lib, ret):
    assert ret == 0, lib.LGBM_GetLastError().decode()


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _data(seed, n=1500, f=6):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    x[rng.rand(n, f) < 0.3] = 0.0          # zeros, so CSR/CSC are sparse
    logit = x[:, 0] + 0.5 * x[:, 1] - 0.7 * x[:, 2] + 0.3 * rng.randn(n)
    return x, (logit > 0.3).astype(np.float32)


def _payload(handle):
    """The bridge's Python object behind a handle (this process)."""
    return ctypes.cast(handle, ctypes.py_object).value


def _from_mat(lib, x, y=None, reference=None, params=b"max_bin=63"):
    h = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromMat(
        _ptr(x), F32, ctypes.c_int32(x.shape[0]), ctypes.c_int32(x.shape[1]),
        1, params, reference, ctypes.byref(h)))
    if y is not None:
        _check(lib, lib.LGBM_DatasetSetField(h, b"label", _ptr(y),
                                             ctypes.c_int64(len(y)), F32))
    return h


def _bins(handle):
    return np.asarray(_payload(handle).core.bins)


def test_dataset_routes_fields_and_binary_cache(lib, tmp_path):
    import scipy.sparse as sp
    x, y = _data(0)
    mat = _from_mat(lib, x, y)
    csr, csc = sp.csr_matrix(x.astype(np.float64)), sp.csc_matrix(x)
    h_csr, h_csc, h_file = (ctypes.c_void_p() for _ in range(3))
    _check(lib, lib.LGBM_DatasetCreateFromCSR(
        _ptr(csr.indptr.astype(np.int32)), I32, _ptr(csr.indices), _ptr(
            csr.data), F64, ctypes.c_int64(len(csr.indptr)),
        ctypes.c_int64(csr.nnz), ctypes.c_int64(x.shape[1]), b"max_bin=63",
        None, ctypes.byref(h_csr)))
    _check(lib, lib.LGBM_DatasetCreateFromCSC(
        _ptr(csc.indptr.astype(np.int64)), 3, _ptr(csc.indices),
        _ptr(csc.data), F32, ctypes.c_int64(len(csc.indptr)),
        ctypes.c_int64(csc.nnz), ctypes.c_int64(x.shape[0]), b"max_bin=63",
        None, ctypes.byref(h_csc)))
    tsv = tmp_path / "train.tsv"
    np.savetxt(tsv, np.column_stack([y, x]), delimiter="\t", fmt="%.9g")
    _check(lib, lib.LGBM_DatasetCreateFromFile(
        str(tsv).encode(), b"max_bin=63", None, ctypes.byref(h_file)))
    for h in (h_csr, h_csc, h_file):
        np.testing.assert_array_equal(_bins(h), _bins(mat))
    out = ctypes.c_int64()
    _check(lib, lib.LGBM_DatasetGetNumData(h_file, ctypes.byref(out)))
    assert out.value == len(y)
    _check(lib, lib.LGBM_DatasetGetNumFeature(h_file, ctypes.byref(out)))
    assert out.value == x.shape[1]
    # fields: set, read back through the caller's pointers
    w = np.linspace(0.5, 1.5, len(y)).astype(np.float32)
    group = np.full(15, 100, np.int32)
    _check(lib, lib.LGBM_DatasetSetField(mat, b"weight", _ptr(w),
                                         ctypes.c_int64(len(w)), F32))
    _check(lib, lib.LGBM_DatasetSetField(mat, b"group", _ptr(group),
                                         ctypes.c_int64(len(group)), I32))
    for field, want, ctype in ((b"label", y, ctypes.c_float),
                               (b"weight", w, ctypes.c_float),
                               (b"group", group, ctypes.c_int32)):
        n, ptr, kind = ctypes.c_int64(), ctypes.c_void_p(), ctypes.c_int()
        _check(lib, lib.LGBM_DatasetGetField(mat, field, ctypes.byref(n),
                                             ctypes.byref(ptr),
                                             ctypes.byref(kind)))
        got = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)),
                                    (n.value,))
        np.testing.assert_array_equal(got, want)
    # the binary cache reloads to the same bins and labels
    cache = str(tmp_path / "train.bin").encode()
    _check(lib, lib.LGBM_DatasetSaveBinary(mat, cache))
    h_bin = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromFile(cache, b"", None,
                                               ctypes.byref(h_bin)))
    np.testing.assert_array_equal(_bins(h_bin), _bins(mat))
    np.testing.assert_array_equal(_payload(h_bin).core.metadata.label, y)
    for h in (mat, h_csr, h_csc, h_file, h_bin):
        _check(lib, lib.LGBM_DatasetFree(h))


def _grad_hess(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32),
            (rng.rand(n) + 0.5).astype(np.float32))


def _python_sequence(x, y, xv, yv, x2, y2, grad, hess, rounds):
    """The C API test's calls through the port's Python API."""
    params = dict(PARAMS, metric="auc")
    ds = lgt.Dataset(x, y, params={"max_bin": 63})
    b = lgt.Booster(params, ds, device=CPU)
    b.add_valid(ds.create_valid(xv, yv), "valid_1")
    for _ in range(rounds):
        b.update()
    evals = b.eval_valid()
    b.update(fobj=lambda preds, data: (grad, hess))
    b.update()
    b.rollback_one_iter()
    b.update(train_set=lgt.Dataset(x2, y2, reference=ds))
    return b, evals


def test_booster_calls_match_the_python_api(lib, tmp_path):
    x, y = _data(1)
    xv, yv = _data(2, n=500)
    x2, y2 = _data(3, n=1200)
    grad, hess = _grad_hess(4, len(y))
    rounds = 3
    train = _from_mat(lib, x, y)
    valid = _from_mat(lib, xv, yv, reference=train)
    train2 = _from_mat(lib, x2, y2, reference=train)
    b = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(
        train, _params_str(dict(PARAMS, metric="auc")), ctypes.byref(b)))
    _check(lib, lib.LGBM_BoosterAddValidData(b, valid))
    fin = ctypes.c_int()
    for _ in range(rounds):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(b, ctypes.byref(fin)))
    n = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterGetEvalCounts(b, ctypes.byref(n)))
    bufs = [ctypes.create_string_buffer(255) for _ in range(n.value)]
    names = (ctypes.c_char_p * n.value)(*map(ctypes.addressof, bufs))
    _check(lib, lib.LGBM_BoosterGetEvalNames(b, ctypes.byref(n), names))
    assert [s.value for s in bufs] == [b"auc"]
    auc = np.zeros(1, np.float32)
    _check(lib, lib.LGBM_BoosterGetEval(b, 1, ctypes.byref(n), _ptr(auc)))
    _check(lib, lib.LGBM_BoosterUpdateOneIterCustom(
        b, _ptr(grad), _ptr(hess), ctypes.byref(fin)))
    _check(lib, lib.LGBM_BoosterUpdateOneIter(b, ctypes.byref(fin)))
    _check(lib, lib.LGBM_BoosterRollbackOneIter(b))
    _check(lib, lib.LGBM_BoosterResetTrainingData(b, train2))
    _check(lib, lib.LGBM_BoosterUpdateOneIter(b, ctypes.byref(fin)))
    it = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(b, ctypes.byref(it)))
    assert it.value == rounds + 2
    model = tmp_path / "model.txt"
    _check(lib, lib.LGBM_BoosterSaveModel(b, -1, str(model).encode()))

    pb, evals = _python_sequence(x, y, xv, yv, x2, y2, grad, hess, rounds)
    assert model.read_text() == pb.model_to_string()
    assert auc[0] == np.float32(evals[0][2])

    loaded = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreateFromModelfile(
        str(model).encode(), ctypes.byref(it), ctypes.byref(loaded)))
    assert it.value == rounds + 2
    xt, _ = _data(5, n=300)
    for kind, kw in ((0, {}), (1, {"raw_score": True})):
        out = np.zeros(len(xt))
        _check(lib, lib.LGBM_BoosterPredictForMat(
            loaded, _ptr(xt), F32, ctypes.c_int32(len(xt)),
            ctypes.c_int32(xt.shape[1]), 1, kind, ctypes.c_int64(-1),
            ctypes.byref(n), _ptr(out)))
        assert n.value == len(xt)
        np.testing.assert_array_equal(out, pb.predict(xt, **kw))
    data_file = tmp_path / "test.tsv"
    np.savetxt(data_file, np.column_stack([np.zeros(len(xt)), xt]),
               delimiter="\t", fmt="%.9g")
    result = tmp_path / "pred.txt"
    _check(lib, lib.LGBM_BoosterPredictForFile(
        loaded, str(data_file).encode(), 0, 0, ctypes.c_int64(-1),
        str(result).encode()))
    np.testing.assert_allclose(np.loadtxt(result), pb.predict(xt),
                               rtol=1e-5, atol=0)   # written as %g
    for h in (b, loaded):
        _check(lib, lib.LGBM_BoosterFree(h))


def test_last_error_after_a_bad_call(lib, tmp_path):
    h = ctypes.c_void_p()
    assert lib.LGBM_DatasetCreateFromFile(
        str(tmp_path / "missing.tsv").encode(), b"", None,
        ctypes.byref(h)) == -1
    assert b"missing.tsv" in lib.LGBM_GetLastError()
    x, y = _data(6, n=300)
    train = _from_mat(lib, x, y)
    assert lib.LGBM_DatasetSetField(train, b"colour", _ptr(y),
                                    ctypes.c_int64(len(y)), F32) == -1
    assert lib.LGBM_GetLastError() == b"Unknown field name: colour"


def test_reset_training_data_matches_jax(lib, tmp_path):
    """3 rounds, the training data replaced, 2 more: the JAX package's
    Booster.update(train_set=) (which trains one of those rounds), the
    port's Python API with the fused trainer (GBDT.train_many) around
    the same reset, and the C API's ResetTrainingData."""
    x1, y1 = _data(7)
    x2, y2 = _data(8, n=900)
    d1 = lgj.Dataset(x1, y1, params={"max_bin": 63}, free_raw_data=False)
    jb = lgj.Booster(PARAMS, d1)
    for _ in range(3):
        jb.update()
    jb.update(train_set=lgj.Dataset(x2, y2, reference=d1))
    jb.update()

    t1 = lgt.Dataset(x1, y1, params={"max_bin": 63})
    tb = lgt.Booster(PARAMS, t1, device=CPU)
    tb.gbdt.train_many(3)
    runner = next(iter(tb.gbdt._fused_cache.values()))
    tb.update(train_set=lgt.Dataset(x2, y2, reference=t1))
    assert not tb.gbdt._fused_cache       # the old data's runner went
    tb.gbdt.train_many(1)
    assert next(iter(tb.gbdt._fused_cache.values())) is not runner
    _assert_same_model(jb, tb, x2)
    np.testing.assert_allclose(tb.gbdt.get_training_score(),
                               jb.gbdt.get_training_score(), rtol=0,
                               atol=1e-6)

    train = _from_mat(lib, x1, y1)
    train2 = _from_mat(lib, x2, y2, reference=train)
    b, fin = ctypes.c_void_p(), ctypes.c_int()
    _check(lib, lib.LGBM_BoosterCreate(train, _params_str(PARAMS),
                                       ctypes.byref(b)))
    for _ in range(3):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(b, ctypes.byref(fin)))
    _check(lib, lib.LGBM_BoosterResetTrainingData(b, train2))
    for _ in range(2):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(b, ctypes.byref(fin)))
    model = tmp_path / "reset.txt"
    _check(lib, lib.LGBM_BoosterSaveModel(b, -1, str(model).encode()))
    assert model.read_text() == tb.model_to_string()
