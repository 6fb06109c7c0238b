"""lightgbm_tpu_torch's estimators and C API on the card.

- LGBMClassifier(device="cuda") with an eval set and early stopping
  (the blockwise route) and with none (the fused route): model text
  byte-equal to lgt.train with the parameters fit() built, on the same
  route;
- the C API (lib_lightgbm_torch.so, its bridge on the card): a
  float32 matrix binned by bin_dense, UpdateOneIter rounds byte-equal to
  lgt.train's per-iteration loop, PredictForMat with device_predict
  (tree_raw) bit-equal to Booster.predict;
- the shim called from two threads at once, each on a booster of its
  own: the same model texts as one thread's.

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_api_card.py -m cuda --noconftest
"""

import ctypes
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import sklearn as sk
from lightgbm_tpu_torch.config import str2map
from lightgbm_tpu_torch.ops import bin_kernels, traverse_kernels

pytestmark = pytest.mark.cuda
PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
          "verbose": -1, "hist_compaction": "false"}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def lib():
    from lightgbm_tpu_torch import native
    return native.load_library(device="cuda")


def _data(seed, n=20_000, f=10):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    logit = x @ rng.randn(f).astype(np.float32) + 0.5 * rng.randn(n)
    return x, (logit > 0).astype(np.float32)


def _recorded_fit(model, *args, **kwargs):
    calls, real = [], sk.train

    def train(params, *a, **k):
        calls.append(dict(params))
        return real(params, *a, **k)
    sk.train = train
    try:
        model.fit(*args, **kwargs)
    finally:
        sk.train = real
    return calls[0]


@pytest.mark.parametrize("with_eval", [True, False])
def test_classifier_matches_train_on_the_card(with_eval):
    x, y = _data(0)
    xv, yv = _data(1, n=4000)
    model = lgt.LGBMClassifier(n_estimators=6, num_leaves=15)
    assert model.device is None            # the card by default
    fit_kw = ({"eval_set": [(xv, yv)], "early_stopping_rounds": 2}
              if with_eval else {})
    params = _recorded_fit(model, x, y, verbose=False, **fit_kw)
    valid = ([lgt.Dataset(xv, yv, max_bin=255, params=params)]
             if with_eval else None)
    ref = lgt.train(params, lgt.Dataset(x, y, max_bin=255, params=params), 6,
                    valid_sets=valid,
                    early_stopping_rounds=2 if with_eval else None,
                    verbose_eval=False)
    assert model.booster().device.type == "cuda"
    assert model.booster().gbdt._fused_cache   # a replayed graph
    assert model.booster().model_to_string() == ref.model_to_string()
    np.testing.assert_array_equal(model.predict_proba(xv)[:, 1],
                                  ref.predict(xv))


def _ok(lib, ret):
    assert ret == 0, lib.LGBM_GetLastError().decode()


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _capi_model(lib, x, y, pstr, rounds):
    h, b, fin = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    _ok(lib, lib.LGBM_DatasetCreateFromMat(
        _ptr(x), 0, ctypes.c_int32(x.shape[0]), ctypes.c_int32(x.shape[1]),
        1, b"max_bin=255", None, ctypes.byref(h)))
    _ok(lib, lib.LGBM_DatasetSetField(h, b"label", _ptr(y),
                                      ctypes.c_int64(len(y)), 0))
    _ok(lib, lib.LGBM_BoosterCreate(h, pstr, ctypes.byref(b)))
    for _ in range(rounds):
        _ok(lib, lib.LGBM_BoosterUpdateOneIter(b, ctypes.byref(fin)))
    return h, b


def _text(lib, b, path):
    _ok(lib, lib.LGBM_BoosterSaveModel(b, -1, str(path).encode()))
    return path.read_text()


def test_capi_on_the_card_matches_train(lib, tmp_path):
    x, y = _data(2)
    pstr = b" ".join(f"{k}={v}".encode() for k, v in PARAMS.items())
    pstr += b" device_predict=true"
    bin_kernels.reset_launch_counts()
    h, b = _capi_model(lib, x, y, pstr, 4)
    assert bin_kernels.launch_counts()["bin_dense"] == 1
    ref = lgt.train(str2map(pstr.decode()), lgt.Dataset(x, y), 4,
                    verbose_eval=False, callbacks=[lambda env: None])
    assert _text(lib, b, tmp_path / "m.txt") == ref.model_to_string()
    out, n = np.zeros(len(x)), ctypes.c_int64()
    traverse_kernels.reset_launch_counts()
    _ok(lib, lib.LGBM_BoosterPredictForMat(
        b, _ptr(x), 0, ctypes.c_int32(len(x)), ctypes.c_int32(x.shape[1]),
        1, 0, ctypes.c_int64(-1), ctypes.byref(n), _ptr(out)))
    assert traverse_kernels.launch_counts()["tree_raw"] >= 1
    np.testing.assert_array_equal(out, ref.predict(x))
    _ok(lib, lib.LGBM_BoosterFree(b))
    _ok(lib, lib.LGBM_DatasetFree(h))


def test_shim_from_two_threads(lib, tmp_path):
    data = [_data(3 + t) for t in range(2)]
    pstr = b" ".join(f"{k}={v}".encode() for k, v in PARAMS.items())
    alone = []
    for t, (x, y) in enumerate(data):
        _, b = _capi_model(lib, x, y, pstr, 3)
        alone.append(_text(lib, b, tmp_path / f"alone{t}.txt"))
    texts, errors = [None, None], []

    def worker(t):
        try:
            _, b = _capi_model(lib, *data[t], pstr, 3)
            texts[t] = _text(lib, b, tmp_path / f"thread{t}.txt")
        except Exception as e:      # re-raised in the main thread
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert texts == alone
