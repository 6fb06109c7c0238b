"""lightgbm_tpu_torch's dense binning against lightgbm_tpu.

The port bins a dense float32 matrix of numerical features where the
dataset is built for (ops/bin_kernels.py bin_dense: the CUDA kernel on
a card, its plain compare-count on the CPU). On the CPU the plain
version is held bit for bit against the JAX package's device program
(lightgbm_tpu/io/dataset.py _bin_dense_on_device, run on the CPU with
LIGHTGBM_TPU_DEVICE_BIN=1) and against the host pass
(BinMapper.value_to_bin), with NaN, +-inf, values on the bounds,
negative bounds, float64 bounds float32 cannot hold, ragged bound rows
and uint8 and int16 widths.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import dataset as jdataset
from lightgbm_tpu.io.bin_mapper import BinMapper as JBinMapper
from lightgbm_tpu.io.dataset import DatasetLoader as JLoader
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.io.bin_mapper import BinMapper as TBinMapper
from lightgbm_tpu_torch.io.dataset import DatasetLoader as TLoader
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.ops import bin_kernels as bk

TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
               np.dtype(np.int16): torch.int16,
               np.dtype(np.int32): torch.int32}


def _matrix(seed, n=5000, f=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    x[:, 1] = np.round(x[:, 1] * 3)              # few distinct values
    x[:, 2] -= 4.0                               # every bound negative
    x[rng.rand(n) < 0.3, 3] = 0.0                # zeros mixed in
    return x


def _plant(x, mappers, real_idx, rng):
    """NaN, +-inf, and values exactly on (the float32 rounding of) each
    feature's bounds and one float32 step on either side."""
    x = x.copy()
    n = x.shape[0]
    x[rng.rand(n) < 0.02, 0] = np.nan
    x[rng.rand(n) < 0.01, 4] = np.inf
    x[rng.rand(n) < 0.01, 5] = -np.inf
    for j, m in zip(real_idx, mappers):
        b = np.asarray(m.bin_upper_bound[np.isfinite(m.bin_upper_bound)],
                       np.float32)
        on = np.concatenate([b, np.nextafter(b, np.float32(np.inf)),
                             np.nextafter(b, np.float32(-np.inf))])
        rows = rng.choice(n, min(len(on), n // 2), replace=False)
        x[rows, j] = on[:len(rows)]
    return x


def _plain(x, real_idx, mappers, dtype):
    return bk.bin_dense_plain(
        torch.from_numpy(np.ascontiguousarray(x)),
        torch.from_numpy(np.asarray(real_idx, np.int32)),
        torch.from_numpy(bk.dense_bounds([m.bin_upper_bound
                                          for m in mappers])),
        TORCH_DTYPE[np.dtype(dtype)]).numpy()


def _host(x, real_idx, mappers, dtype):
    return np.stack([m.value_to_bin(x[:, j]).astype(dtype)
                     for j, m in zip(real_idx, mappers)])


@pytest.fixture(params=[255, 1000], ids=["uint8", "int16"])
def jax_dataset(request):
    x = _matrix(request.param)
    ds = JLoader(JConfig.from_params(
        {"max_bin": request.param, "verbose": -1})).construct_from_matrix(x)
    return x, ds


def test_plain_equals_jax_device_program_and_host_pass(jax_dataset,
                                                       monkeypatch):
    x, ds = jax_dataset
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_BIN", "1")
    real = np.asarray(ds.real_feature_idx)
    xp = _plant(x, ds.bin_mappers, real, np.random.RandomState(3))
    want = jdataset._bin_dense_on_device(xp, real, ds.bin_mappers,
                                         ds.bins.dtype)
    assert want is not None and want.dtype == ds.bins.dtype
    got = _plain(xp, real, ds.bin_mappers, ds.bins.dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _host(xp, real, ds.bin_mappers,
                                             ds.bins.dtype))


def _mapper(cls, bounds):
    m = cls()
    m.bin_upper_bound = np.asarray(bounds, np.float64)
    m.num_bin = len(bounds)
    return m


def _ragged_case(rows):
    rng = np.random.RandomState(5)
    n = 4099
    x = (rng.randn(n, 4) * 2).astype(np.float32)
    specials = np.float32([0.1, 1 / 3, -1 / 3, 7.0000001, 1e-45, -1e-45,
                           1e-30, -1e-30, 0.0, -0.0, 3.4028235e38,
                           -3.4028235e38, np.inf, -np.inf, np.nan])
    x[:, 3] = specials[rng.randint(0, len(specials), n)]
    x[::7, 0] = np.nextafter(np.float32(0.1), np.float32(1))
    return x, np.asarray([3, 0, 2], np.int32)


RAGGED = [[-3e38, -1 / 3, -1e-30, 0.1, 3e38, np.inf],
          [0.1, np.inf],
          [-2.5, 1 / 3, 7.0000001, np.inf]]


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_bounds_float32_cannot_hold_and_ragged_rows(dtype, monkeypatch):
    """Bounds between float32 values (0.1, 1/3, -1e-30, +-3e38), rows of
    2 to 6 bounds (+inf pads), columns taken out of order with one
    skipped, a row count no chunk divides, NaN and +-inf inputs."""
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_BIN", "1")
    x, real = _ragged_case(RAGGED)
    tm = [_mapper(TBinMapper, r) for r in RAGGED]
    jm = [_mapper(JBinMapper, r) for r in RAGGED]
    got = _plain(x, real, tm, dtype)
    np.testing.assert_array_equal(
        got, jdataset._bin_dense_on_device(x, real, jm, dtype))
    np.testing.assert_array_equal(got, _host(x, real, tm, dtype))


def test_bounds_beyond_float32_range(monkeypatch):
    """Bounds of +-1e39 round to -inf and float32's largest value; with
    +-inf and +-float32-max inputs (and no NaN, which makes the JAX
    program and the host pass clip infinities to their type's largest
    value) all three count alike."""
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_BIN", "1")
    rows = [[-1e39, 0.0, 1e39, np.inf]]
    big = np.finfo(np.float32).max
    x = np.float32([[np.inf], [-np.inf], [big], [-big], [0.0], [1.0]])
    real = np.asarray([0], np.int32)
    got = _plain(x, real, [_mapper(TBinMapper, r) for r in rows], np.uint8)
    np.testing.assert_array_equal(got[0], [3, 0, 2, 1, 1, 2])
    np.testing.assert_array_equal(got, jdataset._bin_dense_on_device(
        x, real, [_mapper(JBinMapper, r) for r in rows], np.uint8))
    np.testing.assert_array_equal(got, _host(
        x, real, [_mapper(TBinMapper, r) for r in rows], np.uint8))


def test_subnormal_bound_bins_as_the_host_pass(monkeypatch):
    """A bound of -1e-40 is a float32 subnormal. The plain version (and
    the CUDA kernel, built without flush-to-zero) bins 0.0 above it, as
    the host pass does; the JAX device program on the CPU flushes it to
    -0.0 and bins 0.0 one bin lower (ROADMAP queue 3)."""
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_BIN", "1")
    rows = [[-1e-40, 1.0, np.inf]]
    x = np.float32([[0.0], [-0.0], [-1e-45], [1e-45], [-2e-40], [0.5]])
    real = np.asarray([0], np.int32)
    tm = [_mapper(TBinMapper, r) for r in rows]
    got = _plain(x, real, tm, np.uint8)
    np.testing.assert_array_equal(got, _host(x, real, tm, np.uint8))
    np.testing.assert_array_equal(got[0], [1, 1, 1, 1, 0, 1])
    jax_bins = jdataset._bin_dense_on_device(
        x, real, [_mapper(JBinMapper, r) for r in rows], np.uint8)
    assert jax_bins[0, 0] == 0      # the JAX divergence, recorded


def test_dense_bounds_round_toward_minus_inf():
    ub = [np.array([0.1, 1 / 3, -0.1, 1e39, -1e39, 2.0, np.inf]),
          np.array([-1e-40, np.inf])]
    b = bk.dense_bounds(ub)
    assert b.dtype == np.float32 and b.shape == (2, 7)
    assert np.all(b[1, 2:] == np.inf)
    for row, u in zip(b, ub):
        for v32, v64 in zip(row, u):
            assert float(v32) <= v64            # never above the bound
            assert float(np.nextafter(v32, np.float32(np.inf))) > v64 \
                or v32 == np.inf


def test_plain_refuses_bad_inputs():
    x = torch.zeros((4, 3))
    cols = torch.tensor([0, 2], dtype=torch.int32)
    bounds = torch.zeros((2, 5))
    with pytest.raises(ValueError):
        bk.bin_dense(x.double(), cols, bounds, torch.uint8)
    with pytest.raises(ValueError):
        bk.bin_dense(x, cols.long(), bounds, torch.uint8)
    with pytest.raises(ValueError):
        bk.bin_dense(x, cols, bounds[:1], torch.uint8)
    with pytest.raises(TypeError):
        bk.bin_dense(x, cols, bounds, torch.float32)
    before = bk.launch_counts()["bin_dense"]
    assert bk.bin_dense(x, cols, bounds, torch.uint8).shape == (2, 4)
    assert bk.launch_counts()["bin_dense"] == before   # the CPU launches none


@pytest.fixture
def counting_plain(monkeypatch):
    calls = []
    real = bk.bin_dense_plain

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(bk, "bin_dense_plain", spy)
    return calls


def test_dataset_for_the_cpu_bins_through_the_plain_version(counting_plain):
    """Dataset(X_float32).construct(device="cpu") takes bin_dense (the
    JAX package's device route); construct() with no device the host
    pass; both give the JAX package's bins, and the device bins are
    seeded from the binning."""
    x = _matrix(7)
    x[::11, 0] = np.nan
    y = (x[:, 0] > 0).astype(np.float32)
    on_cpu = lgt.Dataset(x, y).construct(device="cpu")._core
    assert len(counting_plain) == 1
    host = lgt.Dataset(x, y).construct()._core
    assert len(counting_plain) == 1
    want = lgj.Dataset(x, y).construct()._core.bins
    np.testing.assert_array_equal(on_cpu.bins, want)
    np.testing.assert_array_equal(host.bins, want)
    assert "cpu" in on_cpu._device_bins
    np.testing.assert_array_equal(on_cpu.device_bins("cpu").numpy(), want)


def test_booster_constructs_its_dataset_on_its_device(counting_plain):
    x = _matrix(8, n=1500)
    y = (x[:, 0] > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    tb = lgt.train(params, lgt.Dataset(x, y), 2, device="cpu")
    assert len(counting_plain) == 1
    hb = lgt.train(params, lgt.Dataset(x, y).construct(), 2, device="cpu")
    assert tb.model_to_string() == hb.model_to_string()


@pytest.mark.parametrize("kind", ["categorical", "float64", "reference"])
def test_host_pass_routes_stay(kind, counting_plain):
    """Categorical columns, float64 matrices (every text load) and
    aligned valid sets take the host pass, as in the JAX package."""
    x = _matrix(9, n=800)
    y = (x[:, 0] > 0).astype(np.float32)
    if kind == "categorical":
        x[:, 1] = np.abs(x[:, 1])
        ds = lgt.Dataset(x, y, categorical_feature=[1])
        ds.construct(device="cpu")
    elif kind == "float64":
        TLoader(device="cpu")._construct(x.astype(np.float64), None, set(),
                                         set(), Metadata(len(y)))
    else:
        train = lgt.Dataset(x, y)
        train.construct()
        lgt.Dataset(x[:100], y[:100], reference=train).construct(
            device="cpu")
    assert counting_plain == []
