"""lightgbm_tpu_torch's dense binning kernel on the card.

bin_dense (csrc/bin.cu) against its plain PyTorch version on the card
and against the host pass (BinMapper.value_to_bin), bit for bit, on row
counts no tile divides, with NaN, +-inf and values on the bounds, at
uint8 and int16 widths on the lane route (up to 1,024 bounds), int16 at
3,000 bins on the direct route with its bounds in shared-memory feature
tiles, and int32 at 40,000 bins on the direct route with its bounds in
device memory; the lane route on a ragged last tile, an x that is a
misaligned view, a column subset, int16 and int32 output, more than 32
features (several groups) and 400 features (1,600-byte rows of x), and
the direct route's shared-memory tiles on the same ragged matrix; two
launches bitwise equal; and a dataset built for the card binned by it,
its bins seeding the device cache the learner reads.

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_bin_card.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import DatasetLoader
from lightgbm_tpu_torch.ops import bin_kernels as bk

DEV = "cuda"

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _case(n, f, max_bin, seed):
    """n rows of a matrix whose mappers come from its first max(n, 3000)
    rows, with NaN, +-inf and every bound planted."""
    rng = np.random.RandomState(seed)
    full = rng.randn(max(n, 3000), f).astype(np.float32)
    full[:, 1] = np.round(full[:, 1] * 4)
    ds = DatasetLoader(Config.from_params(
        {"max_bin": max_bin, "verbose": -1})).construct_from_matrix(full)
    x = full[:n].copy()
    x[rng.rand(n) < 0.02, 0] = np.nan
    x[rng.rand(n) < 0.01, 2 % f] = np.inf
    x[rng.rand(n) < 0.01, 3 % f] = -np.inf
    for j, m in zip(ds.real_feature_idx, ds.bin_mappers):
        b = np.asarray(m.bin_upper_bound[:-1], np.float32)[:n]
        x[:len(b), j] = b
    return x, ds


def _host(x, ds, dtype):
    return np.stack([m.value_to_bin(x[:, j]).astype(dtype)
                     for j, m in zip(ds.real_feature_idx, ds.bin_mappers)])


@pytest.mark.parametrize("n,f,max_bin", [
    (100_003, 28, 255), (4_097, 28, 1023), (257, 3, 255), (1, 5, 63),
    (20_011, 5, 3000), (40_000, 2, 40_000)],
    ids=["uint8", "int16-lane-table", "short", "one-row",
         "int16-shared-bound-tiles", "int32-bounds-in-device-memory"])
def test_kernel_equals_plain_and_host(n, f, max_bin):
    x, ds = _case(n, f, max_bin, seed=n)
    if max_bin == 3000:          # the direct route, bounds in shared memory
        assert 1024 < max(len(m.bin_upper_bound) for m in ds.bin_mappers) \
            <= 8192
    dtype = ds.bins.dtype
    tdt = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
           np.dtype(np.int32): torch.int32}[np.dtype(dtype)]
    xd = torch.from_numpy(x).to(DEV)
    cols = torch.from_numpy(ds.real_feature_idx.astype(np.int32)).to(DEV)
    bounds = torch.from_numpy(bk.dense_bounds(
        [m.bin_upper_bound for m in ds.bin_mappers])).to(DEV)
    before = bk.launch_counts()["bin_dense"]
    one = bk.bin_dense(xd, cols, bounds, tdt)
    two = bk.bin_dense(xd, cols, bounds, tdt)
    torch.cuda.synchronize()
    assert bk.launch_counts()["bin_dense"] == before + 2
    assert torch.equal(one, two)
    assert torch.equal(one, bk.bin_dense_plain(xd, cols, bounds, tdt))
    np.testing.assert_array_equal(one.cpu().numpy(), _host(x, ds, dtype))


@pytest.mark.parametrize("case", [
    "ragged", "misaligned-view", "column-subset", "int16", "int32",
    "groups", "wide-rows", "direct-shared-bounds"])
def test_lane_route_cases(case):
    rng = np.random.RandomState(11)
    # n = 12,345 leaves a ragged last tile and unaligned output rows
    # (scalar stores); the multiples of 64 take the 32-byte stores
    n, c, bins, tdt = 12_345, 28, 255, torch.uint8
    if case == "groups":
        n, c = 12_800, 70
    if case == "wide-rows":          # 13 groups, 1,600-byte rows of x
        c = 400
    if case == "direct-shared-bounds":   # > 1,024 bounds: the direct route
        bins, tdt = 3000, torch.int16
    if case == "int16":
        n, bins, tdt = 12_288, 1023, torch.int16
    if case == "int32":
        n, tdt = 12_352, torch.int32
    x = rng.randn(n, c).astype(np.float32)
    x[rng.rand(n, c) < 0.02] = np.nan
    x[rng.rand(n, c) < 0.01] = np.inf
    x[rng.rand(n, c) < 0.01] = -np.inf
    cols = np.arange(c, dtype=np.int32)
    if case == "column-subset":
        cols = np.array([27, 3, 3, 11, 0, 19], np.int32)
    qs = np.linspace(0, 1, bins + 1)[1:-1]
    ub = [np.append(np.quantile(np.nan_to_num(x[:, j], posinf=0, neginf=0),
                                qs), np.inf) for j in cols]
    for u in ub:                     # values on the bounds
        x[rng.choice(n, 50), cols[0]] = np.float32(u[rng.randint(len(u) - 1)])
    bounds = torch.from_numpy(bk.dense_bounds(ub)).to(DEV)
    xd = torch.from_numpy(x).to(DEV)
    if case == "misaligned-view":    # 4 bytes past a 16-byte boundary
        flat = torch.empty(n * c + 1, device=DEV)
        xd = flat[1:].view(n, c)
        xd.copy_(torch.from_numpy(x))
        assert xd.data_ptr() % 16 == 4 and xd.is_contiguous()
    cd = torch.from_numpy(cols).to(DEV)
    one = bk.bin_dense(xd, cd, bounds, tdt)
    two = bk.bin_dense(xd, cd, bounds, tdt)
    torch.cuda.synchronize()
    assert one.shape == (len(cols), n) and one.dtype == tdt
    assert torch.equal(one, two)
    assert torch.equal(one, bk.bin_dense_plain(xd, cd, bounds, tdt))
    # against searchsorted on the host: #{b : bound_b < v}, NaN as 0.0
    b_np = bounds.cpu().numpy()
    for k, j in enumerate(cols[:6]):
        v = np.nan_to_num(x[:, j], nan=0.0, posinf=np.inf, neginf=-np.inf)
        want = np.searchsorted(b_np[k], v, side="left")
        np.testing.assert_array_equal(one[k].cpu().numpy(), want)


def test_dataset_on_the_card_seeds_the_device_bins():
    rng = np.random.RandomState(0)
    x = rng.randn(50_000, 28).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    before = bk.launch_counts()["bin_dense"]
    ds = lgt.Dataset(x, y).construct(device=DEV)
    assert bk.launch_counts()["bin_dense"] == before + 1
    host = lgt.Dataset(x, y).construct()
    np.testing.assert_array_equal(ds._core.bins, host._core.bins)
    dev_bins = ds._core.device_bins(DEV)
    assert dev_bins.device.type == "cuda"
    assert torch.equal(dev_bins.cpu(), torch.from_numpy(host._core.bins))
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1}
    a = lgt.train(params, ds, 3, device=DEV)
    b = lgt.train(params, host, 3, device=DEV)
    assert a.model_to_string() == b.model_to_string()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((8, 4), device=DEV)
    cols = torch.tensor([0, 1], dtype=torch.int32, device=DEV)
    bounds = torch.zeros((2, 3), device=DEV)
    with pytest.raises(ValueError):
        bk.bin_dense(x[:, ::2], cols, bounds, torch.uint8)   # not contiguous
    with pytest.raises(ValueError):
        bk.bin_dense(x, cols.cpu(), bounds, torch.uint8)     # two devices
    with pytest.raises(TypeError):
        bk.bin_dense(x, cols, bounds, torch.float16)
