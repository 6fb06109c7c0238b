"""lightgbm_tpu_torch's exclusive feature bundling against lightgbm_tpu
on the CPU.

The fixture is tests/test_bundling.py's (3,000 x 40: three 12-wide
one-hot groups and 4 dense columns), built here with the same seed. The
bundle plan and the stored slot matrix are held equal to the JAX
package's on every construction route (a matrix, CscColumns, the
two-round loader, the conflict-tolerant plan); trees structurally equal
to the JAX learner's on the masked, compacted, partitioned and
cache-less engines, leaf values and predictions within 1e-6 absolute
(the bound of test_torch_train.py; the largest difference measured on
these fixtures is 7.2e-7, on the compacted and partitioned engines).
Bin 0 of an expanded histogram is the slot total minus the member's
range on both sides, each package summing in its own float32 order.
The binary cache crosses packages both ways; a bundled train set scored
as its own valid set gives its train scores bit for bit; subset and cv
carry the plan; the fused trainer writes the per-iteration model.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lgj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import bundling as jbundling
from lightgbm_tpu.io.dataset import DatasetLoader as JLoader
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import bundling as tbundling
from lightgbm_tpu_torch.io.dataset import (CscColumns as TCsc,
                                           DatasetLoader as TLoader)
from lightgbm_tpu_torch.models.tree_learner import BundleMaps
from lightgbm_tpu.io.dataset import CscColumns as JCsc
from test_torch_train import _assert_same_model

CPU = "cpu"
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
        "verbose": -1, "shape_bucketing": "false"}


@pytest.fixture(scope="module")
def sparse_data():
    rng = np.random.RandomState(7)
    n = 3000
    cols = []
    for _ in range(3):
        onehot = np.zeros((n, 12), np.float32)
        onehot[np.arange(n), rng.randint(0, 12, size=n)] = 1.0
        cols.append(onehot)
    dense = rng.randn(n, 4).astype(np.float32)
    x = np.concatenate(cols + [dense], axis=1)
    logit = (x[:, 0] + x[:, 12] - x[:, 24] + 0.5 * dense[:, 0]
             + 0.3 * rng.randn(n))
    return x, (logit > 0.4).astype(np.float32)


def _near_exclusive():
    """tests/test_bundling.py's tolerant-mode fixture: four one-hot
    groups where 1% of rows light a second column."""
    rng = np.random.RandomState(13)
    n = 4000
    cols = []
    for _ in range(4):
        onehot = np.zeros((n, 12), np.float32)
        onehot[np.arange(n), rng.randint(0, 12, size=n)] = 1.0
        extra = rng.rand(n) < 0.01
        onehot[extra, rng.randint(0, 12, size=extra.sum())] = 1.0
        cols.append(onehot)
    x = np.concatenate(cols, axis=1)
    return x, (x[:, 0] + x[:, 12] > 0.5).astype(np.float32)


def _same_plan(j, t):
    assert j.bundle_plan is not None and t.bundle_plan is not None
    for k, v in j.bundle_plan.to_dict().items():
        np.testing.assert_array_equal(t.bundle_plan.to_dict()[k], v,
                                      err_msg=k)
    assert t.bins.dtype == j.bins.dtype
    np.testing.assert_array_equal(np.asarray(t.bins), np.asarray(j.bins))
    assert t.max_stored_bin == j.max_stored_bin


def _write_tsv(path, x, y):
    with open(path, "w") as f:
        for i in range(len(y)):
            f.write("\t".join([f"{y[i]:g}"] + [f"{v:.9g}" for v in x[i]])
                    + "\n")


@pytest.mark.parametrize("route", ["matrix", "csc", "two_round", "tolerant"])
def test_plan_and_stored_bins_equal_jax(sparse_data, tmp_path, route):
    x, y = sparse_data
    params = {"verbose": -1}
    if route == "tolerant":
        x, y = _near_exclusive()
        params["max_conflict_rate"] = 0.05
    jl = JLoader(JConfig.from_params(params))
    tl = TLoader(TConfig.from_params(params))
    if route == "csc":
        m = sp.csc_matrix(x)
        args = (m.indptr, m.indices, m.data, *m.shape)
        j = jl.construct_from_matrix(JCsc(*args), label=y)
        t = tl.construct_from_matrix(TCsc(*args), label=y)
    elif route == "two_round":
        path = str(tmp_path / "train.tsv")
        _write_tsv(path, x, y)
        params.update(use_two_round_loading=True,
                      enable_load_from_binary_file=False)
        j = JLoader(JConfig.from_params(params)).load_from_file(path)
        t = TLoader(TConfig.from_params(params)).load_from_file(path)
    else:
        j = jl.construct_from_matrix(x, label=y)
        t = tl.construct_from_matrix(x, label=y)
    _same_plan(j, t)
    assert t.bins.shape[0] < t.num_features
    if route == "tolerant":
        assert t.bundle_plan.conflict_rate == 0.05
    want = jbundling.expansion_maps(j.bundle_plan, j.bin_mappers,
                                    j.max_num_bin)[0]
    got = tbundling.expansion_maps(t.bundle_plan, t.num_bin_array(),
                                   t.max_num_bin)
    np.testing.assert_array_equal(got, want)
    jv, tv = j.traversal_bins(), t.traversal_bins()
    rows = np.arange(t.num_data)
    for f in range(t.num_features):
        np.testing.assert_array_equal(tv[np.full_like(rows, f), rows],
                                      jv[np.full_like(rows, f), rows])


def test_expand_gives_the_unbundled_histogram(sparse_data):
    """The stored histogram of a bundled set expands to the unbundled
    set's histogram: bins >= 1 exactly, bin 0 within float32 round-off;
    a padding slot (the partitioned layout's) and a leading batch axis
    change nothing."""
    x, y = sparse_data
    ds = TLoader(TConfig.from_params({"verbose": -1})).construct_from_matrix(
        x, label=y)
    flat = TLoader(TConfig.from_params({"verbose": -1,
                                        "is_enable_sparse": False})
                   ).construct_from_matrix(x, label=y)
    rng = np.random.RandomState(0)
    ghc = torch.from_numpy(rng.randn(3, ds.num_data).astype(np.float32))

    def hist(bins, b):
        out = torch.zeros((bins.shape[0], b, 3))
        for f in range(bins.shape[0]):
            out[f].index_add_(0, torch.from_numpy(bins[f].astype(np.int64)),
                              ghc.t())
        return out

    maps = BundleMaps(ds.bundle_plan, ds.num_bin_array(), ds.max_num_bin,
                      "cpu")
    stored = hist(ds.bins, ds.max_stored_bin)
    padded = torch.cat([stored, stored[:1]])        # a slot of row totals
    got = maps.expand(torch.stack([padded, padded]))
    want = hist(flat.bins, flat.max_num_bin)
    assert got.shape == (2,) + tuple(want.shape)
    torch.testing.assert_close(got[0, :, 1:], want[:, 1:], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("extra", [
    {"hist_compaction": "false"},
    {"hist_compaction": "true"},
    {"partitioned_build": "true"},
    {"hist_compaction": "false", "histogram_pool_size": 0.001},
    {"hist_compaction": "true", "histogram_pool_size": 0.001},
    {"partitioned_build": "true", "histogram_pool_size": 0.001},
    {"hist_compaction": "false", "hist_frontier": "false",
     "histogram_pool_size": 0.001},
], ids=["masked", "compacted", "partitioned", "masked-cacheless",
        "compacted-cacheless", "partitioned-cacheless",
        "no-frontier-cacheless"])
def test_trees_equal_jax(sparse_data, extra):
    x, y = sparse_data
    params = dict(BASE, **extra)
    jb = lgj.train(params, lgj.Dataset(x, y), 6, verbose_eval=False)
    tb = lgt.train(params, lgt.Dataset(x, y), 6, verbose_eval=False,
                   device=CPU)
    learner = tb.gbdt.tree_learner
    assert learner.bundle is not None
    assert learner.use_partitioned is jb.gbdt.tree_learner._use_partitioned
    assert learner.use_compact is jb.gbdt.tree_learner._use_compact
    assert learner.cache_hists is ("histogram_pool_size" not in extra)
    # stored rows (padded to whole words when partitioned), not features
    assert learner.s_pad < learner.f_pad == 40
    _assert_same_model(jb, tb, x)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bundled_cache_crosses_packages(sparse_data, tmp_path, writer):
    """A bundled cache written by one package loads in the other and
    trains to the trees both packages grow from the text itself."""
    x, _ = sparse_data
    path = str(tmp_path / "train.tsv")
    _write_tsv(path, *sparse_data)
    params = dict(BASE, hist_compaction="false")
    (lgj if writer == "jax" else lgt).Dataset(
        path, params=params).save_binary(path + ".bin")
    text = dict(params, enable_load_from_binary_file=False)
    jb = lgj.train(text, lgj.Dataset(path, params=text), 4,
                   verbose_eval=False)
    tb = lgt.train(text, lgt.Dataset(path, params=text), 4,
                   verbose_eval=False, device=CPU)
    if writer == "jax":
        cached = lgt.train(params, lgt.Dataset(path + ".bin",
                                               params=params), 4,
                           verbose_eval=False, device=CPU)
        _assert_same_model(jb, cached, x)
    else:
        cached = lgj.train(params, lgj.Dataset(path + ".bin",
                                               params=params), 4,
                           verbose_eval=False)
        _assert_same_model(cached, tb, x)
    assert cached.gbdt.train_data.bundle_plan is not None


def test_incompatible_bundled_cache_rebuilds_from_text(sparse_data,
                                                       tmp_path):
    """A bundled cache this config cannot use (bundling off, or a more
    tolerant plan) is passed over, as the JAX loader does: the text is
    binned again and the cache is kept."""
    x, y = sparse_data
    path = str(tmp_path / "train.tsv")
    _write_tsv(path, x, y)
    lgt.Dataset(path, params={"verbose": -1}).save_binary(path + ".bin")
    before = open(path + ".bin", "rb").read()
    for params in ({"is_enable_sparse": False},
                   {"max_conflict_rate": 0.0}):
        cfg = dict(params, verbose=-1, is_save_binary_file=True)
        core = lgt.Dataset(path, params=cfg).construct()._core
        jcore = lgj.Dataset(path, params=cfg).construct()._core
        assert (core.bundle_plan is None) == (jcore.bundle_plan is None)
        np.testing.assert_array_equal(core.bins, jcore.bins)
    assert open(path + ".bin", "rb").read() == before


def test_bundled_train_set_as_valid_set(sparse_data):
    """The valid-set traversal decodes the slots: a bundled train set
    registered as its own valid set scores its train scores, bit for
    bit (the same float32 leaf values added to the same scores)."""
    x, y = sparse_data
    ds = lgt.Dataset(x, y)
    b = lgt.Booster(dict(BASE, metric="binary_logloss"), ds, device=CPU)
    b.add_valid(ds, "self")
    for _ in range(3):
        b.update()
    gbdt = b.gbdt
    assert gbdt.train_data.bundle_plan is not None
    assert torch.equal(gbdt.valid_score_updaters[0].score,
                       gbdt.train_score_updater.score)
    train, valid = b.eval_train(), b.eval_valid()
    assert train[0][2] == pytest.approx(valid[0][2], abs=1e-6)


def test_subset_and_cv_carry_the_plan(sparse_data):
    x, y = sparse_data
    params = dict(BASE, hist_compaction="false")
    idx = np.arange(0, 3000, 2)
    tsub = lgt.Dataset(x, y).subset(idx).construct()
    assert tsub._core.bundle_plan is not None
    assert tsub._core.bins.shape[0] < 40
    jb = lgj.train(params, lgj.Dataset(x, y).subset(idx), 3,
                   verbose_eval=False)
    tb = lgt.train(params, lgt.Dataset(x, y).subset(idx), 3,
                   verbose_eval=False, device=CPU)
    _assert_same_model(jb, tb, x)
    jr = lgj.cv(params, lgj.Dataset(x, y), 3, nfold=3, seed=1,
                verbose_eval=False)
    tr = lgt.cv(params, lgt.Dataset(x, y), 3, nfold=3, seed=1,
                verbose_eval=False, device=CPU)
    assert jr.keys() == tr.keys()
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=0, atol=1e-6)


def _noop(env):
    """A user callback: it keeps engine.train on the per-iteration loop."""


@pytest.mark.parametrize("extra", [
    {"hist_compaction": "false"}, {"hist_compaction": "true"},
    {"partitioned_build": "true", "bagging_fraction": 0.7,
     "bagging_freq": 2, "feature_fraction": 0.75}],
    ids=["masked", "compacted", "partitioned-bag-ff"])
def test_fused_trainer_equals_per_iteration_loop(sparse_data, extra):
    """The fused trainer (its block step runs eagerly on the CPU) grows
    the per-iteration loop's model on a bundled set, byte for byte."""
    x, y = sparse_data
    params = dict(BASE, **extra)
    fused = lgt.train(params, lgt.Dataset(x, y), 5, verbose_eval=False,
                      device=CPU)
    loop = lgt.train(params, lgt.Dataset(x, y), 5, verbose_eval=False,
                     callbacks=[_noop], device=CPU)
    assert fused.gbdt._fused_cache and not loop.gbdt._fused_cache
    assert fused.gbdt.tree_learner.bundle is not None
    assert fused.model_to_string() == loop.model_to_string()
