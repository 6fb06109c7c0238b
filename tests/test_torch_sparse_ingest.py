"""lightgbm_tpu_torch's bundled O(nnz) ingestion against lightgbm_tpu.

The fixture is tests/test_sparse_ingest.py's wide LibSVM table (1,200
rows: 38 binary one-hot groups of 10, two groups of 12 continuous
sparse columns, 3 dense columns and one all-negative column whose zero
bin is high), built here with the same seed and written with the same
writer. Each case holds the port's bundle plan and stored slot matrix
equal to the JAX package's: the two-round LibSVM triplet stream, the
in-memory matrix, a CscColumns source under a bin budget below the
dense matrix, and the aligned valid file, which shares the train plan.
Trained from the streamed file, the trees are structurally equal to the
JAX package's, leaf values and predictions within 1e-6 absolute (the
bound of test_torch_train.py).
"""

import numpy as np
import pytest

import lightgbm_tpu as lgj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import CscColumns as JCsc
from lightgbm_tpu.io.dataset import DatasetLoader as JLoader
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import CscColumns as TCsc
from lightgbm_tpu_torch.io.dataset import DatasetLoader as TLoader
from test_sparse_ingest import _onehot_groups, _write_libsvm
from test_torch_bundling import _same_plan
from test_torch_train import _assert_same_model

CPU = "cpu"
STREAM = {"use_two_round_loading": True, "enable_load_from_binary_file": False,
          "verbose": -1}


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    rng = np.random.RandomState(5)
    n = 1200
    sparse = _onehot_groups(rng, n, groups=38, width=10)
    sparse = np.concatenate(
        [sparse, _onehot_groups(rng, n, 2, 12, binary=False)], axis=1)
    dense = rng.randint(-128, 128, (n, 3)) / 64.0
    neg = -1.0 - rng.randint(0, 64, (n, 1)) / 64.0
    x = np.concatenate([sparse, dense, neg], axis=1)
    y = (sparse[:, 0] + 0.5 * dense[:, 0] > 0.6).astype(np.float64)
    d = tmp_path_factory.mktemp("wide")
    paths = {}
    for name, rows in (("all", slice(None)), ("train", slice(0, 900)),
                       ("valid", slice(900, None))):
        paths[name] = str(d / f"{name}.libsvm")
        _write_libsvm(paths[name], x[rows], y[rows])
    return x, y, paths


def _both(params):
    return (JLoader(JConfig.from_params(params)),
            TLoader(TConfig.from_params(params)))


def test_streamed_libsvm_plan_and_bins_equal_jax(wide):
    x, y, paths = wide
    jl, tl = _both(STREAM)
    j, t = jl.load_from_file(paths["all"]), tl.load_from_file(paths["all"])
    _same_plan(j, t)
    assert t.bins.shape[0] <= 60 < t.num_features
    np.testing.assert_array_equal(t.metadata.label, j.metadata.label)
    # the in-memory construction of the same matrix: the same plan
    jm, tm = _both({"verbose": -1})
    mem = tm.construct_from_matrix(x.astype(np.float32), label=y)
    _same_plan(jm.construct_from_matrix(x.astype(np.float32), label=y), mem)
    np.testing.assert_array_equal(mem.bins, t.bins)


def test_csc_plan_and_bins_equal_jax_within_budget(wide, monkeypatch):
    """A CscColumns source plans and builds without the dense (F, N)
    block: the budget is set below it."""
    x, y, _ = wide
    monkeypatch.setenv("LIGHTGBM_TPU_MAX_BINS_GB",
                       str(0.5 * x.shape[0] * x.shape[1] / (1 << 30)))
    rows, cols = np.nonzero(x)
    csr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                     minlength=len(x)))])
    args = (csr, cols, x[rows, cols], x.shape[1])
    jl, tl = _both({"verbose": -1})
    _same_plan(jl.construct_from_matrix(JCsc.from_csr(*args), label=y),
               tl.construct_from_matrix(TCsc.from_csr(*args), label=y))


def test_aligned_valid_file_shares_the_plan(wide):
    _, _, paths = wide
    jl, tl = _both(STREAM)
    jtr, ttr = jl.load_from_file(paths["train"]), \
        tl.load_from_file(paths["train"])
    _same_plan(jtr, ttr)
    jva = jl.load_from_file_align_with_other_dataset(paths["valid"], jtr)
    tva = tl.load_from_file_align_with_other_dataset(paths["valid"], ttr)
    assert tva.bundle_plan is ttr.bundle_plan
    _same_plan(jva, tva)


def test_streamed_libsvm_trains_to_jax_trees(wide):
    x, _, paths = wide
    params = dict(STREAM, objective="binary", num_leaves=7,
                  min_data_in_leaf=5, shape_bucketing="false")
    jb = lgj.train(params, lgj.Dataset(paths["all"], params=params), 3,
                   verbose_eval=False)
    tb = lgt.train(params, lgt.Dataset(paths["all"], params=params), 3,
                   verbose_eval=False, device=CPU)
    assert tb.gbdt.train_data.bundle_plan is not None
    assert tb.gbdt.models[0].num_leaves > 1
    _assert_same_model(jb, tb, x)


@pytest.mark.parametrize("keys", [{}, {"is_enable_sparse": "false"},
                                  {"max_conflict_rate": "0.05"}],
                         ids=["default", "unbundled", "tolerant"])
def test_cli_bundling_keys_reach_the_loader(wide, tmp_path, keys):
    """The CLI's is_enable_sparse and max_conflict_rate keys reach the
    loader: its dataset has the JAX loader's plan under the same keys,
    and its model file is the text train() writes with them. (Its trees
    are not held to the JAX CLI's: from the third tree on the two
    objectives' float32 exp differ in the last bit on this file, which
    moves its noise-level splits, gain about 1e-4.)"""
    from lightgbm_tpu_torch.application import Application
    _, _, paths = wide
    params = {"objective": "binary", "num_leaves": "7",
              "min_data_in_leaf": "5", "verbose": "-1",
              "enable_load_from_binary_file": "false", **keys}
    jl, tl = _both(params)
    j, t = jl.load_from_file(paths["train"]), tl.load_from_file(paths["train"])
    if "is_enable_sparse" in keys:
        assert j.bundle_plan is None and t.bundle_plan is None
        np.testing.assert_array_equal(t.bins, j.bins)
    else:
        _same_plan(j, t)
        assert t.bundle_plan.conflict_rate == float(
            keys.get("max_conflict_rate", 0.0))
    tpath = str(tmp_path / "t.txt")
    Application(["task=train", f"data={paths['train']}", "num_trees=3",
                 f"output_model={tpath}"]
                + [f"{k}={v}" for k, v in params.items()], device=CPU).run()
    want = lgt.train(params, lgt.Dataset(paths["train"], params=params), 3,
                     verbose_eval=False, device=CPU)
    with open(tpath) as f:
        assert f.read() == want.model_to_string()
