"""lightgbm_tpu_torch's fused trainer replaying its CUDA graph on the card.

The fused block captures one boosting iteration as a CUDA graph and
replays it once an iteration; on the CPU the same step runs eagerly
(tests/test_torch_fused.py). These tests hold the graph's replays to
the per-iteration loop on the card, where only the replays run them:

- bagging's in-bag mask copied into the graph's static buffer between
  replays and each tree's feature mask picked in the graph by the
  device counter, with the masked, partitioned and cache-less builders:
  model text byte for byte, train score bit for bit, and no host sync in
  a block but its one transfer (the bag's on-device randperm included);
- a natural stop mid-block (the train score rebuilt into the graph's
  tensor), an early-stop break mid-block (the score snapshot copied into
  it, the block's tail dropped), and a longer block's recapture.

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_fused_card.py -m cuda --noconftest
"""

import warnings

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models import gbdt as gbdt_mod
from lightgbm_tpu_torch.ops import hist_kernels as hk

DEV = "cuda"
BASE = {"num_leaves": 15, "min_data_in_leaf": 20, "verbose": -1,
        "partitioned_build": "false", "hist_compaction": "false",
        "device_row_chunk": 4096}
SAMPLING = {"bagging_fraction": 0.7, "bagging_freq": 2,
            "feature_fraction": 0.75}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _noop(env):
    """A user callback: it keeps engine.train on the per-iteration loop."""


def _data(seed=9, n=20000, f=8):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    y = (x[:, 0] + x[:, 1] + 0.3 * rng.randn(n) > 1.0).astype(np.float32)
    return x, y


def _runner(booster):
    (runner,) = booster.gbdt._fused_cache.values()
    return runner


def _transfer_line():
    with open(gbdt_mod.__file__) as f:
        for i, line in enumerate(f, 1):
            if "ONE transfer a block" in line:
                return (gbdt_mod.__file__, i)
    raise AssertionError("the fused block's transfer line was not found")


def _sync_sites(fn):
    """Every host sync `fn` makes, as (file, line), from torch.cuda's
    sync debug mode "warn"."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted({(w.filename, w.lineno) for w in caught
                   if "synchron" in str(w.message).lower()
                   and "prototype" not in str(w.message)})


@pytest.mark.parametrize("builder", [
    {}, {"partitioned_build": "true"}, {"histogram_pool_size": 0.001}],
    ids=["masked", "partitioned", "cacheless"])
def test_sampled_replays_equal_per_iteration_on_card(builder):
    x, y = _data()
    params = dict(BASE, objective="binary", **SAMPLING, **builder)
    loop = lgt.train(params, lgt.Dataset(x, y), 6, verbose_eval=False,
                     callbacks=[_noop], device=DEV)
    hk.reset_launch_counts()
    fused = lgt.train(params, lgt.Dataset(x, y), 6, verbose_eval=False,
                      device=DEV)
    counts = hk.launch_counts()
    runner = _runner(fused)
    assert runner.graph is not None and not loop.gbdt._fused_cache
    assert fused.gbdt.tree_learner.cache_hists is ("histogram_pool_size"
                                                   not in builder)
    # the warm-up step launches what a replay does, then 6 replays
    assert runner.graph.launches
    for name, c in runner.graph.launches.items():
        assert counts[name] == 7 * c, name
    assert len(fused.gbdt.models) == 6
    assert fused.model_to_string() == loop.model_to_string()
    np.testing.assert_array_equal(fused.gbdt.get_training_score(),
                                  loop.gbdt.get_training_score())
    # a second block through the same graph: its one transfer is the
    # only sync, and its trees are the loop's next ones
    sites = _sync_sites(lambda: fused.gbdt.train_many(6))
    assert sites == [_transfer_line()]
    for _ in range(6):
        loop.gbdt.train_one_iter()
    assert _runner(fused) is runner
    assert fused.model_to_string() == loop.model_to_string()


def _natural_stop_problem():
    rng = np.random.RandomState(5)
    x = (rng.rand(500, 2) > 0.5).astype(np.float64)
    y = (x[:, 0] > 0.5).astype(float)
    return x, y


@pytest.mark.parametrize("ff", [1.0, 0.5], ids=["ff1", "ff0.5"])
def test_natural_stop_mid_block_on_card(ff):
    """An empty tree mid-block (split gains decay geometrically and
    min_gain_to_split stops real splits after 3 trees): the train score
    of the kept trees is rebuilt into the graph's tensor, and the rest of
    the rounds run in the per-iteration loop, as the forced loop does."""
    x, y = _natural_stop_problem()
    probe = lgt.train({"objective": "binary", "verbose": -1,
                       "num_leaves": 4}, lgt.Dataset(x, y), 6,
                      verbose_eval=False, device=DEV)
    gains = [float(t.split_gain[0]) for t in probe.gbdt.models]
    assert gains == sorted(gains, reverse=True)
    params = {"objective": "binary", "metric": "binary_logloss",
              "num_leaves": 4, "verbose": -1, "feature_fraction": ff,
              "min_gain_to_split": (gains[2] + gains[3]) / 2.0}
    res = []
    for force in (True, False):
        dtr = lgt.Dataset(x, y)
        dva = lgt.Dataset(x[:100].copy(), y[:100].copy(), reference=dtr)
        ev = {}
        b = lgt.train(params, dtr, 8, valid_sets=[dva], evals_result=ev,
                      verbose_eval=False,
                      callbacks=[_noop] if force else None, device=DEV)
        res.append((b, ev))
    (b1, e1), (b2, e2) = res
    assert _runner(b2).graph is not None and len(b2.gbdt.models) < 8
    assert b1.model_to_string() == b2.model_to_string()
    assert e1 == e2
    np.testing.assert_array_equal(b1.gbdt.get_training_score(),
                                  b2.gbdt.get_training_score())


@pytest.mark.parametrize("builder", ["false", "true"],
                         ids=["masked", "partitioned"])
def test_early_stop_break_mid_block_on_card(builder):
    """Valid labels drawn at random: the valid loss is least after the
    first rounds, so early stopping (5 rounds, blocks of 5) breaks inside
    the second block. The train set is a valid set too, so every
    snapshot is copied into the graph's train score tensor."""
    x, y = _data(seed=11, n=6000)
    rng = np.random.RandomState(12)
    xv = rng.rand(2000, x.shape[1]).astype(np.float32)
    yv = (rng.rand(2000) < 0.5).astype(np.float32)
    params = dict(BASE, objective="binary", partitioned_build=builder,
                  metric=["auc", "binary_logloss"], **SAMPLING)
    res = []
    for force in (True, False):
        dtr = lgt.Dataset(x, y)
        dva = lgt.Dataset(xv, yv, reference=dtr)
        ev = {}
        b = lgt.train(params, dtr, 20, valid_sets=[dtr, dva],
                      valid_names=["tr", "va"], early_stopping_rounds=5,
                      evals_result=ev, verbose_eval=False,
                      callbacks=[_noop] if force else None, device=DEV)
        res.append((b, ev))
    (b1, e1), (b2, e2) = res
    assert _runner(b2).graph is not None and not b1.gbdt._fused_cache
    n_eval = len(e2["va"]["auc"])
    assert n_eval < 20 and n_eval % 5 != 0
    assert b1.best_iteration == b2.best_iteration
    assert b1.model_to_string() == b2.model_to_string()
    assert e1 == e2
    for i in (0, 1):
        np.testing.assert_array_equal(b1.gbdt.get_predict_at(i),
                                      b2.gbdt.get_predict_at(i))


def test_longer_block_recaptures_on_card():
    """Blocks of 3 reuse one graph; a block of 6 captures a new one with
    room for it; the trees are the per-iteration loop's."""
    x, y = _data(seed=3)
    params = dict(BASE, objective="regression", feature_fraction=0.75)
    fused = lgt.Booster(params, lgt.Dataset(x, y), device=DEV)
    fused.gbdt.train_many(3)
    first = _runner(fused)
    fused.gbdt.train_many(3)
    assert _runner(fused) is first and first.capacity == 3
    fused.gbdt.train_many(6)
    second = _runner(fused)
    assert second is not first and second.capacity == 6
    assert second.graph is not None
    loop = lgt.Booster(params, lgt.Dataset(x, y), device=DEV)
    for _ in range(12):
        loop.gbdt.train_one_iter()
    assert fused.model_to_string() == loop.model_to_string()
    np.testing.assert_array_equal(fused.gbdt.get_training_score(),
                                  loop.gbdt.get_training_score())
