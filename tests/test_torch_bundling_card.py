"""lightgbm_tpu_torch's exclusive feature bundling on the card.

On tests/test_bundling.py's fixture (3,000 x 40: three 12-wide one-hot
groups and 4 dense columns; 7 stored rows), with each builder and
engine (masked, compacted, partitioned, cache-less):
- the card's trees have the CPU port's structure (the card sums bin 0
  and the split scans in another float32 order than the CPU's, so leaf
  values are held within 1e-5 absolute);
- the histogram kernels ran on the stored slot matrix (launch counts);
- a fused run (the boosting iteration replayed as a CUDA graph) writes
  the per-iteration model text byte for byte;
- a bundled tree build makes no host sync;
- a bundled train set scored as its own valid set gives its train
  scores bit for bit.

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_bundling_card.py -m cuda --noconftest
"""

import warnings

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import hist_kernels as hk

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
        "verbose": -1}
ENGINES = {
    "masked": ({"hist_compaction": "false"}, ("masked_hist",)),
    "compacted": ({"hist_compaction": "true"},
                  ("compact_rows", "compacted_hist")),
    "partitioned": ({"partitioned_build": "true"}, ("seg_hist",)),
    "masked-cacheless": ({"hist_compaction": "false",
                          "histogram_pool_size": 0.001}, ("frontier_hist",)),
}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (lightgbm_tpu_torch kernels)")


def _data():
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


def _noop(env):
    """A user callback: it keeps engine.train on the per-iteration loop."""


@pytest.mark.parametrize("engine", list(ENGINES))
def test_card_trees_have_the_cpu_structure(engine):
    x, y = _data()
    extra, kernels = ENGINES[engine]
    params = dict(BASE, **extra)
    cpu = lgt.train(params, lgt.Dataset(x, y), 5, verbose_eval=False,
                    callbacks=[_noop], device="cpu")
    hk.reset_launch_counts()
    card = lgt.train(params, lgt.Dataset(x, y), 5, verbose_eval=False,
                     callbacks=[_noop], device="cuda")
    counts = hk.launch_counts()
    learner = card.gbdt.tree_learner
    assert learner.bundle is not None and learner.bins.shape[0] < 40
    for name in kernels:
        assert counts.get(name, 0) > 0, (name, counts)
    for a, b in zip(cpu.gbdt.models, card.gbdt.models):
        assert a.num_leaves == b.num_leaves
        np.testing.assert_array_equal(b.split_feature_real,
                                      a.split_feature_real)
        np.testing.assert_array_equal(b.threshold_in_bin, a.threshold_in_bin)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("engine", ["masked", "compacted", "partitioned"])
def test_fused_replays_write_the_per_iteration_model(engine):
    x, y = _data()
    params = dict(BASE, **ENGINES[engine][0])
    loop = lgt.train(params, lgt.Dataset(x, y), 5, verbose_eval=False,
                     callbacks=[_noop], device="cuda")
    fused = lgt.train(params, lgt.Dataset(x, y), 5, verbose_eval=False,
                      device="cuda")
    assert fused.gbdt._fused_cache
    assert fused.model_to_string() == loop.model_to_string()


@pytest.mark.parametrize("engine", ["masked", "compacted", "partitioned"])
def test_bundled_tree_build_makes_no_host_sync(engine):
    x, y = _data()
    booster = lgt.Booster(dict(BASE, **ENGINES[engine][0]),
                          lgt.Dataset(x, y), device="cuda")
    gbdt = booster.gbdt
    learner = gbdt.tree_learner
    n = gbdt.num_data
    g, h = gbdt.objective.get_gradients(torch.zeros(1, n, device="cuda"))
    fmask = torch.ones(learner.f_pad, dtype=torch.bool, device="cuda")
    inbag = torch.ones(n, device="cuda")
    learner.train_device(g[0], h[0], inbag, fmask)     # warm-up
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = learner.train_device(g[0], h[0], inbag, fmask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert int(out["n_splits"]) > 0


def test_bundled_train_set_as_valid_set():
    x, y = _data()
    ds = lgt.Dataset(x, y)
    b = lgt.Booster(dict(BASE, metric="binary_logloss"), ds, device="cuda")
    b.add_valid(ds, "self")
    for _ in range(3):
        b.update()
    gbdt = b.gbdt
    assert gbdt.train_data.bundle_plan is not None
    assert torch.equal(gbdt.valid_score_updaters[0].score,
                       gbdt.train_score_updater.score)
