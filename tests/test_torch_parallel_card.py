"""lightgbm_tpu_torch's parallel learners on the card.

- CUDA mesh_fold (csrc/mesh.cu) equals its plain version bit for bit, on
  the card and on the CPU, for float32 components (K = 2 and 8, the
  pair exchange's 2W words at 1 and 4 shards, on a frontier root's
  (1, F, B, 3) histogram and a reduce-scatter shard's (f_loc, B, 3)
  block) and bfloat16 words (comm_precision=bf16), with zeros of both
  signs; two launches agree and each counts one launch;
- the data-parallel learner (reduce-scatter and allgather, 2 and 4
  shards sharing the card) grows the serial masked learner's trees on
  the card (same split features and thresholds, leaf values within rtol
  1e-5 and atol 1e-6: a shard's 4096-row chunks are not the serial
  learner's, so each histogram cell parts in its last float32 bits, and
  the split scan's sums on the card run in an order that follows the
  histogram's shape; a leaf near zero, whose gradients cancel, keeps
  that absolute error), its folds go through mesh_fold, and its counted
  collective bytes equal its CommPlan;
- a shard that raises on the card ends training with its error;
- with more than one card, the shards of every learner spread over the
  cards and the trees stay the serial ones (skips on one card).

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_parallel_card.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops import mesh_kernels as mk

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
        "verbose": -1, "hist_compaction": "false"}

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _components(k, shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((k, *shape), generator=g) * 1e4
    x[k // 2:] -= x[:k - k // 2].flip(0)          # cancelling words
    x = x + torch.randn((k, *shape), generator=g) * 1e-3
    flat = x.reshape(k, -1)
    flat[:, 0] = -0.0
    flat[0, 1] = -0.0
    flat[1:, 1] = 0.0
    return x.to(dtype)


@pytest.mark.parametrize("k,shape,dtype", [
    (2, (28, 255, 3), torch.float32),
    (8, (1, 28, 255, 3), torch.float32),
    (8, (7, 255, 3), torch.float32),
    (4, (28, 255, 3), torch.bfloat16)],
    ids=["k2", "k8_frontier", "k8_owned_block", "bf16"])
def test_mesh_fold_is_its_plain_version(k, shape, dtype):
    _need_card()
    comps = _components(k, shape, seed=k, dtype=dtype)
    dev = comps.cuda()
    before = hk.KERNELS["mesh_fold"].launches
    a, b = mk.mesh_fold(dev), mk.mesh_fold(dev)
    assert hk.KERNELS["mesh_fold"].launches == before + 2
    assert a.dtype == torch.float32 and a.shape == shape
    want_card = mk.mesh_fold_plain(dev)
    want_cpu = mk.mesh_fold_plain(comps)
    for want in (want_card.cpu(), want_cpu):
        assert torch.equal(a.cpu().view(torch.int32),
                           want.view(torch.int32))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _data(n=20000, f=10, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] - x[:, 2] * x[:, 3]
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("w,exchange", [(2, "auto"), (4, "auto"),
                                        (4, "allgather")])
def test_data_parallel_tree_on_the_card_is_serial(w, exchange):
    _need_card()
    x, y = _data()
    ds = lgt.Dataset(x, y)
    ser = lgt.train(BASE, ds, 3)
    hk.reset_launch_counts()
    par = lgt.train(dict(BASE, tree_learner="data", num_machines=w,
                         hist_exchange=exchange), ds, 3)
    learner = par.gbdt.tree_learner
    assert learner.mesh.devices[0].type == "cuda"
    assert learner.use_reduce_scatter is (exchange == "auto")
    assert hk.KERNELS["mesh_fold"].launches >= 3 * 15
    assert hk.KERNELS["masked_hist"].launches >= 3 * 14 * w
    for ta, tb in zip(ser.gbdt.models, par.gbdt.models):
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.threshold_in_bin,
                                      tb.threshold_in_bin)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=1e-5,
                                   atol=1e-6)
    counted = learner.mesh.collective_bytes
    assert counted == {k: learner.collective_bytes.get(
        f"collective_bytes_{k}", 0) for k in counted}


def test_a_failing_shard_on_the_card_raises():
    _need_card()
    b = lgt.Booster(dict(BASE, tree_learner="data", num_machines=4),
                    lgt.Dataset(*_data(n=5000)))
    b.update()
    learner = b.gbdt.tree_learner
    inner = learner._shard_fn

    def failing(r, *args):
        if r == 1:
            raise RuntimeError("shard 1 failed")
        return inner(r, *args)

    learner._shard_fn = failing
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        b.update()
    torch.cuda.synchronize()


@pytest.mark.parametrize("learner,extra", [
    ("data", {}), ("data", {"hist_exchange": "allgather"}),
    ("data", {"partitioned_build": "true"}), ("feature", {}),
    ("voting", {"top_k": 10})],
    ids=["data_rs", "data_allgather", "data_partitioned", "feature",
         "voting"])
def test_shards_spread_over_the_cards(learner, extra):
    """With more than one card the shards live on cards r mod D: the
    exchanges copy between cards behind CUDA events, and the trees stay
    the serial learner's (voting with every feature voted)."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs more than one CUDA device")
    x, y = _data()
    ds = lgt.Dataset(x, y)
    base = dict(BASE, **extra)
    ser = lgt.train(base, ds, 3)
    par = lgt.train(dict(base, tree_learner=learner, num_machines=4), ds, 3)
    mesh = par.gbdt.tree_learner.mesh
    assert mesh.multi_device
    assert len(set(mesh.devices)) == min(4, torch.cuda.device_count())
    rtol = 2e-4 if "partitioned_build" in extra else 1e-5
    for ta, tb in zip(ser.gbdt.models, par.gbdt.models):
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.threshold_in_bin,
                                      tb.threshold_in_bin)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=rtol,
                                   atol=1e-6)
    np.testing.assert_allclose(np.ravel(par.predict(x)),
                               np.ravel(ser.predict(x)), atol=1e-5)
