"""lightgbm_tpu_torch's GOSS boosting against lightgbm_tpu, on the CPU.

- _goss_weights equals a numpy transcription of the JAX formula
  (lightgbm_tpu/models/goss.py:54-87) and the JAX function itself, each
  fed the port's uniforms: ties at the threshold, other_rate=0, the
  warm-up and K = 3 classes;
- the uniform draw, a counter-based hash of (bagging_seed, iteration,
  row), is pinned to its bits and is the same for a host iteration
  number and a device one;
- trees structurally equal to the JAX package's when both get one
  weight vector (the JAX side a GBDT whose _bagging returns the port's
  weights of the iteration), on the masked, compacted and partitioned
  builders; leaf values and predictions within test_torch_train.py's
  1e-6 times twice the largest weight (the amplification n_rest /
  rand_n, 8 here): an amplified row's g * w and h * w enter the float32
  sums that many times larger, and so does their rounding, which each
  package does in its own order (the JAX compacted route's chunk sums
  are even float64). Measured: 7.4e-6 on the compacted engine, 1.1e-6
  on the masked one, 9.3e-7 on the partitioned one;
- the fused trainer and the blockwise engine equal the per-iteration
  loop bit for bit; the model text round-trips and names its class; a
  bagging or rate conflict is refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgj
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.models.goss import GOSS as JGOSS

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.models.gbdt import create_boosting
from lightgbm_tpu_torch.models.goss import GOSS, goss_uniform
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = "cpu"
BASE = {"objective": "binary", "boosting": "goss", "num_leaves": 15,
        "learning_rate": 0.3, "min_data_in_leaf": 20, "verbose": -1,
        "metric_freq": 0, "partitioned_build": "false",
        "hist_compaction": "false", "shape_bucketing": "false",
        "device_row_chunk": 4096}
ROUNDS = 8  # warm-up ceil(1 / 0.3) = 4, then 4 sampled iterations


def _data(n=3000, f=8, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    y = (x[:, 0] + x[:, 1] + 0.2 * rng.randn(n) > 1.0).astype(np.float32)
    return x, y


# ------------------------------------------------------------ the weights
def _numpy_goss(g, h, u, n, top_rate, other_rate):
    """lightgbm_tpu/models/goss.py:54-87 in numpy float32 on given u."""
    score = np.sum(np.abs(g * h), axis=0)
    m = score.shape[-1]
    top_n = max(1, int(top_rate * n))
    rand_n = int(other_rate * n)
    thr = np.sort(score)[m - top_n]
    top = score >= thr
    w = top.astype(np.float32)
    if rand_n > 0:
        n_rest = max(int((~top[:n]).sum()), 1)
        p = np.float32(rand_n) / np.float32(n_rest)
        amp = np.float32(n_rest) / np.float32(rand_n)
        w = np.where(~top & (u < p), amp, w).astype(np.float32)
    return w


def _samplers(n, k, top_rate, other_rate, lr=0.3, seed=3):
    cfg = TConfig.from_params({"boosting": "goss", "top_rate": top_rate,
                               "objective": "multiclass" if k > 1
                               else "binary",
                               "other_rate": other_rate, "learning_rate": lr,
                               "bagging_seed": seed, "num_class": k})
    t = GOSS(device=CPU)
    t.config, t.num_data, t.num_class = cfg, n, k
    t._warmup = int(np.ceil(1.0 / lr))
    j = JGOSS()
    j.config, j.num_data, j.num_class = cfg, n, k
    j._warmup = t._warmup
    j._goss_key = jax.random.PRNGKey(seed)
    return t, j


@pytest.mark.parametrize("k,top_rate,other_rate,levels", [
    (1, 0.2, 0.1, None), (1, 0.2, 0.1, 7), (1, 0.3, 0.0, 5),
    (3, 0.2, 0.1, None), (3, 0.1, 0.4, 4)],
    ids=["binary", "ties", "other0", "k3", "k3-ties"])
def test_weights_equal_numpy_and_jax(k, top_rate, other_rate, levels,
                                     monkeypatch):
    n, it = 2000, 6
    rng = np.random.RandomState(5)
    g = rng.randn(k, n).astype(np.float32)
    h = (rng.rand(k, n) + 0.5).astype(np.float32)
    if levels:  # few distinct scores: many rows tie at the threshold
        g = np.round(g * levels) / levels
        h = np.ones_like(h)
    t, j = _samplers(n, k, top_rate, other_rate)
    u = goss_uniform(t.config.bagging_seed, it, n, CPU).numpy()
    got = t._bagging(it, torch.from_numpy(g), torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(
        got, _numpy_goss(g, h, u, n, top_rate, other_rate))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    np.testing.assert_array_equal(got, j._bagging(it, g, h))
    top_n = max(1, int(top_rate * n))
    assert (got == 1.0).sum() >= top_n
    if levels:
        assert (got == 1.0).sum() > top_n
    if other_rate == 0.0:
        assert set(np.unique(got)) <= {0.0, 1.0}


def test_warm_up_trains_on_every_row():
    n = 500
    t, j = _samplers(n, 1, 0.2, 0.1, lr=0.25)
    g = torch.randn(1, n)
    h = torch.ones(1, n)
    for it in range(4):
        assert t._bagging(it, g, h) is None
        assert j._bagging(it, g.numpy(), h.numpy()) is None
        w = t._goss_weights(torch.tensor([it]), g, h)
        assert torch.equal(w, torch.ones(n))
    w = t._goss_weights(torch.tensor([4]), g, h)
    assert torch.equal(w, t._bagging(4, g, h))
    assert not torch.equal(w, torch.ones(n))


def test_uniform_draw_is_pinned():
    u = goss_uniform(3, 5, 6, CPU)
    assert u.dtype == torch.float32
    assert u.numpy().view(np.int32).tolist() == [
        1051289956, 1061282512, 1057957099, 1064467368, 1050694534,
        1033755608]
    assert torch.equal(u, goss_uniform(3, torch.tensor([5]), 6, CPU))
    assert goss_uniform(-1, 1 << 30, 3, CPU).numpy().view(
        np.int32).tolist() == [1058910818, 1030016336, 1036444736]
    assert float(goss_uniform(0, 0, 1, CPU)[0]) > 0.0
    big = goss_uniform(7, 9, 1 << 18, CPU)
    assert 0.0 <= float(big.min()) and float(big.max()) < 1.0
    assert abs(float(big.mean()) - 0.5) < 5 * 0.2887 / 512
    assert not torch.equal(goss_uniform(7, 10, 64, CPU), big[:64])


# ------------------------------------------------------------- the trees
class _GivenWeights(JGBDT):
    """The JAX package's GBDT with the port's GOSS weights as its bag."""
    weights = {}

    def _bagging(self, it, gradients=None, hessians=None):
        w = self.weights.get(it)
        return None if w is None else np.asarray(w)


def _port_per_iteration(x, y, params, rounds):
    b = lgt.Booster(dict(params), lgt.Dataset(x, y), device=CPU)
    weights = {}
    orig = b.gbdt._bagging

    def record(it, g=None, h=None):
        w = orig(it, g, h)
        if w is not None:
            weights[it] = w.numpy().copy()
        return w
    b.gbdt._bagging = record
    for _ in range(rounds):
        b.update()
    return b, weights


def _jax_given(x, y, params, rounds, weights):
    jparams = dict(params)
    jparams.pop("boosting")
    b = lgj.Booster(jparams, lgj.Dataset(x, y))
    b.gbdt.__class__ = _GivenWeights   # a GBDT subclass: same state
    b.gbdt.weights = weights
    for _ in range(rounds):
        b.update()
    return b


@pytest.mark.parametrize("extra,n", [
    ({}, 3000),
    ({"hist_compaction": "auto"}, 6000),
    ({"partitioned_build": "true"}, 3000)],
    ids=["masked", "compacted", "partitioned"])
def test_trees_equal_jax_on_one_weight_vector(extra, n):
    x, y = _data(n=n)
    params = dict(BASE, **extra)
    tb, weights = _port_per_iteration(x, y, params, ROUNDS)
    assert sorted(weights) == list(range(4, ROUNDS))
    learner = tb.gbdt.tree_learner
    assert learner.use_compact is (n > 4096 and "hist_compaction" in extra)
    assert learner.use_partitioned is ("partitioned_build" in extra)
    for w in weights.values():
        assert len(np.unique(w)) == 3       # 0, 1 and the amplification
    jb = _jax_given(x, y, params, ROUNDS, weights)
    tol = 1e-6 * 2.0 * max(float(w.max()) for w in weights.values())
    jt, tt = jb.gbdt.models, tb.gbdt.models
    assert len(jt) == len(tt) == ROUNDS
    for a, b in zip(jt, tt):
        a = a.materialize() if hasattr(a, "materialize") else a
        assert a.num_leaves == b.num_leaves
        for key in ("split_feature_real", "threshold_in_bin", "left_child",
                    "right_child", "leaf_parent", "leaf_count",
                    "internal_count"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                          err_msg=key)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=tol)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("builder", ["false", "true"])
def test_fused_equals_per_iteration(builder):
    """test_goss.py:89: the fused block draws the per-iteration loop's
    sample and grows its trees, bit for bit."""
    x, y = _data()
    params = dict(BASE, partitioned_build=builder)
    seq, _ = _port_per_iteration(x, y, params, ROUNDS)
    fused = lgt.Booster(dict(params), lgt.Dataset(x, y), device=CPU)
    assert fused.gbdt._fused_eligible()
    assert fused.gbdt.warm_up_fused(ROUNDS)
    fused.gbdt.train_many(ROUNDS)
    assert fused.model_to_string() == seq.model_to_string()
    assert torch.equal(fused.gbdt.train_score_updater.score,
                       seq.gbdt.train_score_updater.score)


def test_blockwise_engine_equals_per_iteration():
    """test_goss.py:122: the engine's blockwise valid-set and early-stop
    replay gives the per-iteration loop's model, stop and history."""
    rng = np.random.RandomState(12)
    x = rng.randn(3000, 8)
    y = (x[:, 0] + 0.4 * rng.randn(3000) > 0).astype(float)
    xv = rng.randn(800, 8)
    yv = (xv[:, 0] + 0.4 * rng.randn(800) > 0).astype(float)
    res = []
    for force_periter in (True, False):
        dtr = lgt.Dataset(x, y)
        dva = lgt.Dataset(xv, yv, reference=dtr)
        ev = {}
        cbs = [lambda env: None] if force_periter else None
        b = lgt.train({"objective": "binary", "boosting_type": "goss",
                       "metric": "auc", "num_leaves": 15, "verbose": -1,
                       "hist_compaction": "false"},
                      dtr, 20, valid_sets=[dva], early_stopping_rounds=5,
                      evals_result=ev, verbose_eval=False, callbacks=cbs,
                      device=CPU)
        res.append((b.model_to_string(), b.best_iteration,
                    tuple(ev["valid_0"]["auc"])))
    assert res[0] == res[1]


def test_model_round_trip(tmp_path):
    """test_goss.py:70."""
    x, y = _data(n=2000, f=6)
    b = lgt.train(dict(BASE, num_leaves=7), lgt.Dataset(x, y), 5,
                  verbose_eval=False, device=CPU)
    path = str(tmp_path / "goss.txt")
    b.save_model(path)
    with open(path) as fh:
        assert fh.readline().strip() == "goss"
    b2 = create_boosting("gbdt", CPU, input_model=path)
    assert type(b2).__name__ == "GOSS"
    with open(path) as fh:
        b2.load_model_from_string(fh.read())
    np.testing.assert_array_equal(b.gbdt.predict(x), b2.predict(x))
    assert type(lgt.Booster(model_file=path, device=CPU).gbdt).__name__ \
        == "GOSS"


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.7, "bagging_freq": 1},
    {"top_rate": 0.7, "other_rate": 0.5}], ids=["bagging", "rates"])
def test_conflicts_are_refused(extra):
    x, y = _data(n=500)
    with pytest.raises(LightGBMError, match="GOSS|bagging"):
        lgt.train(dict(BASE, **extra), lgt.Dataset(x, y), 1,
                  verbose_eval=False, device=CPU)
