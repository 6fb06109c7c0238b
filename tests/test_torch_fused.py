"""lightgbm_tpu_torch's fused multi-iteration trainer on the CPU.

On the CPU the fused block runs its step eagerly into the same stacked
buffers the card's CUDA graph replays into, with the same single
transfer at the block's end, so the block logic tested here (stacking,
t_eff, snapshots, natural stop, truncation) is the card's.

- the port's train_many grows the per-iteration loop's model, model
  text byte for byte, with either builder, cache or cache-less, with
  bagging and feature_fraction;
- it grows the JAX package's GBDT.train_many trees (feature_fraction
  on, bagging off: the packages' bag RNGs differ): splits exact, leaf
  values within 1e-6 absolute, the port-vs-JAX tolerance of
  test_torch_train.py (the frameworks' float32 exp differ in the last
  ulp; on a 0.0076 leaf that is 2e-7, 1.2e-5 relative, and the fused
  path adds nothing to it: it equals each package's own per-iteration
  trees bit for bit);
- blockwise engine.train (valid set, early stopping, evals_result)
  equals the port's per-iteration path bit for bit, and the JAX
  package's blockwise path within 1e-6; a natural stop mid-block too;
- the guards and the fused eligibility answer as the JAX package's.
"""

import tempfile

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.utils import guardrails as jguard
from lightgbm_tpu_torch.utils import guardrails as tguard

CPU = "cpu"
BASE = {"num_leaves": 15, "min_data_in_leaf": 20, "verbose": -1,
        "partitioned_build": "false", "hist_compaction": "false",
        "device_row_chunk": 4096}


def _data(seed=9, n=3000, f=8):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    y = (x[:, 0] + x[:, 1] + 0.3 * rng.randn(n) > 1.0).astype(np.float32)
    return x, y


def _noop(env):
    """A user callback: it keeps engine.train on the per-iteration loop."""


def _trees(booster):
    return [t.materialize() if hasattr(t, "materialize") else t
            for t in booster.gbdt.models]


def _assert_same_trees(jb, tb):
    jt, tt = _trees(jb), _trees(tb)
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        for key in ("split_feature_real", "threshold_in_bin", "left_child",
                    "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                          err_msg=key)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "cacheless"])
@pytest.mark.parametrize("builder", ["false", "true"],
                         ids=["masked", "partitioned"])
@pytest.mark.parametrize("sampling", [
    {}, {"bagging_fraction": 0.7, "bagging_freq": 2,
         "feature_fraction": 0.75}], ids=["full", "bag0.7-ff0.75"])
def test_train_many_equals_per_iteration_loop(cache, builder, sampling):
    x, y = _data()
    params = dict(BASE, objective="binary", partitioned_build=builder,
                  **sampling)
    if not cache:
        params["histogram_pool_size"] = 0.001
    fused = lgt.train(params, lgt.Dataset(x, y), 8, verbose_eval=False,
                      device=CPU)
    loop = lgt.train(params, lgt.Dataset(x, y), 8, verbose_eval=False,
                     callbacks=[_noop], device=CPU)
    assert fused.gbdt._fused_cache and not loop.gbdt._fused_cache
    assert fused.gbdt.tree_learner.cache_hists is cache
    assert fused.gbdt.tree_learner.use_partitioned is (builder == "true")
    assert len(fused.gbdt.models) == 8
    assert fused.model_to_string() == loop.model_to_string()
    np.testing.assert_array_equal(fused.gbdt.get_training_score(),
                                  loop.gbdt.get_training_score())


def test_train_many_blocks_equal_one_block():
    """Two blocks of 4 (the second reusing the runner) grow the one
    block of 8's model, and a longer block makes a new runner."""
    x, y = _data(seed=3)
    params = dict(BASE, objective="regression", feature_fraction=0.75)
    one = lgt.Booster(params, lgt.Dataset(x, y), device=CPU)
    assert one.gbdt.warm_up_fused(8)
    one.gbdt.train_many(8)
    two = lgt.Booster(params, lgt.Dataset(x, y), device=CPU)
    two.gbdt.train_many(4)
    runner = next(iter(two.gbdt._fused_cache.values()))
    two.gbdt.train_many(4)
    assert next(iter(two.gbdt._fused_cache.values())) is runner
    assert one.model_to_string() == two.model_to_string()
    two.gbdt.train_many(6)
    assert next(iter(two.gbdt._fused_cache.values())).capacity == 6


def test_train_many_matches_jax():
    """The port's fused block against the JAX package's scan, through
    GBDT.train_many on both sides (warm_up_fused first, as bench.py)."""
    x, y = _data()
    params = dict(BASE, objective="binary", feature_fraction=0.75,
                  learning_rate=0.1)
    jb = lgj.Booster(params, lgj.Dataset(x, y))
    tb = lgt.Booster(params, lgt.Dataset(x, y), device=CPU)
    assert jb.gbdt.warm_up_fused(6) and tb.gbdt.warm_up_fused(6)
    jb.gbdt.train_many(6)
    tb.gbdt.train_many(6)
    assert len(tb.gbdt.models) == 6
    _assert_same_trees(jb, tb)
    # the gap to the JAX trees is the per-iteration loop's own
    loop = lgt.Booster(params, lgt.Dataset(x, y), device=CPU)
    for _ in range(6):
        loop.update()
    assert loop.model_to_string() == tb.model_to_string()


def _valid_problem(seed=11, n=3000, f=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    y = (x[:, 0] + 0.5 * rng.randn(n) > 0).astype(float)
    xv = rng.randn(900, f)
    yv = (xv[:, 0] + 0.5 * rng.randn(900) > 0).astype(float)
    return x, y, xv, yv


def _train_with_valid(pkg, params, data, force_periter, nbr=40, esr=5,
                      **kw):
    x, y, xv, yv = data
    dtr = pkg.Dataset(x, y)
    dva = pkg.Dataset(xv, yv, reference=dtr)
    ev = {}
    if pkg is lgt:
        kw["device"] = CPU
    b = pkg.train(dict(params), dtr, num_boost_round=nbr,
                  valid_sets=[dtr, dva], valid_names=["tr", "va"],
                  early_stopping_rounds=esr, evals_result=ev,
                  verbose_eval=False,
                  callbacks=[_noop] if force_periter else None, **kw)
    return b, ev


VALID_PARAMS = {"objective": "binary", "metric": ["auc", "binary_logloss"],
                "num_leaves": 15, "verbose": -1, "feature_fraction": 0.7,
                "partitioned_build": "false", "hist_compaction": "false",
                "device_row_chunk": 4096}


@pytest.mark.parametrize("builder", ["false", "true"],
                         ids=["masked", "partitioned"])
def test_blockwise_equals_per_iteration(builder):
    params = dict(VALID_PARAMS, bagging_fraction=0.8, bagging_freq=2,
                  partitioned_build=builder)
    data = _valid_problem()
    b1, e1 = _train_with_valid(lgt, params, data, True)
    b2, e2 = _train_with_valid(lgt, params, data, False)
    assert b2.gbdt._fused_cache and not b1.gbdt._fused_cache
    assert b1.model_to_string() == b2.model_to_string()
    assert b1.best_iteration == b2.best_iteration
    assert e1 == e2                    # the whole history, bit for bit
    assert len(e1["va"]["auc"]) < 40   # early stopping engaged
    for i in (0, 1):
        np.testing.assert_array_equal(b1.gbdt.get_predict_at(i),
                                      b2.gbdt.get_predict_at(i))


def test_blockwise_matches_jax():
    data = _valid_problem()
    jb, je = _train_with_valid(lgj, VALID_PARAMS, data, False)
    tb, te = _train_with_valid(lgt, VALID_PARAMS, data, False)
    assert tb.gbdt._fused_cache
    assert jb.best_iteration == tb.best_iteration
    _assert_same_trees(jb, tb)
    assert je.keys() == te.keys()
    for dname in je:
        assert je[dname].keys() == te[dname].keys()
        for mname in je[dname]:
            np.testing.assert_allclose(te[dname][mname], je[dname][mname],
                                       rtol=1e-6, atol=1e-7)


def test_blockwise_without_early_stopping_runs_the_budget():
    data = _valid_problem(seed=3, n=1500, f=6)
    params = dict(VALID_PARAMS, metric="auc", num_leaves=7)
    b1, e1 = _train_with_valid(lgt, params, data, True, nbr=12, esr=None)
    b2, e2 = _train_with_valid(lgt, params, data, False, nbr=12, esr=None)
    assert len(e2["va"]["auc"]) == 12 and b2.best_iteration == 12
    assert e1 == e2 and b1.model_to_string() == b2.model_to_string()


def _natural_stop_problem():
    rng = np.random.RandomState(5)
    x = (rng.rand(500, 2) > 0.5).astype(np.float64)
    y = (x[:, 0] > 0.5).astype(float)
    return x, y


def _natural_stop_params():
    """test_engine_api.py:206's calibration: the split gains decay
    geometrically; min_gain_to_split stops real splits after 3 trees."""
    x, y = _natural_stop_problem()
    probe = lgt.train({"objective": "binary", "verbose": -1,
                       "num_leaves": 4}, lgt.Dataset(x, y), 6,
                      verbose_eval=False, device=CPU)
    gains = [float(t.split_gain[0]) for t in probe.gbdt.models]
    assert gains == sorted(gains, reverse=True)
    return {"objective": "binary", "metric": "binary_logloss",
            "num_leaves": 4, "verbose": -1,
            "min_gain_to_split": (gains[2] + gains[3]) / 2.0}


@pytest.mark.parametrize("ff", [1.0, 0.5], ids=["ff1", "ff0.5"])
def test_natural_stop_mid_block_matches_per_iteration(ff):
    """An empty tree mid-block: the replay hands the rest of the rounds
    to the per-iteration loop with the scores and the feature sampler
    of the kept trees, so both paths end with one model and one
    history (with feature_fraction 0.5 the loop splits again after
    empty trees)."""
    x, y = _natural_stop_problem()
    params = dict(_natural_stop_params(), feature_fraction=ff)
    res = []
    for force in (True, False):
        dtr = lgt.Dataset(x, y)
        dva = lgt.Dataset(x[:100].copy(), y[:100].copy(), reference=dtr)
        ev = {}
        b = lgt.train(params, dtr, 8, valid_sets=[dva], evals_result=ev,
                      verbose_eval=False, callbacks=[_noop] if force else None,
                      device=CPU)
        (mname,) = ev["valid_0"].keys()    # the display name
        res.append((b, ev["valid_0"][mname]))
    (b1, h1), (b2, h2) = res
    assert b2.gbdt._fused_cache and len(b2.gbdt.models) < 8
    assert b1.model_to_string() == b2.model_to_string()
    assert len(h1) == len(h2) == 8 and h1 == h2
    np.testing.assert_array_equal(b1.gbdt.get_training_score(),
                                  b2.gbdt.get_training_score())


def test_natural_stop_matches_jax():
    x, y = _natural_stop_problem()
    params = _natural_stop_params()
    out = []
    for pkg in (lgj, lgt):
        dtr = pkg.Dataset(x, y)
        dva = pkg.Dataset(x[:100].copy(), y[:100].copy(), reference=dtr)
        ev = {}
        kw = {"device": CPU} if pkg is lgt else {}
        b = pkg.train(params, dtr, 8, valid_sets=[dva], evals_result=ev,
                      verbose_eval=False, **kw)
        (mname,) = ev["valid_0"].keys()
        out.append((b, ev["valid_0"][mname]))
    (jb, jh), (tb, th) = out
    _assert_same_trees(jb, tb)
    np.testing.assert_allclose(th, jh, rtol=1e-6)


def test_rollback_and_truncation_subtract_scores():
    """Booster.rollback_one_iter and early_stopping_round's truncation
    (one batched traversal a dataset) leave the scores of the shorter
    model, and the model of the shorter run."""
    x, y = _data(seed=4)
    xv, yv = _data(seed=5, n=700)
    params = dict(BASE, objective="binary")
    boosters = []
    for _ in range(2):
        ds = lgt.Dataset(x, y)
        b = lgt.Booster(params, ds, device=CPU)
        b.add_valid(lgt.Dataset(xv, yv, reference=ds), "va")
        boosters.append(b)
    short, long = boosters
    short.gbdt.train_many(3)
    long.gbdt.train_many(5, ignore_train_metrics=True)
    long.rollback_one_iter()
    long.gbdt._truncate_iters(1)
    assert long.gbdt.iter == 3
    assert long.model_to_string() == short.model_to_string()
    for i in (0, 1):
        np.testing.assert_allclose(long.gbdt._updater(i).host_score(),
                                   short.gbdt._updater(i).host_score(),
                                   rtol=0, atol=1e-6)


def test_valid_set_added_after_training_gets_the_trees_scores():
    """A valid set added after 5 iterations is scored with the 5 trees in
    one batched traversal: the scores a valid set bound from the start
    got one tree at a time (the device trees' float32 leaf * shrinkage
    there, the host trees' shrunk leaf values here: within 1e-6)."""
    x, y = _data(seed=4)
    xv, yv = _data(seed=5, n=700)
    params = dict(BASE, objective="binary")
    scores = []
    for late in (False, True):
        ds = lgt.Dataset(x, y)
        b = lgt.Booster(params, ds, device=CPU)
        if not late:
            b.add_valid(lgt.Dataset(xv, yv, reference=ds), "va")
        for _ in range(5):
            b.gbdt.train_one_iter()
        if late:
            b.add_valid(lgt.Dataset(xv, yv, reference=ds), "va")
        scores.append(b.gbdt._updater(1).host_score())
    assert np.any(scores[0] != 0.0)
    np.testing.assert_allclose(scores[1], scores[0], rtol=0, atol=1e-6)


POISON = [(np.array([[0.5, np.nan, 1.0]]), np.ones((1, 3))),
          (np.ones((1, 3)), np.array([[1.0, 2.0, -np.inf]])),
          (np.array([[np.inf, 0.0, -np.inf]]), np.array([[np.nan, 1, 1]])),
          (np.ones((1, 3)), np.ones((1, 3)))]


@pytest.mark.parametrize("policy", tguard.POLICIES)
def test_guards_match_jax(policy):
    assert tguard.POLICIES == jguard.POLICIES
    assert tguard.CLAMP_MAGNITUDE == jguard.CLAMP_MAGNITUDE
    for g, h in POISON:
        outs = []
        for mod in (jguard, tguard):
            try:
                outs.append(("ok", mod.guard_gradients(g, h, 7, policy)))
            except Exception as e:      # noqa: BLE001 - the message is compared
                outs.append((type(e).__name__, str(e)))
        (jk, jv), (tk, tv) = outs
        assert jk == tk
        if jk == "ok":
            np.testing.assert_array_equal(tv[0], jv[0])
            np.testing.assert_array_equal(tv[1], jv[1])
            assert tv[2] == jv[2]
        else:
            assert tv == jv
        for score in (g, h):
            outs = []
            for mod in (jguard, tguard):
                try:
                    outs.append(mod.guard_scores(score, 3, policy))
                except Exception as e:  # noqa: BLE001
                    outs.append(str(e))
            assert outs[0] == outs[1]


class _Poisoned:
    """An objective wrapper that puts `value` at row 5 of the gradients
    of its second call."""

    def __init__(self, obj, value):
        self.obj, self.value, self.calls = obj, value, 0

    def __getattr__(self, name):
        return getattr(self.obj, name)

    def get_gradients(self, score):
        g, h = self.obj.get_gradients(score)
        self.calls += 1
        if self.calls == 2:
            g = np.array(g, dtype=np.float32)
            g[0, 5] = self.value
            g = torch.from_numpy(g) if isinstance(score, torch.Tensor) else g
        return g, h


@pytest.mark.parametrize("policy", ["raise", "warn_skip", "clamp"])
def test_per_iteration_guard_matches_jax(policy):
    """A NaN in the second iteration's gradients: raise stops with the
    JAX package's message, warn_skip skips the round, clamp trains on
    the clamped gradients, as the JAX package does."""
    x, y = _data(seed=6)
    params = dict(BASE, objective="binary", nonfinite_guard=policy)
    jb = lgj.Booster(params, lgj.Dataset(x, y))
    tb = lgt.Booster(params, lgt.Dataset(x, y), device=CPU)
    results = []
    for b in (jb, tb):
        b.gbdt.objective = _Poisoned(b.gbdt.objective, np.nan)
        try:
            for _ in range(3):
                b.update()
            results.append(None)
        except Exception as e:          # noqa: BLE001 - compared below
            results.append((type(e).__name__, str(e)))
    assert results[0] == results[1]
    if policy == "raise":
        assert results[1] is not None and "iteration 1" in results[1][1]
        return
    assert tb.gbdt.iter == jb.gbdt.iter == (2 if policy == "warn_skip" else 3)
    _assert_same_trees(jb, tb)


ELIGIBILITY = [
    ({}, False, False),
    ({"metric": "auc"}, False, False),
    ({"metric": "auc", "metric_freq": 0}, False, False),
    ({"metric": "auc"}, False, True),
    ({}, True, False),
    ({}, True, True),
    ({"metric": "auc"}, True, True),
    ({"early_stopping_round": 3}, False, False),
    ({"early_stopping_round": 3}, True, True),
    ({"bagging_fraction": 0.5, "bagging_freq": 1}, False, False),
    ({"feature_fraction": 0.5, "partitioned_build": "true"}, False, False),
    ({"metric": "binary_logloss", "metric_freq": 2}, True, True),
]


@pytest.mark.parametrize("extra,with_valid,ignore", ELIGIBILITY)
def test_fused_eligible_matches_jax(extra, with_valid, ignore):
    x, y = _data(seed=8, n=600)
    params = dict(BASE, objective="binary", **extra)
    boosters = []
    for pkg, kw in ((lgj, {}), (lgt, {"device": CPU})):
        ds = pkg.Dataset(x, y)
        b = pkg.Booster(params, ds, **kw)
        if with_valid:
            b.add_valid(pkg.Dataset(x[:200], y[:200], reference=ds), "va")
        boosters.append(b.gbdt)
    jg, tg = boosters
    assert (tg._fused_eligible(ignore_train_metrics=ignore)
            == jg._fused_eligible(ignore_train_metrics=ignore))
    assert tg.warm_up_fused(2) == jg._fused_eligible()


def test_train_routes():
    """No callbacks: train_many; valid sets: the blockwise replay; a
    user callback or a custom objective: the per-iteration loop;
    resume_from an empty directory: a cold start on the fast path."""
    x, y = _data(seed=2, n=1000)
    params = dict(BASE, objective="binary", metric="auc")
    calls = []
    gbdt_cls = lgt.Booster(params, lgt.Dataset(x, y), device=CPU).gbdt
    orig_many, orig_eval = type(gbdt_cls).train_many, \
        type(gbdt_cls).train_many_eval
    try:
        type(gbdt_cls).train_many = lambda self, n, *a: calls.append(
            ("many", n)) or orig_many(self, n, *a)
        type(gbdt_cls).train_many_eval = lambda self, n: calls.append(
            ("eval", n)) or orig_eval(self, n)
        lgt.train(dict(params, metric_freq=0), lgt.Dataset(x, y), 4,
                  verbose_eval=False, device=CPU)
        assert calls == [("many", 4)]
        calls.clear()
        ds = lgt.Dataset(x, y)
        lgt.train(params, ds, 12, valid_sets=[lgt.Dataset(x[:300], y[:300],
                                                          reference=ds)],
                  early_stopping_rounds=8, verbose_eval=False, device=CPU)
        assert calls and calls[0] == ("eval", 8)
        calls.clear()
        lgt.train(params, lgt.Dataset(x, y), 3, verbose_eval=False,
                  callbacks=[_noop], device=CPU)
        assert calls == []
        lgt.train(params, lgt.Dataset(x, y), 2, verbose_eval=False,
                  fobj=lambda p, d: (p - d.get_label(), np.ones_like(p)),
                  device=CPU)
        assert calls == []
    finally:
        type(gbdt_cls).train_many = orig_many
        type(gbdt_cls).train_many_eval = orig_eval
    calls.clear()
    with tempfile.TemporaryDirectory() as d:
        type(gbdt_cls).train_many = lambda self, n, *a: calls.append(
            ("many", n)) or orig_many(self, n, *a)
        try:
            b = lgt.train(dict(params, metric_freq=0), lgt.Dataset(x, y), 1,
                          verbose_eval=False, device=CPU, resume_from=d)
        finally:
            type(gbdt_cls).train_many = orig_many
    assert calls == [("many", 1)] and b.current_iteration() == 1
