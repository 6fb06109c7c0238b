"""lightgbm_tpu_torch's gather-compacted histogram engine and the serial
learner's engine selection, against lightgbm_tpu on the CPU.

The compaction (compact_gather_indices) is held to the JAX function
element for element. The compacted histogram is held within 1e-6 of the
largest |value| of the JAX package's (its CPU route, _compacted_bincount,
which sums each chunk in float64) and of the port's own masked engine
on the same leaf; against a numpy reference of its own chunking
(float32 row-order sums of HIST_CHUNK pieces of the compacted rows, the
covered chunks Kahan-folded) it is equal in bits. End to end with
hist_compaction=true (and hist_frontier=false) the trees are
structurally equal to the JAX learner's, leaf values and predictions
within 1e-6 absolute, the bound of test_torch_train.py. The JAX side
pins shape_bucketing=false: its default pads the rows to a coarser
chunk grid, which can add one trailing chunk of padding rows to a
leaf's compacted buffer, and a trailing zero chunk moves the Kahan
fold's last bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu.ops.partition import compact_gather_indices as jcompact
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops.partition import compact_gather_indices
from test_torch_partitioned import _categorical_data
from test_torch_train import _assert_same_model, _data, _trees

CPU = "cpu"
CHUNK = hk.HIST_CHUNK
N = 3 * CHUNK + 904                # 13,192 rows: four chunks, the last ragged
BASE = {"num_leaves": 15, "min_data_in_leaf": 20, "verbose": -1,
        "partitioned_build": "false", "hist_compaction": "true",
        "shape_bucketing": "false", "device_row_chunk": CHUNK}
REL = 1e-6


def _mask(cnt, n=N, seed=0):
    mask = np.zeros(n, bool)
    mask[np.random.RandomState(seed).choice(n, cnt, replace=False)] = True
    return mask


@pytest.mark.parametrize("cnt", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 777, N])
def test_compact_gather_indices_equals_jax(cnt):
    mask = _mask(cnt)
    src, count = compact_gather_indices(torch.from_numpy(mask), N)
    want = np.asarray(jcompact(jnp.asarray(mask), N))
    assert src.dtype == torch.int32 and count.shape == (1,)
    np.testing.assert_array_equal(src.numpy(), want)
    assert int(count[0]) == cnt


def test_compact_gather_indices_smaller_buffer_equals_jax():
    """A buffer shorter than N (the JAX bucketed route's sizes): the
    sentinel N past the count."""
    mask = _mask(1000, seed=3)
    src, count = compact_gather_indices(torch.from_numpy(mask), 2 * CHUNK)
    want = np.asarray(jcompact(jnp.asarray(mask), 2 * CHUNK))
    np.testing.assert_array_equal(src.numpy(), want)
    assert int(count[0]) == 1000


def _hist_inputs(b, dtype, seed, n=4 * CHUNK, f=5):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, b, size=(f, n)).astype(dtype)
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = np.stack([rng.randn(n).astype(np.float32) * inbag,
                    rng.rand(n).astype(np.float32) * inbag, inbag])
    row_leaf = rng.randint(0, 4, size=n).astype(np.int32)
    row_leaf[:5000] = 1            # one leaf dense at the front
    return bins, ghc, row_leaf


def _reference(bins, ghc, row_leaf, leaf):
    """numpy float32 row-order partials of HIST_CHUNK pieces of the
    compacted rows, max(ceil(cnt / HIST_CHUNK), 1) of them, Kahan-folded
    in order: the engine's function written out."""
    f, _ = bins.shape
    b = int(bins.max()) + 1
    src = np.flatnonzero(row_leaf == leaf)
    acc = np.zeros((f, b, 3), np.float32)
    comp = np.zeros_like(acc)
    for c in range(max(-(-len(src) // CHUNK), 1)):
        rows = src[c * CHUNK:(c + 1) * CHUNK]
        part = np.zeros((f, b, 3), np.float32)
        for j in range(f):
            np.add.at(part[j], bins[j, rows].astype(np.int64),
                      ghc[:, rows].T)
        y = part - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc, (-comp) + np.float32(0.0)


@pytest.mark.parametrize("leaf", [0, 1, 2, 9], ids=["leaf0", "dense-leaf1",
                                                    "leaf2", "empty"])
def test_compacted_histograms_match_jax_masked_and_reference(leaf):
    bins, ghc, row_leaf = _hist_inputs(31, np.uint8, 4)
    args = [torch.from_numpy(a) for a in (bins, ghc, row_leaf)]
    lid = torch.tensor([leaf], dtype=torch.int32)
    hi, lo = thist.compacted_histograms(*args, lid, 31)
    jhi, jlo = jhist.compacted_histograms(
        jnp.asarray(bins), jnp.asarray(ghc), jnp.asarray(row_leaf),
        jnp.int32(leaf), 31)
    mhi, mlo = thist.masked_histograms(*args, lid, 31)
    got, jax_val = (hi + lo).numpy(), np.asarray(jhi + jlo)
    scale = max(float(np.abs(jax_val).max()), 1e-30)
    assert np.abs(got - jax_val).max() <= REL * scale
    assert np.abs(got - (mhi + mlo).numpy()).max() <= REL * scale
    np.testing.assert_array_equal(got[..., 2], jax_val[..., 2])
    want_hi, want_lo = _reference(bins, ghc, row_leaf, leaf)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), want_lo)


@pytest.mark.parametrize("cnt", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1])
def test_compacted_hist_plain_folds_only_the_covered_chunks(cnt):
    """cnt of 0 folds one zero chunk, 4096 one chunk, 4097 two: bit for
    bit the reference, int16 bins at 300 bins."""
    bins, ghc, _ = _hist_inputs(300, np.int16, 5)
    row_leaf = np.where(_mask(cnt, n=bins.shape[1], seed=cnt), 3,
                        0).astype(np.int32)
    src = torch.empty(bins.shape[1], dtype=torch.int32)
    count = torch.empty(1, dtype=torch.int32)
    hk.compact_rows(torch.from_numpy(row_leaf),
                    torch.tensor([3], dtype=torch.int32), src, count)
    assert int(count[0]) == cnt
    hi, lo = hk.compacted_hist(torch.from_numpy(bins),
                               torch.from_numpy(ghc), src, count, 300)
    want_hi, want_lo = _reference(bins, ghc, row_leaf, 3)
    np.testing.assert_array_equal(hi.numpy()[:, :want_hi.shape[1]], want_hi)
    np.testing.assert_array_equal(lo.numpy()[:, :want_lo.shape[1]], want_lo)


def _binary(seed=0, n=N, f=6):
    x, y, logit = _data(seed=seed, n=n, f=f)
    return x, y, logit


def _pair(params, x, y, rounds=5, **ds_kw):
    jb = lgj.train(params, lgj.Dataset(x, y, **ds_kw), rounds,
                   verbose_eval=False)
    tb = lgt.train(params, lgt.Dataset(x, y, **ds_kw), rounds,
                   verbose_eval=False, device=CPU)
    return jb, tb


@pytest.mark.parametrize("objective,extra", [
    ("binary", {}),
    ("regression", {}),
    ("binary", {"histogram_pool_size": 0.001}),
    ("binary", {"hist_frontier": "false"}),
    ("regression", {"hist_frontier": "false", "hist_compaction": "false",
                    "histogram_pool_size": 0.001}),
    ("binary", {"hist_frontier": "false", "histogram_pool_size": 0.001}),
], ids=["binary", "l2", "binary-cacheless", "binary-no-frontier",
        "l2-masked-no-frontier-cacheless", "binary-no-frontier-cacheless"])
def test_trees_and_predictions_match_jax(objective, extra):
    x, yb, yr = _binary()
    params = dict(BASE, objective=objective, **extra)
    jb, tb = _pair(params, x, yb if objective == "binary" else yr)
    learner = tb.gbdt.tree_learner
    assert learner.use_compact is (params["hist_compaction"] == "true")
    assert learner.use_compact is jb.gbdt.tree_learner._use_compact
    assert learner.use_frontier is jb.gbdt.tree_learner._use_frontier
    assert learner.cache_hists is ("histogram_pool_size" not in extra)
    _assert_same_model(jb, tb, x)


def test_multiclass_matches_jax():
    rng = np.random.RandomState(13)
    x = rng.rand(N, 6).astype(np.float32)
    y = ((x[:, 0] * 3 + x[:, 1] * 2).astype(np.int32) % 3).astype(np.float32)
    params = dict(BASE, objective="multiclass", num_class=3, num_leaves=7)
    jb, tb = _pair(params, x, y, rounds=3)
    assert tb.gbdt.tree_learner.use_compact
    _assert_same_model(jb, tb, x)


def test_bagging_with_one_shared_mask_matches_jax():
    """Both _bagging hooks return the same numpy mask per re-bag window:
    out-of-bag rows are in the compaction with zero statistics."""
    x, y, _ = _binary(seed=1)
    n = len(y)
    params = dict(BASE, objective="binary", bagging_fraction=0.7,
                  bagging_freq=2)

    def mask(it):
        rng = np.random.RandomState(1000 + it // 2)
        return (rng.permutation(n) < int(0.7 * n)).astype(np.float32)

    jb = lgj.Booster(params, lgj.Dataset(x, y))
    tb = lgt.Booster(params, lgt.Dataset(x, y), device=CPU)
    jb.gbdt._bagging = lambda it, g=None, h=None: mask(it)
    tb.gbdt._bagging = lambda it, g=None, h=None: torch.from_numpy(mask(it))
    for _ in range(4):
        jb.update()
        tb.update()
    _assert_same_model(jb, tb, x)


def test_categorical_column_matches_jax():
    """The JAX side runs hist_mode=segment: its compacted engine then
    sums each chunk in float32 (the XLA bucketed route) as the port
    does. Its CPU default, a float64 bincount a chunk, moves this
    fixture's small categorical leaves by up to 7e-6 from any float32
    sum (the JAX package's own masked engine included), as
    test_torch_partitioned.py records for segment histograms."""
    x, y = _categorical_data(n=N)
    params = dict(BASE, objective="binary", max_bin=32)
    jb = lgj.train(dict(params, hist_mode="segment"),
                   lgj.Dataset(x, y, categorical_feature=[0, 1]), 5,
                   verbose_eval=False)
    tb = lgt.train(params, lgt.Dataset(x, y, categorical_feature=[0, 1]),
                   5, verbose_eval=False, device=CPU)
    assert jb.gbdt.tree_learner._use_compact and tb.gbdt.tree_learner.use_compact
    assert any((t.decision_type == 1).any() for t in _trees(tb))
    _assert_same_model(jb, tb, x)


@pytest.mark.parametrize("n,mode,partitioned", [
    (CHUNK, "auto", "false"), (CHUNK + 1, "auto", "false"),
    (CHUNK, "true", "false"), (CHUNK + 1, "false", "false"),
    (CHUNK + 1, "auto", "true"), (CHUNK + 1, "true", "true")])
def test_auto_resolves_as_the_jax_learner_off_the_tpu(n, mode, partitioned):
    """auto: compacted above one HIST_CHUNK of rows, masked at or below
    it; moot with the leaf-contiguous builder."""
    x, y, _ = _binary(seed=2, n=n)
    params = dict(BASE, objective="binary", hist_compaction=mode,
                  partitioned_build=partitioned)
    jl = lgj.Booster(params, lgj.Dataset(x, y)).gbdt.tree_learner
    tl = lgt.Booster(params, lgt.Dataset(x, y), device=CPU).gbdt.tree_learner
    assert tl.use_compact is jl._use_compact
    assert tl.use_compact is (partitioned == "false" and mode != "false"
                              and (mode == "true" or n > CHUNK))


def _engine_calls(params, rounds=1):
    """Calls of each histogram engine in one tree, counted by wrapping
    the learner's engines (the dispatchers of ops/histogram.py)."""
    x, y, _ = _binary(seed=3)
    booster = lgt.Booster(params, lgt.Dataset(x, y), device=CPU)
    learner = booster.gbdt.tree_learner
    calls = {"masked": 0, "frontier": 0, "compacted": 0}

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    g = torch.randn(learner.num_data, generator=torch.Generator()
                    .manual_seed(0))
    engines = {"masked_fn": counted("masked", thist.masked_histograms),
               "frontier_fn": counted("frontier",
                                      thist.frontier_histograms)}
    if learner.compacted_fn is not None:
        engines["compacted_fn"] = counted("compacted", learner.compacted_fn)
    out = learner.train_device(g, torch.ones(learner.num_data), **engines)
    return calls, int(out["n_splits"])


@pytest.mark.parametrize("extra,want", [
    ({}, {"frontier": 1, "compacted": "s"}),
    ({"hist_frontier": "false"}, {"masked": 1, "compacted": "s"}),
    ({"histogram_pool_size": 0.001}, {"frontier": 1, "compacted": "2s"}),
    ({"hist_compaction": "false"}, {"frontier": 1, "masked": "s"}),
    ({"hist_compaction": "false", "histogram_pool_size": 0.001},
     {"frontier": "1+s"}),
    ({"hist_compaction": "false", "hist_frontier": "false",
      "histogram_pool_size": 0.001}, {"masked": "1+2s"}),
], ids=["compact", "compact-no-frontier", "compact-cacheless", "masked",
        "masked-cacheless", "masked-no-frontier-cacheless"])
def test_builder_takes_the_jax_builders_branches(extra, want):
    """The three-way branch of the JAX builder (tree_learner.py:301-323,
    364-395), s = the splits of the tree (all L - 1 run here)."""
    calls, splits = _engine_calls(dict(BASE, objective="regression",
                                       **extra))
    assert splits == BASE["num_leaves"] - 1
    s = BASE["num_leaves"] - 1
    expect = {"masked": 0, "frontier": 0, "compacted": 0}
    for name, v in want.items():
        expect[name] = {1: 1, "s": s, "2s": 2 * s, "1+s": 1 + s,
                        "1+2s": 1 + 2 * s}[v]
    assert calls == expect


def test_compaction_buffers_are_the_learners_own():
    """One (N_pad,) index buffer and count a learner, read by every
    tree: what a captured graph replays."""
    x, y, _ = _binary(seed=4)
    booster = lgt.Booster(dict(BASE, objective="binary"), lgt.Dataset(x, y),
                          device=CPU)
    learner = booster.gbdt.tree_learner
    src = learner.compacted_fn.keywords["src"]
    cnt = learner.compacted_fn.keywords["cnt"]
    assert src.shape == (learner.n_pad,) and cnt.shape == (1,)
    before = (src.data_ptr(), cnt.data_ptr())
    booster.update()
    booster.update()
    assert (src.data_ptr(), cnt.data_ptr()) == before
    # the last compaction's rows are a leaf's, in order, then the sentinel
    c = int(cnt[0])
    rows = src[:c].numpy()
    assert 0 < c < learner.n_pad and np.all(np.diff(rows) > 0)
    assert np.all(src[c:].numpy() == learner.n_pad)


@pytest.mark.parametrize("objective,extra", [
    ("binary", {}),
    ("binary", {"bagging_fraction": 0.7, "bagging_freq": 2,
                "feature_fraction": 0.75}),
    ("binary", {"histogram_pool_size": 0.001, "hist_frontier": "false"}),
    ("multiclass", {"num_class": 3, "num_leaves": 7}),
], ids=["binary", "bag0.7-ff0.75", "cacheless-no-frontier", "multiclass"])
def test_fused_model_text_equals_per_iteration(objective, extra):
    x, y, _ = _binary(seed=5)
    if objective == "multiclass":
        y = (np.floor(x[:, 0] * 3) % 3).astype(np.float32)
    params = dict(BASE, objective=objective, **extra)
    fused = lgt.train(params, lgt.Dataset(x, y), 6, verbose_eval=False,
                      device=CPU)
    loop = lgt.train(params, lgt.Dataset(x, y), 6, verbose_eval=False,
                     callbacks=[lambda env: None], device=CPU)
    assert fused.gbdt._fused_cache and not loop.gbdt._fused_cache
    assert fused.gbdt.tree_learner.use_compact
    assert fused.model_to_string() == loop.model_to_string()
