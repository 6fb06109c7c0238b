"""lightgbm_tpu_torch leaf-contiguous (partitioned) builder against
lightgbm_tpu, on the CPU.

- The packing and chunk-cover helpers and the partition ops equal the
  JAX functions exactly (integer arithmetic).
- segment_histograms (the seg_hist kernel's plain version on the CPU)
  is held against the JAX package's segment_histograms, in its XLA
  formulation and as the Pallas kernel in interpret mode, to rtol 1e-5,
  atol 1e-4, the tolerance the JAX tests use: the TPU kernel adds in
  plain f32 over its whole chunk bucket (zero chunks included), the
  port Kahan-folds the covered chunks' row-order partials.
- Trained models equal the JAX package's partitioned models: structure
  exact, leaf values and predictions within 1e-6 (the f32 gradients
  round at the last ulp differently in the two frameworks' exp). The
  JAX side runs hist_mode=segment, the float32 row-order formulation
  the port reproduces: its CPU default for segment histograms is a
  float64 bincount, whose rounding differs from any float32 sum by up
  to 1e-5 on the categorical fixture's small leaves.
- The port's partitioned trees equal its masked trees: structure
  exact, leaf values within rtol 1e-4, atol 1e-6 (only the order of
  the f32 sums inside a histogram differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import ordered_hist as jo
from lightgbm_tpu.ops import partition as jpart
from lightgbm_tpu.ops.pallas_hist import HIST_CHUNK
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import ordered_hist as to
from lightgbm_tpu_torch.ops import partition as tpart
from test_torch_train import _assert_same_model, _trees

CPU = "cpu"
BASE = {"num_leaves": 15, "min_data_in_leaf": 20, "verbose": -1,
        "partitioned_build": "true", "device_row_chunk": 4096,
        "hist_mode": "segment"}


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _bounds(begin, cnt):
    return torch.tensor([begin, cnt], dtype=torch.int32)


# ------------------------------------------------------------ helpers

@pytest.mark.parametrize("f", [1, 5, 8, 10, 28])
def test_pack_feature_words_equals_jax(f):
    bins = np.random.RandomState(f).randint(0, 256, size=(f, 300)).astype(
        np.uint8)
    got = to.pack_feature_words(bins)
    want = jo.pack_feature_words(bins)
    assert got.dtype == np.int32 and got.shape == ((f + 3) // 4, 300)
    np.testing.assert_array_equal(got, want)


def test_unpack_feature_equals_jax():
    """Every byte of every word, sign bit included (feature 3 of a word
    sets bit 31 for bins >= 128)."""
    bins = np.random.RandomState(1).randint(0, 256, size=(10, 257)).astype(
        np.uint8)
    words = to.pack_feature_words(bins)
    tw = torch.from_numpy(words)
    for f in range(12):
        got = to.unpack_feature(tw, _i32(f))
        want = np.asarray(jo.unpack_feature(jnp.asarray(words), jnp.int32(f)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(hk.unpack_words(tw)[:10].numpy(), bins)


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 5, 8, 256, 257])
def test_bucket_sizes_equal_jax(n_chunks):
    assert to.bucket_sizes(n_chunks) == jo.bucket_sizes(n_chunks)


COVER_CASES = [  # (begin, cnt, n_chunks)
    (0, 3 * HIST_CHUNK, 3), (100, HIST_CHUNK, 3), (HIST_CHUNK - 7, 50, 3),
    (2 * HIST_CHUNK + 5, HIST_CHUNK - 5, 3), (5, 0, 3),
    (3 * HIST_CHUNK, 0, 3), (37, 2 * HIST_CHUNK + 9, 3),
    (0, 1 << 20, 256), (300_001, 200_000, 256), (4090, 100, 256),
    ((1 << 20) - 1, 1, 256)]


@pytest.mark.parametrize("begin,cnt,n_chunks", COVER_CASES)
def test_cover_index_and_window_equal_jax(begin, cnt, n_chunks):
    """The JAX bucket arithmetic, exactly; and the chunks the port folds
    (segment_cover) lie inside the window the TPU kernel streams."""
    idx, c_first = to.cover_index(_i32(begin), _i32(cnt), n_chunks)
    j_idx, j_first = jo.cover_index(jnp.int32(begin), jnp.int32(cnt),
                                    n_chunks)
    assert int(idx) == int(j_idx) and int(c_first) == int(j_first)
    bk = to.bucket_sizes(n_chunks)[int(idx)]
    start = to.window_start(c_first, bk, n_chunks)
    assert int(start) == int(jo.window_start(j_first, bk, n_chunks))
    first, last = hk.segment_cover(_bounds(begin, cnt), n_chunks)
    lo_chunk = int(start) // HIST_CHUNK
    assert lo_chunk <= int(first) <= int(last) < lo_chunk + bk


PARTITION_SEGMENTS = [  # (n, begin, cnt): test_partitioned.py:60-121
    (257, 31, 170)] + [
    (3 * HIST_CHUNK, b, c) for b, c in [
        (0, 3 * HIST_CHUNK), (100, HIST_CHUNK), (4000, 300),
        (HIST_CHUNK - 5, 10), (2 * HIST_CHUNK, HIST_CHUNK),
        (3 * HIST_CHUNK - 200, 200), (37, 2 * HIST_CHUNK + 9)]]


@pytest.mark.parametrize("n,begin,cnt", PARTITION_SEGMENTS)
def test_partition_ops_equal_jax(n, begin, cnt):
    rng = np.random.RandomState(n + begin)
    bins = rng.randint(0, 16, size=(5, n)).astype(np.uint8)
    words = to.pack_feature_words(bins)
    ghc = rng.rand(3, n).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    go_left = bins[2] <= 7
    dest, n_left = tpart.split_destinations(torch.from_numpy(go_left),
                                            _i32(begin), _i32(cnt))
    j_dest, j_nl = jpart.split_destinations(
        jnp.asarray(go_left), jnp.int32(begin), jnp.int32(cnt))
    assert dest.dtype == torch.int32 and n_left.dtype == torch.int32
    np.testing.assert_array_equal(dest.numpy(), np.asarray(j_dest))
    assert int(n_left) == int(j_nl)
    src = tpart.invert_permutation(dest)
    np.testing.assert_array_equal(
        src.numpy(), np.asarray(jpart.invert_permutation(j_dest)))
    got = tpart.apply_partition(src, torch.from_numpy(words),
                                torch.from_numpy(ghc), torch.from_numpy(perm))
    want = jpart.apply_partition(jnp.asarray(src.numpy()), jnp.asarray(words),
                                 jnp.asarray(ghc), jnp.asarray(perm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------ segment histograms

SEG_CASES = [  # (f, n_chunks, b, begin, cnt): test_kernel_interpret.py
    (6, 3, 16, 0, 3 * HIST_CHUNK), (6, 3, 16, 100, HIST_CHUNK),
    (6, 3, 16, HIST_CHUNK - 7, 50),
    (6, 3, 16, 2 * HIST_CHUNK + 5, HIST_CHUNK - 5),
    # the bench geometry: 28 features -> 7 words, 255 bins, 2 chunks
    (28, 2, 255, HIST_CHUNK - 9, HIST_CHUNK // 2)]


@pytest.mark.parametrize("f,n_chunks,b,begin,cnt", SEG_CASES)
def test_segment_histograms_match_jax(f, n_chunks, b, begin, cnt):
    rng = np.random.RandomState(f + begin)
    n = n_chunks * HIST_CHUNK
    bins = rng.randint(0, b, size=(f, n)).astype(np.uint8)
    words = to.pack_feature_words(bins)
    ghc = rng.rand(3, n).astype(np.float32)
    hi, lo = to.segment_histograms(torch.from_numpy(words),
                                   torch.from_numpy(ghc), _bounds(begin, cnt),
                                   b)
    got = (hi + lo).numpy()
    s_pad = 4 * words.shape[0]
    assert got.shape == (s_pad, b, 3)
    for backend, interpret in (("cpu", False), ("tpu", True)):
        want = jax.jit(lambda be, cn: jo.segment_histograms(
            jnp.asarray(words), jnp.asarray(ghc), be, cn, b, f=s_pad,
            interpret_backend=backend, interpret=interpret))(
                jnp.int32(begin), jnp.int32(cnt))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-4, err_msg=backend)


@pytest.mark.parametrize("begin,cnt", [
    (0, 3 * HIST_CHUNK), (0, 2 * HIST_CHUNK), (HIST_CHUNK + 3, 5000),
    (11, 4000), (2 * HIST_CHUNK - 1, 2)])
def test_seg_hist_plain_folds_only_covered_chunks(begin, cnt):
    """seg_hist equals the pair contract (build_histograms_pair, itself
    bitwise the JAX package's) over exactly the covered chunks, value
    and residual: no chunk outside the cover enters the Kahan fold."""
    rng = np.random.RandomState(begin + cnt)
    f, n, b = 6, 3 * HIST_CHUNK, 32
    bins = rng.randint(0, b, size=(f, n)).astype(np.uint8)
    ghc = (rng.randn(3, n) * 1e3).astype(np.float32)
    hi, lo = hk.seg_hist_plain(torch.from_numpy(to.pack_feature_words(bins)),
                               torch.from_numpy(ghc), _bounds(begin, cnt), b)
    c0 = begin // HIST_CHUNK
    c1 = (begin + cnt - 1) // HIST_CHUNK + 1
    rows = slice(c0 * HIST_CHUNK, c1 * HIST_CHUNK)
    pos = np.arange(n)[rows]
    masked = ghc[:, rows] * ((pos >= begin) & (pos < begin + cnt))
    want_hi, want_lo = th.build_histograms_pair(
        torch.from_numpy(np.ascontiguousarray(bins[:, rows])),
        torch.from_numpy(np.ascontiguousarray(masked.T)), b)
    assert torch.equal(hi[:f], want_hi) and torch.equal(lo[:f], want_lo)
    # pad features (all rows in bin 0) hold the segment's totals in bin 0
    assert torch.all(hi[f:, 1:] == 0)


@pytest.mark.parametrize("begin", [0, 5000, 3 * HIST_CHUNK])
def test_empty_segment_gives_zeros(begin):
    rng = np.random.RandomState(3)
    n = 3 * HIST_CHUNK
    words = torch.from_numpy(to.pack_feature_words(
        rng.randint(0, 16, size=(4, n)).astype(np.uint8)))
    ghc = torch.from_numpy(rng.rand(3, n).astype(np.float32))
    hi, lo = hk.seg_hist(words, ghc, _bounds(begin, 0), 16)
    assert hi.shape == (4, 16, 3)
    assert torch.equal(hi, torch.zeros_like(hi))
    assert torch.equal(lo, torch.zeros_like(lo))


def test_seg_hist_dispatch_and_checks():
    rng = np.random.RandomState(4)
    n = HIST_CHUNK
    words = torch.from_numpy(to.pack_feature_words(
        rng.randint(0, 16, size=(4, n)).astype(np.uint8)))
    ghc = torch.from_numpy(rng.rand(3, n).astype(np.float32))
    before = hk.launch_counts()
    hi, lo = to.segment_histograms(words, ghc, _bounds(10, 500), 16)
    ph, pl = hk.seg_hist_plain(words, ghc, _bounds(10, 500), 16)
    assert torch.equal(hi, ph) and torch.equal(lo, pl)
    assert hk.launch_counts() == before           # CPU: no kernel launch
    with pytest.raises(ValueError):
        hk.seg_hist(words.to("meta"), ghc.to("meta"),
                    _bounds(0, 1).to("meta"), 16)
    for bad in (dict(words=words[:, :100]), dict(words=words.long()),
                dict(bounds=_bounds(0, 1).long()), dict(num_bins=300)):
        args = dict(words=words, ghc_t=ghc, bounds=_bounds(0, 1),
                    num_bins=16)
        args.update(bad)
        with pytest.raises(ValueError):
            hk.seg_hist(**args)


# ------------------------------------------------------------ training

def _data(seed=0, n=3000, f=6):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    logit = x[:, 0] + 0.5 * x[:, 1] - 0.7 * x[:, 2] + 0.3 * rng.randn(n)
    return x, (logit > 0.4).astype(np.float32), logit.astype(np.float32)


@pytest.mark.parametrize("objective,extra", [
    ("binary", {}),
    ("binary", {"histogram_pool_size": 0.001}),
    ("binary", {"feature_fraction": 0.8}),
    ("regression", {"max_depth": 3, "lambda_l2": 1.0}),
], ids=["binary-cache", "binary-cacheless", "binary-ff0.8", "l2-depth3"])
def test_partitioned_trees_match_jax(objective, extra):
    x, yb, yr = _data()
    y = yb if objective == "binary" else yr
    params = dict(BASE, objective=objective, **extra)
    jb = lgj.train(params, lgj.Dataset(x, y), 5, verbose_eval=False)
    tb = lgt.train(params, lgt.Dataset(x, y), 5, verbose_eval=False,
                   device=CPU)
    learner = tb.gbdt.tree_learner
    assert jb.gbdt.tree_learner._use_partitioned and learner.use_partitioned
    assert learner.bins.dtype == torch.int32 and learner.f_pad == 8
    assert learner.cache_hists is not ("histogram_pool_size" in extra)
    _assert_same_model(jb, tb, x)
    if "max_depth" in extra:
        assert max(t.max_depth for t in _trees(tb)) <= 3


def test_partitioned_bagging_with_one_shared_mask_matches_jax():
    x, y, _ = _data(seed=1)
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


def _categorical_data(n=3000, seed=21):
    """test_partitioned.py:204-245's fixture: two categorical columns."""
    rng = np.random.RandomState(seed)
    x = np.column_stack([
        rng.randint(0, 12, size=n).astype(np.float32),
        rng.randint(0, 5, size=n).astype(np.float32),
        rng.rand(n).astype(np.float32),
        rng.rand(n).astype(np.float32)])
    logit = (np.isin(x[:, 0], [2, 5, 7]) * 1.5 + (x[:, 1] == 3) * 1.0
             + x[:, 2] - 0.5 * x[:, 3])
    return x, (logit + 0.2 * rng.randn(n) > 0.8).astype(np.float32)


@pytest.mark.parametrize("partitioned", ["true", "false"])
def test_categorical_trees_match_jax(partitioned):
    x, y = _categorical_data()
    params = dict(BASE, objective="binary", max_bin=32,
                  partitioned_build=partitioned, hist_compaction="false")
    jb = lgj.train(params, lgj.Dataset(x, y, categorical_feature=[0, 1]), 6,
                   verbose_eval=False)
    tb = lgt.train(params, lgt.Dataset(x, y, categorical_feature=[0, 1]), 6,
                   verbose_eval=False, device=CPU)
    assert tb.gbdt.tree_learner.use_partitioned is (partitioned == "true")
    assert any((t.decision_type == 1).any() for t in _trees(tb))
    _assert_same_model(jb, tb, x)
    for a, b in zip(_trees(jb), _trees(tb)):
        np.testing.assert_array_equal(b.decision_type, a.decision_type)


def test_categorical_column_key_and_names_agree():
    """The categorical_column key, indices and names select the same
    columns: the same trees, with categorical splits."""
    x, y = _categorical_data(n=1500, seed=3)
    base = dict(BASE, objective="binary", max_bin=32)
    by_index = lgt.train(base, lgt.Dataset(x, y, categorical_feature=[0, 1]),
                         3, verbose_eval=False, device=CPU)
    by_key = lgt.train(base, lgt.Dataset(
        x, y, params={"categorical_column": "0,1"}), 3, verbose_eval=False,
        device=CPU)
    by_name = lgt.train(base, lgt.Dataset(x, y), 3, verbose_eval=False,
                        device=CPU, feature_name=["a", "b", "c", "d"],
                        categorical_feature=["a", "b"])
    want = [t.to_string() for t in _trees(by_index)]
    assert any((t.decision_type == 1).any() for t in _trees(by_index))
    assert [t.to_string() for t in _trees(by_key)] == want
    assert [t.to_string() for t in _trees(by_name)] == want


@pytest.mark.parametrize("extra", [
    {}, {"histogram_pool_size": 0.001}, {"bagging_fraction": 0.6,
                                         "bagging_freq": 1}],
    ids=["cache", "cacheless", "bagging"])
def test_partitioned_matches_masked_in_port(extra):
    """Three chunks of rows, so segments cross chunk edges."""
    x, y, _ = _data(seed=9, n=9000, f=7)
    runs = {}
    for pb in ("false", "true"):
        runs[pb] = lgt.train(dict(BASE, objective="binary",
                                  partitioned_build=pb, **extra),
                             lgt.Dataset(x, y), 5, verbose_eval=False,
                             device=CPU)
    mt, pt = _trees(runs["false"]), _trees(runs["true"])
    assert runs["true"].gbdt.tree_learner.use_partitioned
    assert not runs["false"].gbdt.tree_learner.use_partitioned
    assert len(mt) == len(pt) == 5
    for a, b in zip(mt, pt):
        for key in ("split_feature", "threshold_in_bin", "left_child",
                    "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-6)


def test_partitioned_row_leaf_is_in_original_row_order():
    """The builder's row -> leaf map (scattered back through perm) is
    the one the tree gives each row: the train score equals predict."""
    x, y, _ = _data(seed=11, n=5000)
    tb = lgt.train(dict(BASE, objective="binary"), lgt.Dataset(x, y), 4,
                   verbose_eval=False, device=CPU)
    np.testing.assert_allclose(tb.gbdt.get_training_score(),
                               tb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)


def test_auto_and_wide_bins_take_the_masked_builder():
    x, y, _ = _data(seed=12, n=1000)
    for params in ({"partitioned_build": "auto"},
                   {"partitioned_build": "true", "max_bin": 300}):
        tb = lgt.Booster(dict(BASE, objective="binary", **params),
                         lgt.Dataset(x, y, max_bin=params.get("max_bin", 255)),
                         device=CPU)
        assert not tb.gbdt.tree_learner.use_partitioned
    with pytest.raises(lgt.LightGBMError):
        lgt.Booster(dict(BASE, objective="binary", partitioned_build="maybe"),
                    lgt.Dataset(x, y), device=CPU)
