"""lightgbm_tpu_torch's serving predictor against lightgbm_tpu's, on the CPU.

The same model text goes into the JAX package's CompiledPredictor and
the port's (device="cpu": the traversal kernels' plain versions). The
contract held here:

- leaf indices exactly, and the exact-path predict_raw / predict bit for
  bit (both gather the traversed leaves and reduce in f64 on the host
  with the same numpy product), on regression, binary, 3-class and
  categorical models with NaN, +-inf, +-1e10 and -0.5 inputs;
- the `_device` variants within 1e-6 (float32 sums in another order);
- bf16 within `accuracy_bound`, and the bound itself equal to the JAX
  one bit for bit (the same f64 formula on the same bf16 rounding);
- the plain tree_leaf / tree_raw against the JAX device_traverse and
  serving kernels on random trees;
- the predict routing of GBDT.predict_raw: below device_predict_cells
  the host f64 path, bit-equal to the JAX package's; device_predict
  true/false honoured.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgj
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.models.gbdt import device_traverse as jax_traverse
from lightgbm_tpu.serving import CompiledPredictor as JaxPredictor
from lightgbm_tpu.serving.compiled_model import _raw16_kernel, _raw_kernel

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.profile import DatasetProfile, model_profile_path
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.ops import traverse_kernels as tk
from lightgbm_tpu_torch.serving import CompiledPredictor
from lightgbm_tpu_torch.telemetry.ledger import LEDGER

CPU = "cpu"


# --------------------------------------------------------------- models
def _jax_train(objective, num_class=1, n=400, f=6, rounds=10, seed=7):
    """tests/test_serving.py _train's models, trained by the JAX
    package."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    if objective == "regression":
        y = x[:, 0] * 2.0 - x[:, 1] + 0.1 * rng.randn(n)
        params = {"objective": "regression", "metric": "l2"}
    elif objective == "binary":
        y = (x[:, 0] + 0.5 * x[:, 1] + 0.2 * rng.randn(n) > 0).astype(float)
        params = {"objective": "binary", "metric": "binary_logloss"}
    else:
        y = np.floor(rng.rand(n) * num_class)
        y[x[:, 0] > 0.5] = 0
        params = {"objective": "multiclass", "metric": "multi_logloss",
                  "num_class": num_class}
    params.update({"num_leaves": 15, "min_data_in_leaf": 5, "verbose": -1})
    bst = lgj.train(params, lgj.Dataset(x, y, params=params),
                    num_boost_round=rounds, verbose_eval=False)
    return bst.gbdt.save_model_to_string(-1), x


def _categorical_text(seed=3, n=2000):
    """A model the port trains with two categorical columns."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 5).astype(np.float32)
    x[:, 0] = rng.randint(0, 6, n)
    x[:, 1] = rng.randint(0, 4, n)
    y = ((x[:, 0] % 2 == 1) ^ (x[:, 2] > 0.5)).astype(np.float32)
    b = lgt.train({"objective": "binary", "num_leaves": 8,
                   "min_data_in_leaf": 10, "verbose": -1},
                  lgt.Dataset(x, y, categorical_feature=[0, 1]), 6,
                  verbose_eval=False, device=CPU)
    return b.model_to_string(), x


@pytest.fixture(scope="module")
def models():
    texts = {"regression": _jax_train("regression"),
             "binary": _jax_train("binary"),
             "multiclass": _jax_train("multiclass", num_class=3),
             "categorical": _categorical_text()}
    return texts


def _hostile(x, cat_cols=()):
    """x with NaN, +-inf, +-1e10 and -0.5 planted in every column."""
    x = np.array(x, np.float64)
    specials = [np.nan, np.inf, -np.inf, 1e10, -1e10, -0.5]
    for j in range(x.shape[1]):
        for i, v in enumerate(specials):
            x[(7 * i + j) % len(x), j] = v
    for j in cat_cols:
        x[::11, j] = np.nan
    return x


def _port_gbdt(text):
    g = GBDT(device=CPU)
    g.load_model_from_string(text)
    return g


def _jax_gbdt(text):
    g = JaxGBDT()
    g.load_model_from_string(text)
    return g


def _pair(text, **kw):
    return (JaxPredictor.from_booster(_jax_gbdt(text), **kw),
            CompiledPredictor.from_booster(_port_gbdt(text), device=CPU,
                                           **kw))


# ------------------------------------------------------- the predictor
@pytest.mark.parametrize("name", ["regression", "binary", "multiclass",
                                  "categorical"])
def test_predictor_matches_jax(models, name):
    text, x = models[name]
    x = _hostile(x, cat_cols=(0, 1) if name == "categorical" else ())
    jp, tp = _pair(text, max_batch_rows=64)
    np.testing.assert_array_equal(tp.predict_leaf_index(x),
                                  jp.predict_leaf_index(x))
    np.testing.assert_array_equal(tp.predict_raw(x), jp.predict_raw(x))
    np.testing.assert_array_equal(tp.predict(x), jp.predict(x))
    # float32 sums on the device, in another order than JAX's matmul
    np.testing.assert_allclose(tp.predict_raw_device(x),
                               jp.predict_raw_device(x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.predict_device(x), jp.predict_device(x),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.predict_raw_device(x), tp.predict_raw(x),
                               rtol=0, atol=1e-6)
    assert tp.stats["cold_dispatches"] == jp.stats["cold_dispatches"]
    if name == "multiclass":
        assert tp.num_class == 3
        np.testing.assert_allclose(tp.predict(x).sum(axis=1), 1.0,
                                   atol=1e-9)


@pytest.mark.parametrize("name", ["regression", "binary", "multiclass",
                                  "categorical"])
def test_bf16_within_pinned_bound_equal_to_jax(models, name):
    text, x = models[name]
    x = _hostile(x, cat_cols=(0, 1) if name == "categorical" else ())
    jp, tp = _pair(text, max_batch_rows=64, serving_precision="bf16")
    exact = CompiledPredictor.from_booster(_port_gbdt(text), device=CPU,
                                           max_batch_rows=64)
    assert tp.accuracy_bound == jp.accuracy_bound
    assert tp.accuracy_bound > 0
    for got, want in ((tp.predict_raw(x), exact.predict_raw(x)),
                      (tp.predict(x), exact.predict(x))):
        assert np.abs(got - want).max() <= tp.accuracy_bound
    # the same bf16 values, summed in another order than JAX's dot
    np.testing.assert_allclose(tp.predict_raw(x), jp.predict_raw(x),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tp.predict_leaf_index(x),
                                  jp.predict_leaf_index(x))


def test_from_model_file_and_profile_sidecar(tmp_path, models):
    text, x = models["binary"]
    path = tmp_path / "model.txt"
    path.write_text(text)
    # a profile of the training data beside the model file
    ds = lgt.Dataset(x.astype(np.float32), (x[:, 0] > 0).astype(np.float32))
    DatasetProfile.from_dataset(ds.construct()._core).save(
        model_profile_path(path))
    tp = CompiledPredictor.from_model_file(str(path), max_batch_rows=32,
                                           device=CPU)
    jp = JaxPredictor.from_model_file(str(path), max_batch_rows=32)
    np.testing.assert_array_equal(tp.predict(x), jp.predict(x))
    assert tp.model_path == str(path)
    assert tp.profile is not None and tp.profile.num_rows == len(x)
    assert tp.describe()["has_profile"]
    card = tp.describe()
    for key, value in jp.describe().items():
        if key != "has_profile":
            assert card[key] == value, key


def test_chunking_beyond_max_batch_rows(models):
    text, x = models["binary"]
    jp, tp = _pair(text, max_batch_rows=32)
    assert len(x) > 32
    np.testing.assert_array_equal(tp.predict(x), jp.predict(x))
    np.testing.assert_array_equal(tp.predict_leaf_index(x),
                                  _port_gbdt(text).predict_leaf_index(x))
    assert tp.stats["cold_dispatches"] == 0
    # predict and predict_leaf_index: one leaf dispatch a 32-row block
    assert tp.stats["warm_dispatches"] == 2 * -(-len(x) // 32)


def test_width_canonicalization(models):
    text, x = models["binary"]
    jp, tp = _pair(text, max_batch_rows=32)
    wide = np.hstack([x[:5], np.full((5, 3), 99.0)])
    np.testing.assert_array_equal(tp.predict(wide), jp.predict(wide))
    np.testing.assert_array_equal(tp.predict(wide), tp.predict(x[:5]))
    narrow = x[:5, :4]
    padded = np.hstack([narrow, np.zeros((5, x.shape[1] - 4))])
    np.testing.assert_array_equal(tp.predict(narrow), tp.predict(padded))
    np.testing.assert_array_equal(tp.predict(narrow), jp.predict(narrow))
    assert tp.stats["cold_dispatches"] == 0


def test_empty_model_and_empty_input(models):
    g = GBDT(device=CPU)
    g.load_model_from_string("\n".join([
        "gbdt", "num_class=1", "label_index=0", "max_feature_idx=1",
        "sigmoid=-1", "feature_names=A B", ""]))
    tp = CompiledPredictor.from_booster(g, max_batch_rows=4, device=CPU)
    assert tp.predict(np.zeros((3, 2))).shape == (3, 1)
    assert tp.predict_leaf_index(np.zeros((3, 2))).shape == (3, 0)
    assert tp.predict_raw_device(np.zeros((3, 2))).shape == (3, 1)
    text, x = models["binary"]
    _, tp2 = _pair(text, max_batch_rows=4)
    assert tp2.predict(np.zeros((0, x.shape[1]))).shape == (0, 1)
    assert tp2.predict_leaf_index(np.zeros((0, x.shape[1]))).shape == (
        0, tp2.num_trees)


def test_training_on_leaves_served_results_unchanged():
    rng = np.random.RandomState(5)
    x = rng.rand(600, 4).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 1).astype(np.float32)
    b = lgt.Booster({"objective": "binary", "num_leaves": 7,
                     "min_data_in_leaf": 10, "verbose": -1},
                    lgt.Dataset(x, y), device=CPU)
    for _ in range(3):
        b.update()
    tp = CompiledPredictor.from_booster(b, max_batch_rows=64, device=CPU)
    before_raw, before_leaf = tp.predict_raw(x), tp.predict_leaf_index(x)
    for _ in range(3):
        b.update()
    assert len(b.gbdt.models) == 6 and tp.num_trees == 3
    np.testing.assert_array_equal(tp.predict_raw(x), before_raw)
    np.testing.assert_array_equal(tp.predict_leaf_index(x), before_leaf)


def test_warm_up_ledger_and_stats(models):
    text, _ = models["regression"]
    LEDGER.reset()
    tp = CompiledPredictor.from_booster(_port_gbdt(text), max_batch_rows=16,
                                        device=CPU, serving_precision="bf16")
    labels = {e["label"] for e in LEDGER.snapshot(recent_n=256)["recent"]}
    assert {f"serving_bucket_{b}" for b in tp.buckets} <= labels
    # no kernel library on the CPU, and every (kernel, bucket) warmed
    assert tp.stats["compile_cache_hits"] == 0
    assert tp.stats["buckets"] == [1, 2, 4, 8, 16]
    tp.predict(np.zeros((3, tp.num_features)))
    tp.predict_raw(np.zeros((16, tp.num_features)))
    assert tp.stats["cold_dispatches"] == 0


def test_linear_leaf_model_raises():
    """A linear-leaf model is served (its refusal went): a single-leaf
    linear tree answers const + coef * x, NaN falls back to the leaf
    value; an unknown precision still raises."""
    g = GBDT(device=CPU)
    g.load_model_from_string("\n".join([
        "gbdt", "num_class=1", "label_index=0", "max_feature_idx=1",
        "sigmoid=-1", "feature_names=A B", ""]))
    t = Tree(1)
    t.leaf_value[0] = 0.5
    t.set_linear([0.25], [np.array([2.0])], [True], [[1]])
    g.models = [t]
    p = CompiledPredictor.from_booster(g, device=CPU, max_batch_rows=4)
    assert p.is_linear
    x = np.array([[0.0, 1.5], [3.0, np.nan]], np.float32)
    np.testing.assert_array_equal(p.predict_raw(x), [[3.25], [0.5]])
    np.testing.assert_array_equal(p.predict_raw(x),
                                  g.predict_raw(x.astype(np.float64)))
    np.testing.assert_array_equal(p.predict_raw_device(x), [[3.25], [0.5]])
    with pytest.raises(ValueError, match="serving_precision"):
        CompiledPredictor.from_booster(g, device=CPU,
                                       serving_precision="fp8")


# ------------------------------------------- the kernels' plain versions
def _random_forest(rng, t_cnt, max_leaves, f, cat_frac=0.3, num_cat=4):
    """Random valid trees grown by random leaf splits: (T, S) arrays,
    node0, depth and (T, L) leaf values."""
    s = max_leaves - 1
    sf = np.zeros((t_cnt, s), np.int32)
    thr = np.zeros((t_cnt, s), np.float32)
    cat = np.zeros((t_cnt, s), bool)
    lc = np.full((t_cnt, s), ~0, np.int32)
    rc = np.full((t_cnt, s), ~0, np.int32)
    lv = np.zeros((t_cnt, max_leaves), np.float64)
    node0 = np.zeros(t_cnt, np.int32)
    depth = 1
    for t in range(t_cnt):
        nl = rng.randint(1, max_leaves + 1)
        leaves, leaf_depth = [(-1, 0)], [0]
        for ns in range(nl - 1):
            li = rng.randint(len(leaves))
            parent, side = leaves[li]
            if parent >= 0:
                (lc if side == 0 else rc)[t, parent] = ns
            sf[t, ns] = rng.randint(f)
            cat[t, ns] = rng.rand() < cat_frac
            thr[t, ns] = (rng.randint(num_cat) if cat[t, ns]
                          else np.float32(rng.randn()))
            lc[t, ns], rc[t, ns] = ~li, ~len(leaves)
            leaves[li] = (ns, 0)
            leaves.append((ns, 1))
            leaf_depth[li] += 1
            leaf_depth.append(leaf_depth[li])
        node0[t] = 0 if nl > 1 else ~0
        lv[t, :nl] = rng.randn(nl) * 0.3
        depth = max(depth, max(leaf_depth))
    return sf, thr, cat, lc, rc, node0, depth, lv


def _random_rows(rng, n, f, num_cat=4):
    x = rng.randn(n, f).astype(np.float32)
    x[:, ::2] = rng.randint(0, num_cat, (n, (f + 1) // 2))
    return _hostile(x).astype(np.float32)


@pytest.mark.parametrize("num_class", [1, 3])
def test_plain_kernels_match_jax_traverse(num_class):
    rng = np.random.RandomState(11 + num_class)
    f, t_cnt = 7, 24
    sf, thr, cat, lc, rc, node0, depth, lv = _random_forest(rng, t_cnt, 12, f)
    x = _random_rows(rng, 300, f)
    forest = tk.freeze(sf, thr, cat, lc, rc, node0, depth, CPU)
    xt = torch.from_numpy(x)
    leaves = tk.tree_leaf(xt, forest).numpy()
    jnode = np.asarray(jax_traverse(
        jnp.asarray(x), jnp.asarray(sf), jnp.asarray(thr), jnp.asarray(cat),
        jnp.asarray(lc), jnp.asarray(rc), jnp.asarray(node0), depth))
    np.testing.assert_array_equal(leaves, ~jnode)
    onehot = (np.arange(t_cnt)[:, None] % num_class
              == np.arange(num_class)[None, :]).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, sf, thr, cat, lc, rc)]
    raw = tk.tree_raw(xt, forest, torch.from_numpy(lv.astype(np.float32)),
                      num_class).numpy()
    jraw = np.asarray(_raw_kernel(*jargs, jnp.asarray(lv, jnp.float32),
                                  jnp.asarray(node0), jnp.asarray(onehot),
                                  depth))
    np.testing.assert_allclose(raw, jraw, rtol=0, atol=1e-6)
    # the plain sum is the kernel's: f32 adds in tree order
    vals = lv.astype(np.float32)[np.arange(t_cnt)[None, :], leaves]
    seq = np.zeros((len(x), num_class), np.float32)
    for t in range(t_cnt):
        seq[:, t % num_class] += vals[:, t]
    np.testing.assert_array_equal(raw, seq)
    lv16 = torch.from_numpy(lv.astype(np.float32)).to(torch.bfloat16)
    raw16 = tk.tree_raw(xt, forest, lv16, num_class).numpy()
    jraw16 = np.asarray(_raw16_kernel(
        *jargs, jnp.asarray(lv, jnp.bfloat16), jnp.asarray(node0),
        jnp.asarray(onehot, jnp.bfloat16), depth))
    np.testing.assert_allclose(raw16, jraw16, rtol=0, atol=1e-5)


def test_pack_nodes_records():
    sf = np.array([[3, 0]], np.int32)
    thr = np.array([[2.0, -0.25]], np.float32)
    cat = np.array([[True, False]])
    lc = np.array([[1, ~0]], np.int32)
    rc = np.array([[~2, ~1]], np.int32)
    rec = tk.pack_nodes(sf, thr, cat, lc, rc)
    assert rec.shape == (1, 2, 4) and rec.dtype == np.int32
    assert rec[0, 0, 0] == (3 | -(1 << 31)) and rec[0, 1, 0] == 0
    assert rec[0, 0, 0] & 0x7FFFFFFF == 3
    np.testing.assert_array_equal(rec[..., 1].view(np.float32), thr)
    np.testing.assert_array_equal(rec[..., 2], lc)
    np.testing.assert_array_equal(rec[..., 3], rc)


def test_wrappers_check_their_inputs():
    rng = np.random.RandomState(2)
    sf, thr, cat, lc, rc, node0, depth, lv = _random_forest(rng, 4, 6, 5)
    sf[0, 0] = 4            # a split on the last of 5 features
    forest = tk.freeze(sf, thr, cat, lc, rc, node0, depth, CPU)
    assert forest.width == 5
    with pytest.raises(ValueError, match="features"):
        tk.tree_leaf(torch.zeros(3, 4), forest)
    with pytest.raises(ValueError, match="float32"):
        tk.tree_leaf(torch.zeros(3, 5, dtype=torch.float64), forest)
    with pytest.raises(ValueError, match="device"):
        tk.tree_leaf(torch.zeros(3, 5, device="meta"), forest)
    with pytest.raises(TypeError):
        tk.tree_raw(torch.zeros(3, 5), forest,
                    torch.zeros(4, 6, dtype=torch.float64), 1)
    assert tk.launch_counts() == {"tree_leaf": 0, "tree_raw": 0,
                                  "tree_lin_raw": 0}



def _rz(v):
    """__float2int_rz: toward zero, saturating at +-inf."""
    return int(np.clip(np.trunc(v), -2.0 ** 31, 2.0 ** 31 - 1))


def _walk_tile(col, node, xrow, depth):
    """One walk through a tree's column of an interleaved tile
    (interleave: byte offsets), by the kernel's rule; returns the final
    state with a cut-short walk's node as its index."""
    node = node * tk.TILE * 16 if node >= 0 else node
    for _ in range(depth):
        if node < 0:
            break
        feat, thr_bits, left_child, right_child = (
            int(v) for v in col[node // (tk.TILE * 16)])
        v = xrow[(feat & 0x7FFFFFFF) // 4]
        thr = np.int32(thr_bits).view(np.float32)
        if feat < 0:
            left = not np.isnan(v) and _rz(v) == _rz(thr)
        else:
            left = v <= thr
        node = left_child if left else right_child
    return node // (tk.TILE * 16) if node >= 0 else node


def _emulate_launch(p, tiles, node0, x, depth, lv, num_class):
    """csrc/traverse.cu under plan `p`, in Python: the blocks (row block,
    group of tiles), their windows, each warp's (tile, row) items and each
    lane's walk (tree `lane` of the tile) through the interleaved records;
    every pair counted. Returns (the (B, T) leaves, or None for tree_raw;
    the (B, K) sums added window by window in tree order, or None; the
    per-pair count)."""
    b, t = x.shape[0], len(node0)
    leaves = np.zeros((b, t), np.int64) if lv is None else None
    sums = None if lv is None else np.zeros((b, num_class), np.float32)
    count = np.zeros((b, t), np.int64)
    warps = p.threads // 32
    n_rb, n_g = p.grid(b, t)
    assert lv is None or n_g == 1     # tree_raw: the whole forest a block
    for bx in range(n_rb):
        row0 = bx * p.rows
        nrows = min(p.rows, b - row0)
        for by in range(n_g):
            gt0 = by * p.group
            gtn = min(p.group, tiles.shape[0] - gt0)
            g0 = gt0 * tk.TILE
            gn = min(gtn * tk.TILE, t - g0)
            for wt0 in range(0, gtn, p.window):
                wtiles = min(p.window, gtn - wt0)
                wtrees0 = wt0 * tk.TILE
                wtn = min(wtiles * tk.TILE, gn - wtrees0)
                vals = {}
                for warp in range(warps):
                    for u in range(warp, wtiles * nrows, warps):
                        r, tl = divmod(u, wtiles)
                        for lane in range(32):
                            jw = tl * tk.TILE + lane
                            if jw >= wtn:
                                continue
                            tree, row = g0 + wtrees0 + jw, row0 + r
                            count[row, tree] += 1
                            node = _walk_tile(tiles[gt0 + wt0 + tl, :, lane],
                                              int(node0[tree]), x[row], depth)
                            if lv is None:
                                leaves[row, tree] = ~node
                            else:
                                vals[r, jw] = lv[tree,
                                                 ~node if node < 0 else 0]
                if lv is not None:
                    for q in range(nrows * num_class):
                        rr, c = divmod(q, num_class)
                        a = sums[row0 + rr, c]
                        for j in range((c - wtrees0) % num_class, wtn,
                                       num_class):
                            a = np.float32(a + vals[rr, j])
                        sums[row0 + rr, c] = a
    return leaves, sums, count


@pytest.mark.parametrize("b,t_cnt,num_class,smem,cut", [
    (1, 9, None, "auto", 0),       # one part-filled tile
    (45, 90, None, "auto", 0),     # row blocks x tiles
    (33, 70, None, "none", 0),     # records from device memory
    (45, 100, 1, "auto", 0),       # a ring of two one-tile windows
    (45, 100, 1, "one", 0),        # two do not fit: one
    (3, 70, 1, "auto", 0),         # the whole group resident
    (70, 80, 3, "auto", 0),        # sums in the block, a ring
    (70, 80, 3, "one", 0),         # sums in the block, one window
    (7, 40, 1100, "auto", 0),      # many classes: the rows shrink
    (31, 10, 2, "auto", 2),        # walks cut short by depth
])
def test_launch_plan_covers_every_pair_as_jax_traverse(b, t_cnt, num_class,
                                                       smem, cut):
    rng = np.random.RandomState(b + t_cnt)
    f = 5
    sf, thr, cat, lc, rc, node0, depth, lv = _random_forest(rng, t_cnt, 9, f)
    depth = max(0, depth - cut)
    x = _random_rows(rng, b, f)
    rec = tk.pack_nodes(sf, thr, cat, lc, rc)
    tiles = tk.interleave(rec)
    s = rec.shape[1]
    sums = num_class is not None
    p = tk.plan(b, f, t_cnt, s, num_class, sms=2)
    smem_limit = tk.SMEM_OPTIN_SM90
    if smem != "auto":   # a card with less shared memory
        smem_limit = tk.smem_bytes(p.rows, p.group, 1, 2 if smem == "one"
                                   else 1, p.stage_rows, f, s,
                                   num_class or 1, sums) - 1
        p = tk.plan(b, f, t_cnt, s, num_class, sms=2, smem_limit=smem_limit)
    assert p.smem <= smem_limit
    assert p.slots == {"one": 1, "none": 0}.get(smem, p.slots)
    if sums:
        assert p.grid(b, t_cnt)[1] == 1
        assert p.rows * num_class * 4 <= tk.SUM_BYTES
    if (num_class, smem) == (1, "auto"):
        assert (p.window, p.slots) == ((3, 1) if b == 3 else (1, 2))
    lv32 = None if num_class is None else lv.astype(np.float32)
    leaves, sums, count = _emulate_launch(p, tiles, node0, x, depth, lv32,
                                          num_class)
    assert (count == 1).all()
    jnode = np.asarray(jax_traverse(
        jnp.asarray(x), jnp.asarray(sf), jnp.asarray(thr), jnp.asarray(cat),
        jnp.asarray(lc), jnp.asarray(rc), jnp.asarray(node0), depth))
    forest = tk.freeze(sf, thr, cat, lc, rc, node0, depth, CPU)
    if num_class is None:
        np.testing.assert_array_equal(leaves, ~jnode)
        np.testing.assert_array_equal(
            leaves, tk.tree_leaf(torch.from_numpy(x), forest).numpy())
        return
    # the plain version's bits: f32 adds in tree order, leaf 0 where a
    # walk was cut short
    want = tk.tree_raw(torch.from_numpy(x), forest, torch.from_numpy(lv32),
                       num_class).numpy()
    np.testing.assert_array_equal(sums, want)
    if not cut:
        onehot = (np.arange(t_cnt)[:, None] % num_class
                  == np.arange(num_class)[None, :]).astype(np.float32)
        jraw = np.asarray(_raw_kernel(
            *[jnp.asarray(a) for a in (x, sf, thr, cat, lc, rc)],
            jnp.asarray(lv32), jnp.asarray(node0), jnp.asarray(onehot),
            depth))
        np.testing.assert_allclose(sums, jraw, rtol=0, atol=1e-6)


@pytest.mark.parametrize("b,f,t_cnt,s,num_class", [
    (4096, 28, 100, 62, None), (4096, 28, 100, 62, 1), (1, 28, 100, 62, 1),
    (65536, 28, 100, 62, 1), (4097, 3000, 1500, 62, None),
    (1, 60000, 1500, 62, 1), (33, 28, 16, 62, 10224),
    (257, 28, 1200, 62, 9216), (31, 28, 3, 16383, 3),
    (2, 28, 200000, 62, None), (100, 28, 1, 1, 1),
    (5, 28, 20000, 62, 1), (1, 28, 100, 62, 50000)])
def test_launch_plan_fits_every_shape(b, f, t_cnt, s, num_class):
    """Every (K, F, T, S) the earlier 40 KB-shared-memory kernel took (K
    up to 10240 - min(T, 1024), any F, T and S) and more classes and
    trees get a plan within the card's shared memory: wide rows
    unstaged, a tree larger than a stage read from device memory, the
    rows of many classes shrunk until their sums fit, more than 8192
    trees summed in one block."""
    p = tk.plan(b, f, t_cnt, s, num_class)
    n_rb, n_g = p.grid(b, t_cnt)
    sums = num_class is not None
    assert p.smem <= tk.SMEM_OPTIN_SM90
    assert p.smem == tk.smem_bytes(p.rows, p.group, p.window, p.slots,
                                   p.stage_rows, f, s, num_class or 1, sums)
    assert 1 <= p.rows <= 64 and n_rb * p.rows >= max(b, 1)
    assert 256 <= p.threads <= 1024 and p.threads % 32 == 0
    assert 1 <= p.window <= p.group
    assert n_g <= tk.MAX_GROUPS and (n_g - 1) * p.group * tk.TILE < t_cnt
    assert p.stage_rows == (p.rows * (f | 1) * 4 <= tk.ROW_BYTES)
    if sums:
        assert n_g == 1
        assert p.rows == 1 or p.rows * num_class * 4 <= tk.SUM_BYTES
    if s * tk.TILE * 16 > tk.SMEM_OPTIN_SM90:
        assert p.slots == 0


def test_interleave_puts_a_tile_of_trees_side_by_side():
    rng = np.random.RandomState(5)
    sf, thr, cat, lc, rc, node0, depth, lv = _random_forest(rng, 40, 9, 6)
    rec = tk.pack_nodes(sf, thr, cat, lc, rc)
    tiles = tk.interleave(rec)
    assert tiles.shape == (2, rec.shape[1], 32, 4)
    assert tiles.flags.c_contiguous
    for t in range(40):
        col = tiles[t // 32, :, t % 32]
        # the feature as a byte offset, the categorical flag kept
        np.testing.assert_array_equal(col[:, 0] & 0x7FFFFFFF,
                                      (rec[t, :, 0] & 0x7FFFFFFF) * 4)
        np.testing.assert_array_equal(col[:, 0] < 0, rec[t, :, 0] < 0)
        np.testing.assert_array_equal(col[:, 1], rec[t, :, 1])
        for c in (2, 3):     # node children as byte offsets, leaves kept
            want = np.where(rec[t, :, c] >= 0, rec[t, :, c] * 512,
                            rec[t, :, c])
            np.testing.assert_array_equal(col[:, c], want)
    assert not tiles[1, :, 8:].any()      # the padding trees


def test_tree_raw_plain_reads_leaf_zero_where_a_walk_is_cut_short():
    # one tree: root splits on feature 0, its left child splits again
    sf = np.array([[0, 0]], np.int32)
    thr = np.array([[0.5, 0.25]], np.float32)
    cat = np.zeros((1, 2), bool)
    lc = np.array([[1, ~0]], np.int32)
    rc = np.array([[~2, ~1]], np.int32)
    lv = torch.tensor([[1.0, 2.0, 4.0]])
    x = torch.tensor([[0.0], [0.3], [0.9]])
    full = tk.freeze(sf, thr, cat, lc, rc, np.zeros(1, np.int32), 2, CPU)
    cut = full._replace(depth=1)
    np.testing.assert_array_equal(tk.tree_leaf(x, full).numpy().ravel(),
                                  [0, 1, 2])
    # the left walks stop at node 1: tree_leaf keeps ~node, tree_raw
    # reads leaf 0
    np.testing.assert_array_equal(tk.tree_leaf(x, cut).numpy().ravel(),
                                  [~1, ~1, 2])
    np.testing.assert_array_equal(tk.tree_raw(x, cut, lv, 1).numpy().ravel(),
                                  [1.0, 1.0, 4.0])


# ------------------------------------------------------ the predict routing
@pytest.mark.parametrize("name", ["binary", "multiclass", "categorical"])
def test_host_path_bit_equal_to_jax_host_path(models, name):
    text, x = models[name]
    x = _hostile(x, cat_cols=(0, 1) if name == "categorical" else ())
    tg, jg = _port_gbdt(text), _jax_gbdt(text)
    n_used = len(tg.models)
    assert not tg._use_device_predict(len(x), n_used)
    assert not jg._use_device_predict(len(x), n_used)
    np.testing.assert_array_equal(tg.predict_raw(x), jg.predict_raw(x))
    np.testing.assert_array_equal(tg.predict(x), jg.predict(x))
    np.testing.assert_array_equal(tg.predict_leaf_index(x),
                                  jg.predict_leaf_index(x))


def test_booster_predict_no_longer_diverges_from_jax():
    """The port's Booster.predict used to reduce float32 leaf values on
    the device whatever the model's size: a small model's predictions
    differed from the JAX package's host float64 path in the last bits
    (hidden by the 1e-6 tolerance of test_torch_train). Below
    device_predict_cells both now take the host path."""
    rng = np.random.RandomState(21)
    x = rng.rand(2000, 5).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + 0.3 * rng.randn(2000) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "partitioned_build": "false", "hist_compaction": "false",
              "device_row_chunk": 4096}
    tb = lgt.train(params, lgt.Dataset(x, y), 8, verbose_eval=False,
                   device=CPU)
    jg = _jax_gbdt(tb.model_to_string())
    want = jg.predict_raw(x)[:, 0]
    np.testing.assert_array_equal(tb.predict(x, raw_score=True), want)
    np.testing.assert_array_equal(tb.predict(x), jg.predict(x)[:, 0])
    # the old route (float32 sums of float32 leaf values) is not those bits
    tb.gbdt.device_predict = "true"
    dev = tb.predict(x, raw_score=True)
    assert not np.array_equal(dev, want)
    np.testing.assert_allclose(dev, want, rtol=0, atol=1e-6)


def test_device_predict_knob_and_env(monkeypatch, models):
    text, x = models["binary"]
    g = _port_gbdt(text)
    n_used = len(g.models)
    calls = []
    real = tk.tree_raw
    monkeypatch.setattr(tk, "tree_raw",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert not g._use_device_predict(len(x), n_used)
    g.predict_raw(x)
    assert calls == []
    g.device_predict = "true"
    dev = g.predict_raw(x)
    assert calls == [1]
    np.testing.assert_allclose(dev, _jax_gbdt(text).predict_raw(x), rtol=0,
                               atol=1e-6)
    g.device_predict = "auto"
    g.DEVICE_PREDICT_CELLS = 10
    assert g._use_device_predict(11, 1) and not g._use_device_predict(9, 1)
    g.apply_predict_config(Config.from_params(
        {"device_predict": "false", "device_predict_cells": 5,
         "host_traverse_cells": 77}))
    assert g.DEVICE_PREDICT_CELLS == 5 and g._HOST_TRAVERSE_CELLS == 77
    assert not g._use_device_predict(10**9, n_used)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "force")
    assert g._use_device_predict(1, n_used)
    g.force_host_predict = True
    assert not g._use_device_predict(10**9, n_used)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "0")
    g.force_host_predict = False
    g.device_predict = "true"
    assert not g._use_device_predict(10**9, n_used)


def test_training_config_reaches_the_routing():
    rng = np.random.RandomState(4)
    x = rng.rand(500, 4).astype(np.float32)
    b = lgt.train({"objective": "binary", "num_leaves": 4, "verbose": -1,
                   "device_predict": "true", "device_predict_cells": 123},
                  lgt.Dataset(x, (x[:, 0] > 0.5).astype(np.float32)), 2,
                  verbose_eval=False, device=CPU)
    assert b.gbdt.device_predict == "true"
    assert b.gbdt.DEVICE_PREDICT_CELLS == 123
    assert b.gbdt._use_device_predict(1, 1)


def test_concurrent_predict_keeps_every_count(models):
    """Threads outnumbering the cores call one predictor at once, with
    a short switch interval: every dispatch is counted once (the stats
    are updated under a lock) and every answer is the one-thread one."""
    import sys
    import threading
    text, x = models["binary"]
    _, tp = _pair(text, max_batch_rows=16)
    want = tp.predict(x[:16])
    base = tp.stats["warm_dispatches"]
    n_threads, calls = min(2 * (os.cpu_count() or 1) + 4, 40), 20
    bad = []

    def worker():
        for _ in range(calls):
            if not np.array_equal(tp.predict(x[:16]), want):
                bad.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert tp.stats["warm_dispatches"] - base == n_threads * calls
    assert tp.stats["cold_dispatches"] == 0
