"""lightgbm_tpu_torch's traversal kernels and serving predictor on the card.

tree_leaf and tree_raw (csrc/traverse.cu) against their plain versions
on the same CUDA tensors: leaf indices bit for bit on random trees with
NaN, +-inf, +-1e10 and -0.5 on categorical nodes; tree_raw with float32
leaf values within 1e-6 relative (the plain version adds in the kernel's
order, so in practice bit for bit) and with bfloat16 values within the
predictor's pinned accuracy bound, each stable in bits across launches.
A wrapper given a CUDA tensor launches its kernel and never the plain
version, and a CompiledPredictor called from two threads at once gives
the bits of one thread alone.

The launch plans of the shared-memory design are held to the same bits
at their edges: forests larger than shared memory (1,500 trees of 63
leaves; trees of 16,384 leaves, larger than a block's shared memory,
walked from device memory), rows too wide to stage (F = 3000 and
60,000), the largest class counts of the earlier 40 KB design, walks
cut short by `depth`, row counts around the tiles (1, 31, 33, 4095,
4097), single-leaf trees, two threads launching at once, and plans the
kernel must refuse (it raises; nothing falls back).

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_serving_card.py -m cuda --noconftest
"""

import ctypes
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import traverse_kernels as tk
from lightgbm_tpu_torch.serving import CompiledPredictor

DEV = "cuda"

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _random_forest(rng, t_cnt, max_leaves, f, cat_frac=0.3, num_cat=5,
                   exact=False, single_frac=0.0):
    """Random valid trees grown by random leaf splits (`max_leaves`
    leaves each with `exact`; a `single_frac` share single-leaf)."""
    s = max_leaves - 1
    sf = np.zeros((t_cnt, s), np.int32)
    thr = np.zeros((t_cnt, s), np.float32)
    cat = np.zeros((t_cnt, s), bool)
    lc = np.full((t_cnt, s), ~0, np.int32)
    rc = np.full((t_cnt, s), ~0, np.int32)
    lv = np.zeros((t_cnt, max_leaves), np.float32)
    node0 = np.zeros(t_cnt, np.int32)
    depth = 1
    for t in range(t_cnt):
        nl = max_leaves if exact else rng.randint(1, max_leaves + 1)
        if rng.rand() < single_frac:
            nl = 1
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
    return (sf, thr, cat, lc, rc, node0, depth), lv


def _rows(rng, n, f, num_cat=5):
    x = rng.randn(n, f).astype(np.float32)
    x[:, ::2] = rng.randint(0, num_cat, (n, (f + 1) // 2))
    specials = np.array([np.nan, np.inf, -np.inf, 1e10, -1e10, -0.5],
                        np.float32)
    mask = rng.rand(n, f) < 0.1
    x[mask] = specials[rng.randint(len(specials), size=int(mask.sum()))]
    return x


@pytest.mark.parametrize("t_cnt,max_leaves,n", [(112, 63, 4096), (7, 5, 1),
                                                (1500, 16, 300)])
def test_tree_leaf_bit_equal_to_plain(t_cnt, max_leaves, n):
    rng = np.random.RandomState(t_cnt)
    f = 28
    arrays, _ = _random_forest(rng, t_cnt, max_leaves, f)
    forest = tk.freeze(*arrays, DEV)
    x = torch.from_numpy(_rows(rng, n, f)).to(DEV)
    tk.reset_launch_counts()
    got = tk.tree_leaf(x, forest)
    again = tk.tree_leaf(x, forest)
    torch.cuda.synchronize()
    assert tk.launch_counts()["tree_leaf"] == 2
    want = tk.tree_leaf_plain(x, forest)
    assert got.dtype == torch.int32 and got.shape == (n, t_cnt)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    # and the plain walk on the CPU
    cpu_forest = tk.freeze(*arrays, "cpu")
    assert torch.equal(got.cpu(), tk.tree_leaf(x.cpu(), cpu_forest))


@pytest.mark.parametrize("num_class,t_cnt,n", [(1, 112, 4096), (3, 96, 1),
                                               (3, 1200, 257)])
def test_tree_raw_f32_and_bf16(num_class, t_cnt, n):
    rng = np.random.RandomState(100 + t_cnt)
    f = 28
    arrays, lv = _random_forest(rng, t_cnt, 63, f)
    forest = tk.freeze(*arrays, DEV)
    x = torch.from_numpy(_rows(rng, n, f)).to(DEV)
    lv32 = torch.from_numpy(lv).to(DEV)
    lv16 = lv32.to(torch.bfloat16)
    for vals in (lv32, lv16):
        got = tk.tree_raw(x, forest, vals, num_class)
        again = tk.tree_raw(x, forest, vals, num_class)
        torch.cuda.synchronize()
        want = tk.tree_raw_plain(x, forest, vals, num_class)
        assert got.shape == (n, num_class) and got.dtype == torch.float32
        assert torch.equal(got, again)
        scale = vals.float().abs().amax(dim=1).sum()
        assert float((got - want).abs().max()) <= 1e-6 * float(scale)
    # bf16 against the float64 sum of the exact leaf values: within the
    # predictor's pinned bound (compiled_model._pin_accuracy_bound)
    leaves = tk.tree_leaf(x, forest).long().cpu().numpy()
    lv64 = lv.astype(np.float64)
    onehot = (np.arange(t_cnt)[:, None] % num_class
              == np.arange(num_class)[None, :]).astype(np.float64)
    exact = lv64[np.arange(t_cnt)[None, :], leaves] @ onehot
    got16 = tk.tree_raw(x, forest, lv16, num_class).cpu().numpy()
    err_t = np.abs(lv64 - lv16.double().cpu().numpy()).max(axis=1)
    slack = (np.abs(lv64).max(axis=1) @ onehot).max() * t_cnt \
        * float(np.finfo(np.float32).eps)
    bound = 2.0 * ((err_t @ onehot).max() + slack)
    assert np.abs(got16 - exact).max() <= bound


def test_cuda_tensor_never_takes_the_plain_route(monkeypatch):
    rng = np.random.RandomState(3)
    arrays, lv = _random_forest(rng, 16, 8, 6)
    forest = tk.freeze(*arrays, DEV)
    x = torch.from_numpy(_rows(rng, 64, 6)).to(DEV)

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(tk, "tree_leaf_plain", boom)
    monkeypatch.setattr(tk, "tree_raw_plain", boom)
    tk.reset_launch_counts()
    tk.tree_leaf(x, forest)
    tk.tree_raw(x, forest, torch.from_numpy(lv).to(DEV), 2)
    torch.cuda.synchronize()
    assert tk.launch_counts() == {"tree_leaf": 1, "tree_raw": 1,
                                  "tree_lin_raw": 0}
    with pytest.raises(ValueError):
        tk.tree_leaf(x[:, :2].contiguous(), forest)   # too narrow


def test_predictor_from_two_threads_gives_one_threads_bits():
    rng = np.random.RandomState(8)
    x = rng.rand(6000, 10).astype(np.float32)
    y = (x[:, 0] + x[:, 1] + 0.2 * rng.randn(6000) > 1).astype(np.float32)
    b = lgt.train({"objective": "binary", "num_leaves": 31, "verbose": -1},
                  lgt.Dataset(x, y), 20, verbose_eval=False, device=DEV)
    for precision in ("f32", "bf16"):
        cp = CompiledPredictor.from_booster(b, max_batch_rows=512,
                                            serving_precision=precision)
        chunks = [x[i * 700:(i + 1) * 700] for i in range(8)]
        want = [cp.predict(c) for c in chunks]
        got = [None] * len(chunks)
        barrier = threading.Barrier(2)

        def worker(k):
            barrier.wait()
            for i in range(k, len(chunks), 2):
                got[i] = cp.predict(chunks[i])

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # the exact path: the host float64 routing's leaves
        if precision == "f32":
            np.testing.assert_array_equal(
                cp.predict_leaf_index(x[:2000]),
                b.predict(x[:2000], pred_leaf=True))
        assert cp.stats["cold_dispatches"] == 0


def _same_bits(x, forest, lv=None, num_class=None):
    """The kernel twice against the plain version: equal bits."""
    if lv is None:
        got = tk.tree_leaf(x, forest)
        again = tk.tree_leaf(x, forest)
        want = tk.tree_leaf_plain(x, forest)
    else:
        got = tk.tree_raw(x, forest, lv, num_class)
        again = tk.tree_raw(x, forest, lv, num_class)
        want = tk.tree_raw_plain(x, forest, lv, num_class)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, want)
    return got


def _all_kernels(x, forest, lv, classes=(1, 3)):
    _same_bits(x, forest)
    lv32 = torch.from_numpy(lv).to(DEV)
    for k in classes:
        for vals in (lv32, lv32.to(torch.bfloat16)):
            _same_bits(x, forest, vals, k)


@pytest.mark.parametrize("n", [1, 31, 33, 4095, 4097])
def test_row_counts_around_the_tiles(n):
    rng = np.random.RandomState(n)
    arrays, lv = _random_forest(rng, 100, 63, 28, single_frac=0.05)
    forest = tk.freeze(*arrays, DEV)
    _all_kernels(torch.from_numpy(_rows(rng, n, 28)).to(DEV), forest, lv)


@pytest.mark.parametrize("n", [1, 4097])
def test_forest_larger_than_shared_memory(n):
    rng = np.random.RandomState(15)
    arrays, lv = _random_forest(rng, 1500, 63, 28, exact=True)
    forest = tk.freeze(*arrays, DEV)
    assert forest.tiles.numel() * 4 > tk.SMEM_OPTIN_SM90     # 1.49 MB
    _all_kernels(torch.from_numpy(_rows(rng, n, 28)).to(DEV), forest, lv)


def test_trees_larger_than_a_block_shared_memory():
    rng = np.random.RandomState(16)
    arrays, lv = _random_forest(rng, 3, 16384, 28, exact=True)
    forest = tk.freeze(*arrays, DEV)
    assert forest.sf.shape[1] * 16 > tk.SMEM_OPTIN_SM90
    assert tk.plan(2000, 28, 3, forest.sf.shape[1]).slots == 0
    for n in (1, 2000):
        _all_kernels(torch.from_numpy(_rows(rng, n, 28)).to(DEV), forest,
                     lv, classes=(1, 2))


@pytest.mark.parametrize("f,n", [(3000, 1), (3000, 4097), (60000, 3)])
def test_rows_too_wide_to_stage(f, n):
    rng = np.random.RandomState(f + n)
    arrays, lv = _random_forest(rng, 120, 63, f)
    forest = tk.freeze(*arrays, DEV)
    if n > 1 or f > 3000:
        assert not tk.plan(n, f, 120, forest.sf.shape[1]).stage_rows
    _all_kernels(torch.from_numpy(_rows(rng, n, f)).to(DEV), forest, lv)


@pytest.mark.parametrize("t_cnt", [16, 1200])
def test_largest_class_count_of_the_first_kernel(t_cnt):
    """The earlier kernel took K up to 10240 - min(T, 1024) (its 40 KB
    of shared memory); this one sums them in one block of few rows."""
    k = 10240 - min(t_cnt, 1024)
    rng = np.random.RandomState(t_cnt)
    arrays, lv = _random_forest(rng, t_cnt, 31, 28)
    forest = tk.freeze(*arrays, DEV)
    x = torch.from_numpy(_rows(rng, 33, 28)).to(DEV)
    lv32 = torch.from_numpy(lv).to(DEV)
    for vals in (lv32, lv32.to(torch.bfloat16)):
        got = _same_bits(x, forest, vals, k)
        assert got.shape == (33, k)


@pytest.mark.parametrize("n", [1, 257])
def test_more_trees_than_a_block_stages_roots_for(n):
    """10,000 trees (313 tiles) summed in one block: each window's roots
    staged in turn."""
    rng = np.random.RandomState(n + 30)
    arrays, lv = _random_forest(rng, 10_000, 15, 28)
    forest = tk.freeze(*arrays, DEV)
    _all_kernels(torch.from_numpy(_rows(rng, n, 28)).to(DEV), forest, lv,
                 classes=(1, 3))


def test_walks_cut_short_by_depth():
    rng = np.random.RandomState(21)
    arrays, lv = _random_forest(rng, 100, 63, 28)
    arrays = arrays[:-1] + (max(1, arrays[-1] - 4),)
    forest = tk.freeze(*arrays, DEV)
    for n in (1, 4096):
        x = torch.from_numpy(_rows(rng, n, 28)).to(DEV)
        leaves = tk.tree_leaf(x, forest)
        if n > 1:
            assert bool((leaves < 0).any())   # some walks were cut short
        _all_kernels(x, forest, lv)


def test_single_leaf_trees():
    rng = np.random.RandomState(22)
    arrays, lv = _random_forest(rng, 64, 63, 28, single_frac=0.5)
    assert (arrays[5] == ~0).sum() > 10
    forest = tk.freeze(*arrays, DEV)
    for n in (1, 1000):
        _all_kernels(torch.from_numpy(_rows(rng, n, 28)).to(DEV), forest, lv)


def test_two_threads_launch_at_once():
    rng = np.random.RandomState(23)
    arrays, lv = _random_forest(rng, 300, 63, 28)
    forest = tk.freeze(*arrays, DEV)
    lv32 = torch.from_numpy(lv).to(DEV)
    xs = [torch.from_numpy(_rows(rng, n, 28)).to(DEV)
          for n in (1, 64, 4096, 777)]
    want = [(tk.tree_leaf_plain(x, forest),
             tk.tree_raw_plain(x, forest, lv32, 3)) for x in xs]
    torch.cuda.synchronize()
    got = {}
    barrier = threading.Barrier(2)

    def worker(k):
        stream = torch.cuda.Stream()
        barrier.wait()
        with torch.cuda.stream(stream):
            for rep in range(20):
                for i, x in enumerate(xs):
                    got[k, rep, i] = (tk.tree_leaf(x, forest),
                                      tk.tree_raw(x, forest, lv32, 3))
        stream.synchronize()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert len(got) == 2 * 20 * len(xs)
    for (k, rep, i), (leaf, raw) in got.items():
        assert torch.equal(leaf, want[i][0]) and torch.equal(raw, want[i][1])


def test_a_refused_launch_raises(monkeypatch):
    rng = np.random.RandomState(24)
    arrays, lv = _random_forest(rng, 100, 15, 8)
    forest = tk.freeze(*arrays, DEV)
    x = torch.from_numpy(_rows(rng, 40, 8)).to(DEV)
    lv32 = torch.from_numpy(lv).to(DEV)
    good = tk.plan(40, 8, 100, forest.sf.shape[1])

    def force(p):   # the wrappers launch `p` instead of plan()'s choice
        arg = p.args(forest.categorical)
        monkeypatch.setattr(tk, "_planned", lambda *a: (p, arg,
                                                        ctypes.addressof(arg)))

    tk.reset_launch_counts()
    force(good._replace(rows=0))
    with pytest.raises(RuntimeError, match="unsupported"):
        tk.tree_leaf(x, forest)
    # a plan needing more shared memory than the card opts in to (the
    # roots of a window of 2000 tiles)
    force(good._replace(group=2000, window=2000, slots=0))
    with pytest.raises(RuntimeError, match="shared memory"):
        tk.tree_leaf(x, forest)
    # a window larger than its group
    force(good._replace(group=1, window=2))
    with pytest.raises(RuntimeError, match="unsupported"):
        tk.tree_leaf(x, forest)
    # tree_raw sums in one block: its plan must take every tile
    force(good._replace(group=1, window=1))
    with pytest.raises(RuntimeError, match="unsupported"):
        tk.tree_raw(x, forest, lv32, 1)
    assert tk.launch_counts() == {"tree_leaf": 0, "tree_raw": 0,
                                  "tree_lin_raw": 0}
