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

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_serving_card.py -m cuda --noconftest
"""

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


def _random_forest(rng, t_cnt, max_leaves, f, cat_frac=0.3, num_cat=5):
    """Random valid trees grown by random leaf splits."""
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
    assert tk.launch_counts() == {"tree_leaf": 1, "tree_raw": 1}
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
