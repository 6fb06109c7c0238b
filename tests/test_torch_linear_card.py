"""tree_lin_raw (csrc/traverse.cu) on the card against its plain version.

Random forests with random linear leaves (0 to 8 live coefficient slots
on random columns) through tree_lin_raw and tree_lin_raw_plain on the
same CUDA tensors: float32 and bfloat16 storage, raw sums and the
transformed variant (sigmoid with one class, softmax with three), equal
in bits (the plain version adds the slots and the trees in the kernel's
order, each product rounded before its add, and transforms with the
kernel's f32 operations), each stable across launches, at the shapes
that take the kernel's other plans: one row, rows too wide to stage,
forests larger than shared memory. A CUDA tensor never takes the plain
route, and a CompiledPredictor serving a linear model trained on the
card answers its exact path with the host's bits.

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_linear_card.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import traverse_kernels as tk
from lightgbm_tpu_torch.serving import CompiledPredictor
from test_torch_serving_card import _random_forest, _rows

DEV = "cuda"

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _linear_leaves(rng, lv, f):
    """Random linear blocks for every (tree, leaf) of `lv` (T, L): a
    third of the leaves constant, the rest 1..8 live slots."""
    t, l = lv.shape
    cnt = rng.randint(0, tk.COEF_PAD + 1, size=(t, l)).astype(np.int32)
    cnt[rng.rand(t, l) < 0.3] = 0
    feat = rng.randint(0, f, size=(t, l, tk.COEF_PAD)).astype(np.int32)
    coef = (rng.randn(t, l, tk.COEF_PAD) * 0.1).astype(np.float64)
    const = (rng.randn(t, l) * 0.3).astype(np.float64)
    return const, coef, feat, cnt


def _bits(t):
    return t.contiguous().view(torch.int32)


def _case(seed, t_cnt, max_leaves, f, n, num_class):
    rng = np.random.RandomState(seed)
    arrays, lv = _random_forest(rng, t_cnt, max_leaves, f)
    forest = tk.freeze(*arrays, DEV)
    x = _rows(rng, n, f)
    nan = rng.rand(n, f) < 0.02
    x[nan] = np.nan
    return forest, torch.from_numpy(x).to(DEV), lv, _linear_leaves(rng, lv, f)


@pytest.mark.parametrize("num_class,t_cnt,max_leaves,f,n", [
    (1, 112, 63, 28, 4096), (1, 100, 63, 28, 1), (3, 96, 31, 28, 257),
    (3, 1500, 16, 28, 300), (1, 40, 15, 3000, 64)],
    ids=["bucket", "one-row", "3-class", "larger-than-smem", "wide-rows"])
def test_kernel_bit_equal_to_plain(num_class, t_cnt, max_leaves, f, n):
    forest, x, lv, blocks = _case(t_cnt + n, t_cnt, max_leaves, f, n,
                                  num_class)
    for dtype in (torch.float32, torch.bfloat16):
        lin = tk.freeze_linear(*blocks, dtype, DEV)
        vals = torch.from_numpy(lv).to(dtype).to(DEV)
        for transform in (False, True):
            tk.reset_launch_counts()
            got = tk.tree_lin_raw(x, forest, vals, lin, num_class, transform,
                                  1.0)
            again = tk.tree_lin_raw(x, forest, vals, lin, num_class,
                                    transform, 1.0)
            torch.cuda.synchronize()
            assert tk.launch_counts()["tree_lin_raw"] == 2
            want = tk.tree_lin_raw_plain(x, forest, vals, lin, num_class,
                                         transform, 1.0)
            assert got.shape == (n, num_class) and got.dtype == torch.float32
            assert torch.equal(_bits(got), _bits(want)), (dtype, transform)
            assert torch.equal(_bits(got), _bits(again))


def test_constant_blocks_give_tree_raw():
    """With every leaf constant the value stage is tree_raw's."""
    forest, x, lv, (const, coef, feat, cnt) = _case(5, 96, 63, 28, 1024, 3)
    lin = tk.freeze_linear(const, coef, feat, np.zeros_like(cnt),
                           torch.float32, DEV)
    vals = torch.from_numpy(lv).to(DEV)
    assert torch.equal(tk.tree_lin_raw(x, forest, vals, lin, 3),
                       tk.tree_raw(x, forest, vals, 3))


def test_cuda_tensor_never_takes_the_plain_route(monkeypatch):
    forest, x, lv, blocks = _case(9, 40, 15, 28, 64, 1)
    lin = tk.freeze_linear(*blocks, torch.float32, DEV)

    def boom(*a, **k):
        raise AssertionError("plain route on a CUDA tensor")
    monkeypatch.setattr(tk, "tree_lin_raw_plain", boom)
    out = tk.tree_lin_raw(x, forest, torch.from_numpy(lv).to(DEV), lin, 1)
    torch.cuda.synchronize()
    assert out.shape == (64, 1)


def test_predictor_serves_a_model_trained_on_the_card():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3000, 10))
    y = (x[:, 0] * 1.5 - x[:, 1] * 0.8 + 0.3 * x[:, 2] * x[:, 3]
         + 0.3 * rng.standard_normal(3000) > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
              "verbose": -1, "linear_tree": True, "device_row_chunk": 256}
    b = lgt.train(params, lgt.Dataset(x, y, params=params), 6,
                  verbose_eval=False, device=DEV)
    assert any(t.is_linear for t in b.gbdt.models)
    xs = x[:500].astype(np.float32)
    xs[:40, 0] = np.nan
    host = b.gbdt.predict_raw(xs.astype(np.float64))
    p = CompiledPredictor.from_booster(b, max_batch_rows=256, device=DEV)
    assert np.array_equal(p.predict_raw(xs), host)
    tk.reset_launch_counts()
    dev_raw = p.predict_raw_device(xs)
    assert tk.launch_counts()["tree_lin_raw"] == 2      # 256 + 244 rows
    assert np.abs(dev_raw - host).max() < 1e-4
    p16 = CompiledPredictor.from_booster(b, max_batch_rows=256, device=DEV,
                                         serving_precision="bf16")
    assert np.abs(p16.predict_raw(xs) - host).max() <= p16.accuracy_bound
