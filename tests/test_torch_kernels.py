"""lightgbm_tpu_torch CUDA histogram kernels on the card.

These tests need a CUDA device and skip without one (`cuda` marker).
They import neither JAX nor the JAX package, so they also run on a
machine that only has PyTorch:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops.ordered_hist import pack_feature_words

HIST_CHUNK = hk.HIST_CHUNK


def _inputs(b, dtype, seed):
    rng = np.random.RandomState(seed)
    f, n = 5, 2 * HIST_CHUNK
    bins = rng.randint(0, b, size=(f, n)).astype(dtype)
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = np.stack([rng.randn(n).astype(np.float32) * inbag,
                    rng.rand(n).astype(np.float32) * inbag, inbag])
    row_leaf = rng.randint(0, 4, size=n).astype(np.int32)
    return bins, ghc, row_leaf


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ids(ids):
    return torch.tensor(ids, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("name,ids,b,dtype", [
    ("masked_hist", [1], 255, np.uint8),
    ("frontier_hist", [0, 2], 255, np.uint8),
    ("masked_hist", [3], 300, np.int16)])
def test_kernel_bitwise_equals_cpu_plain_on_card(name, ids, b, dtype):
    """On the card: the CUDA kernel adds in row order within a chunk, so
    it equals the plain version run on the CPU bit for bit, and two
    launches agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (lightgbm_tpu_torch kernels)")
    bins, ghc, rl = _inputs(b, dtype, 10)
    cpu = _t(bins, ghc, rl) + [_ids(ids)]
    dev = [t.cuda() for t in cpu]
    fn = getattr(hk, name)
    before = hk.launch_counts()[name]
    hi, lo = fn(*dev, b)
    hi2, lo2 = fn(*dev, b)
    assert hk.launch_counts()[name] == before + 2
    assert torch.equal(hi, hi2) and torch.equal(lo, lo2)
    ch, cl = fn(*cpu, b)
    assert torch.equal(hi.cpu(), ch) and torch.equal(lo.cpu(), cl)


@pytest.mark.cuda
@pytest.mark.parametrize("begin,cnt", [
    (0, 3 * HIST_CHUNK),              # the whole array (a root)
    (1001, HIST_CHUNK + 500),         # crosses a chunk edge
    (HIST_CHUNK - 6, 100),            # short, across a chunk edge
    (3 * HIST_CHUNK, 0)])             # empty, at the array's end
def test_seg_hist_bitwise_equals_cpu_plain_on_card(begin, cnt):
    """seg_hist on the card equals its plain version on the CPU bit for
    bit, two launches agree, and each call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (lightgbm_tpu_torch kernels)")
    rng = np.random.RandomState(begin)
    n, b = 3 * HIST_CHUNK, 255
    bins = rng.randint(0, b, size=(28, n)).astype(np.uint8)
    words = pack_feature_words(bins)
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = np.stack([rng.randn(n).astype(np.float32) * inbag,
                    rng.rand(n).astype(np.float32) * inbag, inbag])
    cpu = _t(words, ghc) + [torch.tensor([begin, cnt], dtype=torch.int32)]
    dev = [t.cuda() for t in cpu]
    before = hk.launch_counts()["seg_hist"]
    hi, lo = hk.seg_hist(*dev, b)
    hi2, lo2 = hk.seg_hist(*dev, b)
    assert hk.launch_counts()["seg_hist"] == before + 2
    assert torch.equal(hi, hi2) and torch.equal(lo, lo2)
    ch, cl = hk.seg_hist(*cpu, b)
    assert torch.equal(hi.cpu(), ch) and torch.equal(lo.cpu(), cl)
