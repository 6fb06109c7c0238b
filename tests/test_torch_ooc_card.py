"""lightgbm_tpu_torch's out-of-core path and resume on the card.

- CUDA hist_pair_fold (csrc/hist.cu) equals its plain version run on
  the CPU bit for bit (the kernel sums each chunk in row order, as the
  CPU's index_add_ does), carry included, at uint8 / 255 bins and
  int16 / 1,023 bins, for a leaf of 1%, 50% and 100% of the rows; two
  launches agree;
- the blocks of a pass folded on the card and collapsed equal CUDA
  masked_hist over the whole array bit for bit;
- the prefetcher at depth 1 and 3 behind a reader slowed by a sleep
  gives the in-RAM masked run's model text (the ring's events keep a
  buffer from being refilled while a fold reads it);
- a fused run crashed and resumed on the card writes the uninterrupted
  run's model text: the restored score is copied into the tensor the
  captured graph updates.

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_ooc_card.py -m cuda --noconftest
"""

import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import callback
from lightgbm_tpu_torch.data.block_store import BlockStore
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.utils import faults

CHUNK = hk.HIST_CHUNK
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "verbose": -1, "hist_compaction": "false", "device_row_chunk": CHUNK}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (lightgbm_tpu_torch kernels)")
    faults.clear_faults()
    yield
    faults.clear_faults()


def _inputs(b, dtype, share, seed, n=3 * CHUNK, f=6):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, b, size=(f, n)).astype(dtype)
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = np.stack([rng.randn(n).astype(np.float32) * inbag,
                    rng.rand(n).astype(np.float32) * inbag, inbag])
    row_leaf = np.where(rng.rand(n) < share, 5,
                        rng.randint(0, 5, size=n)).astype(np.int32)
    return [torch.from_numpy(a) for a in (bins, ghc, row_leaf)]


@pytest.mark.parametrize("share", [0.01, 0.5, 1.0])
@pytest.mark.parametrize("b,dtype", [(255, np.uint8), (1023, np.int16)],
                         ids=["uint8-255", "int16-1023"])
def test_kernel_equals_plain_version(b, dtype, share):
    bins, ghc, rl = _inputs(b, dtype, share, 1)
    lid = torch.tensor([5], dtype=torch.int32)
    f = bins.shape[0]
    # a carry from an earlier block: the kernel must continue it
    rng = np.random.RandomState(2)
    acc0 = torch.from_numpy(rng.randn(f, b, 3).astype(np.float32))
    comp0 = torch.from_numpy((rng.randn(f, b, 3) * 1e-7).astype(np.float32))
    want = hk.hist_pair_fold_plain(acc0.clone(), comp0.clone(), bins, ghc,
                                   rl, lid, b)
    dev = torch.device("cuda")
    outs = []
    for _ in range(2):
        acc, comp = acc0.to(dev), comp0.to(dev)
        before = hk.KERNELS["hist_pair_fold"].launches
        got = hk.hist_pair_fold(acc, comp, bins.to(dev), ghc.to(dev),
                                rl.to(dev), lid.to(dev), b)
        assert got[0] is acc and got[1] is comp          # in place
        assert hk.KERNELS["hist_pair_fold"].launches == before + 1
        outs.append([t.cpu() for t in got])
    for g, w in zip(outs[0], want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    for g, h in zip(*outs):
        assert torch.equal(g.view(torch.int32), h.view(torch.int32))


def test_block_fold_equals_masked_hist_on_the_card():
    dev = torch.device("cuda")
    bins, ghc, rl = (t.to(dev) for t in _inputs(255, np.uint8, 0.3, 3,
                                                n=5 * CHUNK))
    lid = torch.tensor([5], dtype=torch.int32, device=dev)
    hi, lo = hk.masked_hist(bins, ghc, rl, lid, 255)
    want = hi + lo
    for bounds in ([0, 5 * CHUNK], [0, 2 * CHUNK, 5 * CHUNK],
                   [0, CHUNK, 2 * CHUNK, 4 * CHUNK, 5 * CHUNK]):
        acc = torch.zeros_like(want)
        comp = torch.zeros_like(want)
        for s, e in zip(bounds[:-1], bounds[1:]):
            hk.hist_pair_fold(acc, comp, bins[:, s:e].contiguous(),
                              ghc[:, s:e].contiguous(), rl[s:e], lid, 255)
        got = hk.hist_pair_collapse(acc, comp)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _data(n=6 * CHUNK + 123, f=8, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    y = (x[:, 0] + 0.6 * x[:, 1] * x[:, 2] + 0.8 * rng.randn(n) > 0)
    return x, y.astype(np.float64)


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_depth_with_a_slow_reader(monkeypatch, depth):
    x, y = _data()
    ref = lgt.train(BASE, lgt.Dataset(x, y), 3, verbose_eval=False)
    read = BlockStore.read_block_into

    def slow(self, i, out):
        time.sleep(0.002)
        return read(self, i, out)

    monkeypatch.setattr(BlockStore, "read_block_into", slow)
    p = dict(BASE, out_of_core=True, block_rows=CHUNK, prefetch_depth=depth)
    got = lgt.train(p, lgt.Dataset(x, y, params=p), 3, verbose_eval=False)
    learner = got.gbdt.tree_learner
    assert learner.train_set.block_store.num_blocks == 7
    assert learner.stats()["prefetch_blocks"] > 0
    assert got.gbdt.save_model_to_string(-1) == \
        ref.gbdt.save_model_to_string(-1)


def test_fused_resume_on_the_card(tmp_path):
    x, y = _data()
    p = dict(BASE, bagging_fraction=0.7, bagging_freq=2,
             feature_fraction=0.7)
    ref = lgt.train(p, lgt.Dataset(x, y), 10, verbose_eval=False)
    d = str(tmp_path / "ck")
    with faults.injected_faults(crash_at_iteration=6):
        with pytest.raises(faults.InjectedFault):
            lgt.train(p, lgt.Dataset(x, y), 10, verbose_eval=False,
                      callbacks=[callback.checkpoint(d, period=4)])
    got = lgt.train(p, lgt.Dataset(x, y), 10, verbose_eval=False,
                    callbacks=[callback.checkpoint(d, period=4)],
                    resume_from=d)
    runners = list(got.gbdt._fused_cache.values())
    assert runners and runners[0].graph is not None
    assert runners[0].score is got.gbdt.train_score_updater.score
    assert got.gbdt.save_model_to_string(-1) == \
        ref.gbdt.save_model_to_string(-1)
