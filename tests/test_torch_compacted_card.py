"""lightgbm_tpu_torch's gather-compacted engine on the card: CUDA
compact_rows (csrc/compact.cu) and compacted_hist (csrc/compact_hist.cu).

- compact_rows equals its plain version run on the CPU element for
  element (positions in order, the sentinel past the count, the count),
  for counts of 0, 1, 4095, 4096, 4097 and N; two launches agree.
- compacted_hist equals its plain version on the CPU bit for bit (the
  kernel sums each chunk of the compacted rows in row order, as the
  CPU's index_add_ does), uint8 at 255 bins and int16 at 300, at the
  same counts; two launches agree.
- A CUDA graph captured around both (CapturedGraph) replays the eager
  bits and counts its launches; a fused run (the boosting iteration
  replayed as a graph) writes the per-iteration model text byte for
  byte, with both kernels' launches counted through the replays and no
  host sync in a tree build.

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_compacted_card.py -m cuda --noconftest
"""

import warnings

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models.tree_learner import build_tree_device
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops.partition import compact_gather_indices

CHUNK = hk.HIST_CHUNK
N = 4 * CHUNK
COUNTS = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, N]
BASE = {"num_leaves": 15, "min_data_in_leaf": 20, "verbose": -1,
        "partitioned_build": "false", "hist_compaction": "true",
        "device_row_chunk": CHUNK}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (lightgbm_tpu_torch kernels)")


def _row_leaf(cnt, seed, n=N, leaf=3):
    """`cnt` rows of leaf `leaf` at random positions, the rest over
    leaves 0-2."""
    rng = np.random.RandomState(seed)
    row_leaf = rng.randint(0, 3, size=n).astype(np.int32)
    row_leaf[rng.choice(n, cnt, replace=False)] = leaf
    return torch.from_numpy(row_leaf)


def _compact(row_leaf, leaf=3, size=None):
    dev = row_leaf.device
    src = torch.empty(size or row_leaf.shape[0], dtype=torch.int32,
                      device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    return hk.compact_rows(row_leaf, torch.tensor([leaf], dtype=torch.int32,
                                                  device=dev), src, cnt)


@pytest.mark.parametrize("cnt", COUNTS)
def test_compact_rows_equals_cpu_plain_on_card(cnt):
    row_leaf = _row_leaf(cnt, cnt)
    before = hk.launch_counts()["compact_rows"]
    src, count = _compact(row_leaf.cuda())
    src2, count2 = _compact(row_leaf.cuda())
    assert hk.launch_counts()["compact_rows"] == before + 2
    want_src, want_cnt = _compact(row_leaf)
    assert torch.equal(src.cpu(), want_src) and torch.equal(src2, src)
    assert int(count[0]) == int(want_cnt[0]) == cnt
    assert torch.equal(count2, count)


def test_compact_rows_large_and_short_buffer_on_card():
    """1M rows (256 tiles, the scan over many tiles) and a buffer
    shorter than N (rows past it dropped, sentinel to its end)."""
    n = 1 << 20
    row_leaf = _row_leaf(300_001, 7, n=n)
    src, count = _compact(row_leaf.cuda())
    want_src, want_cnt = _compact(row_leaf)
    assert torch.equal(src.cpu(), want_src)
    assert int(count[0]) == int(want_cnt[0])
    short = _row_leaf(1000, 8)
    src, count = _compact(short.cuda(), size=2 * CHUNK)
    want_src, _ = _compact(short, size=2 * CHUNK)
    assert torch.equal(src.cpu(), want_src) and int(count[0]) == 1000


def test_compact_gather_indices_on_card_equals_cpu():
    mask = torch.from_numpy(np.random.RandomState(4).rand(N) < 0.3)
    src, cnt = compact_gather_indices(mask.cuda(), N)
    want_src, want_cnt = compact_gather_indices(mask, N)
    assert torch.equal(src.cpu(), want_src) and torch.equal(cnt.cpu(),
                                                            want_cnt)


def _hist_inputs(b, dtype, seed, f=5, n=N):
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, b, size=(f, n)).astype(dtype))
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = torch.from_numpy(np.stack([rng.randn(n).astype(np.float32) * inbag,
                                     rng.rand(n).astype(np.float32) * inbag,
                                     inbag]))
    return bins, ghc


@pytest.mark.parametrize("b,dtype", [(255, np.uint8), (300, np.int16)],
                         ids=["uint8", "int16"])
@pytest.mark.parametrize("cnt", COUNTS)
def test_compacted_hist_bitwise_equals_cpu_plain_on_card(cnt, b, dtype):
    bins, ghc = _hist_inputs(b, dtype, cnt + b)
    src, count = _compact(_row_leaf(cnt, cnt + 1))
    cpu = (bins, ghc, src, count)
    dev = [t.cuda() for t in cpu]
    before = hk.launch_counts()["compacted_hist"]
    hi, lo = hk.compacted_hist(*dev, b)
    hi2, lo2 = hk.compacted_hist(*dev, b)
    assert hk.launch_counts()["compacted_hist"] == before + 2
    assert torch.equal(hi, hi2) and torch.equal(lo, lo2)
    ch, cl = hk.compacted_hist(*cpu, b)
    assert torch.equal(hi.cpu(), ch) and torch.equal(lo.cpu(), cl)


def test_graph_replay_gives_eager_bits_and_counts_on_card():
    """compact_rows then compacted_hist captured in one CUDA graph: the
    count never leaves the card, each replay gives the eager bits and
    adds both launches; a new leaf id written into the graph's input
    is compacted on the next replay."""
    bins, ghc = _hist_inputs(255, np.uint8, 21)
    row_leaf = _row_leaf(CHUNK + 7, 22).cuda()
    bins, ghc = bins.cuda(), ghc.cuda()
    leaf = torch.tensor([3], dtype=torch.int32, device="cuda")
    src = torch.empty(N, dtype=torch.int32, device="cuda")
    cnt = torch.empty(1, dtype=torch.int32, device="cuda")

    def step():
        hk.compact_rows(row_leaf, leaf, src, cnt)
        return hk.compacted_hist(bins, ghc, src, cnt, 255)

    eager = [t.clone() for t in step()]
    leaf.fill_(1)
    eager1 = [t.clone() for t in step()]
    leaf.fill_(3)
    torch.cuda.synchronize()
    graph = hk.CapturedGraph()
    with graph.capture():
        static = step()
    assert graph.launches == {"compact_rows": 1, "compacted_hist": 1}
    before = hk.launch_counts()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(static, eager))
    leaf.fill_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(static, eager1))
    after = hk.launch_counts()
    for name in ("compact_rows", "compacted_hist"):
        assert after[name] == before[name] + 2


def _data(seed=9, n=20000, f=8):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    y = (x[:, 0] + x[:, 1] + 0.3 * rng.randn(n) > 1.0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("extra", [
    {}, {"hist_compaction": "auto", "bagging_fraction": 0.7,
         "bagging_freq": 2, "feature_fraction": 0.75},
    {"histogram_pool_size": 0.001, "hist_frontier": "false"},
    {"objective": "multiclass", "num_class": 3}],
    ids=["compact", "auto-bag0.7-ff0.75", "cacheless-no-frontier",
         "multiclass"])
def test_captured_replay_gives_the_uncaptured_trees_on_card(extra):
    x, y = _data()
    if extra.get("objective") == "multiclass":
        y = (np.floor(x[:, 2] * 3) % 3).astype(np.float32)
    params = dict(BASE, objective="binary")
    params.update(extra)
    hk.reset_launch_counts()
    fused = lgt.train(params, lgt.Dataset(x, y), 4, verbose_eval=False)
    counts = hk.launch_counts()
    loop = lgt.train(params, lgt.Dataset(x, y), 4, verbose_eval=False,
                     callbacks=[lambda env: None])
    (runner,) = fused.gbdt._fused_cache.values()
    assert fused.gbdt.tree_learner.use_compact
    per_replay = runner.graph.launches
    assert per_replay["compact_rows"] >= 1
    assert per_replay["compacted_hist"] == per_replay["compact_rows"]
    # the root is a masked pass (one a tree) only with hist_frontier=false
    trees = params.get("num_class", 1)
    assert per_replay.get("masked_hist", 0) == (
        trees if params.get("hist_frontier") == "false" else 0)
    for name, c in per_replay.items():
        assert counts[name] == 5 * c          # the warm-up step + 4 replays
    assert fused.model_to_string() == loop.model_to_string()


def test_compacted_tree_build_never_syncs_on_card():
    x, y = _data(seed=10)
    booster = lgt.Booster(dict(BASE, objective="binary"), lgt.Dataset(x, y))
    learner = booster.gbdt.tree_learner
    n = learner.num_data
    g = torch.randn(n, device="cuda")
    args = (learner.bins, learner._pad(g), learner._pad(torch.ones_like(g)),
            learner._pad(torch.ones_like(g)),
            torch.ones(learner.f_pad, dtype=torch.bool, device="cuda"),
            learner.num_bin_pf, learner.is_cat)
    kwargs = {"num_leaves": 15, "max_bin": learner.max_bin,
              "params": learner.params, "max_depth": -1, "cache_hists": True,
              "compact_hist": True, "compacted_fn": learner.compacted_fn}
    build_tree_device(*args, **kwargs)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("error")
        try:
            build_tree_device(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
