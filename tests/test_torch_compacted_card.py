"""lightgbm_tpu_torch's gather-compacted engine on the card: CUDA
compact_rows (csrc/compact.cu) and compacted_hist (csrc/compact_hist.cu).

- compact_rows equals its plain version run on the CPU element for
  element (positions in order, the sentinel past the count, the count),
  for counts of 0, 1, 4095, 4096, 4097 and N; two launches agree.
- compacted_hist equals its plain version on the CPU bit for bit (the
  kernel sums each chunk of the compacted rows in row order, as the
  CPU's index_add_ does), uint8 at 255 bins and int16 at 300, at the
  same counts; two launches agree.
- compacted_hist's sorted route (one launch: rows sorted by bin, the
  fold in the same launch) is bitwise the CPU plain version on a skewed
  feature (90% of a 10% leaf's rows in bin 0) and on a leaf whose rows
  all share one bin; the accumulator route (wide int16 bins) too.
- A CUDA graph captured around both (CapturedGraph) replays the eager
  bits and counts its launches; with one caller's scratch, three
  replays at three counts with an eager call between them each give
  the CPU plain version's bits (the fold counters and look-back flags
  are left valid by every call); two learners whose builds interleave
  give the models each gives alone; a fused run (the boosting iteration
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


def _bitwise_on_card(bins, ghc, src, count, b, scratch=None):
    """compacted_hist on the card (twice) against the CPU plain version
    on the same CPU inputs: equal in bits, both launches equal."""
    dev = [t.cuda() for t in (bins, ghc, src, count)]
    kw = {} if scratch is None else scratch.hist_kwargs()
    hi, lo = hk.compacted_hist(*dev, b, **kw)
    hi2, lo2 = hk.compacted_hist(*dev, b, **kw)
    ch, cl = hk.compacted_hist_plain(bins, ghc, src, count, b)
    assert torch.equal(hi, hi2) and torch.equal(lo, lo2)
    assert torch.equal(hi.cpu(), ch) and torch.equal(lo.cpu(), cl)


def test_compacted_hist_skewed_feature_bitwise_on_card():
    """A 10% leaf whose feature 2 has 90% of its rows in bin 0, as a
    sparse column gives: one bin's run is most of each chunk."""
    n = 16 * CHUNK
    bins, ghc = _hist_inputs(255, np.uint8, 31, n=n)
    src, count = _compact(_row_leaf(n // 10, 32, n=n))
    rows = src[:int(count[0])].long()
    zero = torch.from_numpy(np.random.RandomState(33).rand(rows.numel())
                            < 0.9)
    bins[2, rows[zero]] = 0
    assert hk.compacted_hist_route(255) == "sorted"
    _bitwise_on_card(bins, ghc, src, count, 255)


@pytest.mark.parametrize("chunks", [10, 12, 14, 17, 22, 33, 70])
def test_compacted_hist_every_job_plan_bitwise_on_card(chunks):
    """28 features over 80 chunks, leaves of 10-70 covered chunks: the
    sorted route's plan (gather pieces a chunk, features a sum job)
    follows the count, and every plan gives the CPU plain version's
    bits (pieces that do not divide a chunk evenly included)."""
    n = 80 * CHUNK
    bins, ghc = _hist_inputs(255, np.uint8, 50 + chunks, f=28, n=n)
    src, count = _compact(_row_leaf((chunks - 1) * CHUNK + 333, 51, n=n))
    _bitwise_on_card(bins, ghc, src, count, 255)


@pytest.mark.parametrize("b,dtype", [(255, np.uint8), (300, np.int16)],
                         ids=["uint8", "int16"])
def test_compacted_hist_leaf_in_one_bin_bitwise_on_card(b, dtype):
    """Every row of the leaf in one bin of every feature (a chunk's
    whole 4096 rows one serial run), bins of other rows random."""
    bins, ghc = _hist_inputs(b, dtype, 34)
    src, count = _compact(_row_leaf(CHUNK + 900, 35))
    rows = src[:int(count[0])].long()
    bins[:, rows] = torch.tensor([[b - 1], [0], [7], [b // 2], [1]],
                                 dtype=bins.dtype)
    _bitwise_on_card(bins, ghc, src, count, b)


@pytest.mark.parametrize("cnt", [0, CHUNK + 1, N])
def test_compacted_hist_wide_bins_take_the_accumulator_route_on_card(cnt):
    """int16 bins past COMPACT_SORT_MAX_BINS take the accumulator route
    (chosen by shape): the same function, the same bits."""
    b = hk.COMPACT_SORT_MAX_BINS + 952
    assert hk.compacted_hist_route(b) == "accumulator"
    assert hk._library("compact_hist.cu").compacted_hist_route(b) == 1
    assert hk._library("compact_hist.cu").compacted_hist_route(255) == 0
    bins, ghc = _hist_inputs(b, np.int16, 36 + cnt)
    src, count = _compact(_row_leaf(cnt, 37 + cnt))
    _bitwise_on_card(bins, ghc, src, count, b)


def test_replays_at_three_counts_and_an_eager_call_on_card():
    """One caller's scratch (CompactScratch) behind a captured
    compact_rows + compacted_hist: three replays at three leaf sizes,
    with an eager call on the same scratch between them, each bitwise
    the CPU plain version; so the fold counters and the look-back flags
    are valid after every call, with no memset in the graph."""
    n = 8 * CHUNK
    bins, ghc = _hist_inputs(255, np.uint8, 40, n=n)
    rng = np.random.RandomState(41)
    row_leaf = rng.randint(0, 3, size=n).astype(np.int32)
    for leaf, cnt in ((3, 5), (4, CHUNK + 17), (5, 5 * CHUNK)):
        row_leaf[rng.choice(np.flatnonzero(row_leaf < 3), cnt,
                            replace=False)] = leaf
    row_leaf = torch.from_numpy(row_leaf)
    d_bins, d_ghc, d_rl = bins.cuda(), ghc.cuda(), row_leaf.cuda()
    scratch = hk.CompactScratch(d_bins, 255)
    leaf = torch.tensor([3], dtype=torch.int32, device="cuda")
    src = torch.empty(n, dtype=torch.int32, device="cuda")
    cnt = torch.empty(1, dtype=torch.int32, device="cuda")

    def step(lid=leaf):
        hk.compact_rows(d_rl, lid, src, cnt, flags=scratch.flags)
        return hk.compacted_hist(d_bins, d_ghc, src, cnt, 255,
                                 **scratch.hist_kwargs())

    def want(lid):
        s, c = _compact(row_leaf, leaf=lid)
        return s, c, hk.compacted_hist_plain(bins, ghc, s, c, 255)

    step()
    torch.cuda.synchronize()
    graph = hk.CapturedGraph()
    with graph.capture():
        static = step()
    for k, lid in enumerate((3, 4, 5)):
        leaf.fill_(lid)
        graph.replay()
        torch.cuda.synchronize()
        ws, wc, (wh, wl) = want(lid)
        assert torch.equal(src.cpu(), ws) and torch.equal(cnt.cpu(), wc)
        assert torch.equal(static[0].cpu(), wh)
        assert torch.equal(static[1].cpu(), wl)
        other = (4, 5, 3)[k]
        hi, lo = step(torch.tensor([other], dtype=torch.int32,
                                   device="cuda"))
        _, _, (oh, ol) = want(other)
        assert torch.equal(hi.cpu(), oh) and torch.equal(lo.cpu(), ol)
    torch.cuda.synchronize()
    assert int(scratch.words.abs().sum()) == 0


def test_two_learners_interleaved_give_their_own_models_on_card():
    """Two Boosters on one card, their trees built in turns (each with
    its own compaction scratch), give the model texts each gives
    trained alone."""
    data = [_data(seed=s) for s in (11, 12)]
    params = dict(BASE, objective="binary")
    alone = []
    for x, y in data:
        booster = lgt.Booster(params, lgt.Dataset(x, y))
        for _ in range(3):
            booster.update()
        alone.append(booster.model_to_string())
    boosters = [lgt.Booster(params, lgt.Dataset(x, y)) for x, y in data]
    scratch = [b.gbdt.tree_learner.compacted_fn.keywords["scratch"]
               for b in boosters]
    assert scratch[0].words.data_ptr() != scratch[1].words.data_ptr()
    for _ in range(3):
        for b in boosters:
            b.update()
    assert [b.model_to_string() for b in boosters] == alone


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
