"""lightgbm_tpu_torch CUDA histogram kernels on the card.

The card tests need a CUDA device and skip without one (`cuda` marker);
the build test runs anywhere (no nvcc needed). They import neither JAX
nor the JAX package, so they also run on a machine that only has
PyTorch:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""

import os
import shutil

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


# widths whose per-warp tag words do not fit in shared memory beside the
# chunk partial, so the kernel finds peers with __match_any_sync: int16
# bins at 16,000 bins, and 8 leaves of 2,000 bins
WIDE = [("masked_hist", [3], 16000, np.int16),
        ("frontier_hist", [0, 1, 2, 3, 4, 5, 6, 7], 2000, np.int16)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,ids,b,dtype", [
    ("masked_hist", [1], 255, np.uint8),
    ("frontier_hist", [0, 2], 255, np.uint8),
    ("masked_hist", [3], 300, np.int16)] + WIDE)
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


SKEWS = ("zero_bin_60pct", "one_bin")


def _skewed_bins(f, n, b, dtype, skew, rng):
    """60% of the rows in bin 0 (a sparse feature's zero bin), or every
    row in one bin (32 lanes of a step on one key)."""
    if skew == "one_bin":
        return np.full((f, n), b - 1, dtype=dtype)
    bins = rng.randint(0, b, size=(f, n)).astype(dtype)
    bins[rng.rand(f, n) < 0.6] = 0
    return bins


def _stats(n, rng):
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    return np.stack([rng.randn(n).astype(np.float32) * inbag,
                     rng.rand(n).astype(np.float32) * inbag, inbag])


@pytest.mark.cuda
@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("name,ids,b,dtype", [
    ("masked_hist", [1], 255, np.uint8),
    ("frontier_hist", [0, 1, 2, 3, 4, 5, 6, 7], 255, np.uint8),
    ("masked_hist", [3], 300, np.int16)] + WIDE)
def test_kernel_skewed_bins_bitwise_on_card(name, ids, b, dtype, skew):
    """Heavy bin collisions (up to all 32 lanes of a step on one cell)
    keep the row-order bits: equal to the plain version on the CPU, and
    two launches agree. Rows come in runs of 64 of one leaf, so a step's
    lanes share their leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (lightgbm_tpu_torch kernels)")
    rng = np.random.RandomState(len(ids) * 1000 + b)
    f, n = 5, 2 * HIST_CHUNK
    bins = _skewed_bins(f, n, b, dtype, skew, rng)
    row_leaf = np.repeat(rng.randint(0, len(ids) + 2, size=n // 64),
                         64).astype(np.int32)
    cpu = _t(bins, _stats(n, rng), row_leaf) + [_ids(ids)]
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
@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("begin,cnt", [
    (0, 3 * HIST_CHUNK), (1001, HIST_CHUNK + 500), (HIST_CHUNK - 6, 100),
    (3 * HIST_CHUNK, 0)])
def test_seg_hist_skewed_bins_bitwise_on_card(begin, cnt, skew):
    """seg_hist on the four segment kinds with heavy bin collisions
    equals its plain version on the CPU bit for bit; two launches
    agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (lightgbm_tpu_torch kernels)")
    rng = np.random.RandomState(begin + 1)
    n, b = 3 * HIST_CHUNK, 255
    words = pack_feature_words(_skewed_bins(28, n, b, np.uint8, skew, rng))
    cpu = _t(words, _stats(n, rng)) + [torch.tensor([begin, cnt],
                                                    dtype=torch.int32)]
    dev = [t.cuda() for t in cpu]
    before = hk.launch_counts()["seg_hist"]
    hi, lo = hk.seg_hist(*dev, b)
    hi2, lo2 = hk.seg_hist(*dev, b)
    assert hk.launch_counts()["seg_hist"] == before + 2
    assert torch.equal(hi, hi2) and torch.equal(lo, lo2)
    ch, cl = hk.seg_hist(*cpu, b)
    assert torch.equal(hi.cpu(), ch) and torch.equal(lo.cpu(), cl)


@pytest.mark.cuda
def test_graph_replay_gives_eager_bits_and_counts_on_card():
    """masked_hist and seg_hist captured in one CUDA graph
    (CapturedGraph, as the fused trainer captures a boosting
    iteration): the capture launches nothing, each replay gives the
    eager launches' bits, and every replay adds the captured launches
    to the counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (lightgbm_tpu_torch kernels)")
    bins, ghc, rl = _inputs(255, np.uint8, 12)
    hist_in = [t.cuda() for t in _t(bins, ghc, rl) + [_ids([1])]]
    rng = np.random.RandomState(13)
    n = 3 * HIST_CHUNK
    words = pack_feature_words(rng.randint(0, 255, size=(28, n))
                               .astype(np.uint8))
    seg_in = [t.cuda() for t in _t(words, _stats(n, rng))
              + [torch.tensor([1001, HIST_CHUNK + 500], dtype=torch.int32)]]
    eager = [hk.masked_hist(*hist_in, 255), hk.seg_hist(*seg_in, 255)]
    torch.cuda.synchronize()
    before = hk.launch_counts()
    graph = hk.CapturedGraph()
    with graph.capture():
        static = [hk.masked_hist(*hist_in, 255), hk.seg_hist(*seg_in, 255)]
    assert graph.launches == {"masked_hist": 1, "seg_hist": 1}
    assert hk.launch_counts() == before
    for replays in (1, 2):
        for pair in static:     # a replay that computes nothing shows
            for t in pair:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for (hi, lo), (want_hi, want_lo) in zip(static, eager):
            assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
        counts = hk.launch_counts()
        for name in ("masked_hist", "seg_hist"):
            assert counts[name] == before[name] + replays
        assert counts["frontier_hist"] == before["frontier_hist"]


def test_library_path_follows_included_headers(tmp_path):
    """A library is named by its source AND the headers it includes: a
    changed chunk_hist.cuh gives every source that includes it a new
    library and leaves the one that does not (bin.cu) alone, a header
    no source includes changes none, and a changed source only its
    own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(hk._CSRC, csrc, ignore=shutil.ignore_patterns("build"))

    def paths():
        return {s: hk._library_path(s, str(csrc)) for s in hk.SOURCES}

    before = paths()
    assert before == {s: hk._library_path(s) for s in hk.SOURCES}
    with open(csrc / "chunk_hist.cuh", "ab") as f:
        f.write(b"// changed\n")
    after = paths()
    assert all(after[s] != before[s] for s in ("hist.cu", "seg_hist.cu"))
    assert after["bin.cu"] == before["bin.cu"]
    (csrc / "unused.cuh").write_bytes(b"// included by no source\n")
    assert paths() == after
    with open(csrc / "seg_hist.cu", "ab") as f:
        f.write(b"// changed\n")
    last = paths()
    assert last["hist.cu"] == after["hist.cu"]
    assert last["seg_hist.cu"] != after["seg_hist.cu"]
    assert all(os.path.dirname(p) == hk.BUILD_DIR for p in last.values())
