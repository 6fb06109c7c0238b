"""Device stable partition of a leaf-contiguous row layout, and the
stable compaction of a row mask.

Port of lightgbm_tpu/ops/partition.py (split_destinations,
compact_gather_indices, invert_permutation, apply_partition). Reference: DataPartition::Split
(data_partition.hpp:100-140): per-thread left/right buffers merged by
prefix sum keep each leaf's rows contiguous and in stable order. Here
one vectorized pass computes every row's destination with two prefix
sums, and the permutation is applied as one scatter and three gathers.

All rows of the split segment move, out-of-bag and padding rows
included (their statistics are zero, so where they land has no effect);
the tree's counts remain the in-bag histogram counts.

The JAX builder windows these ops to the segment's chunk bucket. The
port runs them over the whole arrays at every split: O(N) work, no host
sync, and the same permutation bit for bit, since rows outside the
segment keep their positions (tests/test_partitioned.py:87-121 proves
the window equals the full-array partition). An O(segment) partition
kernel that reads the bounds on the device is later work (ROADMAP.md).
"""

import torch

from . import hist_kernels


def split_destinations(go_left, begin, cnt):
    """Stable-partition destinations for the segment [begin, begin+cnt).

    Args:
      go_left: (N,) bool in the current position order (only the
        segment's values matter).
      begin, cnt: 0-d int32 tensors (or ints), the segment bounds.

    Returns (dest, n_left): dest (N,) int32 maps position p to its new
    position (identity outside the segment); n_left is the full left
    row count (in-bag + out-of-bag + padding), a 0-d int32 tensor.
    """
    n = go_left.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=go_left.device)
    in_seg = (pos >= begin) & (pos < begin + cnt)
    lm = in_seg & go_left
    rm = in_seg & ~go_left
    # cumsum of a bool is int64 unless asked: keep the JAX int32
    rank_l = torch.cumsum(lm, 0, dtype=torch.int32) - 1
    rank_r = torch.cumsum(rm, 0, dtype=torch.int32) - 1
    n_left = rank_l[-1] + 1
    dest = torch.where(lm, begin + rank_l,
                       torch.where(rm, begin + n_left + rank_r, pos))
    return dest.to(torch.int32), n_left


def compact_gather_indices(mask, size):
    """Stable compaction of a row mask into gather indices (the gather-
    compacted engine's first step, ops/histogram.py compacted_histograms).

    Args:
      mask: (N,) bool row selector.
      size: buffer length; the caller guarantees sum(mask) <= size
        (selected rows past it are dropped).

    Returns (src, cnt): src (size,) int32 with the selected rows'
    positions in original order, padded with the sentinel N; cnt the
    selected count as a (1,) int32 tensor on mask's device. On the CPU
    this is the cumsum rank and a scatter that drops the rest
    (hist_kernels.compact_rows_plain); on the card the compact_rows
    kernel, whose count is never read by the host.
    """
    dev = mask.device
    src = torch.empty(int(size), dtype=torch.int32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    return hist_kernels.compact_rows(mask.to(torch.int32),
                                     torch.ones(1, dtype=torch.int32,
                                                device=dev), src, cnt)


def invert_permutation(dest):
    """src such that new[q] = old[src[q]] given new[dest[p]] = old[p]."""
    n = dest.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=dest.device)
    return torch.zeros(n, dtype=torch.int32,
                       device=dest.device).index_copy_(0, dest.long(), pos)


def apply_partition(src, words, ghc_t, perm):
    """Permute the leaf-ordered arrays by the inverse permutation
    (new tensors; the inputs are left as they were)."""
    idx = src.long()
    return (words.index_select(1, idx), ghc_t.index_select(1, idx),
            perm.index_select(0, idx))
