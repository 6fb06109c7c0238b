"""Partitioned (leaf-contiguous) tree builder: histogram cost follows
leaf size, not dataset size.

Port of lightgbm_tpu/models/partitioned.py (_partition_segment :56,
build_tree_partitioned :110). Reference: DataPartition
(data_partition.hpp:17-201, contiguous per-leaf row indices) and the
ordered gathers of SerialTreeLearner::BeforeFindBestSplit
(serial_tree_learner.cpp:236-337).

- Rows live in packed words (four features per int32,
  ops/ordered_hist.py); leaf j is the position range
  [seg[j, 0], seg[j, 0] + seg[j, 1]).
- A split stable-partitions its segment with one prefix-sum pass, a
  scatter and gathers (ops/partition.py), and writes `pos_leaf`, the
  leaf of every position.
- The smaller child's histogram reads only the chunks covering its
  segment (the seg_hist kernel); the larger child is parent - smaller,
  as in the masked builder. Cache-less, both children come from two
  segment calls.

Semantics (split scans, gains, tie-breaks, depth guard, subtraction,
leaf-wise order) are the masked builder's; only the summation order
inside a histogram differs, so float32 round-off can differ in the last
ulps. The split bookkeeping is the masked builder's own (LeafState in
models/tree_learner.py).

As in the masked builder the loop is eager PyTorch and never waits for
the device inside a tree: every split's writes are gated by the device
bool `do`, and the segment bounds are an (L, 2) int32 device tensor
that reaches the kernel as a device tensor. The partition runs over
the whole arrays (ops/partition.py says why); when `do` is false its
segment is empty, so the permutation is the identity.

On a bundled dataset (io/bundling.py) the words pack the slot matrix:
histograms build and cache in slot space, `expand_fn` turns them into
virtual ones in front of the split scan and `decode_fn` reads a split
feature out of its slot (the JAX learner's _bundle_partitioned_kwargs,
tree_learner.py:746-760).
"""

import torch

from ..ops.ordered_hist import segment_histograms, unpack_feature
from ..ops.partition import (apply_partition, invert_permutation,
                             split_destinations)
from ..ops.split import SplitParams, find_best_split
from .tree_learner import LeafState, _collapse, _identity, root_sums


def _partition_segment(words, ghc, perm, seg_b, seg_c, feat, thr, cat,
                       decode_fn=unpack_feature):
    """Stable-partition the segment [seg_b, seg_b + seg_c) by the split
    decision (`col == thr` on a categorical feature, `col <= thr` else)
    on the column `decode_fn(words, feat)`.

    Returns (words, ghc, perm, n_left), n_left counting ALL left rows
    of the segment (in-bag + out-of-bag + padding).
    """
    col = decode_fn(words, feat)
    go_left = torch.where(cat, col == thr, col <= thr)
    dest, n_left = split_destinations(go_left, seg_b, seg_c)
    words, ghc, perm = apply_partition(invert_permutation(dest), words, ghc,
                                       perm)
    return words, ghc, perm, n_left


def build_tree_partitioned(words, grad, hess, inbag, feature_mask,
                           num_bin_pf, is_cat, *, num_leaves, max_bin,
                           params: SplitParams, max_depth, cache_hists=True,
                           expand_fn=_identity, decode_fn=unpack_feature,
                           hist_reduce_fn=_identity, evaluate_fn=None,
                           sum_psum_fn=_identity):
    """Grow one leaf-wise tree over the packed-word layout on
    `words.device`. No host synchronization.

    Args:
      words: (W, N_pad) int32 packed stored bins (features, or bundle
        slots), N_pad % HIST_CHUNK == 0.
      grad, hess, inbag: (N_pad,) float32 (pad rows: inbag == 0).
      feature_mask: (F,) bool; num_bin_pf: (F,) int32; is_cat: (F,)
        bool, in virtual feature space (F == 4W unbundled, the pad
        features with 1 bin and not categorical).
      num_leaves/max_bin/params/max_depth: static config.
      cache_hists: False = memory-bounded mode: no (L, 4W, B, 3) cache;
        both children's segment histograms are built at each split.
      expand_fn: stored -> virtual histogram expansion in front of the
        split scan (BundleMaps.expand when bundled).
      decode_fn: (words, feature) -> (N_pad,) int32 bins of the split
        feature (BundleMaps.decode when bundled).
      hist_reduce_fn, evaluate_fn, sum_psum_fn: the parallel learners'
        hooks (the JAX builder's, partitioned.py:110-116).
        hist_reduce_fn reduces every segment histogram across row shards
        (the data-parallel learner's psum; by default the identity);
        evaluate_fn and sum_psum_fn are build_tree_device's.

    Returns the same output dict as build_tree_device; its row_leaf is
    in original row order.
    """
    dev = words.device
    w, n_pad = words.shape
    l = int(num_leaves)
    b = int(max_bin)
    i32 = torch.int32

    if evaluate_fn is None:
        def evaluate_fn(hist3, sum_g, sum_h, cnt):
            return find_best_split(hist3, sum_g, sum_h, cnt, num_bin_pf,
                                   is_cat, feature_mask, params)

    def scan(hist3, sum_g, sum_h, cnt):
        return evaluate_fn(expand_fn(hist3), sum_g, sum_h, cnt)

    def leaf_histogram(words_c, ghc_c, bounds):
        return hist_reduce_fn(_collapse(segment_histograms(words_c, ghc_c,
                                                           bounds, b)))

    ghc = torch.stack([grad * inbag, hess * inbag, inbag])  # (3, N_pad)
    # segment table: [begin, cnt] per leaf; FULL row counts (in-bag +
    # out-of-bag + pad), not the tree's in-bag counts
    seg = torch.zeros((l, 2), dtype=i32, device=dev)
    seg[:1, 1].fill_(n_pad)     # a fill; seg[0, 1] = n_pad would copy

    # ---- root
    hist_root = leaf_histogram(words, ghc, seg[0])
    root_g, root_h, root_c = (sum_psum_fn(s) for s in root_sums(hist_root))
    st = LeafState(l, scan(hist_root, root_g, root_h, root_c), root_c, dev)
    perm = torch.arange(n_pad, dtype=i32, device=dev)  # position -> row
    pos = torch.arange(n_pad, dtype=i32, device=dev)
    pos_leaf = torch.zeros(n_pad, dtype=i32, device=dev)
    if cache_hists:
        hist_cache = torch.zeros((l, 4 * w, b, 3), dtype=torch.float32,
                                 device=dev)
        hist_cache[0] = hist_root

    for i in range(l - 1):
        sp = st.split(i)

        # ---- physical re-partition (DataPartition::Split); a skipped
        # split partitions an empty segment (the identity)
        bounds = seg.index_select(0, sp.best)[0]
        seg_b, seg_c = bounds[0], bounds[1]
        words, ghc, perm, n_left = _partition_segment(
            words, ghc, perm, seg_b, torch.where(sp.do[0], seg_c, 0),
            sp.feat, sp.thr, is_cat.index_select(0, sp.feat)[0], decode_fn)
        st.write_rows(seg, sp.pair, torch.stack([
            torch.stack([seg_b, n_left]),
            torch.stack([seg_b + n_left, seg_c - n_left])]))
        pos_leaf = torch.where(
            sp.do & (pos >= seg_b + n_left) & (pos < seg_b + seg_c),
            st.leaf_ids[sp.right_id], pos_leaf)

        if cache_hists:
            # smaller child by in-bag count, larger by parent subtraction
            left_is_small, small_leaf = st.small_child(sp)
            hist_small = leaf_histogram(
                words, ghc,
                seg.index_select(0, small_leaf.long().reshape(1))[0])
            both = st.cache_children(hist_cache, sp, left_is_small,
                                     hist_small)
        else:
            # memory-bounded mode: both children's segments scanned
            both = torch.stack([leaf_histogram(words, ghc, child)
                                for child in seg.index_select(0, sp.pair)])
        st.set_children(sp, both, scan, max_depth)

    # original-order row -> leaf map: one scatter at the tree's end
    row_leaf = torch.zeros(n_pad, dtype=i32, device=dev).index_copy_(
        0, perm.long(), pos_leaf)
    return st.outputs(row_leaf)
