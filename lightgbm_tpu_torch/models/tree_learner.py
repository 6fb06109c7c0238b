"""Serial tree learner: leaf-wise growth of one tree on the device.

Port of lightgbm_tpu/models/tree_learner.py (build_tree_device :187-434
in its serial configurations, cache_hists_fits :437, SerialTreeLearner
with its engine selection :500-629).
Reference: src/treelearner/serial_tree_learner.cpp:19-442.

The JAX builder is one jitted `lax.fori_loop` with a `lax.cond` per
split. Here the loop is eager PyTorch, and it never waits for the
device inside a tree:
- every piece of per-leaf state is a device tensor, and leaf ids reach
  the histogram kernels as device int32 tensors (the TPU kernels take
  them from SMEM);
- the "no more positive gain" stop is a masked update: each split's
  writes are gated by a device bool `do` (the lax.cond at :418), so the
  host issues all num_leaves - 1 iterations without reading a value;
- the one sync per tree is the fetch of the finished tree arrays
  (SerialTreeLearner.fetch, the counterpart of _to_host_tree :884-897).

Histograms, the JAX builder's three branches (:301-323, :364-395):
- the root (the bagging re-init) comes from the frontier engine with
  L = 1 (use_frontier, hist_frontier != false), else from the masked
  engine on leaf 0;
- with the per-leaf (L, F, B, 3) cache on (the reference's
  HistogramPool), each split builds only the smaller child and gets the
  larger by subtraction from the parent; the child comes from the
  gather-compacted engine (compact_hist, hist_compaction) or the masked
  one;
- over histogram_pool_size it runs cache-less: both children from one
  frontier pass with L = 2 when use_frontier and not compact_hist, else
  from two leaf passes, compacted or masked.
The builder takes the histogram engines as arguments, as the JAX
builder takes its hooks, so a caller can hand it the plain versions for
comparison.

A bundled dataset (io/bundling.py) stores S slot rows for F features.
Histograms, the cache and the parent subtraction stay in stored (S, B)
space; BundleMaps.expand turns a stored histogram into the (F, B_v)
virtual one just before the split scan (gathers of each member's bin
range, bin 0 as the slot total minus that range), and the partition
reads a split feature's column out of its slot (BundleMaps.split_col,
BundleMaps.window). Every table is a device tensor placed once per
learner, so a captured graph reads fixed addresses.

Split semantics (gain formulas, epsilons, tie-breaks, max_depth guard,
min_data/min_sum_hessian constraints) follow ops/split.py.

SerialTreeLearner runs this builder, or with partitioned_build=true the
leaf-contiguous one (models/partitioned.py, over packed words); the two
share the split bookkeeping (LeafState). Engines are selected as the
JAX learner selects them off the TPU (the port never runs on one):
hist_compaction=true, or auto above one HIST_CHUNK of rows, builds the
children with the gather-compacted engine (_compaction_enabled);
hist_frontier=false builds the root with the masked engine; with
partitioned_build=true (bins <= 256) neither applies. The same on the
card and on the CPU: only the kernels behind the engines differ.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.histogram import (compacted_histograms, frontier_histograms,
                             masked_histograms)
from ..ops.hist_kernels import HIST_CHUNK, CompactScratch
from ..ops.ordered_hist import pack_feature_words, unpack_feature
from ..ops.reduce_order import ordered_sum
from ..ops.split import K_MIN_SCORE, SplitParams, find_best_split
from ..utils.device import resolve_device
from ..utils.log import Log
from ..utils.random import Random
from .tree import Tree

# Packed per-leaf split candidates (LeafSplits + best_split_per_leaf_):
# one float32 row per leaf, columns in this order (feature and threshold
# are small integers, exact in float32).
CANDIDATE_FIELDS = ("feature", "threshold", "left_sum_gradient",
                    "left_sum_hessian", "left_count", "right_sum_gradient",
                    "right_sum_hessian", "right_count", "left_output",
                    "right_output")
C_FEAT, C_THR, C_LG, C_LH, C_LC, C_RG, C_RH, C_RC, C_LOUT, C_ROUT = range(10)

# builder outputs fetched to the host once per tree, in packing order
TREE_KEYS = ("split_feature", "split_threshold_bin", "split_gain",
             "left_child", "right_child", "leaf_parent", "leaf_value",
             "leaf_count", "internal_value", "internal_count")
LEAF_KEYS = ("leaf_parent", "leaf_value", "leaf_count")     # (L,); others (L-1,)
FLOAT_KEYS = ("split_gain", "leaf_value", "internal_value")  # bit-cast to int32


def _as_int32(t):
    return t.view(torch.int32) if t.dtype == torch.float32 \
        else t.to(torch.int32)


def tree_layout(num_leaves):
    """[(key, offset, size)] of every TREE_KEYS array in a packed tree
    row (pack_tree), which starts with n_splits at offset 0."""
    l = int(num_leaves)
    out, pos = [], 1
    for k in TREE_KEYS:
        size = l if k in LEAF_KEYS else l - 1
        out.append((k, pos, size))
        pos += size
    return out


def packed_size(num_leaves):
    """Length of a packed tree row."""
    _, pos, size = tree_layout(num_leaves)[-1]
    return pos + size


def pack_tree(out, extra=()):
    """One tree's arrays as one flat int32 device tensor: n_splits, then
    TREE_KEYS in order (float32 arrays bit-cast), then `extra` int32 /
    float32 / bool scalars."""
    parts = [out["n_splits"].reshape(1).to(torch.int32)]
    parts += [_as_int32(out[k]) for k in TREE_KEYS]
    parts += [_as_int32(e.reshape(1)) for e in extra]
    return torch.cat(parts)


def unpack_tree(flat, num_leaves):
    """pack_tree's inverse on one host int32 row: the host dict of the
    tree's numpy arrays (views of `flat`)."""
    host = {"n_splits": int(flat[0])}
    for k, pos, size in tree_layout(num_leaves):
        arr = flat[pos:pos + size]
        host[k] = arr.view(np.float32) if k in FLOAT_KEYS else arr
    return host


def tree_views(rows, num_leaves):
    """Device views of (M, P) packed tree rows: n_splits (M,) and every
    TREE_KEYS array as (M, size), float32 ones bit-cast back."""
    views = {"n_splits": rows[:, 0]}
    for k, pos, size in tree_layout(num_leaves):
        v = rows[:, pos:pos + size]
        views[k] = v.view(torch.float32) if k in FLOAT_KEYS else v
    return views


def _tristate(value, name):
    """Normalize a config tri-state to "auto"/"true"/"false"."""
    mode = str(value).lower()
    if mode in ("true", "1", "on", "+"):
        return "true"
    if mode in ("false", "0", "off", "-"):
        return "false"
    if mode != "auto":
        Log.fatal('%s must be "auto", "true" or "false", got [%s]', name,
                  mode)
    return "auto"


def _collapse(pair):
    hi, lo = pair
    return hi + lo


def _candidates(sp):
    """SplitInfo (batch shape S) -> (S, 10) float32 candidate rows."""
    return torch.stack([getattr(sp, k).to(torch.float32)
                        for k in CANDIDATE_FIELDS], dim=-1)


class Split(NamedTuple):
    """One split of the leaf-wise loop, as device tensors: the chosen
    leaf `best` (int64 (1,)) and `best32` (int32 (1,)), `do` (bool (1,),
    whether the split happens), its candidate row `c` (10,), the split
    feature `feat` (int64 (1,)) and threshold bin `thr` (int32), the
    children's depth, `pair` = [best, right_id] (int64 (2,)) and the
    right child's leaf id `right_id` (host int)."""
    best: torch.Tensor
    best32: torch.Tensor
    do: torch.Tensor
    c: torch.Tensor
    feat: torch.Tensor
    thr: torch.Tensor
    depth: torch.Tensor
    pair: torch.Tensor
    right_id: int


class LeafState:
    """The per-leaf and per-node state of one tree, shared by the masked
    (build_tree_device) and the partitioned (models/partitioned.py)
    builders, and the split bookkeeping on it (apply_tree_split,
    Tree::Split).

    State is packed so that a split costs a few fused updates instead of
    one per array: `cand` (L, 10) candidates and `best_gain` (L,);
    `leaf_i` (L, 3) int32 [parent, count, depth] and `leaf_value` (L,);
    `node_i` (L-1, 5) int32 [split_feature, threshold_bin, left_child,
    right_child, internal_count] and `node_f` (L-1, 2) [split_gain,
    internal_value]. Every write is gated by the current split's device
    bool `do` (the lax.cond of the JAX builders); the packed arrays are
    updated in place.
    """

    def __init__(self, num_leaves, root_split, root_c, dev):
        l = int(num_leaves)
        f32, i32 = torch.float32, torch.int32
        # device constants: leaf ids (slices of them are the kernels'
        # leaf-id arguments), their complements (~leaf child codes),
        # column ids
        self.leaf_ids = torch.arange(l, dtype=i32, device=dev)
        self.leaf_ids64 = self.leaf_ids.long()
        self.neg_ids = ~self.leaf_ids
        self.col_ids = torch.arange(5, device=dev)
        self.cand = torch.zeros((l, len(CANDIDATE_FIELDS)), dtype=f32,
                                device=dev)
        self.cand[0] = _candidates(root_split)
        self.best_gain = torch.full((l,), K_MIN_SCORE, dtype=f32, device=dev)
        self.best_gain[0] = root_split.gain
        self.leaf_i = torch.zeros((l, 3), dtype=i32, device=dev)
        self.leaf_i[:, 0] = -1
        self.leaf_i[0, 1] = root_c.to(i32)
        self.leaf_value = torch.zeros(l, dtype=f32, device=dev)
        self.node_i = torch.zeros((l - 1, 5), dtype=i32, device=dev)
        self.node_f = torch.zeros((l - 1, 2), dtype=f32, device=dev)
        self.done = torch.zeros(1, dtype=torch.bool, device=dev)
        self.n_splits = torch.zeros((), dtype=i32, device=dev)
        self.do = None

    def write_rows(self, arr, rows, new):
        """arr[rows] = new where this split happens (rows: int64 (k,))."""
        arr.index_copy_(0, rows, torch.where(self.do, new,
                                             arr.index_select(0, rows)))

    def split(self, i):
        """Split i: pick the best leaf, record the node and both
        children's leaf rows. Returns the Split."""
        i32 = torch.int32
        node, right_id = i, i + 1
        best = torch.argmax(self.best_gain).reshape(1)      # int64 (1,)
        best32 = best.to(i32)
        gain = self.best_gain.index_select(0, best)
        do = (~self.done) & (gain > 0.0)                    # (1,) bool
        self.done = ~do                                     # stays stopped
        self.do = do
        c = self.cand.index_select(0, best)[0]              # (10,)
        li = self.leaf_i.index_select(0, best)[0]           # parent, count, depth
        lcnt, rcnt = c[C_LC], c[C_RC]
        feat = c[C_FEAT].long().reshape(1)
        thr = c[C_THR].to(i32)
        node_t = self.leaf_ids[node]
        pair = torch.cat([best, self.leaf_ids64[right_id:right_id + 1]])

        node_i = self.node_i
        node_i[node] = torch.where(do, torch.stack(
            [feat[0].to(i32), thr, ~best32[0], self.neg_ids[right_id],
             (lcnt + rcnt).to(i32)]), node_i[node])
        self.node_f[node] = torch.where(do, torch.stack(
            [gain[0], self.leaf_value.index_select(0, best)[0]]),
            self.node_f[node])
        # the parent's child pointer that held ~best now holds this node
        parent = li[0]
        pidx = parent.clamp(min=0).long().reshape(1)
        prow = node_i.index_select(0, pidx)[0]
        which = torch.where(prow[2] == ~best32[0], self.col_ids == 2,
                            self.col_ids == 3)
        node_i.index_copy_(0, pidx, torch.where(
            which & (parent >= 0) & do, node_t, prow)[None])
        depth = li[2] + 1
        self.write_rows(self.leaf_i, pair, torch.stack([
            torch.stack([node_t, lcnt.to(i32), depth]),
            torch.stack([node_t, rcnt.to(i32), depth])]))
        self.write_rows(self.leaf_value, pair, c[C_LOUT:C_ROUT + 1])
        self.n_splits = self.n_splits + do[0].to(i32)
        return Split(best, best32, do, c, feat, thr, depth, pair, right_id)

    def small_child(self, sp):
        """(left_is_small, small leaf id): the smaller child by in-bag
        count, as both JAX builders choose it."""
        left_is_small = sp.c[C_LC] <= sp.c[C_RC]
        return left_is_small, torch.where(left_is_small, sp.best32[0],
                                          self.leaf_ids[sp.right_id])

    def cache_children(self, hist_cache, sp, left_is_small, hist_small):
        """Both children's histograms from the smaller one and the
        parent's cached one; writes them to the cache and returns them
        stacked [left, right]."""
        hist_large = hist_cache.index_select(0, sp.best)[0] - hist_small
        both = torch.stack([
            torch.where(left_is_small, hist_small, hist_large),
            torch.where(left_is_small, hist_large, hist_small)])
        self.write_rows(hist_cache, sp.pair, both)
        return both

    def set_children(self, sp, both, scan, max_depth):
        """Children leaf state (LeafSplits::Init after split): both
        children scan in one batched call, rows (lg, lh, lc), (rg, rh,
        rc), and their candidates are written."""
        sums = sp.c[C_LG:C_RC + 1].reshape(2, 3)
        res = scan(both, sums[:, 0], sums[:, 1], sums[:, 2])
        gains = res.gain
        if max_depth >= 0:  # max_depth guard (serial_tree_learner.cpp:238-247)
            gains = torch.where(sp.depth < max_depth, gains,
                                torch.full_like(gains, K_MIN_SCORE))
        self.write_rows(self.best_gain, sp.pair, gains)
        self.write_rows(self.cand, sp.pair, _candidates(res))

    def outputs(self, row_leaf):
        """The builder's output dict (the tree arrays and the row -> leaf
        partition)."""
        node_i, node_f, leaf_i = self.node_i, self.node_f, self.leaf_i
        return {"n_splits": self.n_splits, "row_leaf": row_leaf,
                "split_feature": node_i[:, 0],
                "split_threshold_bin": node_i[:, 1],
                "left_child": node_i[:, 2], "right_child": node_i[:, 3],
                "internal_count": node_i[:, 4], "split_gain": node_f[:, 0],
                "internal_value": node_f[:, 1], "leaf_parent": leaf_i[:, 0],
                "leaf_count": leaf_i[:, 1], "leaf_value": self.leaf_value}


def root_sums(hist_root):
    """Root totals (g, h, count) from the root histogram: stored row 0's
    bins partition the rows (a feature's, or a bundle slot's), so its
    bin sums are the totals (summed in the order of ops/reduce_order.py)."""
    sums = ordered_sum(hist_root[0])
    return sums[0], sums[1], sums[2]


def _identity(x):
    return x


class BundleMaps:
    """The learner's device tables of a bundle plan (io/bundling.py) and
    the stored <-> virtual hooks of the builders (the JAX learner's
    _bundle_expand_fn, _bundle_window and _bundle_kwargs, :698-760)."""

    def __init__(self, plan, num_bin_pf, b_virtual, dev):
        from ..io.bundling import expansion_maps
        self.num_slots = int(plan.num_slots)
        src = expansion_maps(plan, num_bin_pf, b_virtual)
        self.shape = src.shape                                # (F, B_v)
        self.src = torch.from_numpy(src.reshape(-1)).to(dev)
        self.slot_of = torch.from_numpy(
            plan.feat_slot.astype(np.int64)).to(dev)
        self.off = torch.from_numpy(plan.feat_offset).to(dev)
        self.num_bin = torch.from_numpy(
            np.asarray(num_bin_pf, np.int32)).to(dev)

    def expand(self, h):
        """(..., S_pad, B, 3) stored histograms -> (..., F, B_v, 3)
        virtual ones. Slices to the real slots first: a padding slot's
        bin 0 holds row totals, and the gather's zero cell must lie past
        the real slots. Both sums are ordered_sum's: on the CPU bin 0
        has the JAX package's bits."""
        lead = h.shape[:-3]
        hs = h[..., :self.num_slots, :, :]
        flat = hs.reshape(*lead, -1, 3)
        flat = torch.cat([flat, flat.new_zeros(*lead, 1, 3)], dim=-2)
        hv = flat.index_select(-2, self.src).reshape(*lead, *self.shape, 3)
        slot_tot = ordered_sum(hs)                          # (..., S, 3)
        hv0 = (slot_tot.index_select(-2, self.slot_of)
               - ordered_sum(hv[..., 1:, :]))
        return torch.cat([hv0.unsqueeze(-2), hv[..., 1:, :]], dim=-2)

    def window(self, sc, feat):
        """Slot column -> virtual feature `feat`'s bins: the member owns
        (off, off + nb - 1]; anything else (slot bin 0, another member's
        bins) is its bin 0. The one decode rule of every path."""
        off = self.off.index_select(0, feat)
        nb = self.num_bin.index_select(0, feat)
        return torch.where((sc > off) & (sc <= off + nb - 1), sc - off,
                           torch.zeros_like(sc))

    def split_col(self, bins, feat):
        """(N_pad,) int32 bins of virtual feature `feat` (int64 (1,))."""
        sc = bins.index_select(0, self.slot_of.index_select(0, feat))[0]
        return self.window(sc.to(torch.int32), feat)

    def decode(self, words, feat):
        """The same from the partitioned builder's packed words."""
        return self.window(
            unpack_feature(words, self.slot_of.index_select(0, feat)), feat)


def build_tree_device(bins, grad, hess, inbag, feature_mask,
                      num_bin_pf, is_cat, *, num_leaves, max_bin,
                      params: SplitParams, max_depth, cache_hists=True,
                      compact_hist=False, use_frontier=True,
                      masked_fn=masked_histograms,
                      frontier_fn=frontier_histograms,
                      compacted_fn=compacted_histograms,
                      expand_fn=_identity, split_col_fn=None,
                      hist_psum_fn=_collapse, sum_psum_fn=_identity,
                      evaluate_fn=None):
    """Grow one leaf-wise tree on `bins.device`. No host synchronization.

    Args:
      bins: (S, N_pad) uint8/int16 stored bins (S == F unbundled),
        N_pad % HIST_CHUNK == 0 (pad rows have no effect: inbag = 0
        there).
      grad, hess: (N_pad,) float32; inbag: (N_pad,) float32 0/1 mask.
      feature_mask: (F,) bool feature_fraction mask.
      num_bin_pf: (F,) int32 bins per feature; is_cat: (F,) bool.
      num_leaves/max_bin/params/max_depth: static config (max_bin the
        stored histogram width).
      cache_hists: keep the (L, S, B, 3) per-leaf cache and subtract
        (False = memory-bounded mode: both children recomputed).
      compact_hist: a split's child histograms come from the gather-
        compacted engine (cost follows the child's rows); the root stays
        a full pass.
      use_frontier: the root from the frontier engine with L = 1 (else
        the masked engine on leaf 0), and, cache-less and not
        compact_hist, both children from one frontier pass with L = 2.
      masked_fn, frontier_fn, compacted_fn: the histogram engines,
        (bins, ghc_t, row_leaf, leaf id(s), B) -> (value, residual)
        pair.
      expand_fn: stored -> virtual histogram expansion in front of the
        split scan (BundleMaps.expand for a bundled dataset).
      split_col_fn: (bins, feature (int64 (1,))) -> (N_pad,) int32 bin
        column of the split feature (BundleMaps.split_col for a bundled
        dataset; by default the feature's row).
      hist_psum_fn, sum_psum_fn, evaluate_fn: the hooks of the parallel
        learners (parallel/learners.py; the JAX builder's, :187-330).
        hist_psum_fn turns every (value, residual) pair an engine gives
        into the histogram the builder uses (by default `hi + lo`); a
        data-parallel shard exchanges it with its peers, and under
        reduce-scatter gets back only its owned (f_loc, B, 3) block, in
        which the cache and the subtraction then stay. sum_psum_fn
        reduces each scalar root sum across row shards (by default the
        identity). evaluate_fn (hist3, sum_g, sum_h, cnt) -> SplitInfo
        replaces the split scan over the expanded histogram; it is
        called on the root and on both children at once (a leading
        batch axis of 2).

    Returns a dict of device tensors: the tree arrays, n_splits and the
    final (N_pad,) row -> leaf partition.
    """
    dev = bins.device
    n_pad = bins.shape[1]
    l = int(num_leaves)
    b = int(max_bin)

    if evaluate_fn is None:
        def evaluate_fn(hist3, sum_g, sum_h, cnt):
            return find_best_split(hist3, sum_g, sum_h, cnt, num_bin_pf,
                                   is_cat, feature_mask, params)

    def scan(hist3, sum_g, sum_h, cnt):
        return evaluate_fn(expand_fn(hist3), sum_g, sum_h, cnt)

    if split_col_fn is None:
        def split_col_fn(bins, feat):
            return bins.index_select(0, feat)[0].to(torch.int32)

    ghc_t = torch.stack([grad * inbag, hess * inbag, inbag])  # (3, N_pad)

    leaf_fn = compacted_fn if compact_hist else masked_fn

    # ---- root: the full pass over leaf 0 is the bagging re-init
    row_leaf = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    root_id = torch.zeros(1, dtype=torch.int32, device=dev)
    if use_frontier:
        hist_root = hist_psum_fn(frontier_fn(bins, ghc_t, row_leaf, root_id,
                                             b))[0]
    else:
        hist_root = hist_psum_fn(masked_fn(bins, ghc_t, row_leaf, root_id, b))
    root_g, root_h, root_c = (sum_psum_fn(s) for s in root_sums(hist_root))
    st = LeafState(l, scan(hist_root, root_g, root_h, root_c), root_c, dev)
    if cache_hists:
        # in the histogram space of hist_psum_fn (a reduce-scatter
        # shard's owned block)
        hist_cache = torch.zeros((l, *hist_root.shape), dtype=torch.float32,
                                 device=dev)
        hist_cache[0] = hist_root

    for i in range(l - 1):
        sp = st.split(i)

        # ---- partition update (DataPartition::Split): one where()
        col = split_col_fn(bins, sp.feat)
        feat_is_cat = is_cat.index_select(0, sp.feat)[0]
        go_left = torch.where(feat_is_cat, col == sp.thr, col <= sp.thr)
        move = sp.do & (row_leaf == sp.best32) & ~go_left
        row_leaf = torch.where(move, st.leaf_ids[sp.right_id], row_leaf)

        if cache_hists:
            # smaller child by in-bag count, larger by parent subtraction
            left_is_small, small_leaf = st.small_child(sp)
            hist_small = hist_psum_fn(leaf_fn(bins, ghc_t, row_leaf,
                                              small_leaf.reshape(1), b))
            both = st.cache_children(hist_cache, sp, left_is_small,
                                     hist_small)
        elif use_frontier and not compact_hist:
            # memory-bounded: both children from ONE frontier pass
            both = hist_psum_fn(frontier_fn(bins, ghc_t, row_leaf,
                                            sp.pair.to(torch.int32), b))
        else:
            # memory-bounded: both children recomputed, one pass each
            pair32 = sp.pair.to(torch.int32)
            both = torch.stack([hist_psum_fn(leaf_fn(bins, ghc_t, row_leaf,
                                                     pair32[j:j + 1], b))
                                for j in range(2)])
        st.set_children(sp, both, scan, max_depth)

    return st.outputs(row_leaf)


def cache_hists_fits(cfg, stored, max_bin):
    """Whether the per-leaf histogram cache fits histogram_pool_size
    (MB; < 0 = unbounded) — the same rule as the JAX package, so both
    take the same cache / cache-less decision on the same config."""
    cache_mb = (int(cfg.num_leaves) * stored * max_bin * 3 * 4
                ) / (1024.0 * 1024.0)
    pool = float(cfg.histogram_pool_size)
    if 0 <= pool < cache_mb:
        Log.info("Histogram cache (%.0f MB at %d leaves x %d stored "
                 "features x %d bins) exceeds histogram_pool_size="
                 "%.0f MB: recomputing child histograms instead of "
                 "caching for subtraction", cache_mb,
                 int(cfg.num_leaves), stored, max_bin, pool)
        return False
    if pool < 0 and cache_mb > 4096:
        Log.warning("Histogram cache needs %.0f MB of device memory "
                    "(%d leaves x %d stored features x %d bins); set "
                    "histogram_pool_size (MB) to cap it via "
                    "recompute mode", cache_mb, int(cfg.num_leaves),
                    stored, max_bin)
    return True


class SerialTreeLearner:
    """Host-side driver of the device builder (tree_learner.h:19-71)."""

    name = "serial"
    # the out-of-core learner streams its bins from a block store; its
    # host drives every pass, so it stays off the fused trainer
    streams_blocks = False
    # the parallel learners (parallel/learners.py) build each tree on a
    # shard mesh, off the fused trainer too
    meshed = False

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.random = Random(config.feature_fraction_seed)
        self.train_set = None

    def init(self, train_set):
        if (getattr(train_set, "block_store", None) is not None
                and not self.streams_blocks):
            Log.fatal("the training data is an out-of-core block store "
                      "but out_of_core=false; set out_of_core=true (or "
                      "rebuild the dataset in-RAM)")
        self.train_set = train_set
        cfg = self.config
        self.num_features = train_set.num_features
        self.num_data = train_set.num_data
        self.max_bin = int(train_set.max_stored_bin)
        self.use_partitioned = self._partitioned_enabled(cfg)
        self.use_compact = self._compaction_enabled(cfg)
        self.use_frontier = _tristate(cfg.hist_frontier,
                                      "hist_frontier") != "false"
        self.n_pad = self._pad_rows(self.num_data)
        num_bin_pf = train_set.num_bin_array()
        is_cat = train_set.feature_is_categorical()
        plan = train_set.bundle_plan
        # stored rows the builder streams (features, or bundle slots),
        # padded to whole packed words for the partitioned builder; the
        # virtual per-feature arrays pad with them only when unbundled
        self.s_pad = self._pad_feature_count(self._stored_rows(train_set))
        self.f_pad = (self.s_pad if plan is None
                      else self._pad_virtual_count(self.num_features))
        extra = self.f_pad - self.num_features
        if extra:
            # pad features: all rows in bin 0, one bin, never split
            num_bin_pf = np.concatenate([num_bin_pf, np.ones(extra, np.int32)])
            is_cat = np.concatenate([is_cat, np.zeros(extra, bool)])
        dev = self.device
        self.bins = self._place_bins(train_set)
        self.bundle = (None if plan is None else BundleMaps(
            plan, num_bin_pf[:self.num_features], train_set.max_num_bin,
            dev))
        # the feature_fraction mask of the tree being built: every tree
        # reads this one buffer, so a captured CUDA graph reads it too
        self.fmask = torch.ones(self.f_pad, dtype=torch.bool, device=dev)
        self.packed_size = packed_size(cfg.num_leaves)
        self.num_bin_pf = torch.from_numpy(num_bin_pf).to(dev)
        self.is_cat = torch.from_numpy(is_cat).to(dev)
        self._threshold_table = threshold_table(train_set)
        self.params = SplitParams(
            min_data_in_leaf=float(cfg.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(cfg.min_sum_hessian_in_leaf),
            lambda_l1=float(cfg.lambda_l1),
            lambda_l2=float(cfg.lambda_l2),
            min_gain_to_split=float(cfg.min_gain_to_split))
        self.cache_hists = cache_hists_fits(cfg, self.s_pad, self.max_bin)
        # the compaction's index buffer and count, and on the card the
        # kernels' scratch (look-back flags, chunk partials, fold
        # counters), once per learner: a captured graph reads the same
        # addresses on every replay, and no two learners share a counter
        self.compacted_fn = (self._compacted_engine(self.bins)
                             if self.use_compact else None)
        Log.info("Number of data: %d, number of features: %d",
                 self.num_data, self.num_features)

    def _compacted_engine(self, bins):
        """The gather-compacted engine over `bins` with buffers of its
        own: the compaction's index buffer and count and, on the card,
        the kernels' scratch (CompactScratch)."""
        dev = bins.device
        return functools.partial(
            compacted_histograms,
            src=torch.empty(bins.shape[1], dtype=torch.int32, device=dev),
            cnt=torch.zeros(1, dtype=torch.int32, device=dev),
            scratch=(CompactScratch(bins, self.max_bin)
                     if dev.type == "cuda" else None))

    def _partitioned_enabled(self, cfg):
        """Leaf-contiguous builder (models/partitioned.py): "true" turns
        it on where the bins pack into bytes (max_stored_bin <= 256).
        "auto" resolves to the masked builder on every device here (the
        JAX package picks the leaf-contiguous one on the TPU)."""
        if _tristate(cfg.partitioned_build, "partitioned_build") != "true":
            return False
        if self.max_bin > 256:
            Log.warning("partitioned_build=true ignored: needs max_bin <= 256")
            return False
        return True

    def _compaction_enabled(self, cfg):
        """Gather-compacted child histograms (ops/histogram.py
        compacted_histograms) on the dense builder, as the JAX learner
        decides off the TPU: "true" turns them on, "false" off, "auto"
        on above one HIST_CHUNK of rows (a single-chunk dataset gains
        nothing). Moot with the leaf-contiguous builder, whose passes
        already follow the leaf's rows. (The JAX package's "auto" keeps
        the masked engine on the TPU; the port never runs on one.)"""
        mode = _tristate(cfg.hist_compaction, "hist_compaction")
        if self.use_partitioned or mode == "false":
            return False
        return mode == "true" or self.num_data > HIST_CHUNK

    @staticmethod
    def _pad_rows(n):
        """Rows pad to a HIST_CHUNK multiple, as on the TPU: the kernels
        grid over whole 4096-row chunks."""
        return ((n + HIST_CHUNK - 1) // HIST_CHUNK) * HIST_CHUNK

    @staticmethod
    def _stored_rows(train_set):
        """Stored rows of the dataset's bin matrix (features, or bundle
        slots)."""
        return train_set.bins.shape[0]

    def _pad_feature_count(self, f):
        if self.use_partitioned:
            return ((f + 3) // 4) * 4  # packed words hold 4 features
        return f

    def _pad_virtual_count(self, f):
        """Virtual features of a bundled dataset, as the builder sees
        them (the feature-parallel learner pads them to whole shards)."""
        return f

    def _place_bins(self, train_set):
        """The matrix the builder streams, zero-padded to (s_pad, n_pad)
        rows of bin 0: the dataset's (S, N) device bins at stored width
        (moved to the device once, or binned there), padded on the
        device; or, for the partitioned builder, the packed (s_pad/4,
        n_pad) int32 words, packed on the host and moved once."""
        f, n = train_set.bins.shape
        if self.use_partitioned:
            bins = np.zeros((self.s_pad, self.n_pad),
                            dtype=train_set.bins.dtype)
            bins[:f, :n] = train_set.bins
            return torch.from_numpy(pack_feature_words(bins)).to(self.device)
        dev_bins = train_set.device_bins(self.device)
        if (self.s_pad, self.n_pad) == (f, n):
            return dev_bins
        bins = torch.zeros((self.s_pad, self.n_pad), dtype=dev_bins.dtype,
                           device=self.device)
        bins[:f, :n] = dev_bins
        return bins

    def _sample_features(self):
        """feature_fraction per tree (serial_tree_learner.cpp:160-165),
        drawn over the real features; pad features are never used."""
        cfg = self.config
        if cfg.feature_fraction >= 1.0:
            mask = np.ones(self.num_features, dtype=bool)
        else:
            used_cnt = int(self.num_features * cfg.feature_fraction)
            mask = self.random.sample_mask(self.num_features,
                                           max(used_cnt, 1))
        return np.concatenate(
            [mask, np.zeros(self.f_pad - self.num_features, bool)])

    def _pad(self, v):
        v = v.to(device=self.device, dtype=torch.float32)
        if self.n_pad != self.num_data:
            v = torch.nn.functional.pad(v, (0, self.n_pad - self.num_data))
        return v

    def load_fmask(self, masks, out):
        """Copy host bool `masks` into the device tensor `out` without a
        host sync: from pinned memory, asynchronously, on the card."""
        src = torch.from_numpy(np.ascontiguousarray(masks))
        if out.device.type == "cuda":
            src = src.pin_memory()
        return out.copy_(src, non_blocking=True)

    def train_device(self, grad, hess, inbag=None, fmask=None, **engines):
        """Grow one tree on the device with the builder that is on;
        returns its output dict without waiting for the device.
        `fmask` is the tree's (f_pad,) device feature mask; by default
        one is drawn (feature_fraction) into the learner's mask buffer.
        `engines` override the dense builder's histogram engines
        (masked_fn, frontier_fn, compacted_fn; by default the
        dispatchers, the compacted one on the learner's buffers)."""
        if inbag is None:
            inbag = torch.ones(self.num_data, dtype=torch.float32,
                               device=self.device)
        if fmask is None:
            fmask = self.load_fmask(self._sample_features(), self.fmask)
        cfg = self.config
        if self.use_partitioned:
            from .partitioned import build_tree_partitioned as build
        else:
            build = functools.partial(
                build_tree_device, compact_hist=self.use_compact,
                use_frontier=self.use_frontier)
            if self.compacted_fn is not None:
                engines.setdefault("compacted_fn", self.compacted_fn)
        engines.update(self.bundle_hooks())
        return build(
            self.bins, self._pad(grad), self._pad(hess), self._pad(inbag),
            fmask, self.num_bin_pf, self.is_cat,
            num_leaves=int(cfg.num_leaves), max_bin=self.max_bin,
            params=self.params, max_depth=int(cfg.max_depth),
            cache_hists=self.cache_hists, **engines)

    def bundle_hooks(self):
        """The builder's stored -> virtual hooks of a bundled dataset
        (none unbundled): expand_fn, and split_col_fn for the dense
        builder or decode_fn for the partitioned one."""
        if self.bundle is None:
            return {}
        if self.use_partitioned:
            return {"expand_fn": self.bundle.expand,
                    "decode_fn": self.bundle.decode}
        return {"expand_fn": self.bundle.expand,
                "split_col_fn": self.bundle.split_col}

    def fetch(self, out, extra=()):
        """The tree's ONE device -> host transfer: every tree array (and
        any `extra` int32/float32 scalars) packed into one int32 buffer
        and copied in a single call. Returns (host dict, extra values)."""
        flat = pack_tree(out, extra).cpu().numpy()
        host = unpack_tree(flat, self.config.num_leaves)
        pos = self.packed_size
        extras = [flat[pos + j:pos + j + 1].view(np.float32)[0]
                  if e.dtype == torch.float32 else int(flat[pos + j])
                  for j, e in enumerate(extra)]
        return host, extras

    def host_out_to_tree(self, host, shrink=1.0) -> Tree:
        """Convert one tree's fetched host arrays into a Tree."""
        return tree_from_host(host, self.train_set, shrink,
                              self._threshold_table)

    def linear_fit_context(self):
        """(chunks, bin_value_table, fit_chunk) for the linear-leaf fit
        (models/linear_leaves.py; tree_learner.py:682-696): the whole
        dataset as one (lo, hi, bins, base) block over the virtual-space
        traversal bins (a bundled dataset's slots decoded), the
        dataset's bin representative values (the ones
        Tree.predict_by_bins dots against), and the fit's chunk grid
        (device_row_chunk)."""
        tv = self.train_set.traversal_bins()
        return ([(0, self.num_data, tv, 0)], self.train_set.bin_value_table(),
                int(self.config.device_row_chunk))


def threshold_table(dataset):
    """(F, max_bin) float64 split-threshold values per (feature, bin):
    the bin's upper bound, or its category id (Feature::BinToValue)."""
    table = np.zeros((dataset.num_features, dataset.max_num_bin))
    for i, m in enumerate(dataset.bin_mappers):
        vals = (m.bin_upper_bound if m.bin_type != 1
                else m.bin_2_categorical.astype(np.float64))
        table[i, :len(vals)] = vals
    return table


def tree_from_host(host, dataset, shrink=1.0, table=None) -> Tree:
    """One tree's host arrays (build_tree_device's keys, numpy) -> Tree;
    leaf values scaled by the learning rate `shrink` in float64."""
    n_splits = int(host["n_splits"])
    num_leaves = n_splits + 1
    t = Tree(num_leaves)
    if n_splits == 0:
        return t
    table = threshold_table(dataset) if table is None else table
    sf = np.asarray(host["split_feature"])[:n_splits].astype(np.int32)
    tb = np.asarray(host["split_threshold_bin"])[:n_splits].astype(np.int32)
    t.split_feature = sf
    t.split_feature_real = dataset.real_feature_idx[sf].astype(np.int32)
    t.threshold_in_bin = tb
    t.threshold = table[sf, tb]
    t.decision_type = dataset.feature_is_categorical()[sf].astype(np.int8)
    t.split_gain = np.asarray(host["split_gain"])[:n_splits].astype(np.float64)
    t.left_child = np.asarray(host["left_child"])[:n_splits].astype(np.int32)
    t.right_child = np.asarray(host["right_child"])[:n_splits].astype(np.int32)
    t.leaf_parent = np.asarray(host["leaf_parent"])[:num_leaves].astype(
        np.int32)
    t.leaf_value = (np.asarray(host["leaf_value"])[:num_leaves]
                    .astype(np.float64) * shrink)
    t.leaf_count = np.asarray(host["leaf_count"])[:num_leaves].astype(np.int32)
    t.internal_value = np.asarray(host["internal_value"])[:n_splits].astype(
        np.float64)
    t.internal_count = np.asarray(host["internal_count"])[:n_splits].astype(
        np.int32)
    return t


def create_tree_learner(learner_type, config, device=None):
    """Factory (src/treelearner/tree_learner.cpp:8-19;
    tree_learner.py:929-962): the serial learner, with out_of_core=true
    the block-store streaming learner (data/ooc_learner.py) or, with
    tree_learner=data and num_machines > 1, the gang learner over one
    shared store (data/ooc_parallel.py); or the data-, feature- and
    voting-parallel learners on a shard mesh (parallel/learners.py)."""
    if getattr(config, "out_of_core", False):
        if learner_type == "data" and int(getattr(config, "num_machines",
                                                  1)) > 1:
            from ..data.ooc_parallel import OutOfCoreGangLearner
            return OutOfCoreGangLearner(config, device)
        if learner_type != "serial":
            Log.fatal("out_of_core=true supports tree_learner=serial or "
                      "tree_learner=data with num_machines>1 (got %s); "
                      "feature/voting-parallel need per-shard feature "
                      "stores", learner_type)
        from ..data.ooc_learner import OutOfCoreTreeLearner
        return OutOfCoreTreeLearner(config, device)
    if learner_type == "serial":
        return SerialTreeLearner(config, device)
    from ..parallel.learners import (DataParallelTreeLearner,
                                     FeatureParallelTreeLearner,
                                     VotingParallelTreeLearner)
    learners = {"data": DataParallelTreeLearner,
                "feature": FeatureParallelTreeLearner,
                "voting": VotingParallelTreeLearner}
    if learner_type not in learners:
        Log.fatal("Unknown tree learner type %s", learner_type)
    return learners[learner_type](config, device)
