"""ScoreUpdater: per-dataset model scores (port of
lightgbm_tpu/models/score_updater.py).

Reference: src/boosting/score_updater.hpp:15-85. Scores live on the
training device as a (num_class, N) float32 tensor. The training set is
updated from the builder's final row -> leaf partition, one gather
(add_score_by_partition, :103); every other update is a bin-space
traversal of stacked trees on the device (stacked_deltas, the
counterpart of _stacked_deltas :67-84), every row walking every tree in
lockstep for the deepest tree's depth: one tree for a valid set per
iteration, many at once for a fused block, an early-stopping truncation,
a rollback or a valid set added after training (and DART's dropped
trees, one at a time). On a bundled dataset
the traversal reads each split feature out of its slot (the decode of
the JAX package's _traverse_add :41-47). The deltas are added one
tree at a time in order, the same float32 adds whatever the batch, so
the scores come out bit for bit the same. Every update is in place: the
fused trainer's CUDA graph holds the train score's storage. Linear-leaf
trees are scored on the host in float64 (Tree.predict_by_bins, as in
the JAX package) and their float32 deltas added.
"""

import numpy as np
import torch


def stacked_deltas(bins_dev, is_cat, stk, scale, decode=None):
    """(M, N) float32 `scale * leaf_value[leaf(bins)]` of N rows through
    M stacked trees, one lockstep bin-space traversal.

    stk: the trees' device arrays as (M, S) split_feature,
    split_threshold_bin, left_child, right_child, (M, L) leaf_value and
    (M,) n_splits (leaves encoded as ~leaf in the child arrays), plus
    "depth", a host int no smaller than any tree's depth.
    decode: None when bins_dev holds one row per feature, else the
    bundle's (feat_slot int64, feat_offset, num_bin) device tensors:
    virtual feature f reads slot feat_slot[f] and owns its window
    (off, off + nb - 1]."""
    sf = stk["split_feature"]
    m, s = sf.shape
    dev = bins_dev.device
    base = (torch.arange(m, device=dev) * s)[:, None]
    rows = torch.arange(bins_dev.shape[1], device=dev)[None, :]
    sf_f, thr_f = sf.reshape(-1), stk["split_threshold_bin"].reshape(-1)
    lc_f, rc_f = stk["left_child"].reshape(-1), stk["right_child"].reshape(-1)
    node = torch.where(stk["n_splits"] > 0, 0, -1).to(torch.int32)[:, None]
    node = node.expand(m, bins_dev.shape[1])
    for _ in range(int(stk["depth"])):
        idx = base + node.clamp(min=0).long()                # (M, N)
        feat = sf_f[idx].long()
        if decode is None:
            fv = bins_dev[feat, rows].to(torch.int32)
        else:
            slot, off, nb = decode
            sc = bins_dev[slot[feat], rows].to(torch.int32)
            o = off[feat]
            fv = torch.where((sc > o) & (sc <= o + nb[feat] - 1), sc - o,
                             torch.zeros_like(sc))
        thr = thr_f[idx]
        go_left = torch.where(is_cat[feat], fv == thr, fv <= thr)
        nxt = torch.where(go_left, lc_f[idx], rc_f[idx])
        node = torch.where(node < 0, node, nxt)
    leaf = torch.where(node < 0, ~node, torch.zeros_like(node)).long()
    return scale * torch.gather(stk["leaf_value"], 1, leaf)


def slice_trees(stk, t0, t1):
    """Trees t0..t1 of a stacked-tree dict (the depth bound is kept)."""
    return {k: (v if k == "depth" else v[t0:t1]) for k, v in stk.items()}


def stack_host_trees(trees, device):
    """Materialized constant-leaf Trees -> a stacked-tree dict on
    `device` (leaf values as float32; one copy per array)."""
    s = max([t.num_leaves - 1 for t in trees] + [1])
    m = len(trees)
    sf = np.zeros((m, s), np.int32)
    thr = np.zeros((m, s), np.int32)
    lc = np.full((m, s), -1, np.int32)
    rc = np.full((m, s), -1, np.int32)
    lv = np.zeros((m, s + 1), np.float32)
    nsp = np.zeros(m, np.int32)
    for i, t in enumerate(trees):
        ns = t.num_leaves - 1
        sf[i, :ns] = t.split_feature[:ns]
        thr[i, :ns] = t.threshold_in_bin[:ns]
        lc[i, :ns] = t.left_child[:ns]
        rc[i, :ns] = t.right_child[:ns]
        lv[i, :t.num_leaves] = t.leaf_value
        nsp[i] = ns
    arrays = {"split_feature": sf, "split_threshold_bin": thr,
              "left_child": lc, "right_child": rc, "leaf_value": lv,
              "n_splits": nsp}
    stk = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    stk["depth"] = max([t.max_depth for t in trees] + [0])
    return stk


class ScoreUpdater:
    # bound on a batch of (trees, rows) float32 deltas
    CHUNK_BYTES = 64 << 20

    def __init__(self, dataset, num_class, device):
        self.dataset = dataset
        self.num_class = int(num_class)
        self.device = device
        n = dataset.num_data
        self.num_data = n
        self._is_cat_dev = None
        self._decode_dev = None
        init = dataset.metadata.init_score
        if init is not None:
            if len(init) != n * self.num_class:
                from ..utils.log import Log
                Log.fatal("Number of class for initial score error")
            self.score = torch.from_numpy(np.asarray(
                init, dtype=np.float32).reshape(self.num_class, n)).to(device)
        else:
            self.score = torch.zeros((self.num_class, n), dtype=torch.float32,
                                     device=device)

    def add_score_by_partition(self, leaf_values, row_leaf, curr_class):
        """score += leaf_values[row_leaf] (device gather; in place)."""
        self.score[curr_class] += leaf_values[row_leaf.long()]

    def add_score_by_values(self, values, curr_class):
        """score += values: one (N,) per-row delta computed on the host
        (:108), rounded to float32 there, as the linear-leaf training
        path gives it (a leaf's contribution varies per row, so no
        leaf-value gather expresses it)."""
        self.score[curr_class] += torch.from_numpy(
            np.asarray(values, dtype=np.float32)).to(self.device)

    def add_score_by_tree(self, tree, curr_class, sign=1.0):
        """Add (sign=-1: subtract) one materialized tree's outputs to one
        class (:172-183). A constant-leaf tree goes through the device
        traversal (its float32 leaf values, the f64 leaves rounded once,
        as the JAX package's host values cast to float32); a linear one
        through Tree.predict_by_bins on the host in float64 over the
        dataset's bin representative values, then rounded to float32."""
        if tree.is_linear:
            vals = tree.predict_by_bins(
                self.dataset.traversal_bins(),
                self.dataset.bin_value_table()).astype(np.float32)
            self.score[curr_class].add_(
                torch.from_numpy(vals).to(self.device), alpha=sign)
            return
        delta = self.deltas_by_stacked_device_trees(
            stack_host_trees([tree], self.device), 1.0)[0]
        self.score[curr_class].add_(delta, alpha=sign)

    def sub_score_by_tree(self, tree, curr_class):
        self.add_score_by_tree(tree, curr_class, sign=-1.0)

    def add_score_by_device_tree(self, out, depth, scale, curr_class):
        """Valid-set scoring: the builder's output dict as a one-tree
        stack (`depth` a host int, known once the tree was fetched)."""
        stk = {k: out[k][None] for k in ("split_feature",
                                         "split_threshold_bin", "left_child",
                                         "right_child", "leaf_value")}
        stk["n_splits"] = out["n_splits"].reshape(1)
        stk["depth"] = depth
        self.score[curr_class].add_(
            self.deltas_by_stacked_device_trees(stk, scale)[0])

    def _is_cat(self):
        if self._is_cat_dev is None:
            self._is_cat_dev = torch.from_numpy(
                self.dataset.feature_is_categorical()).to(self.device)
        return self._is_cat_dev

    def _decode(self):
        """The bundle decode tables on the device (None unbundled)."""
        plan = self.dataset.bundle_plan
        if plan is not None and self._decode_dev is None:
            self._decode_dev = tuple(
                torch.from_numpy(a).to(self.device)
                for a in (plan.feat_slot.astype(np.int64), plan.feat_offset,
                          self.dataset.num_bin_array()))
        return self._decode_dev

    def deltas_by_stacked_device_trees(self, stk, scale):
        """(M, N) scaled deltas of M stacked trees (stacked_deltas) on
        this dataset's device bins. No host sync."""
        return stacked_deltas(self.dataset.device_bins(self.device),
                              self._is_cat(), stk, scale, self._decode())

    def add_score_by_stacked_trees(self, stk, num_class, scale, sign=1.0):
        """Add (sign=-1: subtract) M class-major stacked trees' deltas,
        one tree at a time in order, in place; the traversal runs in
        batches of at most CHUNK_BYTES of deltas."""
        m = stk["split_feature"].shape[0]
        step = max(1, self.CHUNK_BYTES // (4 * max(1, self.num_data)))
        for t0 in range(0, m, step):
            deltas = self.deltas_by_stacked_device_trees(
                slice_trees(stk, t0, t0 + step), scale)
            for i in range(deltas.shape[0]):
                self.score[(t0 + i) % num_class].add_(deltas[i], alpha=sign)

    def add_score_by_trees(self, trees, num_class, sign=1.0):
        """Batched update from many class-major materialized trees: one
        device traversal of all of them. sign=-1 removes them
        (early-stopping truncation, rollback). A list holding a linear
        tree goes tree by tree in order (add_score_by_tree)."""
        if any(t.is_linear for t in trees):
            for i, tree in enumerate(trees):
                self.add_score_by_tree(tree, i % num_class, sign)
        elif trees:
            self.add_score_by_stacked_trees(
                stack_host_trees(trees, self.device), num_class, 1.0, sign)

    def sub_score_by_trees(self, trees, num_class):
        self.add_score_by_trees(trees, num_class, sign=-1.0)

    def host_score(self):
        """Flat class-major (K*N,) float64 host array (score[k*N + i])."""
        return self.score.cpu().numpy().astype(np.float64).reshape(-1)
