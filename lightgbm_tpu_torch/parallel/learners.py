"""Parallel tree learners on an in-process shard mesh.

Port of lightgbm_tpu/parallel/learners.py (_MeshedTreeLearner :76,
DataParallelTreeLearner :334, FeatureParallelTreeLearner :534,
VotingParallelTreeLearner :744) for one process. Reference:
src/treelearner/parallel_tree_learner.h and
{feature,data,voting}_parallel_tree_learner.cpp.

The JAX learners run the serial builder under `shard_map`, with
collectives at the reference's sync points. Here each tree runs the same
builders (models/tree_learner.py build_tree_device,
models/partitioned.py build_tree_partitioned) once per shard, on W
threads of a LocalMesh in lockstep (parallel/mesh.py), with the JAX
learners' hooks:

- **Data parallel**: rows sharded, each shard's (S, N_loc) bins on its
  device. The default exchange is the reference's REDUCE-SCATTER: each
  shard all_to_alls the smaller child's Kahan pair in `comm_groups`
  feature groups, folds its owned block in fixed source order (the CUDA
  kernel mesh_fold) and searches it; the global best is an all_gather
  and argmax of one SplitInfo per shard, and the root sums come from
  shard 0, which owns feature 0. At comm_precision=pair the trees are
  the serial masked learner's. `hist_exchange=allgather`, and bundled
  data, fold the full histogram on every shard instead;
  `partitioned_build=true` runs the leaf-contiguous core with one psum
  per segment histogram.
- **Feature parallel**: features sharded, all rows on every shard; each
  shard searches its own features and the global best is an all_gather
  and argmax; the split column is read from a copy of the whole bin
  matrix on each device, or above REPLICATED_BINS_MAX_BYTES broadcast
  from its owner with a psum.
- **Voting parallel** (PV-Tree): rows sharded, histograms kept local;
  each evaluation votes the local top-k, all_gathers the candidates and
  psums only the at most 2k winners' histograms.

The builders issue every one of a tree's num_leaves - 1 iterations under
a device flag (no host read inside a tree), so each iteration exchanges,
also after the tree has stopped growing; the learner accounts its
CommPlan at num_leaves - 1 iterations a tree (the JAX builder skips the
collectives of the iterations its lax.cond skips).
"""

import functools
import types

import numpy as np
import torch

from ..models.partitioned import build_tree_partitioned
from ..models.tree_learner import (BundleMaps, SerialTreeLearner, _tristate,
                                   build_tree_device)
from ..ops.hist_kernels import HIST_CHUNK
from ..ops.ordered_hist import pack_feature_words
from ..ops.reduce_order import ordered_sum
from ..ops.split import (K_MIN_SCORE, SplitInfo, find_best_split,
                         per_feature_best, split_info_at)
from ..utils.log import Log
from .mesh import (CommPlan, LocalMesh, MeshTopology, allgather_recv_bytes,
                   alltoall_recv_bytes, compressed_allreduce,
                   compressed_psum, compressed_reduce_scatter,
                   pair_allreduce, pair_reduce_scatter, psum_recv_bytes,
                   resolve_hist_exchange, shard_rows)

_SPLIT_INFO_BYTES = 11 * 4   # SplitInfo: 11 scalar fields on the wire
_SPLIT_FIELDS = SplitInfo._fields


def _pack_split(sp):
    """SplitInfo (batch shape S) -> (S, 11) float32 (feature and
    threshold are small integers, exact in float32)."""
    return torch.stack([getattr(sp, k).to(torch.float32)
                        for k in _SPLIT_FIELDS], dim=-1)


def _unpack_split(packed):
    fields = {k: packed[..., j] for j, k in enumerate(_SPLIT_FIELDS)}
    fields["feature"] = fields["feature"].to(torch.int32)
    fields["threshold"] = fields["threshold"].to(torch.int32)
    return SplitInfo(**fields)


def gather_best(mesh, sp):
    """Allreduce-max of SplitInfo (feature_parallel_tree_learner.cpp:64-72):
    one best per shard gathered in shard order, the first max gain wins,
    so the smallest shard (the smallest feature block) breaks a tie."""
    gathered = mesh.all_gather(_pack_split(sp), "split_gather")
    widx = torch.argmax(gathered[..., 0], dim=0, keepdim=True)
    best = torch.gather(gathered, 0, widx[..., None].expand(
        1, *gathered.shape[1:]))[0]
    return _unpack_split(best)


def _stable_top_k(x, k):
    """(values, indices) of the k largest of the last axis, equal values
    in ascending index order (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _stack_splits(splits):
    return SplitInfo(*[torch.stack([getattr(s, k) for s in splits])
                       for k in _SPLIT_FIELDS])


class _MeshedTreeLearner(SerialTreeLearner):
    """Common mesh plumbing: the mesh and its topology, per-shard inputs
    on each shard's device, one tree a `mesh.run`, the byte ledger."""

    meshed = True
    # rows sharded (else features, over all rows)
    shard_rows = True
    # the row-sharded learners run the leaf-contiguous builder too
    partitioned_capable = False

    def init(self, train_set):
        cfg = self.config
        self.n_shards = max(int(cfg.num_machines), 1)
        self.mesh = LocalMesh(self.n_shards, self.device)
        self.topology = MeshTopology(self.mesh, cfg)
        self._comm_plan = CommPlan()
        # collective_bytes{_kind} counters of the trees built (CommPlan)
        self.collective_bytes = {}
        self._rows = shard_rows(train_set.num_data, self.n_shards)
        self._dev_state = {}
        super().init(train_set)
        self._replicate()
        self._make_build_core(cfg)
        Log.info("%s tree learner on %d shards over %s", self.name,
                 self.n_shards, ", ".join(sorted(set(
                     str(d) for d in self.mesh.devices))))
        d = self.topology.describe(self.f_pad)
        Log.info("mesh: %d shard(s), f_pad=%d%s, hist_exchange=%s, "
                 "comm_precision=%s", d["shards"], d["f_pad"],
                 f" (f_loc={d['f_loc']})" if "f_loc" in d else "",
                 d["exchange"], d["precision"])

    # SerialTreeLearner.init calls these hooks ----------------------------
    def _partitioned_enabled(self, cfg):
        if not self.partitioned_capable:
            if _tristate(cfg.partitioned_build, "partitioned_build") == "true":
                Log.warning("partitioned_build=true ignored: the %s learner "
                            "has no leaf-contiguous core", self.name)
            return False
        return super()._partitioned_enabled(cfg)

    def _compaction_enabled(self, cfg):
        """Row-sharded learners keep gather compaction OPT-IN
        (learners.py:103-119): shard-local compaction regroups the chunk
        partial sums, which demotes the masked path's serial ==
        parallel histogram agreement to ~1e-6. hist_compaction=true
        accepts that; the feature-parallel learner, whose shards sum all
        rows, follows the serial rule."""
        if (self.shard_rows
                and _tristate(cfg.hist_compaction, "hist_compaction")
                == "auto"):
            return False
        return super()._compaction_enabled(cfg)

    def _pad_rows(self, n):
        """Row-sharded: each shard's rows padded to whole HIST_CHUNKs
        (the length of every shard's arrays); feature-sharded: all rows,
        as the serial learner pads them."""
        if not self.shard_rows:
            return super()._pad_rows(n)
        n_loc = max(hi - lo for lo, hi in self._rows)
        return max(-(-n_loc // HIST_CHUNK), 1) * HIST_CHUNK

    def _place_bins(self, train_set):
        """Each row shard's (s_pad, n_pad) bins (or packed words) on its
        device, its rows zero-padded."""
        if not self.shard_rows:
            return super()._place_bins(train_set)
        f = train_set.bins.shape[0]
        out = []
        if self.use_partitioned:
            for (lo, hi), dev in zip(self._rows, self.mesh.devices):
                bins = np.zeros((self.s_pad, self.n_pad),
                                dtype=train_set.bins.dtype)
                bins[:f, :hi - lo] = train_set.bins[:, lo:hi]
                out.append(torch.from_numpy(pack_feature_words(bins)).to(dev))
            return out
        src = train_set.device_bins(self.device)
        for (lo, hi), dev in zip(self._rows, self.mesh.devices):
            bins = torch.zeros((self.s_pad, self.n_pad), dtype=src.dtype,
                               device=dev)
            bins[:f, :hi - lo] = src[:, lo:hi].to(dev)
            out.append(bins)
        return out

    def _compacted_engine(self, bins):
        """One compacted engine a shard, on its bins (its own buffers)."""
        engines = []
        for b in bins:
            engines.append(super()._compacted_engine(b))
        return engines

    def _replicate(self):
        """The per-feature tables, the feature mask buffer and the bundle
        maps on every device of the mesh (the learner's own on its
        device)."""
        for dev in self.mesh.devices:
            if dev in self._dev_state:
                continue
            if dev == self.device:
                st = types.SimpleNamespace(
                    num_bin_pf=self.num_bin_pf, is_cat=self.is_cat,
                    fmask=self.fmask, bundle=self.bundle)
            else:
                plan = self.train_set.bundle_plan
                st = types.SimpleNamespace(
                    num_bin_pf=self.num_bin_pf.to(dev),
                    is_cat=self.is_cat.to(dev),
                    fmask=torch.ones(self.f_pad, dtype=torch.bool,
                                     device=dev),
                    bundle=None if plan is None else BundleMaps(
                        plan, self.num_bin_pf.cpu().numpy()[
                            :self.num_features],
                        self.train_set.max_num_bin, dev))
            self._dev_state[dev] = st

    def _shard_state(self, r):
        return self._dev_state[self.mesh.devices[r]]

    def _shard_bundle_hooks(self, r):
        """The bundle hooks of build_tree_device / build_tree_partitioned
        on shard r's device (bundle_hooks on the learner's device)."""
        bundle = self._shard_state(r).bundle
        if bundle is None:
            return {}
        if self.use_partitioned:
            return {"expand_fn": bundle.expand, "decode_fn": bundle.decode}
        return {"expand_fn": bundle.expand, "split_col_fn": bundle.split_col}

    # ------------------------------------------------------------ training
    def _shard_rows_of(self, v, r):
        """Shard r's slice of an (N,) row vector, padded to n_pad and
        moved to its device."""
        dev = self.mesh.devices[r]
        if not self.shard_rows:
            return self._pad(v).to(dev)
        lo, hi = self._rows[r]
        part = v[lo:hi].to(device=dev, dtype=torch.float32)
        return torch.nn.functional.pad(part, (0, self.n_pad - (hi - lo)))

    def train_device(self, grad, hess, inbag=None, fmask=None, **engines):
        """Grow one tree on the mesh; returns the output dict of shard 0
        (every shard holds the same tree) with the (N,) row -> leaf map
        assembled from every shard's rows on the learner's device (the
        JAX learner's local_row_leaf), which the booster's score update
        reads. No host sync."""
        if engines:
            raise ValueError("the parallel learners take no engine "
                             "overrides")
        if inbag is None:
            inbag = torch.ones(self.num_data, dtype=torch.float32,
                               device=self.device)
        if fmask is None:
            mask = self._sample_features()
            for st in self._dev_state.values():
                self.load_fmask(mask, st.fmask)
        else:
            for st in self._dev_state.values():
                st.fmask.copy_(fmask)
        args = [[self._shard_rows_of(v, r) for r in range(self.n_shards)]
                for v in (grad, hess, inbag)]

        def shard(r):
            return self._shard_fn(r, args[0][r], args[1][r], args[2][r],
                                  self._shard_state(r).fmask)

        outs = self.mesh.run(shard)
        out = dict(outs[0])
        if self.shard_rows:
            out["row_leaf"] = torch.cat(
                [o["row_leaf"][:hi - lo].to(self.device)
                 for o, (lo, hi) in zip(outs, self._rows)])
        return out

    def _builder_kwargs(self):
        cfg = self.config
        return {"num_leaves": int(cfg.num_leaves), "max_bin": self.max_bin,
                "params": self.params, "max_depth": int(cfg.max_depth),
                "cache_hists": self.cache_hists}

    def _dense_kwargs(self, r):
        """build_tree_device's engine selection and shard r's engines."""
        engines = ({} if self.compacted_fn is None
                   else {"compacted_fn": self.compacted_fn[r]})
        return {"compact_hist": self.use_compact,
                "use_frontier": self.use_frontier, **engines}

    # ------------------------------------------------ collective-byte ledger
    @property
    def split_iterations(self):
        """The split iterations a tree issues (every one exchanges)."""
        return int(self.config.num_leaves) - 1

    def account_tree_collectives(self):
        """Advance this learner's collective_bytes{_kind} counters by one
        tree's bytes (CommPlan at split_iterations); the booster calls it
        after each tree."""
        self._comm_plan.account(self.collective_bytes, self.split_iterations)


class DataParallelTreeLearner(_MeshedTreeLearner):
    """Row-sharded learner (data_parallel_tree_learner.cpp; see the
    module doc for its three cores)."""

    name = "data"
    shard_rows = True
    partitioned_capable = True

    def _rs_eligible(self):
        """Reduce-scatter runs on the masked core for unbundled datasets
        on real (>1 shard) meshes. Bundled datasets exchange stored-slot
        histograms that every shard must expand to its virtual features,
        so they keep the allgather exchange."""
        return (not self.use_partitioned
                and self.train_set.bundle_plan is None
                and self.n_shards > 1
                and resolve_hist_exchange(self.config) != "allgather")

    def _pad_feature_count(self, f):
        if self.use_partitioned or not self._rs_eligible():
            return super()._pad_feature_count(f)
        # reduce-scatter: every shard owns an equal contiguous block
        k = self.n_shards
        return ((f + k - 1) // k) * k

    def _make_build_core(self, cfg):
        max_bin = self.max_bin
        params = self.params
        topo = self.topology
        precision = topo.comm_precision
        mesh = self.mesh
        w = self.n_shards
        self._comm_plan = plan = CommPlan()
        base = self._builder_kwargs()

        if self.use_partitioned:
            psum = functools.partial(compressed_psum, mesh=mesh,
                                     precision=precision)
            # segment histograms are (stored, B, 3) psums (bf16 halves
            # the wire word); one reduction per root + per split
            seg = self.s_pad * max_bin * 3 * (2 if precision == "bf16"
                                              else 4)
            plan.add("hist_reduce", root=psum_recv_bytes(seg, w),
                     per_split=psum_recv_bytes(seg, w))

            def dp_part_fn(r, grad, hess, inbag, fmask):
                st = self._shard_state(r)
                return build_tree_partitioned(
                    self.bins[r], grad, hess, inbag, fmask, st.num_bin_pf,
                    st.is_cat, hist_reduce_fn=psum,
                    **self._shard_bundle_hooks(r), **base)

            self._shard_fn = dp_part_fn
            return

        # masked core: choose the histogram-exchange algorithm
        use_rs = self._rs_eligible()
        self.use_reduce_scatter = use_rs
        if (resolve_hist_exchange(cfg) == "reduce_scatter" and not use_rs
                and w > 1):
            Log.warning("hist_exchange=reduce_scatter unavailable for "
                        "bundled datasets; using the allgather pair "
                        "exchange")
        hist_words = self.s_pad * max_bin * 3 * 4    # one f32 histogram

        if not use_rs:
            if precision == "pair":
                exchange_fn = functools.partial(pair_allreduce, mesh=mesh)
                unit = 2 * allgather_recv_bytes(hist_words, w)
            else:
                exchange_fn = functools.partial(compressed_allreduce,
                                                mesh=mesh,
                                                precision=precision)
                unit = allgather_recv_bytes(
                    hist_words // (2 if precision == "bf16" else 1), w)
            plan.add("hist_reduce", root=unit, per_split=unit)

            def dp_fn(r, grad, hess, inbag, fmask):
                # the allgather exchange yields the GLOBAL histogram on
                # every shard, and the root sums come from it
                st = self._shard_state(r)
                return self._build_dense(
                    r, grad, hess, inbag, fmask, st.num_bin_pf, st.is_cat,
                    hist_psum_fn=exchange_fn,
                    **self._shard_bundle_hooks(r), **base)

            self._shard_fn = dp_fn
            return

        # ---- reduce-scatter core -----------------------------------------
        f_loc = topo.feature_shard(self.f_pad)
        groups = topo.exchange_groups(f_loc)
        self.comm_groups_effective = groups
        if precision == "pair":
            exchange_fn = functools.partial(pair_reduce_scatter, mesh=mesh,
                                            n_shards=w, groups=groups)
            unit = 2 * alltoall_recv_bytes(hist_words, w)
        else:
            exchange_fn = functools.partial(compressed_reduce_scatter,
                                            mesh=mesh, n_shards=w,
                                            groups=groups,
                                            precision=precision)
            unit = alltoall_recv_bytes(
                hist_words // (2 if precision == "bf16" else 1), w)
        # one smaller-child exchange per split + the root build; the
        # larger child is parent - smaller on the OWNED block (the
        # cross-rank subtraction trick — never exchanged)
        plan.add("hist_reduce", root=unit, per_split=unit)
        # split search is local; the global best is one SplitInfo per
        # shard (root evaluates once, each split evaluates 2 children)
        sp_unit = allgather_recv_bytes(_SPLIT_INFO_BYTES, w)
        plan.add("split_gather", root=sp_unit, per_split=2 * sp_unit)
        # root sums broadcast from the global-feature-0 owner (3 scalars)
        plan.add("leaf_sync", root=3 * psum_recv_bytes(4, w))

        def dp_rs_fn(r, grad, hess, inbag, fmask):
            st = self._shard_state(r)
            start = r * f_loc
            nbp_loc = st.num_bin_pf[start:start + f_loc]
            cat_loc = st.is_cat[start:start + f_loc]
            fm_loc = fmask[start:start + f_loc]

            def sum_bcast(s):
                # root sums must come from GLOBAL feature 0 (the serial
                # learner's convention) — shard 0 owns it
                return mesh.psum(s if r == 0 else torch.zeros_like(s),
                                 "leaf_sync")

            def evaluate(hist3, sum_g, sum_h, cnt):
                # hist3: this shard's OWNED (f_loc, B, 3) block. Within
                # the shard the first max is the smallest owned feature,
                # across shards the smallest shard: together the serial
                # argmax tie-break (ownership ascends with the shard)
                sp = find_best_split(hist3, sum_g, sum_h, cnt, nbp_loc,
                                     cat_loc, fm_loc, params)
                return gather_best(mesh, sp._replace(
                    feature=sp.feature + start))

            return self._build_dense(
                r, grad, hess, inbag, fmask, st.num_bin_pf, st.is_cat,
                hist_psum_fn=exchange_fn, sum_psum_fn=sum_bcast,
                evaluate_fn=evaluate, **base)

        self._shard_fn = dp_rs_fn

    def _build_dense(self, r, *args, **kwargs):
        return build_tree_device(self.bins[r], *args,
                                 **self._dense_kwargs(r), **kwargs)


class FeatureParallelTreeLearner(_MeshedTreeLearner):
    """Feature-sharded learner (feature_parallel_tree_learner.cpp). All
    rows on every shard, features split into contiguous blocks (the
    reference's greedy bin-balanced assignment, :28-43, is replaced by a
    block partition of the feature axis)."""

    name = "feature"
    shard_rows = False

    # keep a copy of the whole bin matrix on each device for split-column
    # reads only below this size; larger datasets broadcast the owner's
    # column with a psum (memory >> one (N,) int32 psum per split)
    REPLICATED_BINS_MAX_BYTES = 1 << 30

    def _pad_feature_count(self, f):
        if self.train_set.bundle_plan is not None:
            return f
        k = self.n_shards
        return ((f + k - 1) // k) * k

    def _pad_virtual_count(self, f):
        k = self.n_shards
        return ((f + k - 1) // k) * k

    def _place_bins(self, train_set):
        """Each shard's feature rows (or, bundled, its features' slots)
        over all rows on its device, and the replicated copy."""
        full = super()._place_bins(train_set)          # (s_pad, n_pad)
        k = self.n_shards
        if train_set.bundle_plan is not None:
            stored = full[:train_set.bundle_plan.num_slots]
            self._keep_replicated_copy(stored)
            sel = self._setup_bundle_shards(train_set)
            s_loc = self._fp_s_loc
            return [stored.index_select(0, torch.from_numpy(
                sel[t * s_loc:(t + 1) * s_loc]).to(stored.device))
                .to(dev).contiguous()
                for t, dev in enumerate(self.mesh.devices)]
        self._keep_replicated_copy(full)
        f_loc = self.s_pad // k
        return [full[t * f_loc:(t + 1) * f_loc].to(dev).contiguous()
                for t, dev in enumerate(self.mesh.devices)]

    def _keep_replicated_copy(self, bins):
        # the reference stores ALL data on every machine in feature-
        # parallel mode; when that fits, keep a copy on each device for
        # split-column reads so that applying a split needs no collective
        if bins.numel() * bins.element_size() > \
                self.REPLICATED_BINS_MAX_BYTES:
            self._bins_replicated = None
            return
        self._bins_replicated = {dev: bins.to(dev)
                                 for dev in set(self.mesh.devices)}

    def _setup_bundle_shards(self, train_set):
        """Bundled (EFB) data under feature sharding (learners.py:548-588):
        virtual features stay block-sharded in natural order (shard t owns
        [t*f_loc, (t+1)*f_loc)) and each shard is handed exactly the slot
        rows its features live in — at most f_loc distinct slots. Slot
        histograms expand to the shard's virtual features with per-shard
        local gather maps. Returns the (k * s_loc,) stored slots to
        stack."""
        plan = train_set.bundle_plan
        k = self.n_shards
        f_loc = self.f_pad // k
        f_real = self.num_features
        mappers = train_set.bin_mappers
        b_stored = int(self.max_bin)
        b_virtual = int(train_set.max_num_bin)
        shard_slots = []
        for t in range(k):
            feats = np.arange(t * f_loc, min((t + 1) * f_loc, f_real))
            shard_slots.append(np.unique(plan.feat_slot[feats])
                               if len(feats) else np.zeros(0, np.int64))
        s_loc = max(1, max(len(s) for s in shard_slots))
        sel = np.zeros(k * s_loc, np.int64)
        pad_cell = s_loc * b_stored        # flattened index of a zero row
        src = np.full((self.f_pad, b_virtual), pad_cell, np.int64)
        slot_of = np.full(self.f_pad, s_loc, np.int64)  # pad -> zero total
        for t, slots in enumerate(shard_slots):
            sel[t * s_loc:t * s_loc + len(slots)] = slots
            local = {int(s): i for i, s in enumerate(slots)}
            for j in range(t * f_loc, min((t + 1) * f_loc, f_real)):
                li = local[int(plan.feat_slot[j])]
                slot_of[j] = li
                off = int(plan.feat_offset[j])
                nb = int(mappers[j].num_bin)
                src[j, 1:nb] = li * b_stored + off + np.arange(1, nb)
        self._fp_s_loc = s_loc
        self._fp_src = src
        self._fp_slot_of = slot_of
        return sel

    def _make_build_core(self, cfg):
        params = self.params
        f_loc = self.f_pad // self.n_shards
        mesh = self.mesh
        w = self.n_shards
        self._comm_plan = plan = CommPlan()
        base = self._builder_kwargs()
        replicated = self._bins_replicated is not None
        bundled = self.train_set.bundle_plan is not None
        s_loc = self._fp_s_loc if bundled else f_loc

        # the Allreduce-max of SplitInfo: root evaluates once, every
        # split evaluates both children
        sp_unit = allgather_recv_bytes(_SPLIT_INFO_BYTES, w)
        plan.add("split_gather", root=sp_unit, per_split=2 * sp_unit)
        # root-sum broadcast (3 scalars, once per tree)
        plan.add("leaf_sync", root=3 * psum_recv_bytes(4, w))
        if not replicated:
            # owner-broadcast of the (N_pad,) int32 split column at every
            # partition update
            plan.add("leaf_sync",
                     per_split=psum_recv_bytes(self.n_pad * 4, w))

        maps = {}
        if bundled:
            b_v = int(self.train_set.max_num_bin)
            for r, dev in enumerate(self.mesh.devices):
                lo = r * f_loc
                maps[r] = (torch.from_numpy(
                    self._fp_src[lo:lo + f_loc].reshape(-1)).to(dev),
                    torch.from_numpy(self._fp_slot_of[lo:lo + f_loc]).to(dev))

        def fp_fn(r, grad, hess, inbag, fmask):
            st = self._shard_state(r)
            bins = self.bins[r]
            lo = r * f_loc
            nbp_loc = st.num_bin_pf[lo:lo + f_loc]
            cat_loc = st.is_cat[lo:lo + f_loc]
            fm_loc = fmask[lo:lo + f_loc]
            dev = self.mesh.devices[r]

            def sum_bcast(s):
                # root sums derive from each shard's LOCAL feature 0;
                # broadcast shard 0's (global feature 0, as the serial
                # learner) so every shard evaluates the same parents
                return mesh.psum(s if r == 0 else torch.zeros_like(s),
                                 "leaf_sync")

            def evaluate(hist3, sum_g, sum_h, cnt):
                sp = find_best_split(hist3, sum_g, sum_h, cnt, nbp_loc,
                                     cat_loc, fm_loc, params)
                return gather_best(mesh, sp._replace(
                    feature=sp.feature + lo))

            def expand(h):
                # the shard's slot histogram -> its virtual features
                # (per-shard maps of _setup_bundle_shards); the appended
                # zero row serves both the unused-bin pad cell and pad
                # features' slot totals; sums in ordered_sum's order
                src_loc, slot_of_loc = maps[r]
                lead = h.shape[:-3]
                flat = h.reshape(*lead, -1, 3)
                flat = torch.cat([flat, flat.new_zeros(*lead, 1, 3)], dim=-2)
                hv = flat.index_select(-2, src_loc).reshape(
                    *lead, f_loc, b_v, 3)
                slot_tot = ordered_sum(h)                   # (..., s_loc, 3)
                slot_tot = torch.cat(
                    [slot_tot, slot_tot.new_zeros(*lead, 1, 3)], dim=-2)
                hv0 = (slot_tot.index_select(-2, slot_of_loc)
                       - ordered_sum(hv[..., 1:, :]))
                return torch.cat([hv0.unsqueeze(-2), hv[..., 1:, :]], dim=-2)

            def split_col(_bins, feat):
                # the split column: a direct read of the device's copy of
                # the whole matrix where there is one, else the owner
                # shard's column broadcast with a psum
                if replicated:
                    full = self._bins_replicated[dev]
                    if bundled:
                        return st.bundle.split_col(full, feat)
                    return full.index_select(0, feat)[0].to(torch.int32)
                owned = (feat >= lo) & (feat < lo + f_loc)
                local_feat = (feat - lo).clamp(0, f_loc - 1)
                if bundled:
                    lsl = maps[r][1].index_select(0, local_feat).clamp(
                        0, s_loc - 1)
                    col = st.bundle.window(
                        bins.index_select(0, lsl)[0].to(torch.int32), feat)
                else:
                    col = bins.index_select(0, local_feat)[0].to(torch.int32)
                return mesh.psum(torch.where(owned, col,
                                             torch.zeros_like(col)),
                                 "leaf_sync")

            return build_tree_device(
                bins, grad, hess, inbag, fmask, st.num_bin_pf, st.is_cat,
                sum_psum_fn=sum_bcast, evaluate_fn=evaluate,
                split_col_fn=split_col,
                **({"expand_fn": expand} if bundled else {}),
                **self._dense_kwargs(r), **base)

        self._shard_fn = fp_fn


class VotingParallelTreeLearner(_MeshedTreeLearner):
    """PV-Tree (voting_parallel_tree_learner.cpp): rows sharded, only the
    top-voted features' histograms are reduced — the selective reduction
    and the vote gathers ride the mesh's collectives (comm_precision
    compression and byte accounting)."""

    name = "voting"
    shard_rows = True
    partitioned_capable = True

    def _make_build_core(self, cfg):
        params = self.params
        f = self.num_features
        top_k = min(max(int(cfg.top_k), 1), f)
        w = self.n_shards
        mesh = self.mesh
        precision = self.topology.comm_precision
        self._comm_plan = plan = CommPlan()
        base = self._builder_kwargs()
        # the evaluated histograms' width: virtual bins when bundled
        b_eval = (self.max_bin if self.train_set.bundle_plan is None
                  else int(self.train_set.max_num_bin))
        # two tiny top-k gathers + ONE selective psum of the <= top_k
        # winning features per evaluation (root evaluates once, each
        # split twice); root sums once per tree
        vote_unit = 2 * allgather_recv_bytes(top_k * 4, w)
        sel = top_k * b_eval * 3 * (2 if precision == "bf16" else 4)
        sel_unit = psum_recv_bytes(sel, w)
        plan.add("split_gather", root=vote_unit, per_split=2 * vote_unit)
        plan.add("hist_reduce", root=sel_unit, per_split=2 * sel_unit)
        plan.add("leaf_sync", root=3 * psum_recv_bytes(4, w))
        # local vote constraints scaled by 1/num_machines
        # (voting_parallel_tree_learner.cpp:52-54)
        local_params = params._replace(
            min_data_in_leaf=params.min_data_in_leaf / w,
            min_sum_hessian_in_leaf=params.min_sum_hessian_in_leaf / w)

        def psum(s):
            return mesh.psum(s, "leaf_sync")

        def make_evaluate(fmask, num_bin_pf, is_cat):
            """The vote-and-selectively-reduce evaluation of one leaf,
            shared by the masked and leaf-contiguous cores (both feed it
            the LOCAL histogram)."""
            def evaluate_leaf(hist3, sum_g, sum_h, cnt):
                # local per-feature best gains from LOCAL leaf sums (any
                # one feature's bins partition the local rows)
                local_g, local_h, local_c = ordered_sum(hist3[0])
                gains, _ = per_feature_best(hist3, local_g, local_h,
                                            local_c, num_bin_pf, is_cat,
                                            fmask, local_params)
                top_g, local_top = _stable_top_k(gains, top_k)
                # GlobalVoting (:137-166): every machine's local top-k,
                # re-scored by gain * local_leaf_count / mean_leaf_count;
                # per feature the best; the global candidates are the
                # top-k features by that score
                w_gain = local_c * (w / torch.clamp(cnt, min=1.0))
                top_wg = torch.where(torch.isfinite(top_g), top_g * w_gain,
                                     torch.full_like(top_g, K_MIN_SCORE))
                all_top = mesh.all_gather(local_top.to(torch.int32),
                                          "split_gather").reshape(-1)
                all_wg = mesh.all_gather(top_wg, "split_gather").reshape(-1)
                feature_best = torch.full((f,), K_MIN_SCORE,
                                          dtype=torch.float32,
                                          device=hist3.device).scatter_reduce(
                    0, all_top.long(), all_wg, "amax")
                _, selected = _stable_top_k(feature_best, top_k)
                selected = torch.sort(selected).values
                # a feature nobody voted for must not win on its global
                # histogram (the reference never aggregates it at all)
                voted = torch.isfinite(feature_best.index_select(0, selected))
                hist_sel = compressed_psum(hist3.index_select(0, selected),
                                           mesh, precision)
                cat_sel = is_cat.index_select(0, selected)
                gains_sel, thr_sel = per_feature_best(
                    hist_sel, sum_g, sum_h, cnt,
                    num_bin_pf.index_select(0, selected), cat_sel,
                    fmask.index_select(0, selected), params)
                gains_sel = torch.where(voted, gains_sel,
                                        torch.full_like(gains_sel,
                                                        K_MIN_SCORE))
                best_local = torch.argmax(gains_sel).reshape(1)
                sp = split_info_at(hist_sel, sum_g, sum_h, cnt, cat_sel,
                                   params, best_local.to(torch.int32)[0],
                                   thr_sel.index_select(0, best_local)[0],
                                   gains_sel.index_select(0, best_local)[0])
                return sp._replace(
                    feature=selected.index_select(0, best_local)[0].to(
                        torch.int32))

            def evaluate(hist3, sum_g, sum_h, cnt):
                if hist3.dim() == 3:
                    return evaluate_leaf(hist3, sum_g, sum_h, cnt)
                return _stack_splits([evaluate_leaf(hist3[j], sum_g[j],
                                                    sum_h[j], cnt[j])
                                      for j in range(hist3.shape[0])])

            return evaluate

        if self.use_partitioned:

            def voting_part_fn(r, grad, hess, inbag, fmask):
                st = self._shard_state(r)
                return build_tree_partitioned(
                    self.bins[r], grad, hess, inbag, fmask, st.num_bin_pf,
                    st.is_cat, sum_psum_fn=psum,
                    evaluate_fn=make_evaluate(fmask, st.num_bin_pf,
                                              st.is_cat),
                    **self._shard_bundle_hooks(r), **base)

            self._shard_fn = voting_part_fn
            return

        def voting_fn(r, grad, hess, inbag, fmask):
            st = self._shard_state(r)
            return build_tree_device(
                self.bins[r], grad, hess, inbag, fmask, st.num_bin_pf,
                st.is_cat, sum_psum_fn=psum,
                evaluate_fn=make_evaluate(fmask, st.num_bin_pf, st.is_cat),
                **self._shard_bundle_hooks(r), **self._dense_kwargs(r),
                **base)

        self._shard_fn = voting_fn
