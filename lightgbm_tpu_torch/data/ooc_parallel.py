"""Out-of-core GANG learner: data-parallel training over ONE shared block
store (port of lightgbm_tpu/data/ooc_parallel.py).

The serial out-of-core learner (data/ooc_learner.py) streams every
block of the store through one process. This learner splits the same
store across the W ranks of a torch.distributed process group
(parallel/distributed.py) by contiguous block ranges: rank r owns blocks
[lo, hi) under parallel/machines.py partition_blocks, so the dataset is
binned once (rank 0 builds, its peers adopt; data/block_store.py
load_block_store_gang) and each rank streams 1/W of it.

Each histogram pass folds the rank's owned blocks into a local Kahan
(acc, comp) carry with hist_pair_fold exactly as the serial learner
does, then the ranks exchange their compensated pairs in ONE
ProcessMesh.fold_exchange((acc, -comp)) (parallel/mesh.py): one
all-gather into a receive buffer and one gather-fold launch of mesh_fold
(ops/mesh_kernels.py) that folds acc of ranks 0..W-1, then -comp of
ranks 0..W-1, the JAX package's kahan_fold order (:103-117). Every rank
ends with the same global histogram, so the split loop runs in lockstep
with no further exchange until the next pass; the partition update
reads the owned blocks only, at local row offsets. The exchange runs
under collective_guard("ooc:hist_exchange").

Elastic shrink and grow follow from the derivation: ownership is
computed from the current world at every init, so a supervisor restart
with fewer ranks (supervisor.py) re-partitions the block ranges, and
the survivors resume from the newest shared snapshot over the store
already built, journaling a `block_reshard` record and no `binning`
record. A shrink to one rank resumes through the serial out-of-core
learner (Config.check_param_conflict makes num_machines=1 serial),
which reads the same store end to end.

Wire model (CommPlan `hist_reduce`): one pair all-gather a pass, the
root pass and one a split with the cached-parent subtraction (two
leaves' worth without it).
"""

from ..parallel import distributed
from ..parallel.heartbeat import collective_guard
from ..parallel.mesh import (CommPlan, ProcessMesh, allgather_recv_bytes,
                             pair_allreduce)
from ..utils.log import Log
from .ooc_learner import OutOfCoreTreeLearner


class OutOfCoreGangLearner(OutOfCoreTreeLearner):
    """Shared-block-store data-parallel learner (tree_learner=data,
    out_of_core=true, num_machines > 1). Rows are sharded by owned block
    range, so the booster's row-sharded process-group path (local
    scores, the global snapshot gather and re-slice) applies as it is."""

    name = "out_of_core_gang"
    shard_rows = True

    def init(self, train_set):
        self.n_proc = int(getattr(train_set, "gang_world", 1))
        self.rank = int(getattr(train_set, "gang_rank", 0))
        if (getattr(train_set, "block_store", None) is not None
                and not hasattr(train_set, "block_lo")):
            Log.fatal("the gang learner needs a gang dataset view "
                      "(data/block_store.py gang_view_of); got a "
                      "whole-store dataset: out_of_core=true with "
                      "tree_learner=data needs a process group of "
                      "num_machines ranks loading a data file")
        if self.n_proc > 1 and distributed.num_processes() != self.n_proc:
            Log.fatal("gang world is %d but %d processes are running",
                      self.n_proc, distributed.num_processes())
        self.global_num_data = (int(getattr(train_set, "global_num_data",
                                            0)) or train_set.num_data)
        super().init(train_set)
        self.mesh = ProcessMesh(self.device) if self.n_proc > 1 else None
        # one compensated-pair all-gather a streamed pass
        pair_bytes = 2 * self.num_features * self.max_bin * 3 * 4
        per_pass = allgather_recv_bytes(pair_bytes, self.n_proc)
        self._comm_plan = CommPlan().add(
            "hist_reduce", root=per_pass,
            per_split=per_pass * (1 if self.cache_hists else 2))
        self.collective_bytes = {}
        Log.info("gang rank %d/%d: blocks [%d, %d), %d local rows of %d "
                 "global", self.rank, self.n_proc, self._blk_lo,
                 self._blk_hi, self.num_data, self.global_num_data)

    # ------------------------------------------------------- ownership
    def _owned_block_range(self, store):
        # the dataset view derived (and checked across the ranks) the
        # range at load, from the same partition_blocks
        ts = self.train_set
        return int(ts.block_lo), int(ts.block_hi)

    def _gang_shape(self):
        return self.n_proc, self.rank

    # -------------------------------------------------------- exchange
    def _combine_pair(self, acc, comp):
        """The gang's histogram exchange: every rank's (acc, -comp) in
        one fold_exchange (parallel/mesh.py pair_allreduce, which counts
        the mesh's hist_reduce bytes), the 2W words folded in rank order
        on every rank (one gather-fold launch). Returns (histogram,
        None): the pair is folded already."""
        if self.n_proc <= 1:
            return super()._combine_pair(acc, comp)
        with collective_guard("ooc:hist_exchange"):
            return pair_allreduce((acc, -comp), self.mesh), None

    # ------------------------------------------ collective-byte ledger
    @property
    def split_iterations(self):
        """The split iterations a tree issues: every one streams a pass
        and exchanges (the builder issues all num_leaves - 1)."""
        return int(self.config.num_leaves) - 1

    def account_tree_collectives(self):
        """Advance collective_bytes{_kind} by one tree's bytes (CommPlan
        at split_iterations); the booster calls it after each tree."""
        self._comm_plan.account(self.collective_bytes,
                                self.split_iterations)

    def journal_fields(self):
        fields = super().journal_fields()
        prev = getattr(self, "_journal_prev_comm", None) or {}
        cur = {k: int(v) for k, v in self.collective_bytes.items()
               if k.startswith("collective_bytes_")}
        self._journal_prev_comm = cur
        fields["collective_bytes"] = {k[len("collective_bytes_"):]:
                                      v - prev.get(k, 0)
                                      for k, v in cur.items()}
        return fields
