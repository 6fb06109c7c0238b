"""Out-of-core tree learner: leaf-wise builds over a streamed block store
(port of lightgbm_tpu/data/ooc_learner.py :57-530, the serial learner).

The serial learner keeps the whole (F, N_pad) bin matrix on the device.
Out of core that matrix is the term that cannot exist, so this learner
keeps the per-row statistics (3, N_pad), the row -> leaf partition and
the scores on the device, and streams the bins from the block store
(data/block_store.py) through the prefetcher (data/prefetch.py) once per
histogram pass.

The loop is the in-RAM one: the learner runs models/tree_learner.py
build_tree_device with three engines of its own, so the split loop, the
split scan, the root sums, the per-leaf cache and the parent
subtraction are the masked engine's by construction:
- the masked and frontier engines stream one pass over the blocks and
  fold each block into a running Kahan carry per leaf with the
  hist_pair_fold kernel (ops/hist_kernels.py, csrc/hist.cu); blocks hold
  whole HIST_CHUNK chunks and the last span ends at the in-RAM N_pad, so
  the pass walks the chunk sequence of masked_hist over the whole array
  and its collapse gives masked_hist's bits;
- the split column is read from the store: the split feature's id comes
  to the host (the one host read of a split), then its row of every
  block is read from the block files and copied to the device.
So the trees equal the serial learner's with the masked engine
(hist_compaction=false) bit for bit, on the CPU and on the card. Each
pass also waits for its last fold (the JAX learner's collapse is a
blocking read too), which times the pass for the prefetcher's overlap.

Bagging, GOSS and multiclass reach it through the same `inbag` and
per-class builds; the feature sampler is the only host RNG (captured by
GBDT._rng_registry). The fused trainer stays off (streams_blocks): the
host drives every pass. Linear leaves stream the blocks through the fit
(_BlockChunks).
"""

import os
import time

import numpy as np
import torch

from ..models.tree_learner import SerialTreeLearner
from ..ops import hist_kernels
from ..ops.hist_kernels import HIST_CHUNK
from ..utils.log import Log
from .prefetch import BlockPrefetcher


class _BlockChunks:
    """Re-iterable (lo, hi, bins, base) view of the store's blocks for
    the linear-leaf fit (models/linear_leaves.py): one transient memmap a
    block, rows in ascending order. Each iteration reads the store
    again."""

    def __init__(self, store):
        self._store = store

    def __iter__(self):
        store = self._store
        for b in range(store.num_blocks):
            lo = store.row_start_of(b)
            yield lo, lo + store.block_rows_of(b), store.read_block(b), lo


class _StreamedBins:
    """The builder's stand-in for the (F, N_pad) bin matrix it never
    holds: its shape and device (build_tree_device reads nothing else;
    the learner's engines read the store)."""

    def __init__(self, shape, device):
        self.shape = shape
        self.device = device


class OutOfCoreTreeLearner(SerialTreeLearner):
    """SerialTreeLearner whose bin matrix stays on disk."""

    name = "out_of_core"
    streams_blocks = True

    def init(self, train_set):
        store = getattr(train_set, "block_store", None)
        if store is None:
            Log.fatal("out_of_core=true needs a block-store dataset; the "
                      "training data was constructed in-RAM (construct "
                      "the Dataset with out_of_core=true in its params)")
        if store.num_stored != train_set.num_features:
            Log.fatal("block store holds %d stored features but the "
                      "dataset maps %d", store.num_stored,
                      train_set.num_features)
        super().init(train_set)
        cfg = self.config
        attempt = int(os.environ.get("LIGHTGBM_TPU_RESTART_ATTEMPT", "0")
                      or 0)
        if attempt > 0:
            # the store sat on disk through a kill: check every block's
            # crc32 again before the first pass
            store.reverify(0, store.num_blocks)
        n_spans = -(-self.n_pad // store.block_rows)
        if n_spans > 1 and store.block_rows % HIST_CHUNK:
            Log.fatal("block_rows=%d must be a multiple of HIST_CHUNK=%d "
                      "so block boundaries land on the histogram chunk "
                      "grid", store.block_rows, HIST_CHUNK)
        spans = []
        for i in range(n_spans):
            s = i * store.block_rows
            data_rows = store.block_rows_of(i) if i < store.num_blocks else 0
            # the last span ends at the in-RAM N_pad: a zero chunk folded
            # past it would still change the bits
            spans.append((i if data_rows else None,
                          min(s + store.block_rows, self.n_pad) - s,
                          data_rows))
        self.prefetcher = BlockPrefetcher(
            store, spans, depth=int(cfg.prefetch_depth),
            cache_blocks=int(cfg.block_cache_blocks), device=self.device)
        self._fold_scratch = None
        if self.device.type == "cuda":
            self._fold_scratch = hist_kernels.FoldScratch(
                store.block_rows, self.num_features, self.max_bin,
                self.device)
        self._ghc_src = None
        self._ghc_spans = None
        Log.info("Out-of-core: %d blocks x %d rows (%s), resident bin "
                 "budget %.1f MB", store.num_blocks, store.block_rows,
                 store.dtype.name, self.prefetcher.resident_bytes() / 1e6)

    def _partitioned_enabled(self, cfg):
        return False

    def _compaction_enabled(self, cfg):
        return False  # the stream folds the masked engine's chunk sequence

    @staticmethod
    def _stored_rows(train_set):
        return train_set.block_store.num_stored

    def _place_bins(self, train_set):
        return _StreamedBins((self.s_pad, self.n_pad), self.device)

    # --------------------------------------------------------- the engines
    def _ghc_blocks(self, ghc_t):
        """The tree's (3, N_pad) statistics cut into contiguous per-span
        copies, once per tree (the builder makes ghc_t once a tree)."""
        if self._ghc_src is not ghc_t:
            starts = np.cumsum([0] + [sp[1] for sp in self.prefetcher.spans])
            self._ghc_spans = [ghc_t[:, s:e].contiguous()
                               for s, e in zip(starts[:-1], starts[1:])]
            self._ghc_src = ghc_t
        return self._ghc_spans

    def _pass(self, ghc_t, row_leaf, leaf_ids):
        """One streamed pass: every block folded into each leaf's carry
        in row order, then collapsed -> the ((L, F, B, 3) value,
        residual) pair whose sum is masked_hist's histogram. Waits for
        its last fold."""
        f, b = self.num_features, self.max_bin
        num_leaf = leaf_ids.shape[0]
        acc = torch.zeros((num_leaf, f, b, 3), dtype=torch.float32,
                          device=self.device)
        comp = torch.zeros_like(acc)
        ghc = self._ghc_blocks(ghc_t)
        t0 = time.perf_counter()
        for i, (s, e, blk) in enumerate(self.prefetcher.stream()):
            rl = row_leaf[s:e]
            for j in range(num_leaf):
                hist_kernels.hist_pair_fold(acc[j], comp[j], blk, ghc[i], rl,
                                            leaf_ids[j:j + 1], b,
                                            scratch=self._fold_scratch)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.prefetcher.note_pass_wall(time.perf_counter() - t0)
        return acc, (-comp) + 0.0

    def _masked_fn(self, bins, ghc_t, row_leaf, leaf_id, num_bins):
        hi, lo = self._pass(ghc_t, row_leaf, leaf_id.reshape(1))
        return hi[0], lo[0]

    def _frontier_fn(self, bins, ghc_t, row_leaf, leaf_ids, num_bins):
        return self._pass(ghc_t, row_leaf, leaf_ids)

    def _split_col_fn(self, bins, feat):
        """(N_pad,) int32 bins of the split feature: its id read to the
        host (the split's one host read), its row of every block read
        from the store; pad rows are bin 0, as in the in-RAM matrix."""
        store = self.train_set.block_store
        fi = int(feat.reshape(-1)[0])
        col = np.zeros(self.n_pad, dtype=store.dtype)
        for i in range(store.num_blocks):
            s = store.row_start_of(i)
            col[s:s + store.block_rows_of(i)] = store.feature_rows(i, fi)
        return torch.from_numpy(col).to(self.device).to(torch.int32)

    def train_device(self, grad, hess, inbag=None, fmask=None, **engines):
        """The serial learner's build with the streaming engines (an
        engine passed in takes precedence, as there)."""
        engines.setdefault("masked_fn", self._masked_fn)
        engines.setdefault("frontier_fn", self._frontier_fn)
        engines.setdefault("split_col_fn", self._split_col_fn)
        return super().train_device(grad, hess, inbag, fmask, **engines)

    def linear_fit_context(self):
        """(chunks, bin_value_table, fit_chunk) for the linear-leaf fit:
        the blocks streamed in row order. Their boundaries lie on the
        device_row_chunk grid, so the fit's float64 sums walk the
        in-RAM learner's chunk sequence."""
        store = self.train_set.block_store
        fit_chunk = int(self.config.device_row_chunk)
        if store.num_blocks > 1 and store.block_rows % fit_chunk:
            Log.fatal("linear_tree over a block store needs block_rows "
                      "(%d) to be a multiple of device_row_chunk (%d)",
                      store.block_rows, fit_chunk)
        return (_BlockChunks(store), self.train_set.bin_value_table(),
                fit_chunk)

    def stats(self):
        """The prefetcher's counters (prefetch.BlockPrefetcher.stats)."""
        return self.prefetcher.stats()
