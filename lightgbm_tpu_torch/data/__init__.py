"""Out-of-core training (port of lightgbm_tpu/data/, single process).

- block_store: the on-disk packed-bin blocks, manifest and sidecar (bin
  once, stream every pass); OutOfCoreDataset.
- prefetch: disk -> pinned host ring -> device ring, the copies on a
  stream of their own.
- ooc_learner: the streaming tree learner, its trees bit for bit the
  in-RAM masked engine's.
"""

from .block_store import (BlockStore, BlockStoreError, BlockStoreWriter,
                          OutOfCoreDataset, build_block_store_from_file,
                          effective_block_rows, load_or_build_block_store,
                          open_block_store_dataset, spill_core_dataset)
from .prefetch import BlockPrefetcher

__all__ = ["BlockStore", "BlockStoreError", "BlockStoreWriter",
           "OutOfCoreDataset", "BlockPrefetcher",
           "build_block_store_from_file", "effective_block_rows",
           "load_or_build_block_store", "open_block_store_dataset",
           "spill_core_dataset"]
