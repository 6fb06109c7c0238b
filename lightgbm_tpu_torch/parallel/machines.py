"""Ownership rules of the mesh (port of lightgbm_tpu/parallel/machines.py
partition_features :84, partition_blocks :102, check_block_tiling :124).

The machine-list parsing and rank discovery of the JAX module belong to
the multi-process runtime, a later slice of the port (ROADMAP queue 1
item 6b).
"""


def partition_features(num_features, num_shards, shard):
    """Contiguous owned feature block of one shard under the mesh
    layer's reduce-scatter ownership rule (parallel/mesh.py): features
    are padded to a multiple of `num_shards` and shard r owns
    [r*f_loc, (r+1)*f_loc). Returns (lo, hi) in PADDED feature space
    (hi may exceed num_features for trailing shards — those indices are
    pad features that never win a split)."""
    num_shards = max(int(num_shards), 1)
    f_pad = -(-int(num_features) // num_shards) * num_shards
    f_loc = f_pad // num_shards
    lo = int(shard) * f_loc
    return lo, lo + f_loc


def partition_blocks(num_blocks, num_shards, shard):
    """Contiguous owned BLOCK range of one rank over a shared block
    store: rank r owns [r*base + min(r, rem), ...) where base =
    num_blocks // num_shards and the first `rem = num_blocks %
    num_shards` ranks carry one extra block. Blocks are real on-disk
    data units, so the ranges tile [0, num_blocks) exactly and every
    block has exactly one owner."""
    num_shards = max(int(num_shards), 1)
    num_blocks = int(num_blocks)
    shard = int(shard)
    base, rem = divmod(num_blocks, num_shards)
    lo = shard * base + min(shard, rem)
    hi = lo + base + (1 if shard < rem else 0)
    return lo, hi


def check_block_tiling(ranges, num_blocks):
    """Validate that per-rank (lo, hi) block ranges tile [0, num_blocks)
    exactly, in rank order, with no gap or overlap. A violation means a
    rank derived its range from a different world size than its peers;
    training on it would double-count or drop blocks, so it raises."""
    expect = 0
    for rank, (lo, hi) in enumerate(ranges):
        if int(lo) != expect or int(hi) < int(lo):
            raise ValueError(
                f"stale block-ownership lease: rank {rank} claims blocks "
                f"[{lo}, {hi}) but the previous ranks end at {expect} — "
                "ranks disagree on the world size; refusing to train")
        expect = int(hi)
    if expect != int(num_blocks):
        raise ValueError(
            f"stale block-ownership lease: ranks cover {expect} of "
            f"{num_blocks} blocks — ranks disagree on the world size; "
            "refusing to train")
