"""Parallel learners on an in-process shard mesh (port of
lightgbm_tpu/parallel/, one process).

- machines: the ownership rules of features and blocks.
- mesh: LocalMesh (W shards, a thread each, in lockstep), the
  collectives, the histogram exchanges and their byte model.
- learners: the data-, feature- and voting-parallel tree learners.
"""
