"""Fault injection (port of lightgbm_tpu/utils/faults.py): the training
fire points of the checkpoint and out-of-core paths, the serving
chaos hooks and the model registry's.

Activation is env- or API-driven:

- env: ``LIGHTGBM_TPU_FAULTS="slow_replica_ms=120,error_rate=10"``
  (read once per process at import; re-read with `reload_from_env`).
- API: ``faults.set_fault("wedge_batcher", 1)`` / `clear_faults()`;
  `injected_faults` is the context-manager form that always restores the
  previous state.

Serving chaos faults (serving/server.py, serving/batcher.py), readable
through a per-server overrides dict (`serving_chaos`) so a test can slow
ONE in-process replica while its siblings stay healthy; the env/API
global still applies to every server that has no override:

- ``slow_replica_ms`` (milliseconds): every predict handler sleeps that
  long before dispatch — a degraded/overcommitted replica.
- ``error_rate`` (integer percent): that share of predict requests fail
  with an injected 500. Firing is DETERMINISTIC (Bresenham over a
  request counter, `error_rate_fires`), no RNG.
- ``drop_connection`` (count): the next k predict replies close the
  socket without writing a response.
- ``wedge_batcher`` (flag): the MicroBatcher worker parks before taking
  work until the fault clears — the queue grows and admission control
  must shed; clearing the fault un-wedges without a restart.
- ``corrupt_registry_version`` (count): the next k
  `ModelRegistry.verify` calls raise RegistryError as if the manifest
  checksums failed (fleet/registry.py) — a torn publish the follower
  must refuse to swap.

Training faults (models/gbdt.py, utils/checkpoint.py,
data/prefetch.py, data/block_store.py):

- ``crash_at_iteration`` (iteration index): raise `InjectedFault`, or
  `os._exit(43)` when ``hard_crash`` is also set, just before boosting
  iteration k trains (a fused block containing iteration k crashes at
  its start: the whole block is one device program).
- ``hard_crash`` (flag): escalate `crash_at_iteration` to
  `os._exit(43)`, a kill with no cleanup.
- ``fail_distributed_init`` (count): the next k attempts of
  `torch.distributed.init_process_group` fail
  (parallel/distributed.py).
- ``truncate_checkpoint`` (count): the next k checkpoint saves write
  only the first half of the file's bytes.
- ``corrupt_digest`` (count): the next k checkpoint saves flip a
  payload byte after the digest was computed.
- ``crash_in_checkpoint_write`` (count): the next k checkpoint saves
  write half the payload to the sibling tmp file and `os._exit(43)`
  before the atomic rename.
- ``rank_crash_in_prefetch`` (rank index; -1 = every rank):
  `os._exit(43)` from the block-prefetch producer thread right after a
  block read lands in its staging ring.
- ``bitrot_block_on_restart`` (block index): on a restarted attempt
  (LIGHTGBM_TPU_RESTART_ATTEMPT > 0) flip one byte of that block's file
  before the re-verification pass (BlockStore.reverify).

Rank-targeted faults of the multi-process runtime (the value is
``"rank:iteration"``, or a bare iteration to hit every rank; this
process's rank comes from `set_rank`, which parallel/distributed.py
calls, else from LIGHTGBM_TPU_RANK):

- ``rank_crash_at_iteration`` (``rank:iter``): `os._exit(43)` the
  matching rank just before boosting iteration k, a dead peer: the
  survivors' collective watchdog or heartbeat monitor must end them
  (parallel/heartbeat.py).
- ``rank_hang_at_iteration`` (``rank:iter``): the matching rank sleeps
  forever just before iteration k; its peers block in the next
  collective until their watchdog (`collective_timeout_s`) fires.
- ``heartbeat_stale`` (rank index; -1 = every rank): the matching
  rank's heartbeat publisher stops writing while training continues.
- ``stale_ownership`` (rank index; -1 = every rank): the matching rank
  derives its owned block range of a shared block store from a world
  ONE LARGER than the real one, a stale ownership lease after an
  elastic re-shard; the gang's cross-rank tiling check
  (data/block_store.py, parallel/machines.py check_block_tiling) must
  refuse to train rather than drop or double-count blocks.

The one-shot kills are disarmed on a restarted attempt.
"""

import os
import time

ENV_VAR = "LIGHTGBM_TPU_FAULTS"

# exit code of a hard_crash kill; tests assert on it
HARD_CRASH_EXIT_CODE = 43


class InjectedFault(RuntimeError):
    """Raised by an armed injection point (soft crash mode)."""


_active = {}


def _parse_spec(spec):
    out = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, value = item.partition("=")
        name = name.strip()
        if not name:
            continue
        try:
            out[name] = int(value) if value else 1
        except ValueError:
            out[name] = value.strip()
    return out


def reload_from_env():
    """Replace the active fault set with $LIGHTGBM_TPU_FAULTS."""
    _active.clear()
    _active.update(_parse_spec(os.environ.get(ENV_VAR, "")))


def set_fault(name, value=1):
    _active[name] = value


def clear_faults():
    _active.clear()


def active():
    return dict(_active)


def get(name, default=None):
    return _active.get(name, default)


def consume(name):
    """Count-based faults: True (and decrement) while the counter is
    positive; a negative counter fires forever."""
    count = _active.get(name)
    if not isinstance(count, int) or count == 0:
        return False
    if count > 0:
        _active[name] = count - 1
    return True


class injected_faults:
    """Context manager arming a fault set and restoring the previous
    state on exit (the test suite's idiom)."""

    def __init__(self, **faults):
        self._faults = faults
        self._saved = None

    def __enter__(self):
        self._saved = dict(_active)
        _active.update(self._faults)
        return self

    def __exit__(self, *exc):
        _active.clear()
        _active.update(self._saved)
        return False


# ------------------------------------------------------- serving chaos

def serving_chaos(overrides=None):
    """Merged fault view for the serving layer: the process-global
    fault set overlaid with a per-server overrides dict (so one
    in-process replica can be slowed/broken while siblings sharing the
    process-global table stay healthy)."""
    merged = dict(_active)
    if overrides:
        merged.update(overrides)
    return merged


def consume_from(name, overrides=None):
    """Count-based consume honoring a per-server overrides dict first:
    decrements the override counter when the name is overridden there,
    the global counter otherwise. Negative counters fire forever."""
    if overrides is not None and name in overrides:
        count = overrides.get(name)
        if not isinstance(count, int) or count == 0:
            return False
        if count > 0:
            overrides[name] = count - 1
        return True
    return consume(name)


def error_rate_fires(state, rate):
    """Deterministic percent-based firing for ``error_rate``: `rate` is
    an integer percent; request k fires when floor(k*rate/100) advances
    (Bresenham), so EXACTLY rate% of requests fail with no RNG — chaos
    assertions stay exact and reproducible. `state` is a mutable dict
    owned by the caller (one per server)."""
    try:
        rate = int(rate)
    except (TypeError, ValueError):
        return False
    if rate <= 0:
        return False
    rate = min(100, rate)
    state["seen"] = state.get("seen", 0) + 1
    should_have_fired = (state["seen"] * rate) // 100
    if should_have_fired > state.get("fired", 0):
        state["fired"] = should_have_fired
        return True
    return False


# --------------------------------------------------------- rank targeting

_rank = None


def set_rank(rank):
    """Record this process's distributed rank for rank-targeted faults
    (parallel/distributed.py init_from_config calls it)."""
    global _rank
    _rank = int(rank)


def current_rank():
    if _rank is not None:
        return _rank
    try:
        return int(os.environ.get("LIGHTGBM_TPU_RANK", "0"))
    except ValueError:
        return 0


def _rank_iter_spec(name):
    """A rank-targeted iteration fault's value: ``"rank:iter"`` targets
    one rank, a bare integer every rank. Returns (rank or None,
    iteration), or None when unarmed or unparsable."""
    value = _active.get(name)
    if value is None:
        return None
    if isinstance(value, int):
        return None, value
    rank_s, sep, iter_s = str(value).partition(":")
    if not sep:
        return None
    try:
        return int(rank_s), int(iter_s)
    except ValueError:
        return None


def _rank_flag_fires(name, rank=None):
    """A rank-valued fault: the value equal to `rank` (default this
    process's) fires, -1 fires every rank."""
    value = _active.get(name)
    if value is None:
        return False
    try:
        value = int(value)
    except (TypeError, ValueError):
        return False
    if rank is None:
        rank = current_rank()
    return value in (-1, int(rank))


def heartbeat_suppressed(rank=None):
    """`heartbeat_stale`: True when `rank`'s heartbeat publisher must
    skip its writes (the heartbeat service passes its own rank)."""
    return _rank_flag_fires("heartbeat_stale", rank)


# --------------------------------------------------------- training faults

def _is_restarted_attempt():
    """True inside a relaunch (LIGHTGBM_TPU_RESTART_ATTEMPT > 0): one-shot
    faults must not fire again after the restart they provoke."""
    return os.environ.get("LIGHTGBM_TPU_RESTART_ATTEMPT", "0") not in ("", "0")


def crash_if_reached(first_iteration, num_iterations=1):
    """Crash when `crash_at_iteration` falls inside [first_iteration,
    first_iteration + num_iterations): called at the start of every
    boosting iteration and of every fused block."""
    k = _active.get("crash_at_iteration")
    if not isinstance(k, int):
        return
    if first_iteration <= k < first_iteration + num_iterations:
        if _active.get("hard_crash"):
            os._exit(HARD_CRASH_EXIT_CODE)
        raise InjectedFault(f"injected crash at boosting iteration {k}")


def rank_crash_if_reached(first_iteration, num_iterations=1):
    """`rank_crash_at_iteration`: hard-kill (`os._exit(43)`) the
    matching rank when iteration k falls inside [first_iteration,
    first_iteration + num_iterations). No soft mode: a rank death its
    peers must detect skips every finally and atexit path."""
    spec = _rank_iter_spec("rank_crash_at_iteration")
    if spec is None or _is_restarted_attempt():
        return
    rank, k = spec
    if rank is not None and rank != current_rank():
        return
    if first_iteration <= k < first_iteration + num_iterations:
        os._exit(HARD_CRASH_EXIT_CODE)


def rank_hang_if_reached(first_iteration, num_iterations=1):
    """`rank_hang_at_iteration`: the matching rank sleeps forever just
    before iteration k (it stays alive and keeps heartbeating, so only
    its peers' collective watchdog ends the run)."""
    spec = _rank_iter_spec("rank_hang_at_iteration")
    if spec is None or _is_restarted_attempt():
        return
    rank, k = spec
    if rank is not None and rank != current_rank():
        return
    if first_iteration <= k < first_iteration + num_iterations:
        from .log import Log
        Log.warning("injected hang at boosting iteration %d (rank %d)",
                    k, current_rank())
        while True:
            time.sleep(3600)


def rank_crash_in_prefetch_if_reached():
    """`rank_crash_in_prefetch`: hard-kill the matching rank from the
    prefetch producer thread (data/prefetch.py calls this right after a
    block read lands in the staging ring)."""
    if _is_restarted_attempt():
        return
    if _rank_flag_fires("rank_crash_in_prefetch"):
        os._exit(HARD_CRASH_EXIT_CODE)


def crash_in_checkpoint_write_if_armed(tmp_path, blob):
    """`crash_in_checkpoint_write`: write half of `blob` to `tmp_path`
    and hard-exit, a kill mid-write: the caller's atomic rename never
    runs, so the previous checkpoint survives and the tmp file is the
    debris a resume must ignore."""
    if _is_restarted_attempt():
        return
    if not consume("crash_in_checkpoint_write"):
        return
    with open(tmp_path, "wb") as f:
        f.write(blob[:max(1, len(blob) // 2)])
        f.flush()
        os.fsync(f.fileno())
    os._exit(HARD_CRASH_EXIT_CODE)


def bitrot_block_if_armed(block_path_of, lo, hi):
    """`bitrot_block_on_restart`: on a restarted attempt, flip the last
    byte of the armed block's file (value = block index) when it lies in
    [lo, hi). `block_path_of` maps a block index to its file path.
    Consumed once."""
    if not _is_restarted_attempt():
        return
    target = _active.get("bitrot_block_on_restart")
    if not isinstance(target, int) or not (lo <= target < hi):
        return
    if not consume("bitrot_block_on_restart"):
        return
    path = block_path_of(target)
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))


def stale_ownership_world(num_shards):
    """`stale_ownership`: the world size the matching rank derives its
    owned block range from, one larger than the real one (a lease from
    before an elastic re-shard); the identity when unarmed or for other
    ranks. Not disarmed on a restart: the stale view is a property of
    the lease, and the tiling check must catch it on every attempt."""
    if _rank_flag_fires("stale_ownership"):
        return int(num_shards) + 1
    return int(num_shards)


def mangle_checkpoint_blob(blob):
    """Apply `truncate_checkpoint` / `corrupt_digest` to the final
    checkpoint file bytes. Returns the (possibly mangled) bytes."""
    if consume("truncate_checkpoint"):
        blob = blob[:max(1, len(blob) // 2)]
    if consume("corrupt_digest"):
        flip = len(blob) - 1  # payload tail: past header and digest
        blob = blob[:flip] + bytes([blob[flip] ^ 0xFF])
    return blob


reload_from_env()
