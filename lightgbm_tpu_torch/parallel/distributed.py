"""Multi-process membership: the process group, this process's rank and
card, and the per-rank row partition (port of
lightgbm_tpu/parallel/distributed.py).

Reference: src/network/linkers_socket.cpp:20-207 (machine-list parsing,
rank discovery, the TCP handshake), src/network/network.cpp (Init) and
the per-rank row distribution of src/io/dataset_loader.cpp:505-550.

Membership is `torch.distributed.init_process_group` with a TCP store at
the machine list's first entry (the JAX package's coordinator), one
process a machine-list entry; the rank is LIGHTGBM_TPU_RANK when set
(several ranks on one host), else the first entry naming a local address
(machines.py find_local_rank). The process group's timeout is `time_out`
seconds, and `init_retries` / `init_backoff_s` retry a failed
bring-up with exponential backoff.

The transport is chosen once, here, from the topology, and never after
an error (every log line names it):
- a CPU process: gloo;
- a CUDA process whose host runs no more ranks than it has cards: NCCL,
  rank r on `cuda:(i % device_count)`, i its index among the machine
  list's entries on this host;
- ranks that share a card (NCCL refuses two ranks on one device): gloo
  over pinned host copies ("gloo+pinned"); the exchanges' folds still
  run on the card (parallel/mesh.py ProcessMesh).
Every host is assumed to have the card count of this one. Host-side
gathers (resume agreement, snapshot scores, the mesh's lockstep check)
run over gloo: the default group, or a gloo group beside NCCL.
"""

import atexit
import collections
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..utils import faults
from ..utils.log import Log
from .machines import _local_addresses, find_local_rank, parse_machine_list

_initialized = False
# the transport and the gloo group of host gathers, set by
# init_from_config
_state = {"transport": None, "host_group": None}

# all_gather into one flat tensor: the newer name where this torch has
# it (all_gather_into_tensor is deprecated there)
all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def choose_transport(machines, rank, device):
    """(transport, device) of `rank` from the topology alone: see the
    module doc."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", torch.device("cpu")
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("a CUDA rank was requested but this host has "
                           "no card")
    local = _local_addresses()
    here = sum(1 for h, _ in machines if h in local)
    others = collections.Counter(h for h, _ in machines if h not in local)
    per_host = max([here, *others.values()])
    i = sum(1 for h, _ in machines[:rank] if h in local)
    card = torch.device("cuda", i % count)
    return ("nccl" if per_host <= count else "gloo+pinned"), card


def _coordinator(machines):
    host, port = machines[0]
    return f"[{host}]:{port}" if ":" in host else f"{host}:{port}"


def _call_initialize(coordinator, num_processes, rank, timeout_s, backend):
    """One init_process_group attempt; split out so the fault harness
    (`fail_distributed_init`) and tests can intercept it."""
    if faults.consume("fail_distributed_init"):
        raise RuntimeError("injected distributed-init failure")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(rank),
        timeout=datetime.timedelta(seconds=float(timeout_s)))


def _initialize_with_retry(coordinator, num_processes, rank, retries=3,
                           backoff_s=1.0, timeout_s=120, backend="gloo"):
    """init_process_group with a per-attempt timeout and exponential
    backoff retries (a coordinator that comes up last must not kill
    every worker). Returns True on success, False when a process group
    already exists (an external launcher made it); fatal when the
    retries are exhausted. Every line names the backend."""
    delay = max(0.0, float(backoff_s))
    last_error = None
    for attempt in range(int(retries) + 1):
        if dist.is_initialized():
            Log.warning("torch.distributed process group already "
                        "initialized (backend=%s); keeping it",
                        dist.get_backend())
            return False
        try:
            _call_initialize(coordinator, num_processes, rank, timeout_s,
                             backend)
            if attempt:
                Log.info("torch.distributed.init_process_group succeeded "
                         "on attempt %d (backend=%s)", attempt + 1, backend)
            return True
        except (RuntimeError, ValueError) as e:
            msg = str(e)
            if "twice" in msg or "already" in msg.lower():
                Log.warning("torch.distributed.init_process_group skipped "
                            "(backend=%s): %s", backend, msg)
                return False
            last_error = msg
        if attempt < retries:
            Log.warning("torch.distributed.init_process_group failed "
                        "(attempt %d/%d, coordinator %s, rank %d of %d, "
                        "backend=%s): %s; retrying in %.1fs", attempt + 1,
                        retries + 1, coordinator, rank, num_processes,
                        backend, last_error, delay)
            if delay > 0:
                time.sleep(delay)
            delay = min(delay * 2 if delay > 0 else 1.0, 30.0)
    Log.fatal("torch.distributed.init_process_group failed after %d "
              "attempts (coordinator %s, rank %d of %d, backend=%s): %s",
              retries + 1, coordinator, rank, num_processes, backend,
              last_error)


def init_from_config(config, device=None):
    """Bring the process group up from the reference's network config
    (machine_list_file / num_machines, config.h:219-226) for a process
    that trains on `device` (None: the CUDA card). No-op (False) when
    already initialized or single-machine; a missing machine list trains
    on the in-process mesh unless LIGHTGBM_TPU_RANK says this is a
    multi-process launch."""
    global _initialized
    if _initialized:
        return False
    if config is None or config.num_machines <= 1 \
            or not config.machine_list_file:
        return False
    env_rank = os.environ.get("LIGHTGBM_TPU_RANK")
    if not os.path.exists(config.machine_list_file):
        if env_rank is not None:
            # peers block in the handshake while this one would train
            # alone: die fast, as the reference's socket linker does
            Log.fatal("machine_list_file %s not found (rank %s)",
                      config.machine_list_file, env_rank)
        Log.warning("machine_list_file %s not found; training on the "
                    "in-process mesh of %d shards",
                    config.machine_list_file, config.num_machines)
        return False
    machines = parse_machine_list(config.machine_list_file)
    if len(machines) < config.num_machines:
        Log.fatal("Machine list file only contains %d machines, but "
                  "num_machines is %d", len(machines), config.num_machines)
    machines = machines[:config.num_machines]
    rank = int(env_rank) if env_rank is not None \
        else find_local_rank(machines)
    if not 0 <= rank < config.num_machines:
        # passing a wrong rank through would hang every healthy peer in
        # the handshake
        Log.fatal("rank %d is out of range for num_machines=%d "
                  "(machine list %s has %d usable entries); check "
                  "LIGHTGBM_TPU_RANK against the machine list",
                  rank, config.num_machines, config.machine_list_file,
                  len(machines))
    faults.set_rank(rank)
    Log.set_rank(rank)
    if device is None:
        device = "cuda"
    transport, dev = choose_transport(machines, rank, device)
    if dev.type == "cuda":
        # the booster's default device is the current card
        torch.cuda.set_device(dev)
    backend = "nccl" if transport == "nccl" else "gloo"
    coordinator = _coordinator(machines)
    if not _initialize_with_retry(
            coordinator, config.num_machines, rank,
            retries=getattr(config, "init_retries", 3),
            backoff_s=getattr(config, "init_backoff_s", 1.0),
            timeout_s=getattr(config, "time_out", 120), backend=backend):
        return False
    _initialized = True
    # at a normal exit (after the ranks' last collective, the model
    # agreement) the group goes down with the process; NCCL wants it so
    atexit.register(dist.destroy_process_group)
    _state["transport"] = transport
    _state["host_group"] = (dist.new_group(backend="gloo")
                            if backend == "nccl" else None)
    Log.info("Distributed: rank %d of %d (coordinator %s) on %s, "
             "transport=%s", rank, config.num_machines, coordinator, dev,
             transport)
    return True


def process_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def num_processes():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multi_host():
    return num_processes() > 1


def transport():
    """The transport init_from_config chose ("gloo", "nccl" or
    "gloo+pinned"); "gloo" for a process group made elsewhere."""
    return _state["transport"] or "gloo"


def host_group():
    """The gloo group of host-side gathers (None: the default group)."""
    return _state["host_group"]


def host_allgather(arr):
    """Every rank's host array `arr` (same shape and dtype on every
    rank), stacked in rank order: (W, *arr.shape) numpy, over gloo. A
    failed gather (a peer is gone) raises MeshPeerLost."""
    from .mesh import MeshPeerLost
    a = np.ascontiguousarray(arr)
    send = torch.from_numpy(a.reshape(-1).copy())
    w = num_processes()
    recv = torch.empty(w * send.numel(), dtype=send.dtype)
    try:
        all_gather_flat(recv, send, group=host_group())
    except RuntimeError as e:
        raise MeshPeerLost(f"host all_gather failed on rank "
                           f"{process_rank()}: {e}") from e
    return recv.numpy().reshape(w, *a.shape)


def partition_rows(n, rank, num_machines, query_boundaries=None):
    """Contiguous per-rank row range, aligned to query boundaries so no
    query is split (dataset_loader.cpp distributes rows; contiguous
    blocks give the same global histograms, hence the same trees).
    Returns (lo, hi)."""
    if query_boundaries is not None:
        qb = np.asarray(query_boundaries)
        nq = len(qb) - 1
        q_lo = (nq * rank) // num_machines
        q_hi = (nq * (rank + 1)) // num_machines
        return int(qb[q_lo]), int(qb[q_hi])
    lo = (n * rank) // num_machines
    hi = (n * (rank + 1)) // num_machines
    return lo, hi


def rows_max(n, num_machines, query_boundaries=None):
    """The longest rank block of partition_rows: the row count every
    rank pads to."""
    return max(hi - lo for lo, hi in (
        partition_rows(n, r, num_machines, query_boundaries)
        for r in range(num_machines)))
