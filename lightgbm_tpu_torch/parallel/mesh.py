"""The shard meshes and the communication layer of the parallel learners.

Port of lightgbm_tpu/parallel/mesh.py. The JAX package runs its
learners' per-shard bodies under `shard_map` over a device mesh
(`make_mesh` :94) and exchanges through XLA collectives. Here two meshes
share one interface (`run`, `rank`, `local_shards`, `all_gather`,
`all_to_all`, `psum`, `fold_exchange`, `describe`, `collective_bytes`),
so the exchanges, CommPlan and the learners run unchanged on either:

- `LocalMesh` holds W shards. Shard r lives on `cards[r % D]` (the D
  cards the process sees, starting at the caller's), or on the CPU. The
  mesh keeps W shards where the JAX package would shrink the mesh to the
  device count: at comm_precision=pair the exchange gives the same
  histograms for any W, so sharing a card changes only where the work
  runs. `run(fn)` calls fn(shard) on W threads in lockstep, each with its
  device current: the body of a JAX `shard_map`, line for line. The
  threads take turns: one shard runs its host code from one collective
  to the next while the others wait (W threads contending for the
  interpreter lock at every PyTorch call cost several times the work
  itself); the device work they enqueue runs as it would from one
  thread.
- the collectives are mesh methods called from inside fn: `all_gather`,
  `all_to_all` (tiled), `psum` and `fold_exchange` (every shard's words
  folded where they lie, below). Every shard calls the same sequence;
  a call waits for all W shards' contributions, reads them and waits
  again before any shard goes on, so no contribution is freed or
  overwritten before every consumer has read it. A shard that raises
  aborts the mesh: every shard waiting in a collective is released with
  an error at once, and `run` re-raises the first shard's own error in
  the caller. Each call carries the collective's name, and a shard that
  reaches another collective than its peers fails the same way (a
  lockstep fault, never a hang).
- `ProcessMesh` is one shard a process of a torch.distributed process
  group (parallel/distributed.py): W is the world size, `run(fn)` calls
  fn(rank) in the caller, and every collective is the backend's,
  bit for bit LocalMesh's at the same W. `all_gather` is one flat
  all-gather into a (W, ...) receive buffer; the tiled `all_to_all` is
  all_to_all_single with the split axis moved to the front; `psum` an
  all-gather and then LocalMesh's sum in shard order (never a backend
  all_reduce, whose order of addition is not fixed). `fold_exchange`
  sends the shard's stacked words in one all-gather (the allgather
  exchanges) or in one all_to_all_single a feature group (reduce-
  scatter), and folds them with ONE gather-fold launch whose
  descriptors point into the receive buffer, in LocalMesh's order. The
  transport (parallel/distributed.py) is gloo on the CPU, NCCL where
  each rank has a card, or gloo over pinned host copies where ranks
  share a card (the fold still runs on the card). Each collective's name
  and shape advance a sequence number and a digest; one small host
  all-gather at the end of every `run` (once a tree) compares them, and
  a rank that reached other collectives than its peers raises
  MeshLockstepError. A collective whose transport fails (a peer is gone)
  raises MeshPeerLost, which an armed collective guard turns into the
  watchdog's exit (parallel/heartbeat.py).
- the exchange algorithms of the JAX module (`pair_allreduce`,
  `pair_reduce_scatter`, `compressed_allreduce`,
  `compressed_reduce_scatter`, `compressed_psum`). The four histogram
  exchanges are one `fold_exchange` each: a shard posts its Kahan words
  (or its collapsed word) and, in the collective's read step, folds its
  peers' words with one launch of the CUDA gather-fold
  (ops/mesh_kernels.py gather_fold, csrc/mesh.cu), whose descriptors
  point into the peers' own tensors: the whole histogram for the
  allgather exchanges, this shard's owned feature block for the
  reduce-scatter ones (every feature group of it at once, since the
  groups tile the block). The fold's order is the JAX package's:
  every shard's value word in shard order, then every residual word.
  Nothing is stacked or copied on one card; on the CPU the plain
  version stacks the same views;
- what each collective costs (the `*_recv_bytes` wire models, CommPlan)
  and the topology view of the learners (MeshTopology). The mesh counts
  the bytes its collectives receive per shard under the same models, so
  a learner's declared plan can be held against what ran.

On one card all shards enqueue on its default stream: the barrier orders
a contribution's kernels before its consumers' reads, and a consumer's
reads before anything its producer enqueues after the second barrier
(which may reuse the memory of a contribution it dropped). Across cards,
or on another stream, a contribution is recorded with a CUDA event that
its consumer's stream waits on; a fold_exchange then reads a copy on the
consumer's card (across cards) or marks the peer's tensors used on its
own stream (record_stream), so that their memory outlives the fold.
"""

import contextlib
import math
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from ..ops.mesh_kernels import gather_fold
from ..utils.log import Log
from . import distributed, heartbeat
from .heartbeat import CollectiveFailed
from .machines import partition_blocks, partition_features

COLLECTIVE_KINDS = ("hist_reduce", "split_gather", "leaf_sync")


class MeshAborted(RuntimeError):
    """A collective could not complete: another shard failed or reached
    a different collective."""


class MeshLockstepError(MeshAborted):
    """Shards reached different collectives: the fault itself (the other
    shards' MeshAborted follow from it)."""


class MeshPeerLost(MeshAborted, CollectiveFailed):
    """A process mesh's collective failed in its transport: a peer
    process is gone."""


class LocalMesh:
    """W shards in one process, a thread each (see the module doc)."""

    def __init__(self, n_shards, device):
        w = int(n_shards)
        if w < 1:
            raise ValueError(f"a mesh needs at least one shard, got {w}")
        self.n_shards = w
        # every shard runs in this process
        self.n_proc = 1
        self.local_shards = list(range(w))
        dev = torch.device(device)
        if dev.type == "cuda":
            d = torch.cuda.device_count()
            first = torch.cuda.current_device() if dev.index is None \
                else dev.index
            self.devices = [torch.device("cuda", (first + r) % d)
                            for r in range(w)]
        else:
            self.devices = [dev] * w
        self.multi_device = len(set(self.devices)) > 1
        self._local = threading.local()
        # the turn: one shard runs host code at a time (module doc)
        self._turn = threading.Lock()
        self._barrier = threading.Barrier(w)
        self._slots = [None] * w
        # bytes received per shard by kind, under the wire models below
        self.collective_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def describe(self):
        """{shards, devices}: where each shard lives."""
        return {"shards": self.n_shards,
                "devices": [str(d) for d in self.devices]}

    # ------------------------------------------------------------ running
    def rank(self):
        """The calling shard's index (inside `run` only)."""
        r = getattr(self._local, "rank", None)
        if r is None:
            raise RuntimeError("a mesh collective was called outside "
                               "LocalMesh.run")
        return r

    def run(self, fn):
        """fn(shard) on every shard, one thread each, with the shard's
        device current; returns the W results in shard order. The first
        shard's exception (not the collectives' MeshAborted of the
        others) is raised here."""
        w = self.n_shards
        self._barrier = threading.Barrier(w)
        self._slots = [None] * w
        results = [None] * w
        errors = [None] * w
        # a new thread starts with the default intra-op thread count, not
        # the caller's: W shards would each start a full team
        threads_per_op = torch.get_num_threads()

        def body(r):
            self._local.rank = r
            self._turn.acquire()
            try:
                torch.set_num_threads(threads_per_op)
                if self.devices[r].type == "cuda":
                    with torch.cuda.device(self.devices[r]):
                        results[r] = fn(r)
                else:
                    results[r] = fn(r)
                self._collect("exit", None, lambda vals: None)
            except BaseException as e:  # noqa: B902 - re-raised below
                errors[r] = e
                self._barrier.abort()
            finally:
                self._turn.release()
                self._local.rank = None

        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"mesh-shard-{r}")
                   for r in range(w)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            root = ([e for e in failed if not isinstance(e, MeshAborted)]
                    or [e for e in failed
                        if isinstance(e, MeshLockstepError)] or failed)
            raise root[0]
        return results

    def _wait(self, tag):
        # the turn passes on while this shard waits
        self._turn.release()
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise MeshAborted(f"mesh collective {tag!r} aborted: another "
                              "shard failed") from None
        finally:
            self._turn.acquire()

    def _collect(self, tag, x, consume):
        """The one rendezvous of every collective: post (tag, x), wait for
        every shard's, check they all reached `tag`, run consume(values)
        (which must take what it needs from its peers' tensors), wait
        again so no shard frees or overwrites its contribution before
        all have read it."""
        r = self.rank()
        event = None
        t = x[0] if isinstance(x, tuple) else x
        if isinstance(t, torch.Tensor) and t.is_cuda and (
                self.multi_device or torch.cuda.current_stream(t.device)
                != torch.cuda.default_stream(t.device)):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
        self._slots[r] = (tag, x, event)
        self._wait(tag)
        slots = list(self._slots)
        tags = {s[0] for s in slots}
        if tags != {tag}:
            self._barrier.abort()
            raise MeshLockstepError(
                f"shards out of lockstep: shard {r} reached {tag!r}, "
                f"others {sorted(tags - {tag})}")
        dev = self.devices[r]
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            for _, v, ev in slots:
                if ev is not None:
                    stream.wait_event(ev)
        out = consume([s[1] for s in slots])
        self._wait(tag)
        return out

    def _account(self, kind, nbytes):
        if kind is not None and self.rank() == 0:
            self.collective_bytes[kind] += int(nbytes)

    # -------------------------------------------------------- collectives
    def all_gather(self, x, kind=None):
        """(W, *x.shape): every shard's x stacked in shard order on the
        caller's device (jax.lax.all_gather)."""
        dev = self.devices[self.rank()]
        self._account(kind, allgather_recv_bytes(_nbytes(x), self.n_shards))
        return self._collect("all_gather", x, lambda vals: torch.stack(
            [v.to(dev) for v in vals]))

    def all_to_all(self, x, split_axis, kind=None):
        """Tiled all-to-all (jax.lax.all_to_all(..., split_axis,
        concat_axis=split_axis, tiled=True)): x is cut into W equal pieces
        along `split_axis`, piece j goes to shard j, and each shard
        concatenates the pieces it receives along the same axis in source
        shard order."""
        r = self.rank()
        w = self.n_shards
        dev = self.devices[r]
        size = x.shape[split_axis]
        if size % w:
            raise ValueError(f"all_to_all: axis {split_axis} of size {size} "
                             f"does not split into {w} pieces")
        piece = size // w
        self._account(kind, alltoall_recv_bytes(_nbytes(x), w))
        return self._collect("all_to_all", x, lambda vals: torch.cat(
            [v.narrow(split_axis, r * piece, piece).to(dev) for v in vals],
            dim=split_axis))

    def psum(self, x, kind=None):
        """Sum of every shard's x on the caller's device, added in shard
        index order: ((x_0 + x_1) + x_2) + ... in x's dtype, so every
        shard gets the same bits."""
        dev = self.devices[self.rank()]
        self._account(kind, psum_recv_bytes(_nbytes(x), self.n_shards))

        def total(vals):
            acc = vals[0].to(dev)
            for v in vals[1:]:
                acc = acc + v.to(dev)
            return acc

        return self._collect("psum", x, total)

    def fold_exchange(self, words, scatter=False, kind=None, recv_bytes=(),
                      groups=1):
        """The fixed-order compensated fold of every shard's `words`,
        one gather-fold launch on the caller's device: `words` is this
        shard's tuple of word tensors ((hi, lo), or the collapsed word
        alone), each a contiguous (..., F, B, 3) float32 or bfloat16
        tensor of the same shape on every shard. The components are word
        0 of shards 0 .. W-1, then word 1 of shards 0 .. W-1 (the JAX
        exchanges' order). Returns the (..., F, B, 3) float32 fold or,
        with `scatter`, that of this shard's owned feature block [r *
        F / W, (r + 1) * F / W): (..., F / W, B, 3). `recv_bytes` are
        accounted under `kind`, one entry a collective of the wire model
        the exchange stands for; `groups` is the reduce-scatter's
        feature-group count (ProcessMesh sends one all_to_all a
        group)."""
        r = self.rank()
        w = self.n_shards
        dev = self.devices[r]
        for n in recv_bytes:
            self._account(kind, n)
        lead = words[0].shape[:-3]
        f, b, s = words[0].shape[-3:]
        if scatter and f % w:
            raise ValueError(f"fold_exchange: {f} features do not split "
                             f"into {w} owned blocks")
        f_out = f // w if scatter else f
        run, row = f_out * b * s, f * b * s
        off = r * run if scatter else 0

        def fold(vals):
            # a shard failed after the rendezvous: enqueue nothing
            if self._barrier.broken:
                raise MeshAborted("mesh collective 'fold_exchange' "
                                  "aborted: another shard failed")
            out = torch.empty((*lead, f_out, b, s), dtype=torch.float32,
                              device=dev)
            if self.multi_device:
                # a peer on another card: its part copied to this one
                comps = [((v[i].narrow(-3, off // (b * s), f_out)
                           if scatter else v[i]).to(dev).contiguous(), 0,
                          run) for i in range(len(words)) for v in vals]
            else:
                if dev.type == "cuda" and torch.cuda.current_stream(dev) \
                        != torch.cuda.default_stream(dev):
                    stream = torch.cuda.current_stream(dev)
                    for v in vals:
                        for t in v:
                            t.record_stream(stream)
                comps = [(v[i], off, row) for i in range(len(words))
                         for v in vals]
            return gather_fold(comps, math.prod(lead), run, out)

        return self._collect("fold_exchange", tuple(words), fold)


def _nbytes(x):
    return x.numel() * x.element_size()


def _wire(t):
    """The tensor the transport moves: bfloat16 travels as its bytes
    (gloo moves no 16-bit integers; the first axis, which the
    collectives split, keeps its length)."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


class ProcessMesh:
    """One shard a process of the torch.distributed process group (see
    the module doc): shard r is rank r, on this process's `device` (its
    card, or the CPU). `devices[r]` is that device for the one shard this
    process runs (`local_shards`)."""

    def __init__(self, device):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs a torch.distributed "
                               "process group (parallel/distributed.py "
                               "init_from_config)")
        w = dist.get_world_size()
        self.n_shards = w
        self.n_proc = w
        self._rank = dist.get_rank()
        self.local_shards = [self._rank]
        self.device = torch.device(device)
        self.devices = [self.device] * w
        transport = distributed.transport()
        if self.device.type == "cpu":
            if transport == "nccl":
                raise RuntimeError("an NCCL process group cannot move CPU "
                                   "tensors: this rank trains on the CPU")
        elif transport == "gloo":
            # a gloo group made for a card: its tensors go over the host
            transport = "gloo+pinned"
        self.transport = transport
        self._seq = 0
        self._digest = 0
        self.collective_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def describe(self):
        """{shards, processes, rank, devices, transport}."""
        return {"shards": self.n_shards, "processes": self.n_proc,
                "rank": self._rank, "devices": [str(self.device)],
                "transport": self.transport}

    # ------------------------------------------------------------ running
    def rank(self):
        """This process's shard: its rank."""
        return self._rank

    def run(self, fn):
        """fn(rank) in the caller with this process's device current, then
        the lockstep check; returns {rank: result}."""
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            out = fn(self._rank)
        self._check_lockstep()
        return {self._rank: out}

    def _step(self, name, t):
        """Advance the lockstep sequence and digest by one collective."""
        self._seq += 1
        self._digest = zlib.crc32(
            f"{name}{tuple(t.shape)}{t.dtype}".encode(), self._digest)

    def _check_lockstep(self):
        mine = np.asarray([self._seq, self._digest], dtype=np.int64)
        every = distributed.host_allgather(mine)
        if (every != mine).any():
            raise MeshLockstepError(
                f"ranks out of lockstep: rank {self._rank} reached "
                f"collective #{self._seq} (digest {self._digest:08x}), the "
                "ranks' (count, digest): " + ", ".join(
                    f"{int(c)}/{int(d):08x}" for c, d in every))

    def _account(self, kind, nbytes):
        if kind is not None:
            self.collective_bytes[kind] += int(nbytes)

    def _transfer(self, op, name, send, out):
        """The backend collective `op(out, send)` of the contiguous
        `send` into the contiguous receive buffer `out` on this device,
        synchronous on the current stream: over the group's own device
        tensors, or (gloo+pinned) through pinned host copies of both."""
        self._step(name, send)
        if self.transport == "gloo+pinned":
            hs = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
            hs.copy_(send, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            hr = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._backend(op, name, hr, hs)
            # the caching host allocator keeps hr until this copy ends
            out.copy_(hr, non_blocking=True)
        else:
            self._backend(op, name, out, send)
        return out

    def _backend(self, op, name, out, send):
        """The backend's collective; its failure (a peer is gone) raises
        MeshPeerLost."""
        t0 = time.monotonic() if heartbeat._TIMING_SINK is not None else None
        try:
            op(_wire(out), _wire(send))
            if t0 is not None:
                # the transport's own wait, apart from the guarded
                # section around it (telemetry/comm_profile.py)
                heartbeat.report_timing(f"mesh:{name}",
                                        time.monotonic() - t0)
        except RuntimeError as e:
            raise MeshPeerLost(
                f"collective {name!r} #{self._seq} failed on rank "
                f"{self._rank} ({self.transport}): {e}") from e

    def _gather(self, name, x):
        """(W, *x.shape): every rank's x in rank order."""
        w = self.n_shards
        send = x.contiguous().reshape(-1)
        out = torch.empty(w * send.numel(), dtype=x.dtype,
                          device=self.device)
        self._transfer(distributed.all_gather_flat, name, send.to(self.device),
                       out)
        return out.view(w, *x.shape)

    # -------------------------------------------------------- collectives
    def all_gather(self, x, kind=None):
        """(W, *x.shape): every shard's x stacked in shard order."""
        self._account(kind, allgather_recv_bytes(_nbytes(x), self.n_shards))
        return self._gather("all_gather", x)

    def all_to_all(self, x, split_axis, kind=None):
        """Tiled all-to-all (LocalMesh.all_to_all): piece j of x along
        `split_axis` goes to shard j; the received pieces concatenate in
        source order."""
        w = self.n_shards
        size = x.shape[split_axis]
        if size % w:
            raise ValueError(f"all_to_all: axis {split_axis} of size {size} "
                             f"does not split into {w} pieces")
        self._account(kind, alltoall_recv_bytes(_nbytes(x), w))
        front = x.movedim(split_axis, 0)
        send = front.contiguous().to(self.device)
        out = torch.empty_like(send)
        self._transfer(dist.all_to_all_single, "all_to_all", send, out)
        return out.movedim(0, split_axis).contiguous()

    def psum(self, x, kind=None):
        """Sum of every shard's x, added in shard order in x's dtype
        (LocalMesh.psum's bits): an all-gather, then the sum."""
        self._account(kind, psum_recv_bytes(_nbytes(x), self.n_shards))
        vals = self._gather("psum", x)
        acc = vals[0]
        for v in vals[1:]:
            acc = acc + v
        return acc

    def fold_exchange(self, words, scatter=False, kind=None, recv_bytes=(),
                      groups=1):
        """LocalMesh.fold_exchange over the process group: the shard's
        stacked words go out in one all-gather (or, with `scatter`, one
        all_to_all_single a group of 1/groups of each destination's owned
        block: its feature groups when one leaf is exchanged), and ONE
        gather-fold launch reads the receive buffer, word 0 of shards 0 ..
        W-1 and then word 1, into this shard's result."""
        w = self.n_shards
        for n in recv_bytes:
            self._account(kind, n)
        nw = len(words)
        lead = words[0].shape[:-3]
        f, b, s = words[0].shape[-3:]
        n_lead = math.prod(lead)
        stacked = torch.stack([t.to(self.device) for t in words])
        if not scatter:
            cells = n_lead * f * b * s
            recv = torch.empty(w * nw * cells, dtype=stacked.dtype,
                               device=self.device)
            self._transfer(distributed.all_gather_flat, "fold_exchange",
                           stacked.reshape(-1), recv)
            out = torch.empty((*lead, f, b, s), dtype=torch.float32,
                              device=self.device)
            comps = [(recv, (j * nw + i) * cells, f * b * s)
                     for i in range(nw) for j in range(w)]
            return gather_fold(comps, n_lead, f * b * s, out)
        if f % w:
            raise ValueError(f"fold_exchange: {f} features do not split "
                             f"into {w} owned blocks")
        f_loc = f // w
        block = n_lead * f_loc * b * s      # one destination's owned cells
        if groups < 1 or block % groups:
            raise ValueError(f"fold_exchange: {groups} groups do not tile "
                             f"an owned block of {block} cells")
        chunk = block // groups
        # (W destinations, words, owned block) in destination order
        per_dest = stacked.reshape(nw, n_lead, w, f_loc * b * s).permute(
            2, 0, 1, 3).reshape(w, nw, block)
        recv = torch.empty((groups, w, nw, chunk), dtype=stacked.dtype,
                           device=self.device)
        for g in range(groups):
            self._transfer(dist.all_to_all_single, "fold_exchange",
                           per_dest[:, :, g * chunk:(g + 1) * chunk]
                           .contiguous(), recv[g])
        out = torch.empty((*lead, f_loc, b, s), dtype=torch.float32,
                          device=self.device)
        # component (source j, word i): chunk g of its owned block at
        # recv[g, j, i], so one descriptor of `groups` rows covers it
        comps = [(recv, (j * nw + i) * chunk, w * nw * chunk)
                 for i in range(nw) for j in range(w)]
        return gather_fold(comps, groups, chunk, out)


def make_mesh(n_shards, device):
    """The learners' mesh: a ProcessMesh when this process is a rank of a
    process group of more than one process (n_shards must then be the
    world size), else a LocalMesh of n_shards shards on `device`."""
    if distributed.is_multi_host():
        w = distributed.num_processes()
        if int(n_shards) != w:
            Log.fatal("num_machines=%d but the process group has %d "
                      "ranks", int(n_shards), w)
        return ProcessMesh(device)
    return LocalMesh(n_shards, device)


# ------------------------------------------------------------ precision

COMM_PRECISIONS = ("pair", "f32", "bf16")


def resolve_comm_precision(config):
    """Validate the `comm_precision` knob: "pair" (default, the
    bit-parity Kahan-word exchange), "f32" (collapsed single word, half
    the bytes, deterministic but ~1e-7-relative), "bf16" (quarter the
    bytes, lossy)."""
    p = str(getattr(config, "comm_precision", "pair")).lower()
    if p not in COMM_PRECISIONS:
        Log.fatal("comm_precision must be one of %s, got [%s]",
                  "|".join(COMM_PRECISIONS), p)
    return p


def resolve_hist_exchange(config):
    """Validate `hist_exchange`: auto | reduce_scatter | allgather."""
    e = str(getattr(config, "hist_exchange", "auto")).lower()
    if e not in ("auto", "reduce_scatter", "allgather"):
        Log.fatal("hist_exchange must be auto|reduce_scatter|allgather, "
                  "got [%s]", e)
    return e


# ------------------------------------------------- exchange algorithms
#
# All operate on per-shard histograms of shape (..., F, B, 3) — the
# feature axis sits at ndim-3 (leading axes are frontier leaf batches).
# Each is one fold_exchange, whose fixed-order compensated fold (the JAX
# package's kahan_fold) carries the serial == data-parallel contract;
# the bytes it accounts are those of the JAX exchange's collectives
# under the wire models below: one all_gather of the stacked pair (or
# the word), or one all_to_all of it a feature group.

def _group_recv_bytes(word, mesh, n_shards, groups, words=1):
    """The all_to_all bytes of each feature group of `words` stacked
    words shaped like `word` (the JAX package's _scatter_feature_groups:
    a group sends its (..., W * fg, B, 3) block)."""
    w = mesh.n_shards
    if n_shards != w:
        raise ValueError(f"n_shards={n_shards} on a mesh of {w} shards")
    f_loc = word.shape[-3] // w
    if groups < 1 or f_loc % groups:
        raise ValueError(f"{groups} feature groups do not tile the owned "
                         f"block of {f_loc} features")
    block = words * word.numel() // groups * word.element_size()
    return [alltoall_recv_bytes(block, w)] * groups


def pair_allreduce(pair, mesh, kind="hist_reduce"):
    """Allgather-pair exchange: every shard's BOTH compensated words, the
    2W components folded in fixed order on every shard. Every shard ends
    with the identical FULL global histogram (`hist_exchange=allgather`,
    and bundled datasets)."""
    hi, lo = (t.contiguous() for t in pair)
    return mesh.fold_exchange((hi, lo), kind=kind, recv_bytes=[
        allgather_recv_bytes(2 * _nbytes(hi), mesh.n_shards)])


def _word(pair, precision):
    """The collapsed word a reduced-precision exchange sends."""
    hi, lo = pair
    word = hi + lo
    if precision == "bf16":
        word = word.to(torch.bfloat16)
    return word.contiguous()


def compressed_allreduce(pair, mesh, precision="f32", kind="hist_reduce"):
    """Allgather exchange at reduced precision: collapse the pair to one
    word per shard (half the bytes), optionally bf16 on the wire
    (quarter), fold the W words in fixed order."""
    word = _word(pair, precision)
    return mesh.fold_exchange((word,), kind=kind, recv_bytes=[
        allgather_recv_bytes(_nbytes(word), mesh.n_shards)])


def pair_reduce_scatter(pair, mesh, n_shards, groups=1, kind="hist_reduce"):
    """Reduce-scatter exchange at `comm_precision=pair`: the fixed-order
    Kahan fold of the 2W components of this shard's owned features —
    bit-identical per owned feature to what `pair_allreduce` computes
    for that feature, at 1/W of the wire bytes (one all_to_all of both
    words a feature group). Returns this shard's OWNED (..., f_loc, B,
    3) block."""
    hi, lo = (t.contiguous() for t in pair)
    return mesh.fold_exchange((hi, lo), scatter=True, kind=kind,
                              recv_bytes=_group_recv_bytes(
                                  hi, mesh, n_shards, groups, words=2),
                              groups=groups)


def compressed_reduce_scatter(pair, mesh, n_shards, groups=1,
                              precision="f32", kind="hist_reduce"):
    """Reduce-scatter at reduced precision: collapse the pair locally
    (half the pair bytes), optionally bf16 on the wire (quarter), fold
    the W words of the owned features in fixed source order (still
    deterministic, no longer serial-bit-parity)."""
    word = _word(pair, precision)
    return mesh.fold_exchange((word,), scatter=True, kind=kind,
                              recv_bytes=_group_recv_bytes(
                                  word, mesh, n_shards, groups),
                              groups=groups)


def compressed_psum(x, mesh, precision="pair", kind="hist_reduce"):
    """psum with the comm_precision compression applied at the wire:
    bf16 halves the on-wire word (and adds in bf16); "pair"/"f32" keep
    the plain f32 psum (the psum call sites — the partitioned cores, the
    voting learner's selective reduction — are already single-word)."""
    if precision == "bf16":
        return mesh.psum(x.to(torch.bfloat16), kind).to(torch.float32)
    return mesh.psum(x, kind)


# ------------------------------------------------------ wire-byte model
#
# Received bytes per rank for each collective, `nbytes` = one shard's
# input payload. Standard models: allgather receives every peer's
# payload; all_to_all receives 1/W of every peer's; ring allreduce
# (psum) moves the payload twice minus the local share.

def allgather_recv_bytes(nbytes, w):
    return int((w - 1) * nbytes)


def alltoall_recv_bytes(nbytes, w):
    return int((w - 1) * nbytes // max(w, 1))


def psum_recv_bytes(nbytes, w):
    return int(2 * (w - 1) * nbytes // max(w, 1))


class CommPlan:
    """Per-tree collective-byte ledger of one learner configuration.

    Collective shapes are static, so the learner declares, per kind, the
    bytes exchanged once per TREE (root build) and per SPLIT iteration;
    after each tree the booster accounts `per_tree(iterations)`.
    `account(counters, n)` adds them into a dict of
    `collective_bytes_{kind}` counters and their total
    `collective_bytes`, the learner's; the booster moves their growth
    into its metrics registry (models/gbdt.py _account_collectives)."""

    def __init__(self):
        self.root = {k: 0 for k in COLLECTIVE_KINDS}
        self.per_split = {k: 0 for k in COLLECTIVE_KINDS}

    def add(self, kind, root=0, per_split=0):
        if kind not in self.root:
            raise ValueError(f"unknown collective kind {kind!r}")
        self.root[kind] += int(root)
        self.per_split[kind] += int(per_split)
        return self

    def per_tree(self, n_splits):
        return {k: self.root[k] + self.per_split[k] * int(n_splits)
                for k in COLLECTIVE_KINDS}

    def account(self, counters, n_splits):
        total = 0
        for kind, nbytes in self.per_tree(n_splits).items():
            if nbytes:
                key = f"collective_bytes_{kind}"
                counters[key] = counters.get(key, 0) + nbytes
                total += nbytes
        if total:
            counters["collective_bytes"] = (counters.get("collective_bytes",
                                                         0) + total)
        return total


class MeshTopology:
    """The learner-facing view of one mesh: shard/process counts, feature
    ownership math and the resolved comm knobs. Rebuilt at every learner
    init."""

    def __init__(self, mesh, config=None):
        self.mesh = mesh
        self.n_shards = int(mesh.n_shards)
        self.n_proc = int(getattr(mesh, "n_proc", 1))
        self.comm_precision = resolve_comm_precision(config) \
            if config is not None else "pair"
        self.hist_exchange = resolve_hist_exchange(config) \
            if config is not None else "auto"
        groups = int(getattr(config, "comm_groups", 1) or 1) \
            if config is not None else 1
        self.comm_groups = max(groups, 1)

    def feature_shard(self, f_pad):
        """Owned-block length of a W-divisible padded feature count."""
        assert f_pad % self.n_shards == 0, (f_pad, self.n_shards)
        return f_pad // self.n_shards

    def owned_block(self, shard, f_pad):
        """(lo, hi) feature block shard `shard` owns (machines.py
        partition_features, the builder's `start = shard * f_loc`)."""
        return partition_features(f_pad, self.n_shards, shard)

    def owned_block_range(self, shard, num_blocks):
        """(lo, hi) BLOCK range rank `shard` owns over a shared block
        store (machines.py partition_blocks)."""
        return partition_blocks(num_blocks, self.n_proc, shard)

    def exchange_groups(self, f_loc):
        """Largest group count <= comm_groups dividing the owned block
        (group boundaries must tile f_loc exactly)."""
        g = min(self.comm_groups, max(f_loc, 1))
        while f_loc % g:
            g -= 1
        return g

    def describe(self, f_pad=None):
        d = {"shards": self.n_shards, "processes": self.n_proc,
             "precision": self.comm_precision,
             "exchange": self.hist_exchange}
        if f_pad is not None:
            f_loc = f_pad // self.n_shards if f_pad % self.n_shards == 0 \
                else None
            d["f_pad"] = int(f_pad)
            if f_loc is not None:
                d["f_loc"] = int(f_loc)
        return d


def shard_rows(n, n_shards):
    """[(lo, hi)] real rows of each shard of a row-sharded learner: the
    rows cut into W contiguous blocks of ceil(n / W) (the last ones
    shorter, possibly empty), as each process of the JAX package holds
    its block of a row-sharded dataset."""
    n_loc = -(-int(n) // int(n_shards))
    return [(min(r * n_loc, n), min((r + 1) * n_loc, n))
            for r in range(int(n_shards))]
