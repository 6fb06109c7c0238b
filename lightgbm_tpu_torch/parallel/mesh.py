"""The shard mesh and the communication layer of the parallel learners.

Port of lightgbm_tpu/parallel/mesh.py for one process. The JAX package
runs its learners' per-shard bodies under `shard_map` over a device mesh
(`make_mesh` :94) and exchanges through XLA collectives. Here:

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

import math
import threading

import torch

from ..ops.mesh_kernels import gather_fold
from ..utils.log import Log
from .machines import partition_blocks, partition_features

COLLECTIVE_KINDS = ("hist_reduce", "split_gather", "leaf_sync")


class MeshAborted(RuntimeError):
    """A collective could not complete: another shard failed or reached
    a different collective."""


class MeshLockstepError(MeshAborted):
    """Shards reached different collectives: the fault itself (the other
    shards' MeshAborted follow from it)."""


class LocalMesh:
    """W shards in one process, a thread each (see the module doc)."""

    def __init__(self, n_shards, device):
        w = int(n_shards)
        if w < 1:
            raise ValueError(f"a mesh needs at least one shard, got {w}")
        self.n_shards = w
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

    def fold_exchange(self, words, scatter=False, kind=None, recv_bytes=()):
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
        the exchange stands for."""
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
                                  hi, mesh, n_shards, groups, words=2))


def compressed_reduce_scatter(pair, mesh, n_shards, groups=1,
                              precision="f32", kind="hist_reduce"):
    """Reduce-scatter at reduced precision: collapse the pair locally
    (half the pair bytes), optionally bf16 on the wire (quarter), fold
    the W words of the owned features in fixed source order (still
    deterministic, no longer serial-bit-parity)."""
    word = _word(pair, precision)
    return mesh.fold_exchange((word,), scatter=True, kind=kind,
                              recv_bytes=_group_recv_bytes(
                                  word, mesh, n_shards, groups))


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
    `collective_bytes` (the port has no metrics registry yet: ROADMAP
    queue 1 item 7)."""

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
        self.n_proc = 1
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
