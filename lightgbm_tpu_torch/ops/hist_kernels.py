"""Histogram kernels: CUDA wrappers and their plain PyTorch versions.

Port of the three Pallas kernels of the JAX package:

  masked_hist    <- _hist_kernel     (lightgbm_tpu/ops/pallas_hist.py:62, :130)
  frontier_hist  <- _frontier_kernel (lightgbm_tpu/ops/pallas_hist.py:81, :177)
  seg_hist       <- _seg_hist_kernel (lightgbm_tpu/ops/ordered_hist.py:123, :156)

of the out-of-core pass's block fold, an XLA program there:

  hist_pair_fold <- hist_pair_fold_block / hist_pair_fold_collapse
                    (lightgbm_tpu/ops/histogram.py:277, :324)

and of the gather-compacted engine, an XLA program there:

  compact_rows   <- compact_gather_indices (lightgbm_tpu/ops/partition.py:44)
  compacted_hist <- compacted_histograms   (lightgbm_tpu/ops/histogram.py:573;
                    off the TPU its host route _compacted_bincount, :527)

The kernels live in lightgbm_tpu_torch/csrc/hist.cu, csrc/seg_hist.cu and
csrc/compact_hist.cu, on the chunk accumulator they share in
csrc/chunk_hist.cuh, and csrc/compact.cu (design and bound are noted
there). They are compiled, with the dataset's binning
kernel csrc/bin.cu (ops/bin_kernels.py), the LambdaRank pair
gradients csrc/rank.cu (ops/rank_kernels.py) and the parallel learners'
exchange fold csrc/mesh.cu (ops/mesh_kernels.py), with nvcc for sm_90a
at first use into csrc/build/ (one shared library with a C interface per source,
loaded with ctypes; its name hashes the source, the headers it includes
and the flags) and launched on PyTorch's current stream. Each wrapper
checks device, dtype, shape and contiguity, allocates its outputs and
scratch with torch.empty (the compaction kernels and the block fold take
their scratch from the caller where it has one, CompactScratch and
FoldScratch), raises when the launch
reports an error, and counts its launches in `KERNELS[name].launches`.
A launch made while the current stream captures a CUDA graph
(CapturedGraph) runs nothing yet: it is counted into the graph, and
each replay adds the graph's count.

Dispatch is by the tensors' device only: a CPU tensor takes the plain
version, a CUDA tensor the kernel (or an exception), anything else
raises. There is no fallback from a failed kernel to the plain version.

The plain versions compute the same function the same way: per
HIST_CHUNK-row chunk, a float32 partial accumulated in row order
(index_add_, sequential on the CPU), then the chunk-order Kahan fold of
lightgbm_tpu/ops/histogram.py build_histograms_pair, returning the
(value, residual) pair; seg_hist folds only the chunks that cover its
segment, compacted_hist the max(ceil(count / HIST_CHUNK), 1) chunks of
the compacted buffer, and hist_pair_fold one row block's chunks into a
running (acc, comp) carry (hist_pair_collapse ends the pass with
masked_hist's bits). On the CPU they equal the kernels bit for bit;
on a CUDA tensor index_add_ adds in an arbitrary order, so there they
agree to float32 rounding. The CPU tests use them; chip_smoke.py holds
each kernel against them. Nothing on the training path calls them when
its tensors are on the card.
"""

import contextlib
import ctypes
import gc
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

from ..telemetry import roofline

HIST_CHUNK = 4096

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
SOURCES = ("hist.cu", "seg_hist.cu", "compact.cu", "compact_hist.cu",
           "bin.cu", "rank.cu", "mesh.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# nvcc's output for each source this process built: ptxas's registers
# and spills of every kernel (-Xptxas -v)
BUILD_OUTPUT = {}

_BIN_BYTES = {torch.uint8: 1, torch.int16: 2}


class KernelStats:
    """Launch counter of one kernel wrapper: `launches` grows by one
    where the wrapper launches its kernel, and by a graph's captured
    count where CapturedGraph.replay launches it again; nowhere else."""

    def __init__(self, name):
        self.name = name
        self.launches = 0


# every kernel a CUDA graph of the trainer may capture: the histogram
# kernels and the LambdaRank pair gradients (ops/rank_kernels.py); and
# the out-of-core block fold and the mesh's exchange fold
# (ops/mesh_kernels.py), which run outside any graph
KERNELS = {name: KernelStats(name)
           for name in ("masked_hist", "frontier_hist", "seg_hist",
                        "compact_rows", "compacted_hist",
                        "lambdarank_pairs", "hist_pair_fold", "mesh_fold")}
# the launches recorded into the graph being captured (CapturedGraph)
_CAPTURED = None
# the shards of a parallel learner launch from threads of their own
# (parallel/mesh.py): counts and the first build are taken under a lock
_LOCK = threading.Lock()


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts():
    return {name: k.launches for name, k in KERNELS.items()}


def _count(name):
    """One launch of `name`'s kernel; while the current stream captures
    a graph it is recorded into that graph instead."""
    if torch.cuda.is_current_stream_capturing():
        if _CAPTURED is None:
            raise RuntimeError(f"{name} launched inside a CUDA graph capture "
                               "not made by CapturedGraph: its replays "
                               "would not be counted")
        _CAPTURED[name] += 1
    else:
        with _LOCK:
            KERNELS[name].launches += 1


class CapturedGraph:
    """A torch.cuda.CUDAGraph whose captured kernel launches count on
    every replay: `launches` holds what one replay launches."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches = {}

    @contextlib.contextmanager
    def capture(self, pool=None):
        """Capture the block's work on a side stream (torch.cuda.graph);
        raises when the capture fails. Python's cycle collector is run
        first and held off during the capture: a dead cycle that holds a
        pinned host tensor, freed mid-capture, queries CUDA events,
        which invalidates the capture."""
        global _CAPTURED
        _CAPTURED = dict.fromkeys(KERNELS, 0)
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                yield self
            self.launches = {k: v for k, v in _CAPTURED.items() if v}
        finally:
            _CAPTURED = None
            if collecting:
                gc.enable()

    def replay(self):
        self.graph.replay()
        for name, count in self.launches.items():
            KERNELS[name].launches += count


# ------------------------------------------------------------------ build

def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "lightgbm_tpu_torch are built with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _library_path(source, csrc=_CSRC):
    """Library file of `source`, named by a hash of the source, every
    csrc/*.cuh it includes (directly or through another header) and the
    flags, so that a changed header builds a new library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [source], set()
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(csrc, name), "rb") as f:
            text = f.read()
        digest.update(name.encode() + b"\0" + text)
        todo.extend(h.decode() for h in _INCLUDE.findall(text))
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(sources=SOURCES):
    """Compile every missing library, one nvcc process per source, all
    started together. Returns {source: library path}. Raises with the
    compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {s: _library_path(s) for s in sources}
    procs = {}
    for src, lib in paths.items():
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp)
    failed = []
    for src, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
            continue
        BUILD_OUTPUT[src] = out
        os.replace(tmp, paths[src])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def _bind_hist(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_hist.argtypes = [p, i, p, p, p, i, i, i, p, p, p, p]
    lib.masked_hist.restype = i
    lib.frontier_hist.argtypes = [p, i, p, p, p, i, i, i, i, p, p, p, p]
    lib.frontier_hist.restype = i
    lib.hist_status_string.argtypes = [i]
    lib.hist_status_string.restype = ctypes.c_char_p
    lib.hist_pair_fold.argtypes = [p, i, p, p, p, i, i, i, p, p, p, p, p]
    lib.hist_pair_fold.restype = i
    lib.hist_pair_fold_plan.argtypes = [i, i, i, p]
    lib.hist_pair_fold_plan.restype = i
    lib.hist_max_leaves.argtypes = []
    lib.hist_max_leaves.restype = i
    lib.max_leaves = lib.hist_max_leaves()


def _bind_seg_hist(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.seg_hist.argtypes = [p, p, p, i, i, i, p, p, p, p]
    lib.seg_hist.restype = i
    lib.seg_status_string.argtypes = [i]
    lib.seg_status_string.restype = ctypes.c_char_p


def _bind_compact(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.compact_rows.argtypes = [p, p, i, p, i, p, p, p]
    lib.compact_rows.restype = i
    lib.compact_scratch_ints.argtypes = [i]
    lib.compact_scratch_ints.restype = i
    lib.compact_status_string.argtypes = [i]
    lib.compact_status_string.restype = ctypes.c_char_p


def _bind_compact_hist(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.compacted_hist.argtypes = [p, p, i, i, p, p, p, i, i, i, p, p, p, p,
                                   p, p]
    lib.compacted_hist.restype = i
    lib.compacted_hist_route.argtypes = [i]
    lib.compacted_hist_route.restype = i
    lib.compacted_hist_partials.argtypes = [i, i, i]
    lib.compacted_hist_partials.restype = ctypes.c_long
    lib.compacted_hist_words.argtypes = [i, i]
    lib.compacted_hist_words.restype = i
    lib.compacted_hist_gathered.argtypes = [i, i, i]
    lib.compacted_hist_gathered.restype = ctypes.c_long
    lib.compact_hist_status_string.argtypes = [i]
    lib.compact_hist_status_string.restype = ctypes.c_char_p


def _bind_bin(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bin_dense.argtypes = [p, ctypes.c_longlong, i, p, i, p, i, p, i, i,
                              p]
    lib.bin_dense.restype = i
    lib.bin_status_string.argtypes = [i]
    lib.bin_status_string.restype = ctypes.c_char_p


def _bind_rank(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lambdarank_pairs.argtypes = [p, p, i, p, p, p, p, i, f, f, f, i, p,
                                     i, p, p, p]
    lib.lambdarank_pairs.restype = i
    lib.rank_smem_docs.argtypes = []
    lib.rank_smem_docs.restype = i
    lib.rank_status_string.argtypes = [i]
    lib.rank_status_string.restype = ctypes.c_char_p


def _bind_mesh(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.gather_fold.argtypes = [p, i, i, ll, ll, p, ll, p, p]
    lib.gather_fold.restype = i
    lib.gather_fold_max_comps.argtypes = []
    lib.gather_fold_max_comps.restype = i
    lib.mesh_status_string.argtypes = [i]
    lib.mesh_status_string.restype = ctypes.c_char_p


_BINDERS = {"hist.cu": _bind_hist, "seg_hist.cu": _bind_seg_hist,
            "compact.cu": _bind_compact,
            "compact_hist.cu": _bind_compact_hist, "bin.cu": _bind_bin,
            "rank.cu": _bind_rank, "mesh.cu": _bind_mesh}
_LOADED = {}


def _library(source):
    """The loaded library of one source (built and loaded once per
    process; every source is built together on the first call)."""
    with _LOCK:
        if source not in _LOADED:
            lib = ctypes.CDLL(build()[source])
            _BINDERS[source](lib)
            _LOADED[source] = lib
        return _LOADED[source]


# ------------------------------------------------------------- plain path

def leaf_slots(row_leaf, leaf_ids):
    """(N,) int64 position of each row's leaf in `leaf_ids` (distinct
    ids), -1 for rows outside the frontier."""
    eq = row_leaf[None, :] == leaf_ids.to(row_leaf.dtype)[:, None]
    return torch.where(eq.any(0), eq.to(torch.int8).argmax(0),
                       torch.full_like(row_leaf, -1, dtype=torch.int64))


def chunk_partials_plain(bins, ghc_t, slot, num_leaf, num_bins):
    """(chunks, L, F, B, K) float32 per-chunk partials of the (K, N)
    statistics: every (chunk, leaf, feature, bin) cell sums its rows'
    values in row order. A bin outside [0, num_bins) is dropped, as the
    kernels drop it."""
    f, n = bins.shape
    k_stats = ghc_t.shape[0]
    chunks = n // HIST_CHUNK
    dev = bins.device
    cells = chunks * num_leaf * f * num_bins
    chunk = torch.arange(n, device=dev) // HIST_CHUNK
    row_base = (chunk * num_leaf + slot) * f                   # (N,)
    b64 = bins.to(torch.int64)
    key = ((row_base[None, :] + torch.arange(f, device=dev)[:, None])
           * num_bins + b64)                                   # (F, N)
    keep = (slot[None, :] >= 0) & (b64 >= 0) & (b64 < num_bins)
    key = torch.where(keep, key, torch.full_like(key, cells)).reshape(-1)
    out = torch.zeros(k_stats, cells + 1, dtype=torch.float32, device=dev)
    for k in range(k_stats):
        out[k].index_add_(0, key, ghc_t[k].expand(f, n).reshape(-1))
    return (out[:, :cells].reshape(k_stats, chunks, num_leaf, f, num_bins)
            .permute(1, 2, 3, 4, 0))


def kahan_fold(partials, first=None, last=None):
    """Chunk-order f32 Kahan fold of (chunks, ...) partials ->
    (value, residual); residual = -comp (build_histograms_pair's sign
    convention), +0.0 where the compensation is zero. With `first` and
    `last` (0-d tensors) only chunks first..last are folded, without a
    host read: a trailing zero chunk would still change the bits."""
    acc = torch.zeros_like(partials[0])
    comp = torch.zeros_like(partials[0])
    if first is None:
        acc, comp = fold_carry(partials, acc, comp)
        return acc, (-comp) + 0.0
    for c in range(partials.shape[0]):
        y = partials[c] - comp
        t = acc + y
        take = (first <= c) & (c <= last)
        comp = torch.where(take, (t - acc) - y, comp)
        acc = torch.where(take, t, acc)
    return acc, (-comp) + 0.0


def fold_carry(partials, acc, comp):
    """kahan_fold's chunk-order arithmetic over all (chunks, ...)
    partials, seeded from the running carry (acc, comp) (comp in Kahan's
    sign, the negative residual) -> the new carry: what
    lightgbm_tpu/ops/histogram.py hist_pair_fold_block computes after
    its chunk partials."""
    for c in range(partials.shape[0]):
        y = partials[c] - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc, comp


def hist_pair_collapse(acc, comp):
    """The histogram of a finished out-of-core pass: acc + ((-comp) +
    0.0), the bits of masked_hist's value + residual over the whole
    array (hist_pair_fold_collapse)."""
    return acc + ((-comp) + 0.0)


def _check_shapes(bins, ghc_t, row_leaf, leaf_ids, num_bins):
    if bins.dim() != 2:
        raise ValueError(f"bins must be (F, N), got {tuple(bins.shape)}")
    f, n = bins.shape
    if n % HIST_CHUNK != 0 or n == 0:
        raise ValueError(f"N={n} must be a positive multiple of {HIST_CHUNK}")
    if bins.dtype not in _BIN_BYTES:
        raise TypeError(f"bins must be uint8 or int16, got {bins.dtype}")
    if ghc_t.shape != (3, n) or ghc_t.dtype != torch.float32:
        raise ValueError("ghc_t must be (3, N) float32")
    if row_leaf.shape != (n,) or row_leaf.dtype != torch.int32:
        raise ValueError("row_leaf (src) must be (N,) int32")
    if leaf_ids.dim() != 1 or leaf_ids.dtype != torch.int32:
        raise ValueError("leaf ids (cnt) must be a 1-D int32 tensor")
    if int(num_bins) < 1:
        raise ValueError("num_bins must be positive")
    for t in (ghc_t, row_leaf, leaf_ids):
        if t.device != bins.device:
            raise ValueError("all histogram inputs must be on one device")


def frontier_hist_plain(bins, ghc_t, row_leaf, leaf_ids, num_bins):
    """Plain version of frontier_hist: ((L, F, B, 3) value, residual)."""
    _check_shapes(bins, ghc_t, row_leaf, leaf_ids, num_bins)
    slot = leaf_slots(row_leaf, leaf_ids)
    parts = chunk_partials_plain(bins, ghc_t, slot, leaf_ids.shape[0],
                                 int(num_bins))
    return kahan_fold(parts)


def masked_hist_plain(bins, ghc_t, row_leaf, leaf_id, num_bins):
    """Plain version of masked_hist: ((F, B, 3) value, residual)."""
    hi, lo = frontier_hist_plain(bins, ghc_t, row_leaf,
                                 leaf_id.reshape(1), num_bins)
    return hi[0], lo[0]


def _check_carry(acc, comp, bins, num_bins):
    want = (bins.shape[0], int(num_bins), 3)
    for name, t in (("acc", acc), ("comp", comp)):
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or t.device != bins.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (F, B, 3) "
                             f"float32 tensor {want} on {bins.device}")


def hist_pair_fold_plain(acc, comp, bins, ghc_t, row_leaf, leaf_id,
                         num_bins):
    """Plain version of hist_pair_fold: the block's row-order chunk
    partials of the rows with row_leaf == leaf_id, folded into the carry
    (fold_carry), written into acc and comp, which it returns."""
    _check_shapes(bins, ghc_t, row_leaf, leaf_id, num_bins)
    _check_carry(acc, comp, bins, num_bins)
    slot = leaf_slots(row_leaf, leaf_id.reshape(1))
    parts = chunk_partials_plain(bins, ghc_t, slot, 1, int(num_bins))[:, 0]
    new_acc, new_comp = fold_carry(parts, acc, comp)
    acc.copy_(new_acc)
    comp.copy_(new_comp)
    return acc, comp


def unpack_words(words):
    """(W, N) int32 packed words -> (4W, N) int32 bins, feature f in
    byte f & 3 of word f >> 2 (the mask drops the sign extension)."""
    w, n = words.shape
    shifts = torch.arange(4, dtype=torch.int32, device=words.device) * 8
    return ((words[:, None, :] >> shifts[None, :, None]) & 0xFF).reshape(
        4 * w, n)


def chunk_cover(begin, cnt):
    """First and last HIST_CHUNK chunk covering the rows [begin,
    begin + cnt) (ordered_hist.py cover_index's arithmetic): an empty
    segment covers one chunk."""
    return begin // HIST_CHUNK, (begin + cnt.clamp(min=1) - 1) // HIST_CHUNK


def segment_cover(bounds, chunks):
    """(c_first, c_last) of a (2,) [begin, cnt] segment as 0-d int64
    tensors, clamped into the array's `chunks` chunks (a zero-length
    segment at the array's end covers the last chunk)."""
    begin = bounds[0].long()
    c_first, c_last = chunk_cover(begin, bounds[1].long().clamp(min=0))
    c_first = c_first.clamp(0, chunks - 1)
    return c_first, torch.maximum(c_last.clamp(max=chunks - 1), c_first)


def _check_seg_shapes(words, ghc_t, bounds, num_bins):
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("words must be a (W, N) int32 tensor")
    n = words.shape[1]
    if n % HIST_CHUNK != 0 or n == 0:
        raise ValueError(f"N={n} must be a positive multiple of {HIST_CHUNK}")
    if ghc_t.shape != (3, n) or ghc_t.dtype != torch.float32:
        raise ValueError("ghc_t must be (3, N) float32")
    if bounds.shape != (2,) or bounds.dtype != torch.int32:
        raise ValueError("bounds must be a (2,) int32 [begin, cnt] tensor")
    if not 1 <= int(num_bins) <= 256:
        raise ValueError("num_bins must be in [1, 256] for packed bins")
    for t in (ghc_t, bounds):
        if t.device != words.device:
            raise ValueError("all histogram inputs must be on one device")


def seg_hist_plain(words, ghc_t, bounds, num_bins):
    """Plain version of seg_hist: row-order partials of every chunk
    (rows outside the segment skipped), the covered chunks Kahan-folded
    in order -> ((4W, B, 3) value, residual)."""
    _check_seg_shapes(words, ghc_t, bounds, num_bins)
    n = words.shape[1]
    pos = torch.arange(n, device=words.device)
    begin = bounds[0].long()
    inside = (pos >= begin) & (pos < begin + bounds[1].long().clamp(min=0))
    slot = torch.where(inside, 0, -1)
    parts = chunk_partials_plain(unpack_words(words), ghc_t, slot, 1,
                                 int(num_bins))[:, 0]
    return kahan_fold(parts, *segment_cover(bounds, n // HIST_CHUNK))


def _check_compact_shapes(row_leaf, leaf_id, out_src, out_cnt):
    if row_leaf.dim() != 1 or row_leaf.dtype != torch.int32:
        raise ValueError("row_leaf must be an (N,) int32 tensor")
    if leaf_id.shape != (1,) or leaf_id.dtype != torch.int32:
        raise ValueError("leaf_id must be a (1,) int32 tensor")
    if out_src.dim() != 1 or out_src.dtype != torch.int32:
        raise ValueError("out_src must be a 1-D int32 tensor")
    if out_cnt.shape != (1,) or out_cnt.dtype != torch.int32:
        raise ValueError("out_cnt must be a (1,) int32 tensor")
    for t in (leaf_id, out_src, out_cnt):
        if t.device != row_leaf.device:
            raise ValueError("all compaction tensors must be on one device")


def compact_rows_plain(row_leaf, leaf_id, out_src, out_cnt):
    """Plain version of compact_rows: each row with row_leaf == leaf_id
    goes to its rank among them (a cumsum), by a scatter that drops the
    rest; positions past the count hold the sentinel N. Writes into
    out_src and out_cnt and returns them."""
    _check_compact_shapes(row_leaf, leaf_id, out_src, out_cnt)
    n, size = row_leaf.shape[0], out_src.shape[0]
    mask = row_leaf == leaf_id
    rank = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    dest = torch.where(mask & (rank < size), rank, size).long()
    buf = torch.full((size + 1,), n, dtype=torch.int32,
                     device=row_leaf.device)
    buf.scatter_(0, dest, torch.arange(n, dtype=torch.int32,
                                       device=row_leaf.device))
    out_src.copy_(buf[:size])
    out_cnt.copy_(mask.sum(dtype=torch.int32).reshape(1))
    return out_src, out_cnt


def _check_compacted_shapes(bins, ghc_t, src, cnt, num_bins):
    _check_shapes(bins, ghc_t, src, cnt, num_bins)
    if cnt.shape != (1,):
        raise ValueError("cnt must be a (1,) int32 tensor")


def compacted_hist_plain(bins, ghc_t, src, cnt, num_bins):
    """Plain version of compacted_hist: the rows src[:cnt] gathered in
    order, row-order partials of each HIST_CHUNK piece of the compacted
    buffer (rows past the count skipped), the max(ceil(cnt /
    HIST_CHUNK), 1) covered chunks Kahan-folded in order (chunk bounds
    from the device count, no host read) -> ((F, B, 3) value,
    residual)."""
    _check_compacted_shapes(bins, ghc_t, src, cnt, num_bins)
    n = bins.shape[1]
    pos = torch.arange(n, device=bins.device)
    count = cnt[0].long().clamp(min=0)
    idx = src.long().clamp(0, n - 1)          # the sentinel N -> any row
    slot = torch.where(pos < count, 0, -1)
    parts = chunk_partials_plain(bins.index_select(1, idx),
                                 ghc_t.index_select(1, idx), slot, 1,
                                 int(num_bins))[:, 0]
    first, last = chunk_cover(torch.zeros_like(count), count)
    return kahan_fold(parts, first, last.clamp(max=n // HIST_CHUNK - 1))


# ----------------------------------------------------------- CUDA wrappers

def _stream(dev):
    """PyTorch's current stream on `dev` (made current for the query
    only when it is not already)."""
    if dev.index == torch.cuda.current_device():
        return torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _scan_bytes(bins, words, num_bins, features=None):
    """Bytes a histogram call streams for the roofline table
    (telemetry/roofline.py): its bins, the (3, N) statistics and the
    (N,) row map read once, and `words` (F, B, 3) float32 words (its
    histograms or carry) written once."""
    n = bins.shape[-1]
    f = bins.shape[0] if features is None else features
    return (bins.numel() * bins.element_size() + 16 * n
            + int(words) * f * int(num_bins) * 12)


def _launch(name, bins, ghc_t, row_leaf, leaf_ids, num_bins):
    _check_shapes(bins, ghc_t, row_leaf, leaf_ids, num_bins)
    for t in (bins, ghc_t, row_leaf, leaf_ids):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    lib = _library("hist.cu")
    num_leaf = leaf_ids.shape[0]
    if not 1 <= num_leaf <= lib.max_leaves:
        raise ValueError(f"{name}: {num_leaf} leaves (at most "
                         f"{lib.max_leaves})")
    f, n = bins.shape
    b = int(num_bins)
    dev = bins.device
    partials = torch.empty((n // HIST_CHUNK) * num_leaf * f * b * 3,
                           dtype=torch.float32, device=dev)
    hi = torch.empty((num_leaf, f, b, 3), dtype=torch.float32, device=dev)
    lo = torch.empty_like(hi)
    common = (bins.data_ptr(), _BIN_BYTES[bins.dtype], ghc_t.data_ptr(),
              row_leaf.data_ptr(), leaf_ids.data_ptr())
    tail = (f, n, b, partials.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            _stream(dev))
    with roofline.timed(name, dev, lambda: _scan_bytes(bins, num_leaf, b),
                        n):
        if name == "masked_hist":
            status = lib.masked_hist(*common, *tail)
        else:
            status = lib.frontier_hist(*common, num_leaf, *tail)
    if status != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.hist_status_string(status).decode()}")
    _count(name)
    return hi, lo


def masked_hist(bins, ghc_t, row_leaf, leaf_id, num_bins):
    """((F, B, 3) value, residual) over rows with row_leaf == leaf_id.

    bins (F, N) uint8/int16 at stored width, N % HIST_CHUNK == 0;
    ghc_t (3, N) float32 (g*inbag, h*inbag, inbag); row_leaf (N,) int32;
    leaf_id a (1,) int32 tensor on the same device (read by the kernel
    from device memory, no host sync)."""
    if bins.device.type == "cpu":
        with roofline.timed("masked_hist", bins.device,
                            lambda: _scan_bytes(bins, 1, num_bins),
                            lambda: bins.shape[-1]):
            return masked_hist_plain(bins, ghc_t, row_leaf, leaf_id,
                                     num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"masked_hist: unsupported device {bins.device}")
    hi, lo = _launch("masked_hist", bins, ghc_t, row_leaf,
                     leaf_id.reshape(1), num_bins)
    return hi[0], lo[0]


def frontier_hist(bins, ghc_t, row_leaf, leaf_ids, num_bins):
    """((L, F, B, 3) value, residual) for L distinct leaf ids in one
    pass over the bins; arguments as masked_hist, leaf_ids (L,) int32."""
    if bins.device.type == "cpu":
        with roofline.timed("frontier_hist", bins.device,
                            lambda: _scan_bytes(bins, leaf_ids.shape[0],
                                                num_bins),
                            lambda: bins.shape[-1]):
            return frontier_hist_plain(bins, ghc_t, row_leaf, leaf_ids,
                                       num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"frontier_hist: unsupported device {bins.device}")
    return _launch("frontier_hist", bins, ghc_t, row_leaf, leaf_ids,
                   num_bins)


def fold_partials_floats(rows, num_feat, num_bins):
    """float32 words of hist_pair_fold's chunk partials for blocks of
    `rows` rows (csrc/hist.cu hist_pair_fold): a (chunk, feature) row of
    3 * num_bins cells padded to whole float4s."""
    return ((int(rows) // HIST_CHUNK) * int(num_feat)
            * ((3 * int(num_bins) + 3) // 4 * 4))


def fold_counter_ints(num_feat):
    """int32 words of hist_pair_fold's counters (csrc/hist.cu
    hist_pair_fold): two a feature tile (its blocks that counted their
    partial, and those that are done), at most a tile a feature."""
    return 2 * int(num_feat)


class FoldScratch:
    """Device buffers of hist_pair_fold for blocks of up to `rows` rows
    of `num_feat` features at num_bins, made once: the chunk partials
    (`partials`, fold_partials_floats) and the counters (`counters`,
    fold_counter_ints int32, zeroed here; every call leaves them zero).
    Calls that share one must run in order on one stream."""

    def __init__(self, rows, num_feat, num_bins, device):
        self.partials = torch.empty(
            fold_partials_floats(rows, num_feat, num_bins),
            dtype=torch.float32, device=device)
        self.counters = torch.zeros(fold_counter_ints(num_feat),
                                    dtype=torch.int32, device=device)


def _check_fold_scratch(scratch, bins, num_bins):
    f, n = bins.shape
    _scratch_tensor("hist_pair_fold partials", scratch.partials,
                    torch.float32, fold_partials_floats(n, f, num_bins),
                    bins.device)
    _scratch_tensor("hist_pair_fold counters", scratch.counters, torch.int32,
                    fold_counter_ints(f), bins.device)


def fold_plan(rows, num_feat, num_bins):
    """hist_pair_fold's launch on the current card for blocks of `rows`
    rows (csrc/hist.cu fold_plan): {"tile": features a block, "blocks":
    rows / HIST_CHUNK x tiles, "slices": fold slices a feature, "slice":
    float4 groups a slice, "smem": shared-memory bytes a block}."""
    lib = _library("hist.cu")
    out = (ctypes.c_int * 5)()
    status = lib.hist_pair_fold_plan(int(rows), int(num_feat), int(num_bins),
                                     out)
    if status != 0:
        raise RuntimeError("hist_pair_fold plan failed: "
                           f"{lib.hist_status_string(status).decode()}")
    return dict(zip(("tile", "blocks", "slices", "slice", "smem"), out))


def hist_pair_fold(acc, comp, bins, ghc_t, row_leaf, leaf_id, num_bins,
                   scratch=None):
    """Fold one out-of-core row block into the running Kahan carry of
    the rows with row_leaf == leaf_id, in place; returns (acc, comp).

    acc, comp (F, B, 3) float32, the carry of the pass's blocks before
    this one (zeros at the start of a pass; comp the negative residual);
    bins (F, R) uint8/int16, the block's bins, R % HIST_CHUNK == 0;
    ghc_t (3, R) float32 and row_leaf (R,) int32, the block's slices;
    leaf_id a (1,) int32 device tensor (no host sync). `scratch`, a
    FoldScratch for at least R rows, holds the kernel's partials and
    arrival counters (made for the call without it); it is checked on
    every device. On the card the call is one launch.
    hist_pair_collapse ends the pass."""
    _check_shapes(bins, ghc_t, row_leaf, leaf_id, num_bins)
    _check_carry(acc, comp, bins, num_bins)
    if scratch is not None:
        _check_fold_scratch(scratch, bins, num_bins)
    if bins.device.type == "cpu":
        with roofline.timed("hist_pair_fold", bins.device,
                            lambda: _scan_bytes(bins, 2, num_bins),
                            lambda: bins.shape[-1]):
            return hist_pair_fold_plain(acc, comp, bins, ghc_t, row_leaf,
                                        leaf_id, num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"hist_pair_fold: unsupported device {bins.device}")
    for t in (bins, ghc_t, row_leaf, leaf_id):
        if not t.is_contiguous():
            raise ValueError("hist_pair_fold: inputs must be contiguous")
    lib = _library("hist.cu")
    f, n = bins.shape
    b = int(num_bins)
    if scratch is None:
        scratch = FoldScratch(n, f, b, bins.device)
    with roofline.timed("hist_pair_fold", bins.device,
                        lambda: _scan_bytes(bins, 2, b), n):
        status = lib.hist_pair_fold(
            bins.data_ptr(), _BIN_BYTES[bins.dtype], ghc_t.data_ptr(),
            row_leaf.data_ptr(), leaf_id.data_ptr(), f, n, b,
            scratch.partials.data_ptr(), scratch.counters.data_ptr(),
            acc.data_ptr(), comp.data_ptr(), _stream(bins.device))
    if status != 0:
        raise RuntimeError("hist_pair_fold launch failed: "
                           f"{lib.hist_status_string(status).decode()}")
    _count("hist_pair_fold")
    return acc, comp


def compact_scratch_ints(n):
    """int32 words of compact_rows' scratch for n rows (csrc/compact.cu
    compact_scratch_ints): a ticket, an epoch, two spare, and a 64-bit
    look-back flag per 4096-row tile."""
    return 4 + 2 * max(-(-int(n) // HIST_CHUNK), 1)


# the two routes of compacted_hist (csrc/compact_hist.cu
# compacted_hist_route): one launch up to this many bins, else the chunk
# accumulator and its fold (two launches)
COMPACT_SORT_MAX_BINS = 2048


def compacted_hist_route(num_bins):
    """"sorted" (one launch: rows sorted by bin, a thread a bin, the
    fold in the same launch) up to COMPACT_SORT_MAX_BINS bins, else
    "accumulator" (the chunk accumulator of chunk_hist.cuh, then its
    fold)."""
    return "sorted" if int(num_bins) <= COMPACT_SORT_MAX_BINS else "accumulator"


def compacted_hist_scratch_sizes(n, num_feat, num_bins, bin_bytes):
    """(partials floats, words int32, gathered bytes) of compacted_hist's
    scratch (csrc/compact_hist.cu compacted_hist_partials, _words,
    _gathered): a (chunk, feature) partial row padded to whole float4s;
    the job ticket and the per-chunk and per-tile counters; the leaf's
    statistics and bins gathered in compacted order."""
    chunks = n // HIST_CHUNK
    pad = (3 * int(num_bins) + 3) // 4 * 4
    return (chunks * num_feat * pad, 1 + 2 * chunks + 2 * num_feat,
            12 * n + num_feat * n * int(bin_bytes))


def bin_rows(bins):
    """(N, R) row-major copy of (F, N) bins, each row padded with zeros to
    whole 16-byte pieces (R = 32 at 28 uint8 features): what
    compacted_hist's sorted route gathers a leaf's rows from, one sector
    a row where the feature-major matrix costs one a feature."""
    f, n = bins.shape
    per = 16 // bins.element_size()
    rows = torch.zeros((n, -(-f // per) * per), dtype=bins.dtype,
                       device=bins.device)
    rows[:, :f] = bins.t()
    return rows


class CompactScratch:
    """Device buffers of the compaction kernels for one caller over one
    (F, N) bin matrix, made once: compact_rows' look-back flags
    (`flags`, zeroed here; each call leaves them valid for the next,
    with no memset), the bins' row-major copy (`rows`, bin_rows) and
    compacted_hist's chunk partials (`partials`), counters (`words`,
    zeroed here and left zero by every call) and gathered rows
    (`gathered`), sized by compacted_hist_scratch_sizes. A learner keeps
    one so that a captured graph replays the same addresses and two
    learners never share a counter; two calls that share one must not
    run concurrently."""

    def __init__(self, bins, num_bins):
        f, n = bins.shape
        dev = bins.device
        partials, words, gathered = compacted_hist_scratch_sizes(
            n, f, num_bins, bins.element_size())
        self.flags = torch.zeros(compact_scratch_ints(n), dtype=torch.int32,
                                 device=dev)
        self.rows = bin_rows(bins)
        self.partials = torch.empty(partials, dtype=torch.float32,
                                    device=dev)
        self.words = torch.zeros(words, dtype=torch.int32, device=dev)
        self.gathered = torch.empty(gathered, dtype=torch.uint8, device=dev)

    def hist_kwargs(self):
        """compacted_hist's scratch arguments."""
        return {"rows": self.rows, "partials": self.partials,
                "words": self.words, "gathered": self.gathered}


def _scratch_tensor(name, t, dtype, numel, dev):
    if (t.dtype != dtype or t.device != dev or not t.is_contiguous()
            or t.numel() < numel):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"at least {numel} elements on {dev}")
    return t


def compact_rows(row_leaf, leaf_id, out_src, out_cnt, flags=None):
    """Stable compaction of the rows with row_leaf == leaf_id: out_src
    (size,) int32 receives their positions in original order, then the
    sentinel N; out_cnt (1,) int32 their number. leaf_id is a (1,) int32
    tensor; all four on one device, and on the card nothing is read by
    the host (the count stays in device memory). `flags`
    (CompactScratch.flags) is the kernel's look-back scratch, zeroed
    once by its owner; without it a zeroed one is made for the call.
    Returns (out_src, out_cnt)."""
    if row_leaf.device.type == "cpu":
        with roofline.timed("compact_rows", row_leaf.device,
                            lambda: 8 * row_leaf.numel(),
                            lambda: row_leaf.numel()):
            return compact_rows_plain(row_leaf, leaf_id, out_src, out_cnt)
    if row_leaf.device.type != "cuda":
        raise ValueError(f"compact_rows: unsupported device {row_leaf.device}")
    _check_compact_shapes(row_leaf, leaf_id, out_src, out_cnt)
    for t in (row_leaf, out_src):
        if not t.is_contiguous():
            raise ValueError("compact_rows: inputs must be contiguous")
    lib = _library("compact.cu")
    n = row_leaf.shape[0]
    dev = row_leaf.device
    need = lib.compact_scratch_ints(n)
    if flags is None:
        flags = torch.zeros(need, dtype=torch.int32, device=dev)
    _scratch_tensor("compact_rows flags", flags, torch.int32, need, dev)
    # the row map read, the positions written (at most one a row)
    with roofline.timed("compact_rows", dev, 8 * n, n):
        status = lib.compact_rows(row_leaf.data_ptr(), leaf_id.data_ptr(),
                                  n, out_src.data_ptr(), out_src.shape[0],
                                  out_cnt.data_ptr(), flags.data_ptr(),
                                  _stream(dev))
    if status != 0:
        raise RuntimeError("compact_rows launch failed: "
                           f"{lib.compact_status_string(status).decode()}")
    _count("compact_rows")
    return out_src, out_cnt


def compacted_hist(bins, ghc_t, src, cnt, num_bins, rows=None,
                   partials=None, words=None, gathered=None):
    """((F, B, 3) value, residual) over the rows src[:cnt] (compact_rows'
    output): bins (F, N) uint8/int16, N % HIST_CHUNK == 0; ghc_t (3, N)
    float32; src (N,) int32; cnt a (1,) int32 tensor on the same device
    (read by the kernel from device memory, no host sync). `rows` (the
    bins' bin_rows copy), `partials`, `words` and `gathered`
    (CompactScratch.hist_kwargs()) are the kernel's inputs and scratch;
    without them the call makes its own (words zeroed, rows copied from
    bins). The route (compacted_hist_route) follows num_bins."""
    if bins.device.type == "cpu":
        with roofline.timed("compacted_hist", bins.device,
                            lambda: _scan_bytes(bins, 1, num_bins),
                            lambda: bins.shape[-1]):
            return compacted_hist_plain(bins, ghc_t, src, cnt, num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"compacted_hist: unsupported device {bins.device}")
    _check_compacted_shapes(bins, ghc_t, src, cnt, num_bins)
    for t in (bins, ghc_t, src):
        if not t.is_contiguous():
            raise ValueError("compacted_hist: inputs must be contiguous")
    lib = _library("compact_hist.cu")
    f, n = bins.shape
    b = int(num_bins)
    dev = bins.device
    bin_bytes = _BIN_BYTES[bins.dtype]
    sorted_route = compacted_hist_route(b) == "sorted"
    if sorted_route:
        if rows is None:
            rows = bin_rows(bins)
        per = 16 // bin_bytes
        if (rows.dtype != bins.dtype or rows.device != dev
                or not rows.is_contiguous()
                or rows.shape != (n, -(-f // per) * per)):
            raise ValueError("compacted_hist rows must be bin_rows(bins)")
    sizes = (lib.compacted_hist_partials(n, f, b),
             lib.compacted_hist_words(n, f),
             lib.compacted_hist_gathered(n, f, bin_bytes))
    if partials is None:
        partials = torch.empty(sizes[0], dtype=torch.float32, device=dev)
    if words is None:
        words = torch.zeros(sizes[1], dtype=torch.int32, device=dev)
    if gathered is None:
        gathered = torch.empty(sizes[2], dtype=torch.uint8, device=dev)
    for name, t, dtype, size in (("partials", partials, torch.float32,
                                  sizes[0]),
                                 ("words", words, torch.int32, sizes[1]),
                                 ("gathered", gathered, torch.uint8,
                                  sizes[2])):
        _scratch_tensor(f"compacted_hist {name}", t, dtype, size, dev)
    hi = torch.empty((f, b, 3), dtype=torch.float32, device=dev)
    lo = torch.empty_like(hi)
    # the leaf's row count stays on the card: the bytes count the
    # whole array's (an upper bound)
    with roofline.timed("compacted_hist", dev,
                        lambda: _scan_bytes(bins, 1, b), n):
        status = lib.compacted_hist(
            bins.data_ptr(), rows.data_ptr() if sorted_route else None,
            rows.shape[1] if sorted_route else 0, bin_bytes,
            ghc_t.data_ptr(), src.data_ptr(), cnt.data_ptr(), f, n, b,
            partials.data_ptr(), words.data_ptr(), gathered.data_ptr(),
            hi.data_ptr(), lo.data_ptr(), _stream(dev))
    if status != 0:
        raise RuntimeError(
            "compacted_hist launch failed: "
            f"{lib.compact_hist_status_string(status).decode()}")
    _count("compacted_hist")
    return hi, lo


def seg_hist(words, ghc_t, bounds, num_bins):
    """((4W, B, 3) value, residual) over the leaf-ordered rows
    [begin, begin + cnt).

    words (W, N) int32 packed bins (four uint8 features per word),
    N % HIST_CHUNK == 0; ghc_t (3, N) float32 leaf-ordered statistics
    (g*inbag, h*inbag, inbag); bounds a (2,) int32 [begin, cnt] tensor
    on the same device (read by the kernel from device memory, no host
    sync); num_bins <= 256."""
    if words.device.type == "cpu":
        with roofline.timed("seg_hist", words.device,
                            lambda: _scan_bytes(words, 1, num_bins,
                                                features=4 * words.shape[0]),
                            lambda: words.shape[-1]):
            return seg_hist_plain(words, ghc_t, bounds, num_bins)
    if words.device.type != "cuda":
        raise ValueError(f"seg_hist: unsupported device {words.device}")
    _check_seg_shapes(words, ghc_t, bounds, num_bins)
    for t in (words, ghc_t, bounds):
        if not t.is_contiguous():
            raise ValueError("seg_hist: inputs must be contiguous")
    lib = _library("seg_hist.cu")
    w, n = words.shape
    f, b = 4 * w, int(num_bins)
    dev = words.device
    partials = torch.empty((n // HIST_CHUNK) * f * b * 3,
                           dtype=torch.float32, device=dev)
    hi = torch.empty((f, b, 3), dtype=torch.float32, device=dev)
    lo = torch.empty_like(hi)
    with roofline.timed("seg_hist", dev,
                        lambda: _scan_bytes(words, 1, b, features=f), n):
        status = lib.seg_hist(words.data_ptr(), ghc_t.data_ptr(),
                              bounds.data_ptr(), f, n, b,
                              partials.data_ptr(), hi.data_ptr(),
                              lo.data_ptr(), _stream(dev))
    if status != 0:
        raise RuntimeError("seg_hist launch failed: "
                           f"{lib.seg_status_string(status).decode()}")
    _count("seg_hist")
    return hi, lo
