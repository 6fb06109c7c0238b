"""Tree-traversal kernels: CUDA wrappers and their plain PyTorch versions.

The serving path's hot loop, a walk of every (row, tree) pair. The JAX
package runs it as XLA, not Pallas: device_traverse
(lightgbm_tpu/models/gbdt.py:65) under the jitted kernels of
lightgbm_tpu/serving/compiled_model.py:76-135. Here:

  tree_leaf    <- _leaf_kernel                     (B, T) int32 leaves
  tree_raw     <- _raw_kernel / _raw16_kernel      (B, K) float32 sums
  tree_lin_raw <- _linraw_kernel /                 (B, K) float32 sums of
                  _lintransformed_kernel (:138-192)  linear leaf values,
                                                   optionally transformed

in lightgbm_tpu_torch/csrc/traverse.cu (design and bound are noted
there), built at first use by hist_kernels.build (this source alone, so
a server does not wait for the histogram kernels) and loaded with
ctypes. A frozen model is a `Forest`: the (T, S) node
arrays the plain walk reads, and the same nodes packed into one 16-byte
record each (pack_nodes) and interleaved into tiles of 32 trees
(interleave), which is what the kernels read. A linear model's leaves
are `LinearLeaves`: one 64-byte record a leaf (pack_linear), which both
tree_lin_raw and its plain version read.

The kernels walk their trees from shared memory: a tile of 32 trees
copied in by TMA, a warp walking one row through a tile with lane j on
tree j. `plan` chooses each launch's shape from the call's (B, F, T, S,
K) and the card's SM count and shared memory: rows and threads a block,
tiles a block (tree_leaf spreads a small batch's tiles over blocks;
tree_raw walks the whole forest in a block and adds each (row, class)
sum there, in tree order, with rows shrunk until the sums fit) and a
window, window slots in shared memory, and staged rows. The kernel
checks the plan and lays out shared memory itself; a plan it refuses
raises. The bound is the walk's chain of dependent loads, not the bytes
moved (csrc/traverse.cu's header).

Dispatch is by the row tensor's device only: a CPU tensor takes the
plain version, a CUDA tensor the kernel (or an exception), anything else
raises. There is no fallback from a failed build or launch to the plain
version. A wrapper launches on PyTorch's current stream of the tensor's
own device, with that device made current for the launch (the serving
batcher's worker and the HTTP handler threads call it), allocates its
output per call (nothing shared across threads) and counts its
launches in `KERNELS[name].launches` under a lock.

The plain versions are the lockstep walk of models/gbdt.py
device_traverse and, for tree_raw, f32 adds of the leaf values in tree
order, the kernel's order: on the same inputs they give the kernel's
bits. tree_lin_raw_plain adds each lane's coefficient slots in order
0..7 (a product rounded before its add, a dead or NaN slot adding 0.0)
and then the lanes in tree order, and transforms with explicit f32
operations in the kernel's order, so it too gives the kernel's bits. A
walk cut short by `depth` (not a valid model) reads leaf 0 in tree_raw
and tree_lin_raw, in both.
"""

import ctypes
import functools
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..telemetry.ledger import LEDGER
from . import hist_kernels

SOURCE = "traverse.cu"

KERNELS = {name: hist_kernels.KernelStats(name)
           for name in ("tree_leaf", "tree_raw", "tree_lin_raw")}
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB = None
# seconds the library took to build in this process, and whether it was
# found already built in csrc/build/ (CompiledPredictor.warm_up reads
# both)
LOAD_INFO = {}

_CATEGORICAL_BIT = np.int32(-(1 << 31))
# coefficient slots of a linear leaf (the JAX package's COEF_PAD; kCoefPad)
COEF_PAD = 8
# 32-bit words of a linear leaf's record (pack_linear; LinRecord), and
# the columns a record's 20-bit ids reach
REC_WORDS = 16
MAX_COLUMNS = 1 << 20
# tree_lin_raw's output transforms (csrc/traverse.cu Transform)
TRANSFORMS = {"raw": 0, "sigmoid": 1, "softmax": 2}


def reset_launch_counts():
    with _COUNT_LOCK:
        for k in KERNELS.values():
            k.launches = 0


def launch_counts():
    with _COUNT_LOCK:
        return {name: k.launches for name, k in KERNELS.items()}


def _count(name):
    with _COUNT_LOCK:
        KERNELS[name].launches += 1


class Forest(NamedTuple):
    """A frozen ensemble on one device: (T, S) split feature (int32),
    f32-safe threshold (float32), categorical flag (bool), left and
    right child (int32, a leaf is ~leaf); (T,) root state node0 (0, or
    ~0 for a single-leaf tree); `depth` the walk's step count; `width`
    the least row width (largest split feature + 1); `tiles` the packed
    records interleaved (interleave), which the kernels read;
    `categorical` whether any node is categorical."""
    sf: torch.Tensor
    thr: torch.Tensor
    cat: torch.Tensor
    lc: torch.Tensor
    rc: torch.Tensor
    node0: torch.Tensor
    depth: int
    width: int
    tiles: torch.Tensor
    categorical: bool


class LinearLeaves(NamedTuple):
    """A frozen forest's linear leaves on one device: `rec`, the (T, L,
    REC_WORDS) int32 records (pack_linear), one a (tree, leaf) like the
    leaf values; `dtype` the type their intercepts, coefficients and leaf
    values were rounded to (float32 or bfloat16, the serving precision's;
    a record holds them widened to float32, which is exact); `width` the
    least row width (largest live column + 1)."""
    rec: torch.Tensor
    dtype: torch.dtype
    width: int


def pack_linear(const, coef, feat, cnt, values):
    """(T, L, REC_WORDS) int32 records of linear leaves from (T, L)
    float32 intercepts, (T, L, COEF_PAD) float32 coefficients and int32
    columns (below 2^20, zero in dead slots), (T, L) int32 live counts
    and (T, L) float32 leaf values: one 64-byte record a leaf, which the
    kernel reads as four 16-byte loads (csrc/traverse.cu LinRecord): word
    0 the intercept's bits, 1..8 the coefficients', 9..12 the columns'
    low 16 bits (two a word, the even slot low), 13 their bits 16..19 (a
    nibble a slot, slot j at bit 4j), 14 the leaf value's bits (what a
    constant lane returns), 15 the count."""
    t, l = cnt.shape
    rec = np.zeros((t, l, REC_WORDS), np.uint32)
    rec[..., 0] = np.ascontiguousarray(const, np.float32).view(np.uint32)
    rec[..., 1:9] = np.ascontiguousarray(coef, np.float32).view(np.uint32)
    col = np.asarray(feat, np.int64).astype(np.uint32)
    low = col & 0xFFFF
    rec[..., 9:13] = low[..., 0::2] | (low[..., 1::2] << 16)
    rec[..., 13] = np.bitwise_or.reduce(
        ((col >> 16) & 0xF) << (4 * np.arange(COEF_PAD, dtype=np.uint32)),
        axis=-1)
    rec[..., 14] = np.ascontiguousarray(values, np.float32).view(np.uint32)
    rec[..., 15] = np.asarray(cnt, np.int32).view(np.uint32)
    return rec.view(np.int32)


def unpack_linear(lin):
    """(const, coef, feat, cnt, values) of LinearLeaves as tensors on its
    device, decoded from the records: (T, L) and (T, L, COEF_PAD) float32
    (the stored values widened), int32 columns, (T, L) int32 counts and
    (T, L) float32 leaf values."""
    rec = lin.rec
    words = rec.to(torch.int64) & 0xFFFFFFFF
    low = torch.stack([words[..., 9 + j // 2] >> (16 * (j % 2))
                       for j in range(COEF_PAD)], dim=-1) & 0xFFFF
    high = torch.stack([words[..., 13] >> (4 * j)
                        for j in range(COEF_PAD)], dim=-1) & 0xF
    return (rec[..., 0].view(torch.float32), rec[..., 1:9].view(torch.float32),
            (low | (high << 16)).to(torch.int32), rec[..., 15],
            rec[..., 14].view(torch.float32))


def freeze_linear(const, coef, feat, cnt, values, dtype, device):
    """LinearLeaves on `device` from host (T, L) / (T, L, C <= COEF_PAD)
    arrays and the (T, L) leaf values, the slot axis zero-padded to
    COEF_PAD; intercepts, coefficients and leaf values rounded to `dtype`
    (torch.float32 or torch.bfloat16; through float32, as the JAX package
    casts) and packed with the live columns and counts into records
    (pack_linear). Columns are 20-bit in a record: a live column of 2^20
    or more raises."""
    coef = np.asarray(coef)
    c = coef.shape[2]
    if c > COEF_PAD:
        raise ValueError(f"linear leaves have {c} coefficients, the kernel "
                         f"takes at most COEF_PAD={COEF_PAD}")
    pad = ((0, 0), (0, 0), (0, COEF_PAD - c))
    feat = np.asarray(feat, np.int32)
    cnt = np.asarray(cnt, np.int32)
    live = np.arange(c)[None, None, :] < cnt[:, :, None]
    if (feat[live] < 0).any():
        raise ValueError("linear leaves' feature columns must be "
                         "non-negative")
    width = int(feat[live].max()) + 1 if live.any() else 1
    if width > MAX_COLUMNS:
        raise ValueError(f"linear leaves read column {width - 1}; a linear "
                         "record holds columns below 2^20")

    def stored(a):
        # rounded to the storage type, widened back exactly
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, np.float64).astype(np.float32))).to(dtype).to(
                torch.float32).numpy()

    rec = pack_linear(stored(const), stored(np.pad(coef, pad)),
                      np.pad(np.where(live, feat, 0), pad), cnt,
                      stored(values))
    return LinearLeaves(torch.from_numpy(rec).to(device), dtype, width)


def pack_nodes(sf, thr32, is_cat, lc, rc):
    """(T, S, 4) int32 node records: split feature with the categorical
    flag in bit 31, the threshold's float32 bits, left child, right
    child."""
    sf = np.asarray(sf, np.int32)
    if sf.size and sf.min() < 0:
        raise ValueError("split features must be non-negative")
    feat = np.where(np.asarray(is_cat, bool), sf | _CATEGORICAL_BIT, sf)
    thr_bits = np.ascontiguousarray(thr32, np.float32).view(np.int32)
    return np.ascontiguousarray(np.stack(
        [feat, thr_bits, np.asarray(lc, np.int32),
         np.asarray(rc, np.int32)], axis=-1).astype(np.int32))


def freeze(sf, thr32, is_cat, lc, rc, node0, depth, device):
    """A Forest on `device` from host (T, S) arrays (thr32 already the
    f32-safe cast, models/gbdt.py f32_safe_thresholds)."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    sf = np.asarray(sf, np.int32)
    rec = pack_nodes(sf, thr32, is_cat, lc, rc)
    return Forest(put(sf, np.int32), put(thr32, np.float32),
                  put(is_cat, np.bool_), put(lc, np.int32),
                  put(rc, np.int32), put(node0, np.int32), int(depth),
                  int(sf.max()) + 1 if sf.size else 1,
                  put(interleave(rec), np.int32),
                  bool(np.asarray(is_cat, bool).any()))


# ------------------------------------------------------------ launch plan

TILE = 32              # trees a tile interleaves (kTile): a warp's lanes
# dynamic shared memory a block may opt in to on sm_90 (H100), for
# planning without a card; the wrappers ask the card
SMEM_OPTIN_SM90 = 232_448
SMS_H100 = 132
ROW_BYTES = 64 << 10   # a block's staged rows at most
SUM_BYTES = 16 << 10   # tree_raw: a block's (rows, K) class sums at most,
                       # unless one row needs more
MAX_GROUPS = 65535     # grid.y


class Plan(NamedTuple):
    """One launch: `rows` a block, `group` tiles of 32 trees a block
    (grid.y = ceil(tiles / group); tree_raw: all of them), `window`
    tiles walked between two barriers, `slots` shared-memory windows (2:
    a ring, the next window's copy overlapping this one's walks; 0:
    records read from device memory), `stage_rows`, the dynamic shared
    memory it takes (`smem`, csrc/traverse.cu layout()), and threads a
    block."""
    rows: int
    group: int
    window: int
    slots: int
    stage_rows: bool
    smem: int
    threads: int

    def grid(self, b, t):
        return -(-b // self.rows), -(-(-(-t // TILE)) // self.group)

    def args(self, categorical):
        """The kernel's plan argument; `categorical`: the forest has
        categorical nodes (Forest.categorical)."""
        return (ctypes.c_int * 7)(self.rows, self.group, self.window,
                                  self.slots, int(self.stage_rows),
                                  int(categorical), self.threads)


def smem_bytes(rows, group, window, slots, stage_rows, f, s, k, sums):
    """Bytes of dynamic shared memory of a block (csrc/traverse.cu
    layout(): a 128-byte head, the window slots, the roots, the rows, and
    when summing the window's leaf values and the class sums; a group of
    more than one window keeps two buffers of roots and of values)."""
    def a16(n):
        return (n + 15) & ~15
    bufs = 2 if group > window else 1
    wt = window * TILE
    return (128 + a16(slots * wt * s * 16) + a16(bufs * wt * 4)
            + (a16(rows * (f | 1) * 4) if stage_rows else 0)
            + (a16(bufs * rows * (wt | 1) * 4) + a16(rows * k * 4)
               if sums else 0))


def plan(b, f, t, s, num_class=None, sms=SMS_H100,
         smem_limit=SMEM_OPTIN_SM90):
    """The launch plan of tree_leaf (num_class None) or tree_raw on B
    rows of F features through T trees of S node slots (T / 32 tiles),
    as measured best on the H100 (PERF.md, the traversal findings).

    Rows a block: about B x tiles / `sms` (up to 64; 32 for tree_raw),
    so that small batches still fill the SMs and large ones copy each
    tile into few blocks; tree_raw's rows shrink until their (rows, K)
    sums take at most SUM_BYTES (one row at least). tree_leaf: a tile a
    block (grid.y = tiles). tree_raw: the whole forest a block, the class
    sums added there. A block keeps its whole group in shared memory
    when that fits and the grid is under one wave of blocks (or the
    group is one tile); otherwise a ring of two one-tile windows;
    otherwise one; otherwise the records are read from device memory.
    Threads a block: a (tile, row) item of a window a warp, 256 to
    1024. A plan whose sums alone exceed `smem_limit` is returned as it
    is; the kernel refuses it and the wrapper raises."""
    ntiles = -(-t // TILE)
    sums = num_class is not None
    rows = min(32 if sums else 64, max(1, -(-b * ntiles // sms)))
    if sums:
        rows = max(1, min(rows, SUM_BYTES // (4 * num_class)))
    row_blocks = -(-b // rows)
    group = ntiles if sums else -(-ntiles // MAX_GROUPS)
    groups = -(-ntiles // group)
    stage_rows = rows * (f | 1) * 4 <= ROW_BYTES

    def size(win, slots):
        return smem_bytes(rows, group, win, slots, stage_rows, f, s,
                          num_class or 1, sums)

    options = [(group, 1)] if group == 1 or row_blocks * groups < sms else []
    for win, slots in options + [(1, 2), (1, 1)]:
        if size(win, slots) <= smem_limit:
            break
    else:  # not one tile fits: records read from device memory
        win, slots = 1, 0
    threads = min(1024, max(256, 32 * rows * (win if slots else 1)))
    return Plan(rows, group, win, slots, stage_rows, size(win, slots),
                threads)


def interleave(rec):
    """The kernels' (ceil(T / 32), S, 32, 4) int32 tiles of the (T, S, 4)
    records (pack_nodes): record n of tree t at [t // 32, n, t % 32], so
    that a warp's lanes, one tree each, read consecutive 16-byte words
    (no shared-memory bank conflict) and a tile is one contiguous copy.
    Each record holds byte offsets, so that a step of the walk computes no
    index: the split feature times 4 (the categorical flag stays in bit
    31), and each child that is a node times 512 (a record's offset in its
    tree's column of the tile); a leaf child stays ~leaf. The trees that
    pad the last tile are all zeros and never walked."""
    rec = np.asarray(rec, np.int32)
    t, s = rec.shape[:2]
    ntiles = -(-t // TILE)
    feat = rec[..., 0]
    cat = feat < 0
    scaled = np.stack([
        np.where(cat, (feat & 0x7FFFFFFF) * 4 | _CATEGORICAL_BIT, feat * 4),
        rec[..., 1],
        np.where(rec[..., 2] >= 0, rec[..., 2] * TILE * 16, rec[..., 2]),
        np.where(rec[..., 3] >= 0, rec[..., 3] * TILE * 16, rec[..., 3])],
        axis=-1).astype(np.int32)
    out = np.zeros((ntiles * TILE, s, 4), np.int32)
    out[:t] = scaled
    return np.ascontiguousarray(
        out.reshape(ntiles, TILE, s, 4).transpose(0, 2, 1, 3))


# ------------------------------------------------------------- plain path

def _check(x, forest, name):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: rows must be a (B, F) float32 tensor")
    if x.shape[1] < forest.width:
        raise ValueError(f"{name}: rows have {x.shape[1]} features, the "
                         f"trees split on feature {forest.width - 1}")
    if forest.tiles.device != x.device:
        raise ValueError(f"{name}: rows and trees on different devices")


def tree_leaf_plain(x, forest):
    """(B, T) int32 leaf indices by the lockstep walk."""
    from ..models.gbdt import device_traverse
    _check(x, forest, "tree_leaf")
    node = device_traverse(x, forest.sf, forest.thr, forest.cat, forest.lc,
                           forest.rc, forest.node0, forest.depth)
    return (~node).to(torch.int32)


def _check_values(forest, lv, num_class):
    t = forest.sf.shape[0]
    if lv.dim() != 2 or lv.shape[0] != t:
        raise ValueError(f"tree_raw: leaf values must be (T={t}, L)")
    if lv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("tree_raw: leaf values must be float32 or bfloat16")
    if lv.device != forest.tiles.device:
        raise ValueError("tree_raw: leaf values and trees on different "
                         "devices")
    if int(num_class) < 1:
        raise ValueError("tree_raw: bad class count")


def tree_raw_plain(x, forest, lv, num_class):
    """(B, K) float32 sums: tree t adds its leaf value (bf16 widened to
    f32) to class t % K, in tree order; a walk cut short by `depth`
    reads leaf 0."""
    _check_values(forest, lv, num_class)
    leaves = tree_leaf_plain(x, forest).long().clamp(min=0)
    num_trees = leaves.shape[1]
    t_idx = torch.arange(num_trees, device=x.device)
    vals = lv[t_idx[None, :], leaves].float()                 # (B, T)
    acc = torch.zeros((x.shape[0], num_class), dtype=torch.float32,
                      device=x.device)
    for t in range(num_trees):
        acc[:, t % num_class] += vals[:, t]
    return acc


def _check_linear(x, forest, lv, lin):
    if x.shape[1] < lin.width:
        raise ValueError(f"tree_lin_raw: rows have {x.shape[1]} features, "
                         f"a linear leaf reads feature {lin.width - 1}")
    want = (*lv.shape, REC_WORDS)
    if tuple(lin.rec.shape) != want or lin.rec.dtype != torch.int32:
        raise ValueError(f"tree_lin_raw: records must be {want} int32, got "
                         f"{tuple(lin.rec.shape)} {lin.rec.dtype}")
    if lin.rec.device != lv.device:
        raise ValueError("tree_lin_raw: linear leaves and trees on "
                         "different devices")
    if lin.dtype != lv.dtype:
        raise TypeError("tree_lin_raw: intercepts and coefficients must be "
                        "stored as the leaf values are")


def linear_leaf_values_plain(x, leaves, lin):
    """(B, T) float32 value of each (row, tree) lane at its leaf, from
    the records: the linear leaf's const + coefficient slots added in
    order 0..7 (each product rounded, a dead or NaN slot adding 0.0), or
    the constant leaf value where cnt is 0 or a live feature is NaN (the
    JAX package's _linear_leaf_values, in a fixed slot order)."""
    b, t = leaves.shape
    t_idx = torch.arange(t, device=x.device)[None, :]
    const, coef, feat, cnt, values = unpack_linear(lin)
    base = values[t_idx, leaves]
    acc = const[t_idx, leaves]
    cn = cnt[t_idx, leaves]
    co = coef[t_idx, leaves]                                  # (B, T, C)
    ft = feat[t_idx, leaves].long()
    xf = torch.gather(x, 1, ft.reshape(b, -1)).reshape(b, t, COEF_PAD)
    nan = torch.zeros_like(cn, dtype=torch.bool)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(COEF_PAD):
        live = cn > j
        xj = xf[..., j]
        isnan = torch.isnan(xj)
        acc = acc + torch.where(live & ~isnan, co[..., j] * xj, zero)
        nan = nan | (live & isnan)
    return torch.where((cn > 0) & ~nan, acc, base)


def transform_plain(raw, num_class, sigmoid):
    """The kernel's transform of (B, K) float32 sums: sigmoid 1 / (1 +
    exp(f32(-2 sigmoid) * raw)) when K == 1 and sigmoid > 0, a softmax
    (max, exp of the differences, their sum from class 0 up, each exp
    over the sum) when K > 1, else the sums."""
    if num_class == 1 and sigmoid > 0:
        return 1.0 / (1.0 + torch.exp((-2.0 * sigmoid) * raw))
    if num_class > 1:
        m = raw[:, 0]
        for c in range(1, num_class):
            m = torch.maximum(m, raw[:, c])
        e = [torch.exp(raw[:, c] - m) for c in range(num_class)]
        total = e[0]
        for c in range(1, num_class):
            total = total + e[c]
        return torch.stack([ec / total for ec in e], dim=1)
    return raw


def _transform_kind(transform, num_class, sigmoid):
    if not transform:
        return "raw"
    if num_class == 1 and sigmoid > 0:
        return "sigmoid"
    return "softmax" if num_class > 1 else "raw"


def tree_lin_raw_plain(x, forest, lv, lin, num_class, transform=False,
                       sigmoid=-1.0):
    """(B, K) float32: tree t adds its lane's linear leaf value (from
    the records, as the kernel reads them) to class t % K in tree order
    (a walk cut short reads leaf 0), then, with `transform`,
    transform_plain."""
    _check_values(forest, lv, num_class)
    _check_linear(x, forest, lv, lin)
    leaves = tree_leaf_plain(x, forest).long().clamp(min=0)
    vals = linear_leaf_values_plain(x, leaves, lin)
    acc = torch.zeros((x.shape[0], num_class), dtype=torch.float32,
                      device=x.device)
    for t in range(vals.shape[1]):
        acc[:, t % num_class] += vals[:, t]
    if _transform_kind(transform, num_class, sigmoid) == "raw":
        return acc
    return transform_plain(acc, num_class, sigmoid)


# ----------------------------------------------------------- CUDA wrappers

def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tree_leaf.argtypes = [p, i, i, p, p, i, i, i, p, p, p]
    lib.tree_leaf.restype = i
    for fn in (lib.tree_raw_f32, lib.tree_raw_bf16):
        fn.argtypes = [p, i, i, p, p, i, i, i, p, i, i, p, p, p]
        fn.restype = i
    lib.tree_lin_raw.argtypes = [p, i, i, p, p, i, i, i, p, i, i, i,
                                 ctypes.c_float, p, p, p]
    lib.tree_lin_raw.restype = i
    lib.traverse_smem_optin.argtypes = [i]
    lib.traverse_smem_optin.restype = i
    lib.traverse_status_string.argtypes = [i]
    lib.traverse_status_string.restype = ctypes.c_char_p


def library():
    """The loaded traversal library, built or found built at the first
    call of the process; LOAD_INFO records which and how long."""
    global _LIB
    if _LIB is not None:   # set once, after binding
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path = hist_kernels._library_path(SOURCE)
            hit = os.path.exists(path)
            t0 = time.perf_counter()
            lib = ctypes.CDLL(hist_kernels.build((SOURCE,))[SOURCE])
            _bind(lib)
            LOAD_INFO.update(cache_hit=hit,
                             seconds=time.perf_counter() - t0, path=path)
            LEDGER.record("kernel_library", LOAD_INFO["seconds"],
                          cache_hit=hit)
            _LIB = lib
        return _LIB


@functools.lru_cache(maxsize=None)
def _card_limits(index):
    """(SM count, opt-in shared memory bytes) of CUDA device `index`."""
    lib = library()
    optin = lib.traverse_smem_optin(index)
    if optin <= 0:
        raise RuntimeError("traversal: cannot read the card's shared memory "
                           "limit: " + lib.traverse_status_string(
                               -optin).decode())
    return torch.cuda.get_device_properties(index).multi_processor_count, optin


@functools.lru_cache(maxsize=4096)
def _planned(b, f, t, s, num_class, index, categorical):
    """plan() on device `index`, its ctypes argument and that argument's
    address, once a shape (a server launches the same few buckets; the
    kernel's host code only reads the argument, and the cache keeps it
    alive)."""
    sms, optin = _card_limits(index)
    p = plan(b, f, t, s, num_class, sms=sms, smem_limit=optin)
    arg = p.args(categorical)
    return p, arg, ctypes.addressof(arg)


def _launch(name, fn, x, forest, num_class, extra, out):
    """Plan and launch one call; `extra` are tree_raw's leaf-value
    arguments (pointer, L, K), or tree_lin_raw's (the records' pointer,
    L, K, transform, -2 sigmoid)."""
    for t in (x, forest.tiles, forest.node0):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    lib = library()
    b, f = x.shape
    t, s = forest.sf.shape
    _, _, ptr = _planned(b, f, t, s, num_class, x.device.index,
                         forest.categorical)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = getattr(lib, fn)(x.data_ptr(), b, f, forest.tiles.data_ptr(),
                                  forest.node0.data_ptr(), t, s, forest.depth,
                                  *extra, ptr, out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.traverse_status_string(status).decode()}")
    _count(name)
    return out


def _device_ok(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def tree_leaf(x, forest):
    """(B, T) int32 leaf index of each row in each tree of `forest`;
    x (B, F) float32, F >= forest.width."""
    if x.device.type == "cpu":
        return tree_leaf_plain(x, forest)
    _device_ok(x, "tree_leaf")
    _check(x, forest, "tree_leaf")
    out = torch.empty((x.shape[0], forest.sf.shape[0]), dtype=torch.int32,
                      device=x.device)
    return _launch("tree_leaf", "tree_leaf", x, forest, None, (), out)


def tree_raw(x, forest, lv, num_class):
    """(B, K) float32 class sums of the leaf values `lv` (T, L) float32
    or bfloat16 that each row reaches: tree t adds to class t % K, in
    tree order, accumulated in float32."""
    if x.device.type == "cpu":
        return tree_raw_plain(x, forest, lv, num_class)
    _device_ok(x, "tree_raw")
    _check(x, forest, "tree_raw")
    _check_values(forest, lv, num_class)
    if not lv.is_contiguous():
        raise ValueError("tree_raw: leaf values must be contiguous")
    fn = "tree_raw_f32" if lv.dtype == torch.float32 else "tree_raw_bf16"
    out = torch.empty((x.shape[0], int(num_class)), dtype=torch.float32,
                      device=x.device)
    return _launch("tree_raw", fn, x, forest, int(num_class),
                   (lv.data_ptr(), lv.shape[1], int(num_class)), out)


def tree_lin_raw(x, forest, lv, lin, num_class, transform=False,
                 sigmoid=-1.0):
    """(B, K) float32 class sums of the linear leaf values each row
    reaches (`lin`, the LinearLeaves frozen with the leaf values `lv`
    and rounded as `lv` is stored, float32 or bfloat16, widened to f32;
    the records hold every value the sums read, `lv` is checked against
    their type and shape): tree t adds to class t % K, in tree order.
    With `transform`, the sums go through sigmoid (K == 1, sigmoid > 0)
    or softmax (K > 1) in the same launch."""
    if x.device.type == "cpu":
        return tree_lin_raw_plain(x, forest, lv, lin, num_class, transform,
                                  sigmoid)
    _device_ok(x, "tree_lin_raw")
    _check(x, forest, "tree_lin_raw")
    _check_values(forest, lv, num_class)
    _check_linear(x, forest, lv, lin)
    for a in (lv, lin.rec):
        if not a.is_contiguous():
            raise ValueError("tree_lin_raw: leaf arrays must be contiguous")
    kind = TRANSFORMS[_transform_kind(transform, int(num_class), sigmoid)]
    out = torch.empty((x.shape[0], int(num_class)), dtype=torch.float32,
                      device=x.device)
    return _launch("tree_lin_raw", "tree_lin_raw", x, forest,
                   int(num_class), (lin.rec.data_ptr(), lv.shape[1],
                                    int(num_class), kind,
                                    ctypes.c_float(-2.0 * float(sigmoid))),
                   out)
