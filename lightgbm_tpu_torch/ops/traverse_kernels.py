"""Tree-traversal kernels: CUDA wrappers and their plain PyTorch versions.

The serving path's hot loop, a walk of every (row, tree) pair. The JAX
package runs it as XLA, not Pallas: device_traverse
(lightgbm_tpu/models/gbdt.py:65) under the jitted kernels of
lightgbm_tpu/serving/compiled_model.py:76-135. Here:

  tree_leaf  <- _leaf_kernel                       (B, T) int32 leaves
  tree_raw   <- _raw_kernel / _raw16_kernel        (B, K) float32 sums

in lightgbm_tpu_torch/csrc/traverse.cu (design and bound are noted
there), built at first use by hist_kernels.build (this source alone, so
a server does not wait for the histogram kernels) and loaded with
ctypes. A frozen model is a `Forest`: the (T, S) node
arrays the plain walk reads, and the same nodes packed into one 16-byte
record each (pack_nodes), which is what the kernel reads.

Dispatch is by the row tensor's device only: a CPU tensor takes the
plain version, a CUDA tensor the kernel (or an exception), anything else
raises. There is no fallback from a failed build or launch to the plain
version. A wrapper launches on PyTorch's current stream of the tensor's
own device, with that device made current for the launch (the serving
batcher's worker and the HTTP handler threads call it), allocates its
output per call (no scratch shared across threads) and counts its
launches in `KERNELS[name].launches` under a lock.

The plain versions are the lockstep walk of models/gbdt.py
device_traverse and, for tree_raw, f32 adds of the leaf values in tree
order, the kernel's order: on the same inputs they give the kernel's
bits.
"""

import ctypes
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
           for name in ("tree_leaf", "tree_raw")}
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB = None
# seconds the library took to build in this process, and whether it was
# found already built in csrc/build/ (CompiledPredictor.warm_up reads
# both)
LOAD_INFO = {}

_CATEGORICAL_BIT = np.int32(-(1 << 31))


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
    ~0 for a single-leaf tree); `nodes` the (T, S, 4) int32 packed
    records; `depth` the walk's step count; `width` the least row width
    (largest split feature + 1)."""
    sf: torch.Tensor
    thr: torch.Tensor
    cat: torch.Tensor
    lc: torch.Tensor
    rc: torch.Tensor
    node0: torch.Tensor
    nodes: torch.Tensor
    depth: int
    width: int


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
    return Forest(put(sf, np.int32), put(thr32, np.float32),
                  put(is_cat, np.bool_), put(lc, np.int32),
                  put(rc, np.int32), put(node0, np.int32),
                  put(pack_nodes(sf, thr32, is_cat, lc, rc), np.int32),
                  int(depth), int(sf.max()) + 1 if sf.size else 1)


# ------------------------------------------------------------- plain path

def _check(x, forest, name):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: rows must be a (B, F) float32 tensor")
    if x.shape[1] < forest.width:
        raise ValueError(f"{name}: rows have {x.shape[1]} features, the "
                         f"trees split on feature {forest.width - 1}")
    if forest.nodes.device != x.device:
        raise ValueError(f"{name}: rows and trees on different devices")


def tree_leaf_plain(x, forest):
    """(B, T) int32 leaf indices by the lockstep walk."""
    from ..models.gbdt import device_traverse
    _check(x, forest, "tree_leaf")
    node = device_traverse(x, forest.sf, forest.thr, forest.cat, forest.lc,
                           forest.rc, forest.node0, forest.depth)
    return (~node).to(torch.int32)


def _check_values(forest, lv, num_class):
    t = forest.nodes.shape[0]
    if lv.dim() != 2 or lv.shape[0] != t:
        raise ValueError(f"tree_raw: leaf values must be (T={t}, L)")
    if lv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("tree_raw: leaf values must be float32 or bfloat16")
    if lv.device != forest.nodes.device:
        raise ValueError("tree_raw: leaf values and trees on different "
                         "devices")
    if int(num_class) < 1:
        raise ValueError("tree_raw: bad class count")


def tree_raw_plain(x, forest, lv, num_class):
    """(B, K) float32 sums: tree t adds its leaf value (bf16 widened to
    f32) to class t % K, in tree order."""
    _check_values(forest, lv, num_class)
    leaves = tree_leaf_plain(x, forest).long()
    num_trees = leaves.shape[1]
    t_idx = torch.arange(num_trees, device=x.device)
    vals = lv[t_idx[None, :], leaves].float()                 # (B, T)
    acc = torch.zeros((x.shape[0], num_class), dtype=torch.float32,
                      device=x.device)
    for t in range(num_trees):
        acc[:, t % num_class] += vals[:, t]
    return acc


# ----------------------------------------------------------- CUDA wrappers

def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tree_leaf.argtypes = [p, i, i, p, p, i, i, i, p, p]
    lib.tree_leaf.restype = i
    for fn in (lib.tree_raw_f32, lib.tree_raw_bf16):
        fn.argtypes = [p, i, i, p, p, i, i, i, p, i, i, p, p]
        fn.restype = i
    lib.traverse_status_string.argtypes = [i]
    lib.traverse_status_string.restype = ctypes.c_char_p


def library():
    """The loaded traversal library, built or found built at the first
    call of the process; LOAD_INFO records which and how long."""
    global _LIB
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


def _launch(name, fn, x, forest, args, out):
    for t in (x, forest.nodes, forest.node0):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    lib = library()
    b, f = x.shape
    t, s = forest.nodes.shape[:2]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = getattr(lib, fn)(
            x.data_ptr(), b, f, forest.nodes.data_ptr(),
            forest.node0.data_ptr(), args[0], s, forest.depth,
            *args[1:], out.data_ptr(), stream)
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
    t = forest.nodes.shape[0]
    out = torch.empty((x.shape[0], t), dtype=torch.int32, device=x.device)
    return _launch("tree_leaf", "tree_leaf", x, forest, (t,), out)


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
    return _launch("tree_raw", fn, x, forest,
                   (forest.nodes.shape[0], lv.data_ptr(), lv.shape[1],
                    int(num_class)), out)
