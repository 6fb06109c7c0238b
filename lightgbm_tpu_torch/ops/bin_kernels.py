"""Dense binning kernel: its CUDA wrapper and its plain PyTorch version.

Port of the JAX package's device binning, an XLA program with no Pallas
kernel: _bin_dense_on_device (lightgbm_tpu/io/dataset.py:156). For a
float32 matrix x (N, C) whose features are numerical,

  bin_dense  (F, N) bins, bin[f, n] = #{b : bounds[f, b] < x[n, cols[f]]}

with NaN read as 0.0 (+-inf compare as themselves), stored at the
dataset's packed width (uint8, int16 or int32). `dense_bounds` makes
the (F, B) float32 bounds from the mappers' float64 upper bounds on the
host, once: each rounded toward
-inf, so that for every float32 input the float32 compare equals the
float64 one, which is the host pass's searchsorted(side="left") over
the mapper's bounds; rows of unequal length are padded with +inf, which
no value exceeds.

The kernel is csrc/bin.cu (design and bound are noted there), built by
hist_kernels.build with the other sources and loaded with ctypes. A
call is one launch, on PyTorch's current stream (the kernel picks its
route by the bounds' count), counted in `KERNELS["bin_dense"].launches`.
Dispatch is by the tensor's device only: a CPU tensor takes the plain
version, a CUDA tensor the kernel or an exception; there is no fallback
from a failed build or launch.

The plain version is the same compare-count on tensors, in row chunks
(the JAX program's own method): it gives the kernel's bits. The CPU
tests use it, and so does a dataset constructed for the CPU where the
JAX package would bin on its device (io/dataset.py).
"""

import numpy as np
import torch

from . import hist_kernels

KERNELS = {"bin_dense": hist_kernels.KernelStats("bin_dense")}
_OUT_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}
# rows a chunk of the plain version: chunk x F x B booleans at a time
_PLAIN_CHUNK = 4096


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts():
    return {name: k.launches for name, k in KERNELS.items()}


def dense_bounds(upper_bounds):
    """(F, B) float32 bounds of the per-feature float64 upper bounds
    `upper_bounds` (a list of 1-D arrays): each rounded toward -inf
    (lightgbm_tpu/io/dataset.py:195-200), rows padded with +inf to the
    longest."""
    f = len(upper_bounds)
    b_max = max(len(u) for u in upper_bounds)
    bounds = np.full((f, b_max), np.inf)
    for j, u in enumerate(upper_bounds):
        bounds[j, :len(u)] = u
    with np.errstate(over="ignore"):      # beyond float32: +-inf
        b32 = bounds.astype(np.float32)
    lifted = b32.astype(np.float64) > bounds
    return np.where(lifted, np.nextafter(b32, np.float32(-np.inf),
                                         dtype=np.float32), b32)


def _check(x, cols, bounds, out_dtype):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("bin_dense: x must be an (N, C) float32 tensor")
    if cols.dim() != 1 or cols.dtype != torch.int32:
        raise ValueError("bin_dense: cols must be an (F,) int32 tensor")
    if (bounds.dim() != 2 or bounds.dtype != torch.float32
            or bounds.shape[0] != cols.shape[0] or bounds.shape[1] < 1):
        raise ValueError("bin_dense: bounds must be an (F, B) float32 "
                         "tensor, one row a column of cols")
    if out_dtype not in _OUT_BYTES:
        raise TypeError(f"bin_dense: output must be uint8, int16 or int32, "
                        f"got {out_dtype}")
    for t in (cols, bounds):
        if t.device != x.device:
            raise ValueError("bin_dense: inputs on different devices")


def bin_dense_plain(x, cols, bounds, out_dtype):
    """(F, N) bins of x's columns `cols` by the compare-count, NaN read
    as 0.0; columns out of range raise (index_select)."""
    _check(x, cols, bounds, out_dtype)
    n = x.shape[0]
    out = torch.empty((cols.shape[0], n), dtype=out_dtype, device=x.device)
    idx = cols.long()
    for r0 in range(0, n, _PLAIN_CHUNK):
        xs = x[r0:r0 + _PLAIN_CHUNK].index_select(1, idx)    # (rows, F)
        xs = torch.where(torch.isnan(xs), 0.0, xs)           # +-inf stay
        cnt = (xs[:, :, None] > bounds[None, :, :]).sum(-1)  # (rows, F)
        out[:, r0:r0 + _PLAIN_CHUNK] = cnt.t().to(out_dtype)
    return out


def _library():
    return hist_kernels._library("bin.cu")


def bin_dense(x, cols, bounds, out_dtype):
    """(F, N) bins of the float32 matrix x (N, C) by the bounds (F, B)
    of its columns `cols` (F,) int32, at `out_dtype` (torch.uint8,
    int16 or int32); NaN bins as 0.0. `cols` must lie in [0, C): the
    kernel reads x at them unchecked (the plain version raises)."""
    if x.device.type == "cpu":
        return bin_dense_plain(x, cols, bounds, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"bin_dense: unsupported device {x.device}")
    _check(x, cols, bounds, out_dtype)
    for t in (x, cols, bounds):
        if not t.is_contiguous():
            raise ValueError("bin_dense: inputs must be contiguous")
    n, c = x.shape
    f, b = bounds.shape
    out = torch.empty((f, n), dtype=out_dtype, device=x.device)
    if n == 0:
        return out
    lib = _library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    status = lib.bin_dense(x.data_ptr(), n, c, cols.data_ptr(), f,
                           bounds.data_ptr(), b, out.data_ptr(),
                           _OUT_BYTES[out_dtype], sms,
                           hist_kernels._stream(x.device))
    if status != 0:
        raise RuntimeError("bin_dense launch failed: "
                           f"{lib.bin_status_string(status).decode()}")
    KERNELS["bin_dense"].launches += 1
    return out
