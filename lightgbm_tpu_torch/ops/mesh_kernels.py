"""The mesh's exchange fold: its CUDA wrapper and its plain PyTorch
version.

Port of the JAX package's kahan_fold (lightgbm_tpu/parallel/mesh.py:138),
an XLA scan with no Pallas kernel, under every histogram exchange of the
parallel learners (parallel/mesh.py pair_allreduce, pair_reduce_scatter
and the compressed_* variants). K components are folded in fixed index
order with compensated float32 sums, and the result is `s - c`:

  gather_fold  K component descriptors (tensor, offset, stride) -> the
               (lead, run) output: component j's cell (i, e) is element
               offset + i * stride + e of its contiguous tensor, float32
               or bfloat16 (comm_precision=bf16's wire word, widened in
               the same launch). An exchange points the descriptors at
               its peers' own tensors and folds in one launch.
  mesh_fold    (...) float32 from stacked (K, ...) components: the same
               fold with descriptor j -> comps[j].

The order is the descriptors' order and nothing else, so the result does
not depend on which shard folds it, and every shard of a mesh gets the
same bits.

The kernel is csrc/mesh.cu (design and bound are noted there), built by
hist_kernels.build with the other sources and loaded with ctypes. It
launches on PyTorch's current stream with no host sync; its launches
count in `KERNELS["mesh_fold"].launches` (hist_kernels' registry), one
a launch: one a call up to MAX_COMPS components, a pass of MAX_COMPS
each above. Dispatch is by the components' device only: CPU tensors
take the plain version, CUDA tensors the kernel or an exception; there
is no fallback.

The plain versions stack the components (gather_fold_plain takes the
same views first) and run a PyTorch loop over K with the kernel's
float32 operations in the kernel's order; the CPU tests hold them bit
for bit against the JAX function, and chip_smoke.py holds the kernel bit
for bit against them on the card.
"""

import ctypes

import torch

from ..telemetry import roofline
from . import hist_kernels

KERNELS = {"mesh_fold": hist_kernels.KERNELS["mesh_fold"]}
_DTYPES = (torch.float32, torch.bfloat16)
# descriptors one launch takes (csrc/mesh.cu kMaxComps)
MAX_COMPS = 128


def _check(comps):
    if comps.dim() < 1 or comps.shape[0] < 1:
        raise ValueError("mesh_fold: components must be (K, ...) with K >= 1")
    if comps.dtype not in _DTYPES:
        raise TypeError(f"mesh_fold: components must be float32 or "
                        f"bfloat16, got {comps.dtype}")


def mesh_fold_plain(comps):
    """Plain version of mesh_fold: the fixed-order compensated fold of
    the (K, ...) components, (...) float32."""
    _check(comps)
    s = torch.zeros(comps.shape[1:], dtype=torch.float32,
                    device=comps.device)
    c = torch.zeros_like(s)
    for j in range(comps.shape[0]):
        y = comps[j].to(torch.float32) - c
        t = s + y
        c = (t - s) - y
        s = t
    return s - c


def _check_gather(comps, lead, run, out, out_stride):
    """Validate gather_fold's descriptors and output; returns the
    components' device."""
    if not comps:
        raise ValueError("gather_fold: no components")
    if lead < 1 or run < 1 or out_stride < run:
        raise ValueError(f"gather_fold: bad shape lead={lead} run={run} "
                         f"out_stride={out_stride}")
    t0 = comps[0][0]
    if t0.dtype not in _DTYPES:
        raise TypeError(f"gather_fold: components must be float32 or "
                        f"bfloat16, got {t0.dtype}")
    for t, off, stride in comps:
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError("gather_fold: components of different types "
                             "or devices")
        if not t.is_contiguous():
            raise ValueError("gather_fold: component tensors must be "
                             "contiguous")
        if off < 0 or stride < 0 or (off + (lead - 1) * stride + run
                                     > t.numel()):
            raise ValueError("gather_fold: a descriptor reaches outside "
                             "its tensor")
    if out.dtype != torch.float32 or out.device != t0.device \
            or not out.is_contiguous() \
            or (lead - 1) * out_stride + run > out.numel():
        raise ValueError("gather_fold: the output must be a contiguous "
                         "float32 tensor on the components' device that "
                         "holds (lead, run) at out_stride")
    return t0.device


def _view(t, off, stride, lead, run):
    return t.as_strided((lead, run), (stride, 1), t.storage_offset() + off)


def gather_fold_plain(comps, lead, run, out, out_stride=None):
    """Plain version of gather_fold: the components' views stacked in
    descriptor order and folded by mesh_fold_plain into `out`."""
    out_stride = run if out_stride is None else out_stride
    _check_gather(comps, lead, run, out, out_stride)
    folded = mesh_fold_plain(torch.stack(
        [_view(t, off, stride, lead, run) for t, off, stride in comps]))
    _view(out, 0, out_stride, lead, run).copy_(folded)
    return out


def _launch(lib, table, k, bf16, lead, run, out_ptr, out_stride, device):
    """The C entry on `table` (2k addresses and strides); one count a
    launch."""
    state = None
    if k > MAX_COMPS:
        state = torch.empty(2 * lead * run, dtype=torch.float32,
                            device=device)
    # K components read, the result written once
    with roofline.timed("mesh_fold", device,
                        lead * run * (k * (2 if bf16 else 4) + 4),
                        lead * run):
        status = lib.gather_fold(table, k, bf16, lead, run, out_ptr,
                                 out_stride,
                                 None if state is None else state.data_ptr(),
                                 hist_kernels._stream(device))
    if status != 0:
        raise RuntimeError("mesh_fold launch failed: "
                           f"{lib.mesh_status_string(status).decode()}")
    for _ in range(-(-k // MAX_COMPS)):
        hist_kernels._count("mesh_fold")


def gather_fold(comps, lead, run, out, out_stride=None):
    """The fixed-order compensated fold of K components into `out` (a
    contiguous float32 tensor holding the (lead, run) result, row i at
    element i * out_stride, run by default): comps is a sequence of
    (tensor, offset, stride) descriptors in fold order, each tensor
    contiguous, float32 or bfloat16 (all one type), component j's cell
    (i, e) its element offset + i * stride + e. Returns out."""
    out_stride = run if out_stride is None else out_stride
    if comps and comps[0][0].device.type == "cpu":
        t0 = comps[0][0]
        with roofline.timed("mesh_fold", t0.device,
                            lead * run * (len(comps) * t0.element_size()
                                          + 4), lead * run):
            return gather_fold_plain(comps, lead, run, out, out_stride)
    device = _check_gather(comps, lead, run, out, out_stride)
    if device.type != "cuda":
        raise ValueError(f"gather_fold: unsupported device {device}")
    t0 = comps[0][0]
    es = t0.element_size()
    table = []
    for t, off, stride in comps:
        table += (t.data_ptr() + off * es, stride)
    _launch(hist_kernels._library("mesh.cu"),
            (ctypes.c_longlong * len(table))(*table), len(comps),
            int(t0.dtype == torch.bfloat16), lead, run, out.data_ptr(),
            out_stride, device)
    return out


def mesh_fold(comps):
    """The fixed-order compensated fold of the (K, ...) float32 or
    bfloat16 components -> (...) float32 (kahan_fold's `s - c`)."""
    if comps.device.type == "cpu":
        with roofline.timed("mesh_fold", comps.device,
                            lambda: comps.numel() * comps.element_size()
                            + 4 * comps[0].numel(),
                            lambda: comps[0].numel()):
            return mesh_fold_plain(comps)
    if comps.device.type != "cuda":
        raise ValueError(f"mesh_fold: unsupported device {comps.device}")
    _check(comps)
    comps = comps.contiguous()
    out = torch.empty(comps.shape[1:], dtype=torch.float32,
                      device=comps.device)
    cells = out.numel()
    if cells == 0:
        return out
    k, base, es = comps.shape[0], comps.data_ptr(), comps.element_size()
    table = []
    for j in range(k):
        table += (base + j * cells * es, cells)
    _launch(hist_kernels._library("mesh.cu"),
            (ctypes.c_longlong * (2 * k))(*table), k,
            int(comps.dtype == torch.bfloat16), 1, cells, out.data_ptr(),
            cells, comps.device)
    return out
