"""The mesh's exchange fold: its CUDA wrapper and its plain PyTorch
version.

Port of the JAX package's kahan_fold (lightgbm_tpu/parallel/mesh.py:138),
an XLA scan with no Pallas kernel, under every histogram exchange of the
parallel learners (parallel/mesh.py pair_allreduce, pair_reduce_scatter
and the compressed_* variants). For K stacked components (K, ...) it
folds in fixed index order with compensated float32 sums and returns
`s - c`:

  mesh_fold  (...) float32 from (K, ...) float32 or bfloat16 components
             (bfloat16, comm_precision=bf16's wire word, widened in the
             same launch).

The order is the components' index order and nothing else, so the result
does not depend on which shard folds it, and every shard of a mesh gets
the same bits.

The kernel is csrc/mesh.cu (design and bound are noted there), built by
hist_kernels.build with the other sources and loaded with ctypes. It
launches on PyTorch's current stream with no host sync; its launches
count in `KERNELS["mesh_fold"].launches` (hist_kernels' registry).
Dispatch is by the components' device only: a CPU tensor takes the plain
version, a CUDA tensor the kernel or an exception; there is no fallback.

The plain version is a PyTorch loop over K with the kernel's float32
operations in the kernel's order; the CPU tests hold it bit for bit
against the JAX function, and chip_smoke.py holds the kernel bit for bit
against it on the card.
"""

import torch

from . import hist_kernels

KERNELS = {"mesh_fold": hist_kernels.KERNELS["mesh_fold"]}
_DTYPES = (torch.float32, torch.bfloat16)


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


def mesh_fold(comps):
    """The fixed-order compensated fold of the (K, ...) float32 or
    bfloat16 components -> (...) float32 (kahan_fold's `s - c`)."""
    if comps.device.type == "cpu":
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
    lib = hist_kernels._library("mesh.cu")
    status = lib.mesh_fold(comps.data_ptr(),
                           int(comps.dtype == torch.bfloat16),
                           comps.shape[0], cells, out.data_ptr(),
                           hist_kernels._stream(comps.device))
    if status != 0:
        raise RuntimeError("mesh_fold launch failed: "
                           f"{lib.mesh_status_string(status).decode()}")
    hist_kernels._count("mesh_fold")
    return out
