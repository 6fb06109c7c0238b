"""Histogram construction: the pair contract and the engine dispatch.

Port of lightgbm_tpu/ops/histogram.py: build_histograms_pair (:232-274),
frontier_histograms (:428-476) and compacted_histograms (:573-640), plus
lightgbm_tpu/ops/pallas_hist.py masked_histograms (:211).

    hist[f, b, k] = sum_n [bins[f, n] == b] * ghc[n, k]

Rows are cut into HIST_CHUNK-row chunks; each chunk's float32 partial
depends only on the chunk's rows, and partials combine in chunk order
with a Kahan pair (value, residual) — the property the serial ==
data-parallel and in-RAM == out-of-core contracts rest on. Collapse a
pair with `hi + lo`.

The gather-compacted engine (compacted_histograms) reads only one
leaf's rows: a stable compaction of row_leaf == leaf into an (N,) index
buffer and a device count, then the histogram of the compacted rows. Its
chunking mirrors the JAX package's route off the TPU, _compacted_bincount
(:527-570), which is also what its tests run: the leaf's rows in
original order cut into HIST_CHUNK-row pieces, the last one ragged, and
max(ceil(count / HIST_CHUNK), 1) chunk partials folded, with no trailing
bucket-padding chunk (a trailing zero chunk changes the Kahan bits; the
JAX XLA route, :619-640, folds the padded chunks of its geometric
bucket). The JAX route sums each chunk in float64 and casts it to
float32; here each chunk is a float32 row-order sum, as in the masked
engine, so the two packages' compacted histograms agree within the
reference's 1e-6 relative cross-engine contract, not in bits.

The engines dispatch on the tensors' device: a CUDA tensor runs the
hand-written kernels (ops/hist_kernels.py, csrc/hist.cu, csrc/compact.cu,
csrc/compact_hist.cu), a CPU tensor their plain PyTorch versions, any
other device raises.
"""

import torch

from . import hist_kernels
from .hist_kernels import HIST_CHUNK


def build_histograms_pair(bins, ghc, num_bins_total, row_chunk=HIST_CHUNK):
    """Compensated (Kahan) accumulation across row chunks.

    Args:
      bins: (F, N) integer bin matrix, N a multiple of row_chunk.
      ghc: (N, K) float32 packed statistics; masked rows are zero.
      num_bins_total: histogram width B.
      row_chunk: must be HIST_CHUNK (the port's one chunk grid).

    Returns the ((F, B, K) value, residual) float32 pair; the residual
    is the NEGATED Kahan compensation (`return acc, -comp`).
    """
    if int(row_chunk) != HIST_CHUNK:
        raise ValueError(f"row_chunk must be {HIST_CHUNK}")
    n = bins.shape[1]
    if n % HIST_CHUNK != 0:
        raise ValueError(f"N={n} must be padded to a multiple of {HIST_CHUNK}")
    slot = torch.zeros(n, dtype=torch.int64, device=bins.device)
    parts = hist_kernels.chunk_partials_plain(
        bins, ghc.t().contiguous(), slot, 1, int(num_bins_total))
    hi, lo = hist_kernels.kahan_fold(parts)
    return hi[0], lo[0]


def masked_histograms(bins, ghc_t, row_leaf, leaf_id, num_bins_total):
    """((F, B, 3) value, residual) over the rows of one leaf; `leaf_id`
    is a (1,) int32 device tensor (no host sync)."""
    return hist_kernels.masked_hist(bins, ghc_t, row_leaf, leaf_id,
                                    num_bins_total)


def frontier_histograms(bins, ghc_t, row_leaf, leaf_ids, num_bins_total):
    """Multi-leaf histograms: ONE pass over the bin matrix builds the
    ((L, F, B, 3) value, residual) pair of every leaf in `leaf_ids`
    ((L,) int32 device tensor of distinct ids). Per-leaf values are
    bitwise what the single-leaf engine gives for the same rows."""
    return hist_kernels.frontier_hist(bins, ghc_t, row_leaf, leaf_ids,
                                      num_bins_total)


def compacted_histograms(bins, ghc_t, row_leaf, leaf_id, num_bins_total,
                         src=None, cnt=None, scratch=None):
    """Gather-compacted leaf histogram: ((F, B, 3) value, residual) over
    the rows with row_leaf == leaf_id, whose cost follows the leaf's row
    count. `leaf_id` is a (1,) int32 device tensor; `src` ((N,) int32)
    and `cnt` ((1,) int32) are the compaction's buffers and `scratch` a
    hist_kernels.CompactScratch (the kernels' look-back flags, chunk
    partials and fold counters), allocated here when not given (a
    learner passes its own, so that a captured graph reads the same
    addresses on every replay). No host sync."""
    n = bins.shape[1]
    if src is None:
        src = torch.empty(n, dtype=torch.int32, device=bins.device)
    if cnt is None:
        cnt = torch.empty(1, dtype=torch.int32, device=bins.device)
    kw = {} if scratch is None else scratch.hist_kwargs()
    hist_kernels.compact_rows(row_leaf, leaf_id, src, cnt,
                              flags=None if scratch is None
                              else scratch.flags)
    return hist_kernels.compacted_hist(bins, ghc_t, src, cnt,
                                       num_bins_total, **kw)
