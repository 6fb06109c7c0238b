"""Segment histograms over a leaf-contiguous row layout: the hot op of
the partitioned tree builder (models/partitioned.py).

Port of lightgbm_tpu/ops/ordered_hist.py. Rows are kept physically
sorted by leaf (ops/partition.py), a leaf is a position range
[begin, begin + cnt), and its histogram reads only the HIST_CHUNK-row
chunks covering that range, so its cost follows the leaf's size rather
than N. Bins are packed four uint8 features per int32 word (W =
ceil(F/4), feature f in byte f % 4 of word f // 4): one gather moves
four features at once, and the kernel unpacks with a shift and a mask.

The JAX package gets static shapes under jit by rounding a segment up
to a geometric bucket of chunks (bucket_sizes, cover_index,
window_start) and dispatching with lax.switch. The port reads the
segment's bounds on the device instead (csrc/seg_hist.cu): no bucket is
chosen on the host and no host sync happens per split. The bucket
arithmetic is kept, equal to the JAX package's, as the geometry the TPU
kernel streams: the chunks the port folds always lie inside that window
(tests/test_torch_partitioned.py).
"""

import numpy as np
import torch

from . import hist_kernels
from .hist_kernels import HIST_CHUNK, chunk_cover

# geometric growth of the JAX package's chunk buckets (its
# LIGHTGBM_TPU_BUCKET_GROWTH default)
BUCKET_GROWTH = 2


def pack_feature_words(bins_u8):
    """(F, N) uint8 bins -> (ceil(F/4), N) int32 packed words (host)."""
    f, n = bins_u8.shape
    w = (f + 3) // 4
    padded = np.zeros((w * 4, n), dtype=np.uint8)
    padded[:f] = bins_u8
    p = padded.reshape(w, 4, n).astype(np.uint32)
    words = p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16) | (p[:, 3] << 24)
    return words.view(np.int32)


def unpack_feature(words, feat):
    """(N,) int32 bin column of feature `feat` (a one-element integer
    tensor on the words' device) from packed words."""
    feat = feat.reshape(1).long()
    word = words.index_select(0, feat >> 2)[0]
    return (word >> ((feat & 3) * 8).to(torch.int32)) & 0xFF


def bucket_sizes(n_chunks):
    """Geometric chunk buckets up to the full array."""
    sizes = []
    b = 1
    while b < n_chunks:
        sizes.append(b)
        b *= BUCKET_GROWTH
    sizes.append(n_chunks)
    return sizes


def cover_index(begin, cnt, n_chunks):
    """The JAX package's bucket index and first covered chunk for the
    position range [begin, begin + cnt) (0-d integer tensors); an empty
    segment covers one chunk."""
    c_first, c_last = chunk_cover(begin, cnt)
    sizes = torch.tensor(bucket_sizes(n_chunks), dtype=c_first.dtype,
                         device=c_first.device)
    idx = torch.searchsorted(sizes, (c_last - c_first + 1).reshape(1))[0]
    return idx, c_first


def window_start(c_first, bk, n_chunks):
    """First row of the bk-chunk window at c_first, clipped in-bounds
    (a pulled-back window still covers the range)."""
    return c_first.clamp(0, n_chunks - bk) * HIST_CHUNK


def segment_histograms(words, ghc_t, bounds, num_bins_total):
    """((4W, B, 3) value, residual) over the position range
    [begin, begin + cnt).

    Args:
      words: (W, N) int32 packed bins (leaf-ordered), N % HIST_CHUNK == 0.
      ghc_t: (3, N) float32 leaf-ordered statistics (grad*inbag,
        hess*inbag, inbag); padding rows are zero.
      bounds: (2,) int32 [begin, cnt] tensor on the words' device.
      num_bins_total: histogram width B (<= 256).

    A CUDA tensor runs the seg_hist kernel, a CPU tensor its plain
    version, any other device raises. Collapse the pair with `hi + lo`.
    """
    return hist_kernels.seg_hist(words, ghc_t, bounds, num_bins_total)
