"""Streaming (two-round) text loading: O(block) host memory (port of
lightgbm_tpu/io/streaming.py).

Reference: include/LightGBM/utils/pipeline_reader.h:18-70 (block reads),
include/LightGBM/utils/text_reader.h:21-311 (count / sample / filtered
reads), and the two-round path of src/io/dataset_loader.cpp:505-610:
round one samples rows to find bin boundaries, round two re-reads the
file pushing binned values directly into feature storage, so the full
float matrix never exists in memory.

CSV/TSV blocks come from the parser's block reader (io/parser.py
TextTable: numpy's C reader, pandas' NA rules), LibSVM lines from its
line reader (iter_libsvm_rows); peak memory is O(block_rows x cols) +
the bin matrix.
"""

import queue
import threading

import numpy as np

from .parser import TextTable, iter_libsvm_rows

DEFAULT_BLOCK_ROWS = 1 << 16


def count_rows(path, has_header):
    """Non-empty line count only, no tokenization (text_reader.h
    CountLine)."""
    n = 0
    with open(path, "r") as f:
        if has_header:
            next(f, None)
        for line in f:
            if line.strip():
                n += 1
    return n


def scan_file(path, fmt, has_header):
    """First pass: row count + (names, num_cols). For LibSVM also
    discovers the column count (max index + 1), text_reader.h CountLine
    plus the reference's max-idx scan."""
    if fmt == "libsvm":
        n = 0
        max_idx = -1
        for _, pairs in iter_libsvm_rows(path, has_header):
            n += 1
            max_idx = max([max_idx] + [idx for idx, _ in pairs])
        # +1 for the label column so num_cols matches the dense formats
        return n, None, max_idx + 2
    names = None
    with open(path, "r") as f:
        first = f.readline().rstrip("\r\n")
        sep = "," if fmt == "csv" else "\t"
        cols = first.split(sep)
        num_cols = len(cols)
        if has_header:
            names = [str(c) for c in cols]
            n = 0
        else:
            n = 1 if first.strip() else 0
        for line in f:
            if line.strip():
                n += 1
    return n, names, num_cols


def iter_blocks(path, fmt, has_header, num_cols, block_rows=DEFAULT_BLOCK_ROWS):
    """Second/third pass: yield (row_start, float64 (b, num_cols) block)
    with NaNs zeroed, matching parse_text_file's dense semantics."""
    if fmt == "libsvm":
        buf = np.zeros((block_rows, num_cols), dtype=np.float64)
        fill = 0
        start = 0
        for lab, pairs in iter_libsvm_rows(path, has_header):
            buf[fill, 0] = lab
            for idx, val in pairs:
                buf[fill, idx + 1] = val
            fill += 1
            if fill == block_rows:
                yield start, buf[:fill]
                start += fill
                fill = 0
                buf = np.zeros((block_rows, num_cols), dtype=np.float64)
        if fill:
            yield start, buf[:fill]
        return

    start = 0
    table = TextTable(path, fmt, has_header)
    for block in table.blocks(block_rows):
        if not len(block):
            continue
        yield start, np.nan_to_num(block, nan=0.0)
        start += len(block)


def prefetch_blocks(block_iter, depth=2):
    """Double-buffered block pipeline (pipeline_reader.h:18-70): a
    producer thread runs the parse iterator while the consumer bins the
    previous block; the bounded queue caps peak memory at `depth` blocks
    and gives the backpressure of the reference's two-buffer swap."""
    q = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    err = []

    def produce():
        try:
            for item in block_iter:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surface parse errors in the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(end, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=produce, daemon=True, name="block-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            yield item
    finally:
        # early consumer exit: release the producer so the file handle
        # closes promptly
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)
    if err:
        raise err[0]


def iter_sparse_blocks(path, has_header, block_rows=DEFAULT_BLOCK_ROWS):
    """LibSVM second-pass iterator in O(block nnz) memory: yields
    (row_start, labels (b,) f64, rows (nnz,) i64 block-local,
    cols (nnz,) i64 feature ids, vals (nnz,) f64)."""
    labels = []
    rows, cols, vals = [], [], []
    start = 0
    fill = 0

    def emit():
        return (start, np.asarray(labels, dtype=np.float64),
                np.asarray(rows, dtype=np.int64),
                np.asarray(cols, dtype=np.int64),
                np.asarray(vals, dtype=np.float64))

    for lab, pairs in iter_libsvm_rows(path, has_header):
        labels.append(lab)
        for idx, val in pairs:
            rows.append(fill)
            cols.append(idx)
            vals.append(val)
        fill += 1
        if fill == block_rows:
            yield emit()
            start += fill
            fill = 0
            labels, rows, cols, vals = [], [], [], []
    if fill:
        yield emit()


def collect_sample_csc(path, has_header, num_feats, sample_idx,
                       block_rows=DEFAULT_BLOCK_ROWS):
    """Round one for wide LibSVM: gather the sampled rows as CSC
    (colptr, indices-into-sample, vals) + labels, in O(sample nnz)
    memory."""
    sample_idx = np.asarray(sample_idx, dtype=np.int64)
    labels = np.zeros(len(sample_idx), dtype=np.float64)
    parts_c, parts_r, parts_v = [], [], []
    for start, lab, rows, cols, vals in iter_sparse_blocks(
            path, has_header, block_rows):
        lo = np.searchsorted(sample_idx, start)
        hi = np.searchsorted(sample_idx, start + len(lab))
        if hi <= lo:
            continue
        want = sample_idx[lo:hi] - start          # block-local row ids
        labels[lo:hi] = lab[want]
        # map block rows -> sample positions; -1 = not sampled
        pos = np.full(len(lab), -1, dtype=np.int64)
        pos[want] = np.arange(lo, hi)
        keep = pos[rows] >= 0
        parts_r.append(pos[rows[keep]])
        parts_c.append(cols[keep])
        parts_v.append(vals[keep])

    def cat(parts, dtype):
        return np.concatenate(parts) if parts else np.zeros(0, dtype=dtype)

    rows = cat(parts_r, np.int64)
    cols = cat(parts_c, np.int64)
    vals = cat(parts_v, np.float64)
    order = np.argsort(cols, kind="stable")
    counts = np.bincount(cols, minlength=num_feats)
    colptr = np.concatenate([[0], np.cumsum(counts)])
    return labels, colptr, rows[order], vals[order]


def collect_sample_rows(path, fmt, has_header, num_cols, sample_idx,
                        block_rows=DEFAULT_BLOCK_ROWS):
    """Round one: gather the (ascending) sampled row indices in one
    streaming pass (text_reader.h SampleFromFile)."""
    sample_idx = np.asarray(sample_idx, dtype=np.int64)
    out = np.empty((len(sample_idx), num_cols), dtype=np.float64)
    for start, block in prefetch_blocks(
            iter_blocks(path, fmt, has_header, num_cols, block_rows)):
        lo = np.searchsorted(sample_idx, start)
        hi = np.searchsorted(sample_idx, start + len(block))
        if hi > lo:
            out[lo:hi] = block[sample_idx[lo:hi] - start]
    return out
