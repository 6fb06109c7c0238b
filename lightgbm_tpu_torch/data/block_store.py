"""On-disk packed-bin block store: the out-of-core quantized dataset
(port of lightgbm_tpu/data/block_store.py).

The in-RAM path holds the whole (F, N) bin matrix on the host and the
card. Out of core, the matrix is binned once into fixed-row-count blocks
on disk and streamed through the card for every histogram pass
(data/prefetch.py, data/ooc_learner.py); only the per-row statistics,
the row -> leaf partition and the scores stay on the device.

Layout (one directory per store), the JAX package's, so either package
reads a store the other wrote:

- ``block-%05d.npy``: one (num_stored, rows) C-order packed-bin array
  per block (uint8 up to 256 bins, int16 above). A pass reads a whole
  block, and a split a feature's row, with one read from the file into
  its buffer; the host traversal and the linear fit map the block
  (`np.load(mmap_mode="r")`).
- ``sidecar.npz``: everything else a CoreDataset carries (bin mappers,
  metadata, feature names and maps), the binary cache's entry set.
- ``manifest.json``: format version, dtype, per-block row ranges and
  crc32 digests, the binning signature and the source file's signature
  that decide reuse against rebuild. Written last and atomically: a
  crash mid-build leaves no manifest, never a store that lies.

Every defect a truncated, bit-rotted or stale store can show surfaces as
a BlockStoreError naming the file and the defect.

A gang of W processes shares one store (:698-829): rank 0 builds it (or
reuses it), its peers wait for a signature-matching manifest and adopt
it (`load_block_store_gang`), and each rank takes its contiguous owned
block range as a local-row view (`gang_view_of`, OutOfCoreGangView).
Every rank gathers every rank's range and checks that they tile the
store (`_check_gang_tiling`) before any histogram is built.
"""

import io
import json
import os
import shutil
import tempfile
import time
import weakref

import numpy as np

from ..io.dataset import (CoreDataset, _qid_to_counts, bins_dtype,
                          decode_dataset_sidecar, encode_dataset_sidecar)
from ..io.metadata import Metadata
from ..io.mmap_io import crc32_file
from ..ops.hist_kernels import HIST_CHUNK
from ..utils import faults
from ..utils.checkpoint import atomic_open, atomic_write_bytes
from ..utils.log import Log

MANIFEST_NAME = "manifest.json"
SIDECAR_NAME = "sidecar.npz"
BLOCK_MAGIC = "lightgbm_tpu_block_store"
FORMAT_VERSION = 1


class BlockStoreError(Exception):
    """A block store failed validation (missing/corrupt/truncated block,
    stale or foreign manifest)."""


def _block_name(i):
    return f"block-{i:05d}.npy"


def source_signature(filename):
    """Reuse-or-rebuild identity of a text data file: path, size and
    mtime, so that a silently swapped file cannot feed stale blocks."""
    st = os.stat(filename)
    return {"path": os.path.abspath(str(filename)),
            "size": int(st.st_size), "mtime_ns": int(st.st_mtime_ns)}


class BlockStoreWriter:
    """Buffered block writer: append (num_stored, r) packed-bin column
    slices in row order; full blocks flush to disk atomically."""

    def __init__(self, directory, num_stored, dtype, block_rows):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        # a manifest from an earlier build must not coexist with a
        # half-written replacement
        stale = os.path.join(self.directory, MANIFEST_NAME)
        if os.path.exists(stale):
            os.remove(stale)
        self.num_stored = int(num_stored)
        self.dtype = np.dtype(dtype)
        self.block_rows = int(block_rows)
        self._buf = np.zeros((self.num_stored, self.block_rows), self.dtype)
        self._fill = 0
        self._blocks = []
        self.num_rows = 0

    def append(self, cols):
        """cols: (num_stored, r) packed bins for the next r rows."""
        cols = np.asarray(cols)
        if cols.shape[0] != self.num_stored:
            raise BlockStoreError(
                f"append expects {self.num_stored} stored rows, got "
                f"{cols.shape[0]}")
        r = cols.shape[1]
        off = 0
        while off < r:
            take = min(self.block_rows - self._fill, r - off)
            self._buf[:, self._fill:self._fill + take] = \
                cols[:, off:off + take]
            self._fill += take
            off += take
            if self._fill == self.block_rows:
                self._flush()

    def _flush(self):
        if self._fill == 0:
            return
        i = len(self._blocks)
        name = _block_name(i)
        path = os.path.join(self.directory, name)
        with atomic_open(path) as f:
            np.save(f, np.ascontiguousarray(self._buf[:, :self._fill]))
        self._blocks.append({
            "file": name,
            "rows": int(self._fill),
            "row_start": int(self.num_rows),
            "nbytes": int(os.path.getsize(path)),
            "crc32": int(crc32_file(path)),
        })
        self.num_rows += self._fill
        self._fill = 0

    def finish(self, sidecar_arrays, source=None, binning=None,
               build_count=1):
        """Flush the tail block, write the sidecar, then the manifest
        (last: its presence is the store's validity marker).
        `build_count` counts the binning passes this directory has seen
        (the previous manifest's count + 1)."""
        self._flush()
        sidecar_path = os.path.join(self.directory, SIDECAR_NAME)
        buf = io.BytesIO()
        np.savez(buf, **sidecar_arrays)
        atomic_write_bytes(sidecar_path, buf.getvalue())
        manifest = {
            "magic": BLOCK_MAGIC,
            "format_version": FORMAT_VERSION,
            "num_rows": int(self.num_rows),
            "num_stored": int(self.num_stored),
            "block_rows": int(self.block_rows),
            "dtype": self.dtype.name,
            "blocks": self._blocks,
            "sidecar": {"nbytes": int(os.path.getsize(sidecar_path)),
                        "crc32": int(crc32_file(sidecar_path))},
            "source": source,
            "binning": binning,
            "build_count": int(build_count),
        }
        atomic_write_bytes(os.path.join(self.directory, MANIFEST_NAME),
                           json.dumps(manifest, indent=1).encode())
        return manifest


class BlockStore:
    """Reader over a finished block-store directory."""

    def __init__(self, directory, manifest, verify=True):
        self.directory = str(directory)
        self.manifest = manifest
        self.num_rows = int(manifest["num_rows"])
        self.num_stored = int(manifest["num_stored"])
        self.block_rows = int(manifest["block_rows"])
        self.dtype = np.dtype(manifest["dtype"])
        self.blocks = manifest["blocks"]
        self.num_blocks = len(self.blocks)
        self.verify = bool(verify)
        self._verified = set()

    @classmethod
    def open(cls, directory, verify=True):
        """Open and validate. BlockStoreError names every defect: a
        missing or foreign manifest, version skew, and a per-block size
        mismatch (a stale manifest over regenerated blocks, or a
        truncated block)."""
        directory = str(directory)
        mpath = os.path.join(directory, MANIFEST_NAME)
        if not os.path.exists(mpath):
            raise BlockStoreError(
                f"{directory} has no {MANIFEST_NAME} (not a block store, "
                "or an interrupted build)")
        try:
            with open(mpath, "r") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise BlockStoreError(f"{mpath} is unreadable or not JSON: {e}")
        if manifest.get("magic") != BLOCK_MAGIC:
            raise BlockStoreError(
                f"{mpath} has foreign magic {manifest.get('magic')!r} "
                f"(expected {BLOCK_MAGIC})")
        version = int(manifest.get("format_version", 0))
        if version > FORMAT_VERSION:
            raise BlockStoreError(
                f"{directory} is block-store format {version}; this "
                f"build reads up to {FORMAT_VERSION}")
        for key in ("num_rows", "num_stored", "block_rows", "dtype",
                    "blocks"):
            if key not in manifest:
                raise BlockStoreError(
                    f"{mpath} is truncated (missing {key!r})")
        rows = 0
        for blk in manifest["blocks"]:
            path = os.path.join(directory, blk["file"])
            if not os.path.exists(path):
                raise BlockStoreError(
                    f"stale manifest: {blk['file']} listed in {mpath} "
                    "does not exist")
            size = os.path.getsize(path)
            if size != int(blk["nbytes"]):
                raise BlockStoreError(
                    f"{blk['file']} is {size} bytes but the manifest "
                    f"records {blk['nbytes']} — truncated block or "
                    "stale manifest")
            if int(blk["row_start"]) != rows:
                raise BlockStoreError(
                    f"stale manifest: {blk['file']} starts at row "
                    f"{blk['row_start']}, expected {rows}")
            rows += int(blk["rows"])
        if rows != int(manifest["num_rows"]):
            raise BlockStoreError(
                f"stale manifest: blocks cover {rows} rows but the "
                f"manifest records {manifest['num_rows']}")
        return cls(directory, manifest, verify=verify)

    def _block_path(self, i):
        return os.path.join(self.directory, self.blocks[i]["file"])

    def _verify_block(self, i):
        if not self.verify or i in self._verified:
            return
        blk = self.blocks[i]
        crc = crc32_file(self._block_path(i))
        if crc != int(blk["crc32"]):
            raise BlockStoreError(
                f"{blk['file']} is corrupt (crc32 {crc:#010x} != "
                f"manifest {int(blk['crc32']):#010x})")
        self._verified.add(i)

    def block_rows_of(self, i):
        return int(self.blocks[i]["rows"])

    def row_start_of(self, i):
        return int(self.blocks[i]["row_start"])

    def reverify(self, lo, hi):
        """A fresh crc32 check of blocks [lo, hi) now, their verified-once
        entries dropped: after a restart the store sat on disk through a
        kill, and bit rot must surface here as a named BlockStoreError,
        not as garbage histograms."""
        faults.bitrot_block_if_armed(self._block_path, lo, hi)
        was_verify = self.verify
        self.verify = True
        try:
            for i in range(int(lo), int(hi)):
                self._verified.discard(i)
                self._verify_block(i)
        finally:
            self.verify = was_verify

    def read_block(self, i):
        """Read-only (num_stored, rows) memmap of block i (digest
        verified on first touch). Maps are not cached: unmapping drops
        the block's pages from the resident set, which keeps the
        resident bound independent of the blocks a pass visits."""
        self._verify_block(i)
        try:
            mm = np.load(self._block_path(i), mmap_mode="r")
        except Exception as e:
            raise BlockStoreError(
                f"{self.blocks[i]['file']} is unreadable ({e})")
        want = (self.num_stored, self.block_rows_of(i))
        if mm.shape != want or mm.dtype != self.dtype:
            raise BlockStoreError(
                f"{self.blocks[i]['file']} holds {mm.dtype}{mm.shape}, "
                f"manifest says {self.dtype}{want} — stale manifest")
        return mm

    def _read_data(self, i, out, offset=0):
        """Read bytes of block i's array, from element `offset` on,
        straight from the file into the C-contiguous `out` (one read, no
        page-by-page copy out of a mapping); the .npy header is checked
        against the manifest first."""
        self._verify_block(i)
        name = self.blocks[i]["file"]
        want = (self.num_stored, self.block_rows_of(i))
        try:
            with open(self._block_path(i), "rb") as f:
                version = np.lib.format.read_magic(f)
                read_header = (np.lib.format.read_array_header_1_0
                               if version == (1, 0) else
                               np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read_header(f)
                if shape != want or fortran or np.dtype(dtype) != self.dtype:
                    raise BlockStoreError(
                        f"{name} holds {dtype}{shape}, manifest says "
                        f"{self.dtype}{want} — stale manifest")
                f.seek(offset * self.dtype.itemsize, os.SEEK_CUR)
                got = f.readinto(memoryview(out).cast("B"))
        except (OSError, ValueError) as e:
            raise BlockStoreError(f"{name} is unreadable ({e})")
        if got != out.nbytes:
            raise BlockStoreError(f"{name} is truncated ({got} of "
                                  f"{out.nbytes} data bytes)")
        return out

    def read_block_into(self, i, out):
        """Copy block i into `out[:, :rows]` (the prefetcher's staging
        buffers); returns the row count. A C-contiguous `out` of exactly
        the block's shape is filled by one read from the file; otherwise
        through the memmap."""
        rows = self.block_rows_of(i)
        if (out.shape == (self.num_stored, rows) and out.dtype == self.dtype
                and out.flags.c_contiguous):
            self._read_data(i, out)
            return rows
        mm = self.read_block(i)
        out[:, :rows] = mm
        return rows

    def feature_rows(self, i, feat):
        """One stored feature's row of block i: one contiguous read from
        the file (the per-split partition update's path)."""
        rows = self.block_rows_of(i)
        return self._read_data(i, np.empty(rows, self.dtype),
                               int(feat) * rows)

    def load_sidecar(self):
        path = os.path.join(self.directory, SIDECAR_NAME)
        side = self.manifest.get("sidecar") or {}
        try:
            size = os.path.getsize(path)
        except OSError:
            raise BlockStoreError(f"{self.directory} has no {SIDECAR_NAME}")
        if side and size != int(side.get("nbytes", size)):
            raise BlockStoreError(
                f"{SIDECAR_NAME} is {size} bytes but the manifest "
                f"records {side.get('nbytes')} — stale manifest")
        try:
            return np.load(path, allow_pickle=True)
        except Exception as e:
            raise BlockStoreError(f"{SIDECAR_NAME} is unreadable ({e})")

    def total_bytes(self):
        return sum(int(b["nbytes"]) for b in self.blocks)


class _BlockBinsView:
    """Fancy-indexable [feat_arr, row_arr] view over the block store:
    the host bin-space traversal of DART's drops, early-stop truncation
    and rollback (Tree.get_leaf_by_bins, Tree.predict_by_bins), which
    index bins by paired (feature, row) arrays. Rows are grouped by
    their block and gathered through its memmap."""

    def __init__(self, store):
        self._store = store
        self.shape = (store.num_stored, store.num_rows)

    def __getitem__(self, key):
        feat, rows = key
        feat, rows = np.broadcast_arrays(np.asarray(feat), np.asarray(rows))
        out = np.zeros(feat.shape, dtype=np.int64)
        blk = rows // self._store.block_rows
        for b in np.unique(blk):
            sel = blk == b
            mm = self._store.read_block(int(b))
            local = rows[sel] - int(b) * self._store.block_rows
            out[sel] = mm[feat[sel], local].astype(np.int64)
        return out


class OutOfCoreDataset(CoreDataset):
    """CoreDataset whose bin matrix lives in a block store. Mappers,
    maps and metadata are in RAM; `bins` stays None, and the paths that
    would need a resident matrix stream (data/ooc_learner.py), decode
    through the block view (host traversal), or refuse by name (subset
    and cv, device_bins, save_binary)."""

    def __init__(self):
        super().__init__()
        self.block_store = None

    @property
    def num_data(self):
        return 0 if self.block_store is None else self.block_store.num_rows

    @property
    def max_stored_bin(self):
        return self.max_num_bin  # the block store never bundles

    @property
    def stored_bins_dtype(self):
        return self.block_store.dtype

    def traversal_bins(self):
        return _BlockBinsView(self.block_store)

    def stacked_leaves(self, sf, thr, lc, rc, n_splits, depth):
        """(M, N) int64 leaf of every row through M stacked trees of
        host (M, S) bin-space arrays (split_feature, split_threshold_bin,
        left_child, right_child; leaves as ~leaf) and (M,) n_splits: the
        lockstep walk of score_updater.stacked_deltas, block by block on
        the host (a dataset without device bins)."""
        store = self.block_store
        is_cat = self.feature_is_categorical()
        m = sf.shape[0]
        t_idx = np.arange(m)[:, None]
        out = np.zeros((m, self.num_data), np.int64)
        for b, s in self._block_starts():
            blk = np.asarray(store.read_block(b))
            rows = np.arange(blk.shape[1])[None, :]
            node = np.where(n_splits > 0, 0, -1).astype(np.int32)[:, None]
            node = np.broadcast_to(node, (m, blk.shape[1])).copy()
            for _ in range(int(depth)):
                nd = np.maximum(node, 0)
                feat = sf[t_idx, nd]
                fv = blk[feat, rows].astype(np.int64)
                th = thr[t_idx, nd]
                go_left = np.where(is_cat[feat], fv == th, fv <= th)
                nxt = np.where(go_left, lc[t_idx, nd], rc[t_idx, nd])
                node = np.where(node < 0, node, nxt)
            out[:, s:s + blk.shape[1]] = np.where(node < 0, ~node, 0)
        return out

    def _block_starts(self):
        """(block, first row of the block in this dataset's rows) of the
        blocks its rows come from: every block of the store."""
        store = self.block_store
        return [(b, store.row_start_of(b)) for b in range(store.num_blocks)]

    def device_bins(self, device):
        Log.fatal("out-of-core dataset has no resident bin matrix; "
                  "bind it as the TRAIN set (valid sets stay in-RAM)")

    def subset(self, indices):
        Log.fatal("subset()/cv is not supported on an out-of-core "
                  "dataset; train on the full block store")

    def save_binary(self, path):
        Log.fatal("save_binary is redundant for an out-of-core dataset: "
                  "the block store at %s already is the binary form",
                  self.block_store.directory if self.block_store else "?")

    def materialize_in_ram(self):
        """Every block read back into a resident CoreDataset (the same
        binning by construction): the in-RAM half of parity checks.
        Training never calls it."""
        store = self.block_store
        core = CoreDataset()
        core.bins = np.concatenate(
            [np.array(store.read_block(i)) for i in range(store.num_blocks)],
            axis=1)
        core.bin_mappers = self.bin_mappers
        core.used_feature_map = self.used_feature_map
        core.real_feature_idx = self.real_feature_idx
        core.feature_names = list(self.feature_names)
        core.num_total_features = self.num_total_features
        core.label_idx = self.label_idx
        core.metadata = self.metadata
        return core


# --------------------------------------------------------------- sidecar

def _dataset_from_sidecar(z, store):
    ds = OutOfCoreDataset()
    ds.block_store = store
    decode_dataset_sidecar(
        ds, z, lambda msg: BlockStoreError(f"sidecar is truncated ({msg})"))
    if len(ds.metadata.label) != store.num_rows:
        raise BlockStoreError(
            f"sidecar label has {len(ds.metadata.label)} rows but the "
            f"manifest records {store.num_rows} — stale store")
    return ds


# ----------------------------------------------------------- build paths

def effective_block_rows(cfg):
    """`block_rows` rounded up to a multiple of both row grids a block
    boundary must land on: the histogram kernels' HIST_CHUNK (the Kahan
    chunk grid the bit-parity contract rests on) and device_row_chunk
    (the linear-leaf fit's accumulation grid, models/linear_leaves.py).
    The JAX package rounds to device_row_chunk alone, its histogram
    chunk."""
    chunk = int(np.lcm(HIST_CHUNK, max(1, int(cfg.device_row_chunk))))
    want = max(1, int(cfg.block_rows))
    rows = ((want + chunk - 1) // chunk) * chunk
    if rows != want:
        Log.warning("block_rows=%d rounded up to %d (a multiple of "
                    "HIST_CHUNK=%d and device_row_chunk=%d keeps block "
                    "boundaries on the histogram and fit chunk grids)",
                    want, rows, HIST_CHUNK, int(cfg.device_row_chunk))
    return rows


def spill_core_dataset(core, directory, block_rows, verify=True):
    """Write an in-RAM CoreDataset into a block store and return the
    OutOfCoreDataset over it (the matrix path; text files stream
    block by block through build_block_store_from_file and never
    materialize the matrix). The returned dataset holds no matrix."""
    if core.bundle_plan is not None:
        Log.fatal("out_of_core does not compose with feature bundling "
                  "yet; set is_enable_sparse=false")
    writer = BlockStoreWriter(directory, core.bins.shape[0],
                              core.bins.dtype, block_rows)
    r = int(block_rows)
    for s in range(0, core.num_data, r):
        writer.append(core.bins[:, s:s + r])
    writer.finish(encode_dataset_sidecar(core))
    store = BlockStore.open(directory, verify=verify)
    ds = _dataset_from_sidecar(store.load_sidecar(), store)
    Log.info("Spilled %d x %d bins to block store %s (%d blocks of %d "
             "rows)", core.bins.shape[0], core.num_data, str(directory),
             store.num_blocks, store.block_rows)
    return ds


def spill_anonymous(core, cfg):
    """The matrix path's spill (io/dataset.py construct_from_matrix with
    out_of_core): into `ooc_dir`, or into a fresh temp directory that is
    removed when the returned dataset dies (an anonymous matrix has no
    reuse identity)."""
    anonymous = not cfg.ooc_dir
    directory = cfg.ooc_dir or tempfile.mkdtemp(prefix="lightgbm_tpu_blocks_")
    out = spill_core_dataset(core, directory, effective_block_rows(cfg),
                             verify=cfg.ooc_verify)
    if anonymous:
        weakref.finalize(out, shutil.rmtree, directory, ignore_errors=True)
    return out


def _binning_signature(cfg):
    return {
        "max_bin": int(cfg.max_bin),
        "data_random_seed": int(cfg.data_random_seed),
        "bin_construct_sample_cnt": int(cfg.bin_construct_sample_cnt),
        "has_header": bool(cfg.has_header),
        "label_column": str(cfg.label_column),
        "weight_column": str(cfg.weight_column),
        "group_column": str(cfg.group_column),
        "ignore_column": str(cfg.ignore_column),
        "categorical_column": str(cfg.categorical_column),
    }


def build_block_store_from_file(loader, filename, directory):
    """Two-round streaming build straight into a block store: round one
    samples rows and derives the bin mappers (the in-memory path's
    draws, so its mappers), round two re-reads the file in parse blocks,
    bins each and appends it to the writer. Peak memory is O(parse block
    + store block + metadata); the (F, N) matrix never exists."""
    from ..io.parser import detect_format
    from ..io.streaming import (collect_sample_rows, iter_blocks,
                                prefetch_blocks, scan_file)
    cfg = loader.config
    build_count = 1
    prior = os.path.join(directory, MANIFEST_NAME)
    if os.path.exists(prior):
        try:
            with open(prior, "r") as f:
                build_count = int(json.load(f).get("build_count", 0)) + 1
        except (OSError, ValueError):
            build_count = 1
    fmt = detect_format(filename)
    n, names, num_cols = scan_file(filename, fmt, cfg.has_header)
    if n == 0:
        Log.fatal("Data file %s is empty", str(filename))
    label_idx = loader._resolve_label_idx(names, fmt)
    feat_names = ([nm for i, nm in enumerate(names) if i != label_idx]
                  if names is not None else None)
    num_feats = num_cols - 1
    feat_cols = np.asarray([j for j in range(num_cols) if j != label_idx])
    weight_idx, group_idx, ignore, categorical = loader._resolve_columns(
        feat_names, num_feats)
    if weight_idx >= 0:
        ignore.add(weight_idx)
    if group_idx >= 0:
        ignore.add(group_idx)

    sample_feats = collect_sample_rows(filename, fmt, cfg.has_header,
                                       num_cols, loader._sample_rows(n)
                                       )[:, feat_cols]
    mappers, used_map, real_idx = loader._make_mappers(
        lambda j: sample_feats[:, j], num_feats, ignore, categorical)
    # the in-RAM path would bundle here and train on bundle slots; the
    # block store bins per feature, so a real plan would train another
    # model
    if loader._plan(mappers, lambda u: sample_feats[:, real_idx[u]]) \
            is not None:
        Log.fatal("out_of_core does not compose with feature bundling "
                  "yet; set is_enable_sparse=false")

    dtype = bins_dtype(max(m.num_bin for m in mappers))
    writer = BlockStoreWriter(directory, len(mappers), dtype,
                              effective_block_rows(cfg))
    label = np.empty(n, dtype=np.float32)
    weights = np.empty(n, dtype=np.float32) if weight_idx >= 0 else None
    qid = np.empty(n, dtype=np.float64) if group_idx >= 0 else None
    binned = None
    for start, block in prefetch_blocks(
            iter_blocks(filename, fmt, cfg.has_header, num_cols)):
        end = start + len(block)
        label[start:end] = block[:, label_idx]
        feats_block = block[:, feat_cols]
        if weights is not None:
            weights[start:end] = feats_block[:, weight_idx]
        if qid is not None:
            qid[start:end] = feats_block[:, group_idx]
        if binned is None or binned.shape[1] < len(block):
            binned = np.empty((len(mappers), len(block)), dtype)
        for u, j in enumerate(real_idx):
            binned[u, :len(block)] = \
                mappers[u].value_to_bin(feats_block[:, j]).astype(dtype)
        writer.append(binned[:, :len(block)])

    meta = Metadata(n)
    meta.set_label(label)
    if weights is not None:
        meta.set_weights(weights)
    if qid is not None:
        meta.set_query(_qid_to_counts(qid))
    meta.load_side_files(filename)

    proto = CoreDataset()
    proto.num_total_features = num_feats
    proto.feature_names = (list(feat_names) if feat_names is not None
                           else [f"Column_{i}" for i in range(num_feats)])
    proto.bin_mappers = mappers
    proto.used_feature_map = used_map
    proto.real_feature_idx = np.asarray(real_idx, dtype=np.int32)
    proto.label_idx = label_idx
    proto.metadata = meta
    writer.finish(encode_dataset_sidecar(proto),
                  source=source_signature(filename),
                  binning=_binning_signature(cfg),
                  build_count=build_count)
    Log.info("Built block store %s: %d rows x %d features, %d blocks "
             "of %d rows (%s)", str(directory), n, len(mappers),
             len(writer._blocks), writer.block_rows, np.dtype(dtype).name)
    # a journal is usually not open yet at load time (the booster opens
    # it later), so the manifest's build_count is the durable record;
    # when one is current the binning pass lands on the timeline too
    from ..telemetry import journal as run_journal
    j = run_journal.current()
    if j is not None:
        j.event("binning", rows=int(n), blocks=len(writer._blocks),
                directory=str(directory), features=len(mappers),
                build_count=int(build_count))


def open_block_store_dataset(directory, verify=True):
    """A finished block-store directory as an OutOfCoreDataset: no
    source file, no binning pass."""
    store = BlockStore.open(directory, verify=verify)
    return _dataset_from_sidecar(store.load_sidecar(), store)


def _try_open_matching(cfg, directory, filename, warn_mismatch=True):
    """The store at `directory` when its manifest matches this (source,
    binning, block geometry) signature; None otherwise (quietly for a
    gang peer polling for rank 0's build)."""
    if not os.path.exists(os.path.join(directory, MANIFEST_NAME)):
        return None
    try:
        cand = BlockStore.open(directory, verify=cfg.ooc_verify)
    except BlockStoreError as e:
        if warn_mismatch:
            Log.warning("Ignoring unusable block store: %s", e)
        return None
    if (cand.manifest.get("source") == source_signature(filename)
            and cand.manifest.get("binning") == _binning_signature(cfg)
            and cand.block_rows == effective_block_rows(cfg)):
        Log.info("Reusing block store %s (%d blocks)", directory,
                 cand.num_blocks)
        return cand
    if warn_mismatch:
        Log.warning("Block store %s was built from a different (source, "
                    "binning, block_rows) signature; rebuilding",
                    directory)
    return None


def load_or_build_block_store(loader, filename):
    """The loader's out-of-core entry: open the store next to the data
    file (or at ooc_dir) when its manifest matches this (source,
    binning, block geometry) signature, stream-rebuild it otherwise."""
    cfg = loader.config
    directory = cfg.ooc_dir or (str(filename) + ".blocks")
    store = _try_open_matching(cfg, directory, filename)
    if store is None:
        build_block_store_from_file(loader, filename, directory)
        store = BlockStore.open(directory, verify=cfg.ooc_verify)
    return _dataset_from_sidecar(store.load_sidecar(), store)


# --------------------------------------------------- shared-store gang

class _OffsetBinsView:
    """A gang rank's local-row traversal view: local row r is global row
    r + row_lo of the shared store."""

    def __init__(self, store, row_lo, num_rows):
        self._view = _BlockBinsView(store)
        self._off = int(row_lo)
        self.shape = (store.num_stored, int(num_rows))

    def __getitem__(self, key):
        feat, rows = key
        return self._view[feat, np.asarray(rows) + self._off]


class OutOfCoreGangView(OutOfCoreDataset):
    """One rank's view of a SHARED block store: the store handle and
    this rank's contiguous owned block range (parallel/machines.py
    partition_blocks). Rows are local (the metadata sliced to the owned
    rows, num_data the owned rows), so the booster's row-sharded
    process-group path (local scores, the global snapshot gather and
    re-slice in rank order) applies unchanged; only the gang learner
    (data/ooc_parallel.py) reads the shared store behind those rows."""

    def __init__(self):
        super().__init__()
        self.gang_rank = 0
        self.gang_world = 1
        self.block_lo = 0
        self.block_hi = 0
        self.row_lo = 0
        self.row_hi = 0
        self.global_num_data = 0

    @property
    def num_data(self):
        return self.row_hi - self.row_lo

    def traversal_bins(self):
        return _OffsetBinsView(self.block_store, self.row_lo,
                               self.num_data)

    def _block_starts(self):
        """The owned blocks, each at its first local row."""
        store = self.block_store
        return [(b, store.row_start_of(b) - self.row_lo)
                for b in range(self.block_lo, self.block_hi)]


def gang_view_of(ds, rank, num_machines):
    """One rank's gang view of a whole-store OutOfCoreDataset. The world
    size runs through the `stale_ownership` fault: an armed rank derives
    its range from a stale (one larger) world, and the cross-rank tiling
    check (_check_gang_tiling) must catch it."""
    from ..parallel.machines import partition_blocks
    store = ds.block_store
    world = faults.stale_ownership_world(num_machines)
    blo, bhi = partition_blocks(store.num_blocks, world, int(rank))
    row_lo = (store.row_start_of(blo) if blo < store.num_blocks
              else store.num_rows)
    row_hi = (store.row_start_of(bhi) if bhi < store.num_blocks
              else store.num_rows)
    view = OutOfCoreGangView()
    view.block_store = store
    view.bin_mappers = ds.bin_mappers
    view.used_feature_map = ds.used_feature_map
    view.real_feature_idx = ds.real_feature_idx
    view.feature_names = list(ds.feature_names)
    view.num_total_features = ds.num_total_features
    view.label_idx = ds.label_idx
    view.metadata = ds.metadata.subset(np.arange(row_lo, row_hi))
    view.gang_rank = int(rank)
    view.gang_world = int(num_machines)
    view.block_lo, view.block_hi = int(blo), int(bhi)
    view.row_lo, view.row_hi = int(row_lo), int(row_hi)
    view.global_num_data = int(store.num_rows)
    return view


def _check_gang_tiling(view, num_blocks, num_machines):
    """COLLECTIVE: every rank gathers every rank's claimed block range
    (parallel/distributed.py host_allgather) and checks that they tile
    the store exactly; a rank that fails raises a BlockStoreError before
    any histogram is built."""
    from ..parallel import distributed
    from ..parallel.heartbeat import collective_guard
    from ..parallel.machines import check_block_tiling
    if distributed.num_processes() != num_machines:
        Log.fatal("num_machines=%d but %d processes are running; block "
                  "ownership would not tile the store", num_machines,
                  distributed.num_processes())
    mine = np.asarray([view.block_lo, view.block_hi], dtype=np.int64)
    with collective_guard("ooc:ownership_gather"):
        ranges = distributed.host_allgather(mine).reshape(-1, 2)
    try:
        check_block_tiling([tuple(int(v) for v in r) for r in ranges],
                           num_blocks)
    except ValueError as e:
        raise BlockStoreError(str(e))


def load_block_store_gang(loader, filename, rank, num_machines):
    """The gang's entry: ONE shared store, built once. Rank 0 reuses or
    stream-builds it (load_or_build_block_store); its peers poll for a
    signature-matching manifest (written last and atomically, so a
    matching open is a complete store) for up to ooc_build_wait_s. Every
    rank then takes its owned-block view and checks the tiling."""
    cfg = loader.config
    directory = cfg.ooc_dir or (str(filename) + ".blocks")
    if int(rank) == 0:
        ds = load_or_build_block_store(loader, filename)
    else:
        store = None
        deadline = time.monotonic() + float(cfg.ooc_build_wait_s)
        while store is None:
            store = _try_open_matching(cfg, directory, filename,
                                       warn_mismatch=False)
            if store is None:
                if time.monotonic() >= deadline:
                    raise BlockStoreError(
                        f"rank {rank}: no signature-matching block store "
                        f"appeared at {directory} within "
                        f"{cfg.ooc_build_wait_s:.0f}s (ooc_build_wait_s): "
                        "did rank 0's build fail?")
                time.sleep(0.5)
        ds = _dataset_from_sidecar(store.load_sidecar(), store)
    view = gang_view_of(ds, rank, num_machines)
    _check_gang_tiling(view, ds.block_store.num_blocks, num_machines)
    Log.info("Rank %d/%d owns blocks [%d, %d) = rows [%d, %d) of %d "
             "(shared store %s)", rank, num_machines, view.block_lo,
             view.block_hi, view.row_lo, view.row_hi,
             view.global_num_data, directory)
    return view
