"""Binned dataset container + loader (port of lightgbm_tpu/io/dataset.py).

Reference: include/LightGBM/dataset.h:278-421, src/io/dataset.cpp,
include/LightGBM/dataset_loader.h, src/io/dataset_loader.cpp:162-941.

The training data is ONE dense features-major integer matrix `bins` of
shape (stored rows, num_data) at its natural packed width (bins_dtype:
uint8 when every stored row has <= 256 bins, int16 up to 32768). It
moves to the device once, at that width, and every histogram kernel
streams it there (`device_bins`). Stored rows are the features, or, when
exclusive feature bundling engages (is_enable_sparse, io/bundling.py),
the bundle plan's slots: mutually exclusive sparse features share one
row, so a one-hot-heavy table stores a few rows for many features. A
bundled matrix is built on the host on every route (matrix, column
source, two-round stream, O(nnz) LibSVM stream, aligned valid sets,
which share the train plan), as in the JAX package.

Sources: dense matrices and column sources (DenseColumns, CscColumns:
sparse inputs bin one column at a time), CSV/TSV/LibSVM files parsed in
memory or streamed in two rounds (use_two_round_loading, and wide LibSVM
files in O(nnz)), valid files binned with the training mappers, and the
binary cache (save_binary / load_binary, the JAX package's npz format:
a cache written by either package loads in the other).

Binning runs where the dataset is built for. A loader given a device
(DatasetLoader(device=...), which Dataset.construct(device=) passes on
from the Booster) bins a dense float32 matrix of numerical features
there, with the kernel of ops/bin_kernels.py on a CUDA device (its
plain version on the CPU), as the JAX package bins such a matrix on its
accelerator; the card's bins then seed `device_bins`. Every other
input, and a loader without a device, takes the host pass
(BinMapper.value_to_bin), bin for bin the same. Float64 matrices (every
text load) and categorical columns always take the host pass, as in the
JAX package. A failed build or launch raises: there is no fallback.

Later slices of the port: out-of-core block stores (ROADMAP queue 1
item 5), per-rank row partitions (item 6) and the training-time dataset
profile (item 7).
"""

import os

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.log import LightGBMError, Log
from ..utils.random import Random
from .bin_mapper import BinMapper, CATEGORICAL, NUMERICAL
from .bundling import (BundlePlan, build_stored_matrix, log_conflicts,
                       plan_bundles, write_member)
from .metadata import Metadata
from .parser import ZERO_THRESHOLD, detect_format, libsvm_pairs, \
    parse_text_file

# the JAX package's binary cache format, so that a cache written by one
# package loads in the other. v2: bins persist at their natural packed
# width (uint8 <= 256 bins, int16 above). v1 caches (uint8/uint16) still
# load, uint16 narrowed to int16; anything wider is rejected.
BINARY_MAGIC = "lightgbm_tpu_dataset_v1"
BINARY_FORMAT_VERSION = 2
_ZIP_MAGIC = b"PK\x03\x04"  # npz container prefix
_BINS_CACHE_DTYPES = ("uint8", "uint16", "int16", "int32")

_TORCH_BINS_DTYPE = {np.dtype(np.uint8): torch.uint8,
                     np.dtype(np.int16): torch.int16,
                     np.dtype(np.int32): torch.int32}

AUTO_STREAM_MIN_FEATS = 1024


def bins_dtype(num_bins):
    """Natural storage width of a bin matrix — the packed-bin contract
    the loader and the histogram kernels share: uint8 when every stored
    row has <= 256 bins, int16 up to 32768 (bin ids are non-negative so
    the sign bit is free), int32 beyond."""
    if num_bins <= 256:
        return np.uint8
    if num_bins <= 32768:
        return np.int16
    return np.int32


def _later_slice(what, item):
    return NotImplementedError(
        f"{what} is a later slice of lightgbm_tpu_torch (ROADMAP queue 1 "
        f"item {item})")


class BinaryDatasetError(Exception):
    """A binary dataset file failed validation. `claimed` is True when
    the file LOOKS like a binary dataset (npz container) but is
    truncated/corrupt/foreign, as opposed to a text file that was never
    binary at all, so callers can fall past a rotten cache with a
    warning while staying silent for ordinary text data files."""

    def __init__(self, message, claimed=False):
        super().__init__(message)
        self.claimed = claimed


class _VirtualBinsView:
    """Fancy-indexable [feat, rows] view of a bundled stored matrix in
    virtual feature space (io/bundling.py's encoding): a member owns the
    slot window (off, off + nb - 1]; anything else is its bin 0."""

    def __init__(self, stored, plan, num_bin_pf):
        self._stored = stored
        self._plan = plan
        self._nb = np.asarray(num_bin_pf)
        self.shape = (len(plan.feat_slot), stored.shape[1])

    def __getitem__(self, key):
        feat, rows = key
        feat = np.asarray(feat)
        sc = self._stored[self._plan.feat_slot[feat], rows].astype(np.int64)
        off = self._plan.feat_offset[feat]
        nb = self._nb[feat]
        return np.where((sc > off) & (sc <= off + nb - 1), sc - off, 0)


def _qid_to_counts(qid_col):
    """Row-order run-length encoding of a per-row query-id column into
    per-query counts (Metadata::LoadQueryBoundaries semantics,
    metadata.cpp:358-371)."""
    qid = np.asarray(qid_col).astype(np.int64)
    if len(qid) == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.nonzero(np.diff(qid))[0] + 1
    edges = np.concatenate([[0], change, [len(qid)]])
    return np.diff(edges)


def _libsvm_looks_wide(filename, has_header):
    """Cheap probe: is this a LibSVM file whose feature ids reach past
    AUTO_STREAM_MIN_FEATS within the first 1000 data lines? Wide sparse
    files auto-route to the O(nnz) streaming loader; narrow ones keep
    the in-memory path."""
    try:
        if detect_format(filename) != "libsvm":
            return False
        with open(filename, "r") as f:
            if has_header:
                next(f, None)
            for _, line in zip(range(1000), f):
                parts = line.split()
                if len(parts) < 2:
                    continue
                for idx, _ in libsvm_pairs(parts[1:]):
                    if idx + 1 > AUTO_STREAM_MIN_FEATS:
                        return True
    except (OSError, ValueError, LightGBMError):
        return False  # unreadable / undecodable / empty: not libsvm
    return False


def check_bins_budget(rows, cols, itemsize, what):
    """Loud guard before allocating a stored bin matrix: a wide sparse
    dataset would otherwise materialize the dense F x N block the
    reference's SparseBin exists to avoid (src/io/sparse_bin.hpp).
    Budget in GB via LIGHTGBM_TPU_MAX_BINS_GB (default 16; <= 0
    disables)."""
    budget_gb = float(os.environ.get("LIGHTGBM_TPU_MAX_BINS_GB", "16"))
    if budget_gb <= 0:
        return
    need = rows * cols * itemsize / (1 << 30)
    if need > budget_gb:
        Log.fatal(
            "%s needs a %d x %d bin matrix (%.1f GB > budget %.0f GB). "
            "For wide sparse data enable bundling (is_enable_sparse=true"
            ") so exclusive features share slots; raise/disable the "
            "budget with LIGHTGBM_TPU_MAX_BINS_GB if the dense matrix "
            "is intended.", what, rows, cols, need, budget_gb)


def _bin_columns_threaded(col_fn, count):
    """Map col_fn over column indices with a thread pool: value_to_bin
    is searchsorted-dominated and releases the GIL (the reference's
    OpenMP-parallel ExtractFeatures, dataset_loader.cpp:762-841)."""
    from concurrent.futures import ThreadPoolExecutor
    workers = min(8, os.cpu_count() or 1, max(count, 1))
    if workers <= 1 or count <= 1:
        return [col_fn(j) for j in range(count)]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(col_fn, range(count)))


def is_column_source(obj):
    """True for objects implementing the column-source protocol
    (DenseColumns / CscColumns). A bare hasattr(obj, "col") is NOT
    enough: scipy.sparse COO matrices carry a `.col` ndarray."""
    return callable(getattr(obj, "col", None)) and hasattr(obj, "num_total")


class DenseColumns:
    """Column source over a dense (N, F) matrix (see _construct)."""

    def __init__(self, mat):
        self._m = mat
        self.n, self.num_total = mat.shape

    def col(self, j):
        return self._m[:, j]


class CscColumns:
    """Column source over CSC triplets: each column materializes as ONE
    dense (N,) f32 vector at a time, so a sparse input is binned in
    O(nnz + N) peak memory instead of the O(N * F) dense raw matrix (the
    reference's row-iterator construction, c_api.cpp:317-427)."""

    def __init__(self, colptr, indices, vals, num_row, num_col):
        self._p = np.asarray(colptr, dtype=np.int64)
        self._i = np.asarray(indices, dtype=np.int64)
        self._v = np.nan_to_num(np.asarray(vals, dtype=np.float32), nan=0.0)
        self.n = int(num_row)
        self.num_total = int(num_col)

    def col(self, j):
        out = np.zeros(self.n, dtype=np.float32)
        sl = slice(self._p[j], self._p[j + 1])
        out[self._i[sl]] = self._v[sl]
        return out

    @classmethod
    def from_csr(cls, indptr, indices, vals, num_col):
        """O(nnz log nnz) CSR -> CSC transpose (stable by row within a
        column); never builds the dense matrix."""
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        vals = np.asarray(vals)
        nrow = len(indptr) - 1
        row_of = np.repeat(np.arange(nrow, dtype=np.int64),
                           np.diff(indptr))
        order = np.argsort(indices, kind="stable")
        counts = np.bincount(indices, minlength=num_col)
        colptr = np.concatenate([[0], np.cumsum(counts)])
        return cls(colptr, row_of[order], vals[order], nrow, num_col)


def encode_dataset_sidecar(ds, arrays=None):
    """npz encoding of a CoreDataset minus its bin matrix: feature maps,
    names, bin mappers, bundle plan, metadata (the JAX package's
    dictionary, whose profile this port does not make)."""
    arrays = {} if arrays is None else arrays
    arrays.update({
        "used_feature_map": ds.used_feature_map,
        "real_feature_idx": ds.real_feature_idx,
        "num_total_features": np.asarray(ds.num_total_features),
        "label_idx": np.asarray(ds.label_idx),
        "feature_names": np.asarray(ds.feature_names, dtype=object),
    })
    for i, m in enumerate(ds.bin_mappers):
        for k, v in m.to_dict().items():
            arrays[f"mapper{i}_{k}"] = np.asarray(v)
    if ds.bundle_plan is not None:
        for k, v in ds.bundle_plan.to_dict().items():
            arrays[f"bundle_{k}"] = np.asarray(v)
    for k, v in ds.metadata.to_dict().items():
        arrays[f"meta_{k}"] = np.asarray(v)
    return arrays


def decode_dataset_sidecar(ds, z, truncated):
    """Inverse of encode_dataset_sidecar: populate `ds` (everything but
    bins) from npz archive `z`. `truncated(msg)` builds the exception to
    raise on a structurally incomplete archive. A JAX cache's profile
    members are not read."""
    ds.used_feature_map = z["used_feature_map"]
    ds.real_feature_idx = z["real_feature_idx"]
    ds.num_total_features = int(z["num_total_features"])
    ds.label_idx = int(z["label_idx"])
    ds.feature_names = [str(x) for x in z["feature_names"]]
    n_used = len(ds.real_feature_idx)
    mappers = []
    for i in range(n_used):
        d = {k[len(f"mapper{i}_"):]: z[k] for k in z.files
             if k.startswith(f"mapper{i}_")}
        if "num_bin" not in d:
            raise truncated(f"missing bin mapper {i} of {n_used}")
        mappers.append(BinMapper.from_dict(d))
    ds.bin_mappers = mappers
    bundle = {k[7:]: z[k] for k in z.files if k.startswith("bundle_")}
    if bundle:
        ds.bundle_plan = BundlePlan.from_dict(bundle)
    meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    ds.metadata = Metadata.from_dict(meta)
    return ds


class CoreDataset:
    """Eagerly-binned dataset (the reference's `Dataset`, dataset.h:278-421)."""

    def __init__(self):
        self.bins = None              # (stored rows, N) packed, host
        self.bin_mappers = []         # per used feature
        self.used_feature_map = None  # (num_total_features,) int32: total->used or -1
        self.real_feature_idx = None  # (F_used,) int32: used -> total
        self.feature_names = []       # one per total feature
        self.num_total_features = 0
        self.label_idx = 0
        self.metadata = Metadata()
        self.bundle_plan = None       # io/bundling.py BundlePlan or None
        self.raw_data = None          # (N, C) raw values for init scores
        self._device_bins = {}
        self._bin_value_cache = None

    # ------------------------------------------------------------ properties
    @property
    def num_data(self):
        return 0 if self.bins is None else self.bins.shape[1]

    @property
    def num_features(self):
        return len(self.bin_mappers)

    @property
    def max_num_bin(self):
        return max((m.num_bin for m in self.bin_mappers), default=1)

    @property
    def max_stored_bin(self):
        """Histogram width of the stored matrix (a bundle slot packs
        several features' bin ranges)."""
        if self.bundle_plan is None:
            return self.max_num_bin
        return int(self.bundle_plan.slot_bins.max())

    def traversal_bins(self):
        """The bins indexable as [feature, rows] in virtual feature
        space: the matrix itself, or a view decoding bundle slots."""
        if self.bundle_plan is None:
            return self.bins
        return _VirtualBinsView(self.bins, self.bundle_plan,
                                self.num_bin_array())

    @property
    def stored_bins_dtype(self):
        return self.bins.dtype

    def num_bin_array(self):
        return np.asarray([m.num_bin for m in self.bin_mappers], dtype=np.int32)

    def feature_is_categorical(self):
        return np.asarray([m.bin_type == CATEGORICAL for m in self.bin_mappers])

    def bin_value_table(self):
        """(F, max_num_bin) float64 bin representative values
        (Feature::BinToValue), non-finite bounds clamped to their
        nearest finite neighbour (lightgbm_tpu CoreDataset.bin_value_table)."""
        if self._bin_value_cache is None:
            table = np.zeros((self.num_features, self.max_num_bin),
                             dtype=np.float64)
            for i, m in enumerate(self.bin_mappers):
                vals = (m.bin_upper_bound if m.bin_type != CATEGORICAL
                        else m.bin_2_categorical.astype(np.float64))
                vals = np.asarray(vals, np.float64).copy()
                bad = ~np.isfinite(vals)
                if bad.any():
                    good = np.nonzero(~bad)[0]
                    if len(good) == 0:
                        vals[:] = 0.0
                    else:
                        idx = np.clip(
                            np.searchsorted(good, np.nonzero(bad)[0]),
                            1, len(good)) - 1
                        vals[bad] = vals[good[idx]]
                table[i, :len(vals)] = vals
            self._bin_value_cache = table
        return self._bin_value_cache

    def device_bins(self, device):
        """The (S, N) stored bin matrix on `device` at its width, moved
        there once and cached per device (binning on the card seeds the
        cache with the kernel's output)."""
        key = str(torch.device(device))
        if key not in self._device_bins:
            self._device_bins[key] = to_device_bins(self.bins, device)
        return self._device_bins[key]

    def subset(self, indices) -> "CoreDataset":
        """Row subset sharing bin mappers (dataset.cpp Subset; Dataset.subset
        and cv use it)."""
        indices = np.asarray(indices, dtype=np.int64)
        out = CoreDataset()
        out.bins = np.ascontiguousarray(self.bins[:, indices])
        out.bin_mappers = self.bin_mappers
        out.used_feature_map = self.used_feature_map
        out.real_feature_idx = self.real_feature_idx
        out.feature_names = self.feature_names
        out.num_total_features = self.num_total_features
        out.label_idx = self.label_idx
        out.bundle_plan = self.bundle_plan
        out.metadata = self.metadata.subset(indices)
        if self.raw_data is not None:
            out.raw_data = self.raw_data[indices]
        return out

    # ------------------------------------------------------------- alignment
    def check_align(self, other: "CoreDataset") -> bool:
        """Bin-mapper compatibility between train/valid (dataset.h CheckAlign)."""
        if self.num_features != other.num_features:
            return False
        if self.num_total_features != other.num_total_features:
            return False
        return all(a == b for a, b in zip(self.bin_mappers, other.bin_mappers))

    # --------------------------------------------------------- binary cache
    def save_binary(self, path):
        """Binary cache (reference dataset.cpp:133-212), written
        crash-atomically with uncompressed members, so the loader maps
        the bins through the page cache (io/mmap_io.py)."""
        from ..utils.checkpoint import atomic_open
        arrays = encode_dataset_sidecar(self, {"bins": np.asarray(self.bins)})
        with atomic_open(path) as f:
            np.savez(f, magic=np.asarray(BINARY_MAGIC),
                     format_version=np.asarray(BINARY_FORMAT_VERSION),
                     **arrays)
        Log.info("Saved binary dataset to %s", str(path))

    @classmethod
    def load_binary(cls, path) -> "CoreDataset":
        """Load + validate a binary dataset cache. Every failure a
        truncated, bit-rotted or foreign file can produce surfaces as a
        BinaryDatasetError naming the file and the defect, with the JAX
        package's wording."""
        try:
            with open(path, "rb") as f:
                head = f.read(len(_ZIP_MAGIC))
        except OSError as e:
            raise BinaryDatasetError(f"cannot read {path}: {e}")
        if head != _ZIP_MAGIC:
            raise BinaryDatasetError(
                f"{path} is not a lightgbm_tpu binary dataset (bad magic)")
        try:
            z = np.load(path, allow_pickle=True)
            files = set(z.files)
        except Exception as e:  # any unreadable archive is the diagnosis
            raise BinaryDatasetError(
                f"{path} is truncated or corrupt (unreadable archive: "
                f"{e})", claimed=True)
        if "magic" not in files:
            raise BinaryDatasetError(
                f"{path} is an npz archive but not a lightgbm_tpu "
                "dataset (no magic entry)", claimed=True)
        try:
            if str(z["magic"]) != BINARY_MAGIC:
                raise BinaryDatasetError(
                    f"{path} has foreign magic {str(z['magic'])!r} "
                    f"(expected {BINARY_MAGIC})", claimed=True)
            version = (int(z["format_version"])
                       if "format_version" in files else 1)
            if version > BINARY_FORMAT_VERSION:
                raise BinaryDatasetError(
                    f"{path} is format version {version}; this build "
                    f"reads up to {BINARY_FORMAT_VERSION}", claimed=True)
            missing = [k for k in ("bins", "used_feature_map",
                                   "real_feature_idx",
                                   "num_total_features", "label_idx",
                                   "feature_names", "meta_label")
                       if k not in files]
            if missing:
                raise BinaryDatasetError(
                    f"{path} is truncated (missing entries: "
                    f"{', '.join(missing)})", claimed=True)
            ds = cls()
            from .mmap_io import memmap_npz_member
            mapped = memmap_npz_member(path, "bins.npy")
            ds.bins = mapped if mapped is not None else z["bins"]
            decode_dataset_sidecar(
                ds, z, lambda msg: BinaryDatasetError(
                    f"{path} is truncated ({msg})", claimed=True))
        except BinaryDatasetError:
            raise
        except Exception as e:  # zip CRC failures surface at entry access
            raise BinaryDatasetError(
                f"{path} is truncated or corrupt ({e})", claimed=True)
        if ds.bins.ndim != 2:
            raise BinaryDatasetError(
                f"{path}: bins matrix has {ds.bins.ndim} dims, "
                "expected 2", claimed=True)
        if ds.bins.dtype.name not in _BINS_CACHE_DTYPES:
            raise BinaryDatasetError(
                f"{path}: bins matrix is {ds.bins.dtype.name}, expected "
                f"a packed bin matrix ({'/'.join(_BINS_CACHE_DTYPES)}) — "
                "stale or foreign cache", claimed=True)
        natural = bins_dtype(int(ds.max_stored_bin))
        if ds.bins.dtype != natural:
            # v1 caches stored uint16 where the packed contract says
            # int16; bin ids < max_stored_bin make the cast lossless
            ds.bins = ds.bins.astype(natural)
        n_rows = int(ds.bins.shape[1])
        n_label = int(np.asarray(z["meta_label"]).shape[0])
        if n_label != n_rows:
            raise BinaryDatasetError(
                f"{path}: bin matrix holds {n_rows} rows but the label "
                f"has {n_label} — truncated or foreign file",
                claimed=True)
        return ds


def to_device_bins(bins, device):
    """Host (F, N) packed bins -> a torch tensor of the same width on
    `device` (one copy; never widened)."""
    arr = np.ascontiguousarray(bins)
    if not arr.flags.writeable:           # a memory-mapped cache
        arr = arr.copy()
    if arr.dtype not in _TORCH_BINS_DTYPE:
        raise TypeError(f"bins must be uint8/int16/int32, got {arr.dtype}")
    return torch.from_numpy(arr).to(device)


class DatasetLoader:
    """Text/matrix -> CoreDataset pipeline (dataset_loader.cpp:162-941).

    `predict_fun(ds)` seeds init scores for continued training from the
    raw values; `device` is where a dense float32 matrix of numerical
    features is binned (None: the host pass)."""

    def __init__(self, config=None, predict_fun=None, device=None):
        from ..config import Config
        self.config = config if config is not None else Config()
        self.predict_fun = predict_fun
        self.device = None if device is None else resolve_device(device)

    def _check_slice(self):
        if self.config.out_of_core:
            raise _later_slice("out_of_core (block-store datasets)", 5)

    # ----------------------------------------------------------- from file
    def load_from_file(self, filename) -> CoreDataset:
        """A CSV/TSV/LibSVM file or a binary cache (the file itself or
        its `<file>.bin` sibling) -> CoreDataset."""
        cfg = self.config
        self._check_slice()
        bin_path = str(filename) + ".bin"
        # the binary cache stores no raw values, which continued training
        # needs for init scores: take the text path then
        use_cache = cfg.enable_load_from_binary_file and self.predict_fun is None
        cache_incompatible = False
        # CheckCanLoadFromBin (dataset_loader.cpp:903-940): the data path
        # may BE a binary cache file, or have a sibling <data>.bin cache
        if use_cache:
            for cand in (str(filename), bin_path):
                if not os.path.exists(cand):
                    continue
                try:
                    ds = CoreDataset.load_binary(cand)
                except BinaryDatasetError as e:
                    if e.claimed and cand == str(filename):
                        # the data file itself is a broken binary dataset:
                        # the text parser would only produce garbage
                        Log.fatal("%s", e)
                    if e.claimed:
                        Log.warning("ignoring unusable binary cache: %s", e)
                    continue  # not a binary cache; fall through
                if ds.bundle_plan is not None and (
                        not cfg.is_enable_sparse
                        or ds.bundle_plan.conflict_rate
                        > cfg.max_conflict_rate):
                    # bundled with a plan this config cannot use
                    # (bundling off, or a more tolerant plan): rebuild
                    # from text without overwriting the cache
                    Log.warning("Binary cache %s contains a bundled "
                                "dataset incompatible with this config; "
                                "rebuilding from text", cand)
                    cache_incompatible = True
                    break
                Log.info("Loaded binary dataset %s", cand)
                self._attach_init_score(ds)
                return ds

        # two-round streaming path: peak memory O(block), the full float
        # matrix never materializes (dataset_loader.cpp:505-610). Wide
        # LibSVM auto-streams even without use_two_round_loading, unless
        # a weight or group column is set (the streamer would parse
        # dense blocks then).
        if self.predict_fun is None and (
                cfg.use_two_round_loading
                or (cfg.weight_column == "" and cfg.group_column == ""
                    and _libsvm_looks_wide(filename, cfg.has_header))):
            if cfg.max_bad_rows > 0:
                Log.warning("max_bad_rows=%d is not applied on the "
                            "two-round/streaming load path: malformed "
                            "rows still abort the load", cfg.max_bad_rows)
            ds = self._load_two_round(filename)
            if cfg.is_save_binary_file and not cache_incompatible:
                ds.save_binary(bin_path)
            return ds

        label, feats, names, _, label_idx = parse_text_file(
            filename, has_header=cfg.has_header, label_column=cfg.label_column,
            max_bad_rows=cfg.max_bad_rows)
        weight_idx, group_idx, ignore, categorical = self._resolve_columns(
            names, feats.shape[1])
        meta = Metadata(len(label))
        meta.set_label(label)
        if weight_idx >= 0:
            meta.set_weights(feats[:, weight_idx])
            ignore.add(weight_idx)
        if group_idx >= 0:
            # a query id per row, run-length encoded in ROW order
            # (metadata.cpp:358-371)
            meta.set_query(_qid_to_counts(feats[:, group_idx]))
            ignore.add(group_idx)
        meta.load_side_files(filename)

        ds = self._construct(feats, names, ignore, categorical, meta)
        ds.label_idx = label_idx
        if self.predict_fun is not None:
            ds.raw_data = feats  # continued training needs raw values
        self._attach_init_score(ds)
        if cfg.is_save_binary_file and not cache_incompatible:
            ds.save_binary(bin_path)
        return ds

    def load_from_file_align_with_other_dataset(self, filename,
                                                train_ds) -> CoreDataset:
        """Valid-set path: bin with the TRAIN mappers
        (dataset_loader.cpp:222-266)."""
        cfg = self.config
        if (detect_format(filename) == "libsvm"
                and self.predict_fun is None
                and cfg.weight_column == "" and cfg.group_column == ""):
            # O(nnz) aligned route: stream triplets with the TRAIN
            # mappers, never a dense (N, F) parse
            return self._load_sparse_aligned(filename, train_ds)
        label, feats, names, _, _ = parse_text_file(
            filename, has_header=cfg.has_header, label_column=cfg.label_column,
            max_bad_rows=cfg.max_bad_rows)
        meta = Metadata(len(label))
        meta.set_label(label)
        weight_idx, group_idx, _, _ = self._resolve_columns(names,
                                                            feats.shape[1])
        if weight_idx >= 0:
            meta.set_weights(feats[:, weight_idx])
        if group_idx >= 0:
            meta.set_query(_qid_to_counts(feats[:, group_idx]))
        meta.load_side_files(filename)
        ds = self._bin_with_mappers(feats, train_ds, meta)
        if self.predict_fun is not None:
            ds.raw_data = feats
        self._attach_init_score(ds)
        return ds

    # ------------------------------------------------- two-round streaming
    def _load_two_round(self, filename) -> CoreDataset:
        """Sample pass -> mappers -> binning pass (dataset_loader.cpp:
        505-610; io/streaming.py)."""
        from .streaming import (collect_sample_csc, collect_sample_rows,
                                iter_blocks, prefetch_blocks, scan_file)
        cfg = self.config
        fmt = detect_format(filename)
        n, names, num_cols = scan_file(filename, fmt, cfg.has_header)
        if n == 0:
            Log.fatal("Data file %s is empty", str(filename))

        label_idx = self._resolve_label_idx(names, fmt)
        feat_names = ([nm for i, nm in enumerate(names) if i != label_idx]
                      if names is not None else None)
        num_feats = num_cols - 1
        feat_cols = np.asarray([j for j in range(num_cols) if j != label_idx])

        weight_idx, group_idx, ignore, categorical = self._resolve_columns(
            feat_names, num_feats)
        if weight_idx >= 0:
            ignore.add(weight_idx)
        if group_idx >= 0:
            ignore.add(group_idx)

        # O(nnz) route for LibSVM: triplet blocks + CSC sample, never a
        # dense (rows, num_cols) float block
        sparse_route = (fmt == "libsvm" and weight_idx < 0
                        and group_idx < 0)

        # round one: sample rows, find mappers (the in-memory path's
        # draws, so its mappers)
        sample_idx = self._sample_rows(n)
        cnt = len(sample_idx)
        if sparse_route:
            _, s_colptr, s_rows, s_vals = collect_sample_csc(
                filename, cfg.has_header, num_feats, sample_idx)

            def sample_feat_col(j):
                out = np.zeros(cnt, dtype=np.float64)
                sl = slice(s_colptr[j], s_colptr[j + 1])
                out[s_rows[sl]] = s_vals[sl]
                return out
        else:
            sample_feats = collect_sample_rows(
                filename, fmt, cfg.has_header, num_cols,
                sample_idx)[:, feat_cols]

            def sample_feat_col(j):
                return sample_feats[:, j]
        mappers, used_map, real_idx = self._make_mappers(
            sample_feat_col, num_feats, ignore, categorical)
        # the in-memory path's plan: same sample rows, same greedy pass
        plan = self._plan(mappers,
                          lambda u: sample_feat_col(real_idx[u]))

        # round two: stream blocks, pushing binned values + metadata columns
        weights = qid = None
        if sparse_route:
            bins, label = self._stream_sparse_libsvm(filename, mappers,
                                                     used_map, plan, n)
        else:
            dtype, bins = self._alloc_bins(mappers, plan, n,
                                           "streaming load")
            conflicts = 0
            label = np.empty(n, dtype=np.float32)
            weights = (np.empty(n, dtype=np.float32)
                       if weight_idx >= 0 else None)
            qid = np.empty(n, dtype=np.float64) if group_idx >= 0 else None
            # double-buffered: the prefetch thread parses block k+1 while
            # this loop bins block k (pipeline_reader.h:18-70)
            for start, block in prefetch_blocks(
                    iter_blocks(filename, fmt, cfg.has_header, num_cols)):
                end = start + len(block)
                label[start:end] = block[:, label_idx]
                feats_block = block[:, feat_cols]
                if weights is not None:
                    weights[start:end] = feats_block[:, weight_idx]
                if qid is not None:
                    qid[start:end] = feats_block[:, group_idx]
                for u, j in enumerate(real_idx):
                    col = mappers[u].value_to_bin(feats_block[:, j])
                    if plan is None:
                        bins[u, start:end] = col.astype(dtype)
                    else:
                        conflicts += write_member(
                            bins[plan.feat_slot[u], start:end], col,
                            plan.feat_offset[u], dtype)
            log_conflicts(conflicts)

        ds = CoreDataset()
        ds.num_total_features = num_feats
        ds.feature_names = (list(feat_names) if feat_names is not None
                            else [f"Column_{i}" for i in range(num_feats)])
        ds.bins = bins
        ds.bundle_plan = plan
        ds.bin_mappers = mappers
        ds.used_feature_map = used_map
        ds.real_feature_idx = np.asarray(real_idx, dtype=np.int32)
        ds.label_idx = label_idx
        meta = Metadata(n)
        meta.set_label(label)
        if weights is not None:
            meta.set_weights(weights)
        if qid is not None:
            meta.set_query(_qid_to_counts(qid))
        meta.load_side_files(filename)
        ds.metadata = meta
        Log.info("Number of data: %d, number of features: %d (two-round)",
                 n, len(mappers))
        return ds

    def _stream_sparse_libsvm(self, filename, mappers, used_map, plan, n):
        """Round two over LibSVM triplet blocks: O(block nnz) transient
        memory, and the only (rows x cols) allocation is the stored bin
        matrix itself, (slots, N) when bundling engaged. A feature alone
        in its row is pre-filled with its zero bin (a bundle member's is
        0 by the plan's candidate rule), so only nonzero entries are
        binned (the reference's sparse_bin.hpp:17-331 storage,
        densified)."""
        from .streaming import iter_sparse_blocks, prefetch_blocks
        cfg = self.config
        dtype, bins = self._alloc_bins(mappers, plan, n,
                                       "sparse-LibSVM load")
        slot = (np.arange(len(mappers)) if plan is None
                else plan.feat_slot)
        alone = np.bincount(slot, minlength=bins.shape[0])[slot] == 1
        for u, m in enumerate(mappers):
            b0 = int(m.value_to_bin(np.zeros(1))[0])
            if b0 and alone[u]:
                bins[slot[u], :] = b0
        label = np.empty(n, dtype=np.float32)
        conflicts = 0
        for start, lab, rows, cols, vals in prefetch_blocks(
                iter_sparse_blocks(filename, cfg.has_header)):
            label[start:start + len(lab)] = lab
            r = rows + start
            # aligned (valid) files may mention feature ids past the
            # train set's feature space: those are simply unused
            u_arr = np.where(cols < len(used_map),
                             used_map[np.minimum(cols, len(used_map) - 1)],
                             np.int32(-1))
            v = np.nan_to_num(vals, nan=0.0)
            used = u_arr >= 0
            r, v, u_arr = r[used], v[used], u_arr[used]
            # entries grouped by used feature, ascending: in a bundle the
            # first (lowest) member wins a conflict, as on the dense routes
            order = np.argsort(u_arr, kind="stable")
            r, v, u_arr = r[order], v[order], u_arr[order]
            cuts = np.flatnonzero(np.diff(u_arr)) + 1
            for g0, g1 in zip(np.concatenate([[0], cuts]),
                              np.concatenate([cuts, [len(u_arr)]])):
                if g1 <= g0:
                    continue
                u = int(u_arr[g0])
                b = mappers[u].value_to_bin(v[g0:g1]).astype(np.int64)
                rr = r[g0:g1]
                if alone[u]:
                    bins[slot[u], rr] = b.astype(dtype)
                    continue
                nz = b > 0
                rnz = rr[nz]
                clash = bins[slot[u], rnz] != 0
                conflicts += int(clash.sum())
                bins[slot[u], rnz[~clash]] = (
                    b[nz][~clash] + plan.feat_offset[u]).astype(dtype)
        log_conflicts(conflicts)
        return bins, label

    def _load_sparse_aligned(self, filename, train_ds) -> CoreDataset:
        """O(nnz) valid-set LibSVM load with the TRAIN mappers and bundle
        plan (the sparse analog of the dense aligned path)."""
        from .streaming import count_rows
        cfg = self.config
        n = count_rows(filename, cfg.has_header)
        if n == 0:
            Log.fatal("Data file %s is empty", str(filename))
        bins, label = self._stream_sparse_libsvm(
            filename, train_ds.bin_mappers, train_ds.used_feature_map,
            train_ds.bundle_plan, n)
        ds = self._aligned_shell(train_ds)
        ds.bins = bins.astype(train_ds.stored_bins_dtype, copy=False)
        meta = Metadata(n)
        meta.set_label(label)
        meta.load_side_files(filename)
        ds.metadata = meta
        return ds

    # --------------------------------------------------------- from matrix
    def construct_from_matrix(self, data, label=None, reference=None,
                              categorical_features=()) -> CoreDataset:
        """In-memory path (c_api.cpp LGBM_DatasetCreateFromMat:268-315).
        `data` may also be a column source (CscColumns): sparse inputs
        bin column by column, never densified. The columns in
        `categorical_features` and in the config's categorical_column
        (comma-separated indices) bin as categories."""
        self._check_slice()
        if is_column_source(data):
            n = data.n
        else:
            data = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
            data = np.nan_to_num(data, nan=0.0)
            n = data.shape[0]
        meta = Metadata(n)
        if label is not None:
            meta.set_label(label)
        if reference is not None:
            return self._bin_with_mappers(data, reference, meta)
        categorical = (set(int(c) for c in categorical_features)
                       | self._categorical_columns())
        return self._construct(data, None, set(), categorical, meta)

    def _categorical_columns(self):
        """Column indices of the categorical_column config key; a matrix
        has no header, so "name:" selectors are refused."""
        spec = str(self.config.categorical_column or "")
        out = set()
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.startswith("name:"):
                Log.fatal("categorical_column=%s: a matrix has no column "
                          "names; give column indices", spec)
            if int(tok) >= 0:
                out.add(int(tok))
        return out

    # ------------------------------------------------------------ internals
    def _resolve_label_idx(self, names, fmt):
        """Label column resolution (parser semantics; LibSVM labels are
        always column 0)."""
        cfg = self.config
        if fmt == "libsvm" or cfg.label_column == "":
            return 0
        s = str(cfg.label_column)
        if s.startswith("name:"):
            if names is None or s[5:] not in names:
                Log.fatal("Could not find label column %s in data file",
                          s[5:])
            return names.index(s[5:])
        return int(s)

    def _resolve_columns(self, names, num_cols):
        """weight/group/ignore/categorical column resolution. Indices do
        not count the label column (config.h:116-131)."""
        cfg = self.config

        def resolve(spec):
            if spec == "" or spec is None:
                return -1
            s = str(spec)
            if s.startswith("name:"):
                if names is None:
                    Log.fatal("Cannot use name: column selector without header")
                return names.index(s[5:])
            return int(s)

        weight_idx = resolve(cfg.weight_column)
        group_idx = resolve(cfg.group_column)
        ignore = set()
        if cfg.ignore_column:
            for tok in str(cfg.ignore_column).split(","):
                idx = resolve(tok)
                if idx >= 0:
                    ignore.add(idx)
        categorical = set()
        if cfg.categorical_column:
            for tok in str(cfg.categorical_column).split(","):
                idx = resolve(tok)
                if idx >= 0:
                    categorical.add(idx)
        return weight_idx, group_idx, ignore, categorical

    def _sample_rows(self, n):
        cfg = self.config
        cnt = min(cfg.bin_construct_sample_cnt, n)
        if cnt == n:
            return np.arange(n, dtype=np.int64)
        rnd = Random(cfg.data_random_seed)
        return rnd.sample(n, cnt).astype(np.int64)

    def _make_mappers(self, sample_col, num_total, ignore, categorical):
        """Bin-mapper construction from sampled rows
        (ConstructBinMappersFromTextData, dataset_loader.cpp:612-760)."""
        cfg = self.config
        used_map = np.full(num_total, -1, dtype=np.int32)
        mappers, real_idx = [], []
        for j in range(num_total):
            if j in ignore:
                continue
            col_sample = sample_col(j).astype(np.float64)
            nonzero = col_sample[np.abs(col_sample) > ZERO_THRESHOLD]
            btype = CATEGORICAL if j in categorical else NUMERICAL
            m = BinMapper().find_bin(nonzero, len(col_sample), cfg.max_bin,
                                     btype)
            if m.is_trivial:
                Log.warning("Ignoring Column_%d , only has one value", j)
                continue
            used_map[j] = len(mappers)
            real_idx.append(j)
            mappers.append(m)
        if not mappers:
            Log.fatal("Cannot construct Dataset since there are no useful "
                      "features. It should be at least two unique rows.")
        return mappers, used_map, real_idx

    def _plan(self, mappers, sample_col):
        """The bundle plan from the binning sample (io/bundling.py), or
        None when bundling is off or nothing bundles. `sample_col(u)`
        gives used feature u's sample values: planning bins one sample
        column at a time, never the (F, sample) stack."""
        cfg = self.config
        if not cfg.is_enable_sparse:
            return None
        plan = plan_bundles(
            mappers, lambda u: mappers[u].value_to_bin(sample_col(u)),
            enable=True, max_conflict_rate=cfg.max_conflict_rate)
        return None if plan.is_identity else plan

    @staticmethod
    def _alloc_bins(mappers, plan, n, what):
        """(dtype, zeroed (stored rows, n) bin matrix) of an unbundled
        or bundled load, behind the budget guard."""
        if plan is None:
            dtype = bins_dtype(max(m.num_bin for m in mappers))
            rows, what = len(mappers), "Dense (unbundled) " + what
        else:
            dtype = bins_dtype(int(plan.slot_bins.max()))
            rows, what = plan.num_slots, "Bundled " + what
        check_bins_budget(rows, n, np.dtype(dtype).itemsize, what)
        return dtype, np.zeros((rows, n), dtype=dtype)

    def _bin_dense_on_device(self, mat, real_idx, mappers, dtype):
        """(F, N) bins of a dense float32 matrix on the loader's device:
        ops/bin_kernels.bin_dense (the CUDA kernel on a card, its plain
        version on the CPU). Returns (host bins, device bins)."""
        from ..ops.bin_kernels import bin_dense, dense_bounds
        dev = self.device
        bounds = dense_bounds([m.bin_upper_bound for m in mappers])
        x = torch.from_numpy(np.ascontiguousarray(mat)).to(dev)
        cols = torch.from_numpy(np.asarray(real_idx, dtype=np.int32)).to(dev)
        out = bin_dense(x, cols, torch.from_numpy(bounds).to(dev),
                        _TORCH_BINS_DTYPE[np.dtype(dtype)])
        return out.cpu().numpy(), out

    def _construct(self, feats, names, ignore, categorical, meta) -> CoreDataset:
        """Bin-mapper construction + feature extraction
        (ConstructBinMappersFromTextData + ExtractFeatures,
        dataset_loader.cpp:612-841). `feats` is a dense (N, F) matrix or
        a column source."""
        src = feats if is_column_source(feats) else DenseColumns(feats)
        n, num_total = src.n, src.num_total
        sample_idx = self._sample_rows(n)

        def sample_col(j):
            return src.col(j)[sample_idx]

        ds = CoreDataset()
        ds.num_total_features = num_total
        ds.feature_names = (list(names) if names is not None
                            else [f"Column_{i}" for i in range(num_total)])
        mappers, used_map, real_idx = self._make_mappers(
            sample_col, num_total, ignore, categorical)
        # exclusive feature bundling (io/bundling.py): a bundled matrix
        # is built on the host, one column at a time, as in the JAX
        # package, which never bins one on its device
        ds.bundle_plan = self._plan(mappers,
                                    lambda u: sample_col(real_idx[u]))
        if ds.bundle_plan is not None:
            plan = ds.bundle_plan
            dtype = bins_dtype(int(plan.slot_bins.max()))
            check_bins_budget(plan.num_slots, n, np.dtype(dtype).itemsize,
                              "Bundled dataset construction")
            ds.bins = build_stored_matrix(
                plan, lambda u: mappers[u].value_to_bin(
                    src.col(real_idx[u])), dtype)
            return self._finish(ds, mappers, used_map, real_idx, meta)
        dtype = bins_dtype(max(m.num_bin for m in mappers))
        check_bins_budget(len(real_idx), n, np.dtype(dtype).itemsize,
                          "Dense (unbundled) dataset construction")
        # the JAX package's device route (io/dataset.py:156, :1317): a
        # dense float32 matrix of numerical features only; float64 text
        # matrices keep the host pass's f64 compare
        if (self.device is not None and isinstance(src, DenseColumns)
                and src._m.dtype == np.float32
                and all(m.bin_type == NUMERICAL for m in mappers)):
            ds.bins, dev_bins = self._bin_dense_on_device(
                src._m, real_idx, mappers, dtype)
            ds._device_bins[str(self.device)] = dev_bins
        else:
            ds.bins = np.stack(_bin_columns_threaded(
                lambda u: mappers[u].value_to_bin(
                    src.col(real_idx[u])).astype(dtype),
                len(real_idx)), axis=0)
        return self._finish(ds, mappers, used_map, real_idx, meta)

    @staticmethod
    def _finish(ds, mappers, used_map, real_idx, meta):
        ds.bin_mappers = mappers
        ds.used_feature_map = used_map
        ds.real_feature_idx = np.asarray(real_idx, dtype=np.int32)
        ds.metadata = meta
        Log.info("Number of data: %d, number of features: %d",
                 ds.num_data, len(mappers))
        return ds

    @staticmethod
    def _aligned_shell(ref_ds):
        """A CoreDataset sharing `ref_ds`'s feature space and mappers."""
        ds = CoreDataset()
        ds.num_total_features = ref_ds.num_total_features
        ds.label_idx = ref_ds.label_idx
        ds.feature_names = ref_ds.feature_names
        ds.bin_mappers = ref_ds.bin_mappers
        ds.used_feature_map = ref_ds.used_feature_map
        ds.real_feature_idx = ref_ds.real_feature_idx
        ds.bundle_plan = ref_ds.bundle_plan
        return ds

    def _bin_with_mappers(self, feats, ref_ds: CoreDataset, meta) -> CoreDataset:
        """A valid set binned with the training set's mappers (host
        pass); a bundled train set's plan is shared, so scoring decodes
        the valid set's slots as the train set's."""
        src = feats if is_column_source(feats) else DenseColumns(feats)
        ds = self._aligned_shell(ref_ds)
        if src.num_total < ref_ds.num_total_features:
            Log.fatal("Validation data has fewer features than training data")
        dtype = ref_ds.stored_bins_dtype
        real, mappers = ref_ds.real_feature_idx, ref_ds.bin_mappers
        plan = ref_ds.bundle_plan
        check_bins_budget(
            len(mappers) if plan is None else plan.num_slots, src.n,
            np.dtype(dtype).itemsize,
            "Aligned (valid set) dataset construction")
        ds.metadata = meta
        if plan is not None:
            ds.bins = build_stored_matrix(
                plan, lambda u: mappers[u].value_to_bin(src.col(real[u])),
                dtype)
            return ds
        ds.bins = np.stack(_bin_columns_threaded(
            lambda u: mappers[u].value_to_bin(
                src.col(real[u])).astype(dtype), len(mappers)), axis=0)
        return ds

    def _attach_init_score(self, ds):
        """Continued-training init scores via the predictor hook
        (application.cpp:108-115)."""
        if self.predict_fun is not None and ds.metadata.init_score is None:
            raw = self.predict_fun(ds)
            ds.metadata.set_init_score(
                np.asarray(raw, dtype=np.float64).reshape(-1, order="F"))
