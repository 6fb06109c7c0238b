"""Binned dataset container + loader (port of lightgbm_tpu/io/dataset.py).

Reference: include/LightGBM/dataset.h:278-421, src/io/dataset_loader.cpp.

The training data is ONE dense features-major integer matrix `bins` of
shape (num_features, num_data) at its natural packed width (bins_dtype:
uint8 when every feature has <= 256 bins, int16 up to 32768). Binning
runs on the host (the JAX package's host pass, bin for bin); the matrix
then moves to the device once, at that width, and every histogram
kernel streams it there (`device_bins`).

This slice binds dense in-memory matrices (construct_from_matrix), with
numerical and categorical features, and their row subsets. Text files,
the binary cache and sparse column sources are ROADMAP queue 1 item 1,
exclusive feature bundling item 3; the loader raises
NotImplementedError where the JAX package would take one of those
paths.
"""

import numpy as np
import torch

from ..utils.log import Log
from ..utils.random import Random
from .bin_mapper import BinMapper, CATEGORICAL, NUMERICAL
from .metadata import Metadata
from .parser import ZERO_THRESHOLD

# lightgbm_tpu/io/bundling.py: a numerical feature whose zero maps to
# bin 0 and whose sample is at least this sparse is a bundling candidate
SPARSE_THRESHOLD = 0.8

_TORCH_BINS_DTYPE = {np.dtype(np.uint8): torch.uint8,
                     np.dtype(np.int16): torch.int16,
                     np.dtype(np.int32): torch.int32}


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


class CoreDataset:
    """Eagerly-binned dataset (the reference's `Dataset`, dataset.h:278-421)."""

    def __init__(self):
        self.bins = None              # (F_used, N) packed (bins_dtype), host
        self.bin_mappers = []         # per used feature
        self.used_feature_map = None  # (num_total_features,) int32: total->used or -1
        self.real_feature_idx = None  # (F_used,) int32: used -> total
        self.feature_names = []       # one per total feature
        self.num_total_features = 0
        self.label_idx = 0
        self.metadata = Metadata()
        self.bundle_plan = None       # bundling is a later slice: always None
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
        """Histogram width of the stored matrix (no bundle slots here)."""
        return self.max_num_bin

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
        """The (F, N) bin matrix on `device` at its stored width, moved
        there once and cached per device."""
        key = str(device)
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
        out.metadata = self.metadata.subset(indices)
        return out

    # ------------------------------------------------------------- alignment
    def check_align(self, other: "CoreDataset") -> bool:
        """Bin-mapper compatibility between train/valid (dataset.h CheckAlign)."""
        if self.num_features != other.num_features:
            return False
        if self.num_total_features != other.num_total_features:
            return False
        return all(a == b for a, b in zip(self.bin_mappers, other.bin_mappers))


def to_device_bins(bins, device):
    """Host (F, N) packed bins -> a torch tensor of the same width on
    `device` (one copy; never widened)."""
    arr = np.ascontiguousarray(bins)
    if arr.dtype not in _TORCH_BINS_DTYPE:
        raise TypeError(f"bins must be uint8/int16/int32, got {arr.dtype}")
    return torch.from_numpy(arr).to(device)


class DatasetLoader:
    """Matrix -> CoreDataset pipeline (dataset_loader.cpp:162-941)."""

    def __init__(self, config=None):
        from ..config import Config
        self.config = config if config is not None else Config()

    def construct_from_matrix(self, data, label=None, reference=None,
                              categorical_features=()) -> CoreDataset:
        """In-memory path (c_api.cpp LGBM_DatasetCreateFromMat:268-315).
        The columns in `categorical_features` and in the config's
        categorical_column (comma-separated indices) bin as categories."""
        data = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
        data = np.nan_to_num(data, nan=0.0)
        meta = Metadata(data.shape[0])
        if label is not None:
            meta.set_label(label)
        if reference is not None:
            return self._bin_with_mappers(data, reference, meta)
        categorical = (set(int(c) for c in categorical_features)
                       | self._categorical_columns())
        return self._construct(data, meta, categorical)

    def _categorical_columns(self):
        """Column indices of the categorical_column config key
        (lightgbm_tpu io/dataset.py _resolve_columns); a matrix has no
        header, so "name:" selectors are refused."""
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

    def _sample_rows(self, n):
        cfg = self.config
        cnt = min(cfg.bin_construct_sample_cnt, n)
        if cnt == n:
            return np.arange(n, dtype=np.int64)
        rnd = Random(cfg.data_random_seed)
        return rnd.sample(n, cnt).astype(np.int64)

    def _make_mappers(self, sample_col, num_total, categorical):
        """Bin-mapper construction from sampled rows
        (ConstructBinMappersFromTextData, dataset_loader.cpp:612-760)."""
        cfg = self.config
        used_map = np.full(num_total, -1, dtype=np.int32)
        mappers, real_idx = [], []
        for j in range(num_total):
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

    def _check_no_bundling(self, mappers):
        """The JAX loader bundles mutually exclusive sparse features
        (lightgbm_tpu/io/bundling.py plan_bundles) when at least two
        candidates exist; that storage is a later slice here."""
        if not self.config.is_enable_sparse:
            return
        candidates = sum(
            1 for m in mappers
            if m.bin_type == NUMERICAL and m.sparse_rate >= SPARSE_THRESHOLD
            and int(m.value_to_bin(np.zeros(1))[0]) == 0)
        if candidates >= 2:
            raise NotImplementedError(
                f"{candidates} sparse features are bundling candidates; "
                "exclusive feature bundling (ROADMAP queue 1 item 3) is a "
                "later slice of "
                "lightgbm_tpu_torch (set is_enable_sparse=false to store "
                "them unbundled)")

    def _construct(self, mat, meta, categorical) -> CoreDataset:
        """Bin-mapper construction + feature extraction on the host
        (ConstructBinMappersFromTextData + ExtractFeatures)."""
        n, num_total = mat.shape
        sample_idx = self._sample_rows(n)

        def sample_col(j):
            return mat[sample_idx, j]

        ds = CoreDataset()
        ds.num_total_features = num_total
        ds.feature_names = [f"Column_{i}" for i in range(num_total)]
        mappers, used_map, real_idx = self._make_mappers(
            sample_col, num_total, categorical)
        self._check_no_bundling(mappers)
        dtype = bins_dtype(max(m.num_bin for m in mappers))
        ds.bins = np.stack([mappers[u].value_to_bin(mat[:, real_idx[u]])
                            .astype(dtype) for u in range(len(real_idx))],
                           axis=0)
        ds.bin_mappers = mappers
        ds.used_feature_map = used_map
        ds.real_feature_idx = np.asarray(real_idx, dtype=np.int32)
        ds.metadata = meta
        Log.info("Number of data: %d, number of features: %d", n,
                 len(mappers))
        return ds

    def _bin_with_mappers(self, mat, ref_ds: CoreDataset, meta) -> CoreDataset:
        """A valid set binned with the training set's mappers."""
        ds = CoreDataset()
        ds.num_total_features = ref_ds.num_total_features
        ds.label_idx = ref_ds.label_idx
        ds.feature_names = ref_ds.feature_names
        ds.bin_mappers = ref_ds.bin_mappers
        ds.used_feature_map = ref_ds.used_feature_map
        ds.real_feature_idx = ref_ds.real_feature_idx
        if mat.shape[1] < ref_ds.num_total_features:
            Log.fatal("Validation data has fewer features than training data")
        dtype = ref_ds.bins.dtype
        ds.bins = np.stack([m.value_to_bin(mat[:, j]).astype(dtype)
                            for m, j in zip(ref_ds.bin_mappers,
                                            ref_ds.real_feature_idx)],
                           axis=0)
        ds.metadata = meta
        return ds
