"""Dataset profile: the training-time baseline feature distribution
(the port's copy of lightgbm_tpu/io/profile.py).

Per used feature the profile records: name, real column index, bin
type, the mapper's bin bounds (numeric upper bounds / categorical ids),
the full-dataset bin-occupancy histogram, and a missing (NaN) count.
Ingestion collapses NaN to 0.0 before binning, so missing mass lands in
the zero bin and the serving-side drift monitor (serving/drift.py) bins
NaN through the same rule. `DatasetProfile.from_dataset(core)` builds it
from a constructed dataset, `save(model_profile_path(model))` writes the
``<model>.profile.json`` sidecar that CompiledPredictor.from_model_file
discovers. The bounds travel with the counts, so a serving process bins
incoming rows as training did without the dataset. (The JAX package
also captures the profile at binning and writes the sidecar with every
saved model; in the port that comes with its telemetry slice.)

`group_counts` folds a mapper's bins into at most `profile_bins` groups
(contiguous, even in bin space) before PSI — the baseline and the
serving-side rolling histogram fold the same way, so the comparison
stays aligned while small samples stop being noisy at 255-bin
granularity.

numpy + stdlib json only.
"""

import json
import os

import numpy as np

from ..utils.checkpoint import atomic_write_text
from .bin_mapper import NUMERICAL, BinMapper

PROFILE_VERSION = 1
PROFILE_SUFFIX = ".profile.json"
# PSI's classic formulation uses ~10 quantile buckets; finer groups
# make small serving samples spuriously noisy (an empty group reads as
# drift), coarser ones hide real shifts
DEFAULT_PROFILE_BINS = 10


def group_counts(counts, profile_bins):
    """Fold a per-bin count vector into at most `profile_bins`
    contiguous groups (group of bin i = i * G // B — even in bin
    space). <=0 or enough room returns the counts unchanged."""
    counts = np.asarray(counts, np.int64)
    g = int(profile_bins)
    if g <= 0 or len(counts) <= g:
        return counts
    idx = (np.arange(len(counts), dtype=np.int64) * g) // len(counts)
    out = np.zeros(g, np.int64)
    np.add.at(out, idx, counts)
    return out


class DatasetProfile:
    """One dataset's per-feature baseline distribution (module
    docstring). `features` is a list of dicts with keys: name, column,
    bin_type, num_bin, upper_bounds (numeric) / categories
    (categorical), counts, missing."""

    def __init__(self, num_rows, features):
        self.num_rows = int(num_rows)
        self.features = list(features)

    # ------------------------------------------------------------ build
    @classmethod
    def from_parts(cls, mappers, real_idx, feature_names, counts_list,
                   num_rows, missing=None):
        """Assemble from a loader's pieces: the bin mappers, the
        used->total map, per-used-feature occupancy counts, and the
        optional per-used-feature NaN counts."""
        features = []
        for u, m in enumerate(mappers):
            col = int(real_idx[u])
            name = (str(feature_names[col])
                    if col < len(feature_names) and feature_names[col]
                    else f"Column_{col}")
            rec = {
                "name": name,
                "column": col,
                "bin_type": int(m.bin_type),
                "num_bin": int(m.num_bin),
                "counts": np.asarray(counts_list[u], np.int64),
                "missing": int(missing[u]) if missing is not None else 0,
            }
            if m.bin_type == NUMERICAL:
                rec["upper_bounds"] = np.asarray(m.bin_upper_bound,
                                                 np.float64)
            else:
                rec["categories"] = np.asarray(m.bin_2_categorical,
                                               np.int64)
            features.append(rec)
        return cls(num_rows, features)

    @classmethod
    def from_dataset(cls, ds, missing=None):
        """Occupancy pass over a constructed dataset (its host bins in
        virtual feature space): one bincount per used feature."""
        if ds.bins is None:
            return None
        counts = []
        bins = ds.traversal_bins()
        for u, m in enumerate(ds.bin_mappers):
            col = np.asarray(bins[u, slice(None)]).astype(np.int64,
                                                          copy=False)
            counts.append(np.bincount(np.minimum(col, m.num_bin - 1),
                                      minlength=m.num_bin)[:m.num_bin])
        return cls.from_parts(ds.bin_mappers, ds.real_feature_idx,
                              ds.feature_names, counts, ds.num_data,
                              missing=missing)

    # --------------------------------------------------------- accessors
    @property
    def num_features(self):
        return len(self.features)

    def zero_bin(self, u):
        """The bin the value 0.0 (and therefore NaN) lands in."""
        rec = self.features[u]
        if rec["bin_type"] == NUMERICAL:
            return int(np.searchsorted(rec["upper_bounds"], 0.0,
                                       side="left"))
        cats = rec["categories"]
        hit = np.nonzero(cats == 0)[0]
        return int(hit[0]) if len(hit) else 0

    def zero_rate(self, u):
        rec = self.features[u]
        total = int(rec["counts"].sum())
        if total <= 0:
            return 0.0
        return float(rec["counts"][self.zero_bin(u)]) / total

    def missing_rate(self, u):
        if self.num_rows <= 0:
            return 0.0
        return float(self.features[u]["missing"]) / self.num_rows

    def mapper(self, u):
        """Rebuild the feature's BinMapper (value->bin for the serving
        drift monitor; identical boundaries by construction)."""
        rec = self.features[u]
        m = BinMapper()
        m.num_bin = int(rec["num_bin"])
        m.is_trivial = m.num_bin <= 1
        m.bin_type = int(rec["bin_type"])
        if m.bin_type == NUMERICAL:
            m.bin_upper_bound = np.asarray(rec["upper_bounds"],
                                           np.float64)
        else:
            m.bin_2_categorical = np.asarray(rec["categories"], np.int64)
        return m

    # ----------------------------------------------------- serialization
    def to_json_dict(self):
        features = []
        for rec in self.features:
            out = {"name": rec["name"], "column": int(rec["column"]),
                   "bin_type": int(rec["bin_type"]),
                   "num_bin": int(rec["num_bin"]),
                   "counts": [int(c) for c in rec["counts"]],
                   "missing": int(rec["missing"])}
            if rec["bin_type"] == NUMERICAL:
                # inf is not JSON: the last upper bound is always +inf
                # (bin_mapper.find_bin), encode it as null
                out["upper_bounds"] = [
                    None if not np.isfinite(b) else float(b)
                    for b in rec["upper_bounds"]]
            else:
                out["categories"] = [int(c) for c in rec["categories"]]
            features.append(out)
        return {"version": PROFILE_VERSION, "num_rows": self.num_rows,
                "features": features}

    @classmethod
    def from_json_dict(cls, d):
        if int(d.get("version", 0)) > PROFILE_VERSION:
            raise ValueError(
                f"profile version {d.get('version')} is newer than this "
                f"build reads ({PROFILE_VERSION})")
        features = []
        for rec in d.get("features", []):
            out = {"name": str(rec["name"]), "column": int(rec["column"]),
                   "bin_type": int(rec["bin_type"]),
                   "num_bin": int(rec["num_bin"]),
                   "counts": np.asarray(rec["counts"], np.int64),
                   "missing": int(rec.get("missing", 0))}
            if out["bin_type"] == NUMERICAL:
                out["upper_bounds"] = np.asarray(
                    [np.inf if b is None else float(b)
                     for b in rec["upper_bounds"]], np.float64)
            else:
                out["categories"] = np.asarray(rec["categories"],
                                               np.int64)
            features.append(out)
        return cls(int(d.get("num_rows", 0)), features)

    def save(self, path):
        """Atomic JSON write (a kill mid-save must never leave a
        truncated profile where a valid one stood)."""
        atomic_write_text(os.fspath(path),
                          json.dumps(self.to_json_dict(),
                                     separators=(",", ":")) + "\n")

    @classmethod
    def load(cls, path):
        with open(os.fspath(path), "r", encoding="utf-8") as f:
            return cls.from_json_dict(json.load(f))


def model_profile_path(model_path):
    return os.fspath(model_path) + PROFILE_SUFFIX
