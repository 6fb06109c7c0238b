"""CompiledPredictor: a trained ensemble frozen for online serving (port of
lightgbm_tpu/serving/compiled_model.py).

The training-side predict path (models/gbdt.py predict_raw) re-derives
its arrays per model state and routes by size; a standing service wants
the model frozen once and every request shape ready before the first
request. This module freezes the model:

- the ensemble becomes immutable device arrays (class-major stacked
  split feature / threshold / decision type / children / leaf value, via
  GBDT._stacked_model_arrays), with the round-toward--inf f32 threshold
  cast of models/gbdt.py f32_safe_thresholds so f32 traversal decisions
  equal the f64 host reference; the nodes are packed into one 16-byte
  record each for the traversal kernel (ops/traverse_kernels.py
  pack_nodes), which takes the place of the JAX package's int16 node
  compaction (_compact_int) and changes no result. The JAX package pads
  the tree and node axes (TREE_PAD, NODE_PAD) so that a hot-swapped model
  reuses its compiled executables; a CUDA kernel takes any shape, so the
  arrays here hold the real trees only;
- requests run in power-of-two ROW BUCKETS up to max_batch_rows (larger
  ones chunk through the largest), and warm_up() builds or loads the
  kernel library (nvcc at first use, so a server's first request never
  pays it) and runs every (kernel, bucket) pair once at load.

The device work is three hand-written CUDA kernels (csrc/traverse.cu):
tree_leaf for the leaf indices every exact endpoint starts from,
tree_raw (f32 or bf16 leaf values, f32 sums) for the `_device` variants
and serving_precision="bf16", and tree_lin_raw, the same for linear-leaf
models (the JAX package's _linraw_kernel / _lintransformed_kernel), whose
transformed variant applies the sigmoid or softmax in the same launch.
On a CPU device their plain versions run.

Precision contract, as in the JAX package: traversal decisions are
exact, so `predict_raw`/`predict` gather the traversed leaf indices and
reduce in f64 ON HOST (`self._lv64[t, leaves] @ self._onehot64`), which
gives the JAX CompiledPredictor's bits. The `_device` variants keep the
whole pipeline on the device in f32 for throughput-bound callers that
tolerate ~1e-6. bf16 keeps the decisions exact and gathers bf16 leaf
values with f32 accumulation, within the pinned `accuracy_bound`.

Linear-leaf models freeze their per-leaf coefficient blocks, padded to
COEF_PAD slots, beside the node arrays as one 64-byte record a leaf
(traverse_kernels.LinearLeaves, pack_linear; a wider model is
refused). The exact path keeps the linear value stage
on the host in f64 (models.tree.linear_leaf_values, the function
Tree._linear_values calls, NaN fallback included) and sums each class
as GBDT's host path does; the `_device` variants and bf16 run tree_lin_raw (bf16 stores the
intercepts and coefficients in bfloat16 too, and the pinned
`accuracy_bound` grows a coefficient term).
"""

import os
import threading
import time

import numpy as np
import torch

from ..io.profile import DatasetProfile, model_profile_path
from ..models.gbdt import create_boosting, f32_safe_thresholds
from ..models.tree import Tree, linear_leaf_values
from ..ops import traverse_kernels
from ..telemetry.ledger import LEDGER
from ..utils import common
from ..utils.device import resolve_device
from ..utils.log import Log

DEFAULT_MAX_BATCH_ROWS = 4096
# coefficient slots a linear leaf model may use in serving
COEF_PAD = traverse_kernels.COEF_PAD
# serving_precision values: `f32` is the exact contract (device f32
# traversal + host f64 reduction, bit-identical to the JAX predictor);
# `bf16` keeps the traversal DECISIONS exact (f32 compare against
# f32-safe thresholds) but gathers bf16 leaf values, accumulated in f32
# on the device, and ships a PINNED accuracy bound (`accuracy_bound`,
# computed from the frozen leaf values at load) that the skew monitor
# adopts as its tolerance.
SERVING_PRECISIONS = ("f32", "bf16")


def _bf16_round(arr):
    """Host f64 view of an array after a round trip through bfloat16
    (via float32, the rounding the JAX package's cast applies)."""
    t = torch.from_numpy(np.asarray(arr, np.float64).astype(np.float32))
    return t.to(torch.bfloat16).to(torch.float64).numpy()


class CompiledPredictor:
    """A frozen view of one trained model on one device.

    Build with `from_booster` (a live GBDT or Booster) or
    `from_model_file` (the text format). Immutable after construction:
    later training on the source booster never changes served results.
    Safe to call from several threads at once: every call allocates its
    own device buffers.
    """

    # set by from_model_file (sidecar auto-discovery); None when frozen
    # from a live booster
    model_path = None
    profile_path = None
    profile = None
    is_linear = False

    def __init__(self, booster, num_iteration=-1,
                 max_batch_rows=DEFAULT_MAX_BATCH_ROWS, warmup=True,
                 serving_precision="f32", device=None):
        if serving_precision not in SERVING_PRECISIONS:
            raise ValueError(
                f"serving_precision must be one of {SERVING_PRECISIONS}, "
                f"got {serving_precision!r}")
        self.device = resolve_device(device)
        n_used = booster._num_used_models(num_iteration)
        self.num_class = max(int(booster.num_class), 1)
        self.sigmoid = float(booster.sigmoid)
        self.num_features = int(booster.max_feature_idx) + 1
        self.num_trees = n_used
        self.feature_names = list(getattr(booster, "feature_names", []))
        self.max_batch_rows = int(max_batch_rows)
        self.serving_precision = serving_precision
        self.accuracy_bound = 0.0
        self.buckets = tuple(_default_buckets(self.max_batch_rows))
        self.stats = {"warmup_s": 0.0, "compile_cache_hits": 0,
                      "warm_dispatches": 0, "cold_dispatches": 0,
                      "buckets": list(self.buckets),
                      "serving_precision": serving_precision}
        self._stats_lock = threading.Lock()
        self._warmed = set()
        if n_used == 0:
            self.depth = 0
            return
        sf, thr, dt, lc, rc, lv, has_split, depth = \
            booster._stacked_model_arrays(n_used)
        self.depth = int(depth)
        # frozen copies: the booster's cached arrays are replaced as
        # training continues; the served model must not change
        self._lv64 = np.array(lv, dtype=np.float64)             # (T, L)
        onehot = (np.arange(n_used)[:, None] % self.num_class
                  == np.arange(self.num_class)[None, :])
        self._onehot64 = onehot.astype(np.float64)              # (T, K)
        dt = np.array(dt)
        self._forest = traverse_kernels.freeze(
            np.array(sf), f32_safe_thresholds(np.array(thr), dt),
            dt == Tree.CATEGORICAL, np.array(lc), np.array(rc),
            np.where(has_split, 0, ~0).astype(np.int32), self.depth,
            self.device)
        # the f32 device values back only the `_device` variants: built
        # on first use, so the exact and bf16 paths hold one value
        # buffer per model
        self._lv32 = None
        # linear leaves (gbdt.py _stacked_linear_arrays): host f64 copies
        # padded to COEF_PAD slots for the exact path, and the device
        # blocks in the value type of the precision's kernel
        lin = booster._stacked_linear_arrays(n_used)
        self.is_linear = lin is not None
        self._lin_dev = None
        if self.is_linear:
            const, coef, cfeat, ccnt = lin
            if coef.shape[2] > COEF_PAD:
                raise ValueError(
                    f"model's widest leaf model has {coef.shape[2]} "
                    f"coefficients but serving pads to COEF_PAD="
                    f"{COEF_PAD}; retrain with linear_max_features <= "
                    f"{COEF_PAD}")
            pad = ((0, 0), (0, 0), (0, COEF_PAD - coef.shape[2]))
            self._lin_const64 = np.array(const, dtype=np.float64)
            self._lin_coef64 = np.pad(np.asarray(coef, np.float64), pad)
            self._lin_feat = np.pad(np.asarray(cfeat, np.int32), pad)
            self._lin_cnt = np.array(ccnt, dtype=np.int32)
            self._lin_dev = traverse_kernels.freeze_linear(
                const, coef, cfeat, ccnt, self._lv64,
                torch.bfloat16 if serving_precision == "bf16"
                else torch.float32, self.device)
        if serving_precision == "bf16":
            self._lv16 = torch.from_numpy(
                self._lv64.astype(np.float32)).to(torch.bfloat16).to(
                    self.device)
            self.accuracy_bound = self._pin_accuracy_bound(
                n_used, np.array(sf), np.array(thr))
        if warmup:
            self.warm_up()

    def _pin_accuracy_bound(self, n_used, sf=None, thr=None):
        """Worst-case |bf16 output - exact f64 output| over ANY input,
        derived from the frozen leaf values (the JAX package's formula,
        verbatim): traversal decisions are exact, so the only error
        sources are the bf16 rounding of each gathered leaf value
        (bounded per tree by its worst-rounded leaf) and the f32
        accumulation of the class reduction. The transform can amplify
        raw error (binary: dp/draw <= sigmoid/2), so the pinned bound
        covers raw AND transformed outputs. A 2x margin absorbs
        rounding-mode asymmetries. The serving skew monitor adopts this
        as its tolerance (server.build_monitors).

        Linear leaves add a coefficient-rounding term (:427-450): per
        tree, the worst leaf's |const - bf16(const)| + sum_j |coef_j -
        bf16(coef_j)| * env(feat_j), with env(f) twice the largest
        |threshold| any split placed on feature f (at least 1.0), and
        the accumulation slack grows with the largest value a linear
        lane can add inside that envelope."""
        err_t = np.abs(self._lv64 - _bf16_round(self._lv64)).max(axis=1)
        if self.is_linear:
            env = np.ones(self.num_features, np.float64)
            if sf is not None and sf.size:
                np.maximum.at(env, sf.reshape(-1),
                              2.0 * np.abs(thr.reshape(-1)))
            cerr = (np.abs(self._lin_coef64 - _bf16_round(self._lin_coef64))
                    * env[self._lin_feat])
            valid = (np.arange(COEF_PAD)[None, None, :]
                     < self._lin_cnt[:, :, None])
            lin_err_t = (np.abs(self._lin_const64
                                - _bf16_round(self._lin_const64))
                         + np.where(valid, cerr, 0.0).sum(axis=2)
                         ).max(axis=1)
            err_t = np.maximum(err_t, lin_err_t)
        raw_bound = float((err_t @ self._onehot64).max())
        mag_t = np.abs(self._lv64).max(axis=1)
        if self.is_linear:
            lin_mag_t = (np.abs(self._lin_const64)
                         + np.where(valid, np.abs(self._lin_coef64)
                                    * env[self._lin_feat], 0.0).sum(axis=2)
                         ).max(axis=1)
            mag_t = np.maximum(mag_t, lin_mag_t)
        mags = float((mag_t @ self._onehot64).max())
        slack = mags * n_used * float(np.finfo(np.float32).eps)
        factor = 1.0
        if self.sigmoid > 0 and self.num_class == 1:
            factor = max(1.0, self.sigmoid / 2.0)
        return 2.0 * factor * (raw_bound + slack)

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_booster(cls, booster, num_iteration=-1, **kw):
        """Freeze a live booster (a GBDT or a python-API Booster)."""
        gbdt = getattr(booster, "gbdt", booster)  # basic.Booster wraps
        return cls(gbdt, num_iteration=num_iteration, **kw)

    @classmethod
    def from_model_file(cls, path, num_iteration=-1, **kw):
        """Load the text model format and freeze it. Picks up the
        `<model>.profile.json` dataset-profile sidecar (io/profile.py)
        when one sits next to the model: `predictor.profile` then
        carries the training baseline the drift monitor needs."""
        # the host arrays only, in the class the file's first line names
        booster = create_boosting("gbdt", "cpu", input_model=path)
        with open(path) as f:
            booster.load_model_from_string(f.read())
        inst = cls(booster, num_iteration=num_iteration, **kw)
        inst.model_path = os.fspath(path)
        sidecar = model_profile_path(path)
        if os.path.exists(sidecar):
            try:
                inst.profile = DatasetProfile.load(sidecar)
                inst.profile_path = sidecar
            except (OSError, ValueError) as e:
                Log.warning("ignoring unreadable profile sidecar %s: %s",
                            sidecar, e)
        return inst

    # --------------------------------------------------------------- warmup
    def warm_up(self):
        """Load the kernel library (nvcc builds it into csrc/build/ at the
        first load on a machine; `stats["compile_cache_hits"]` counts a
        library found already built) and run every (kernel, bucket) pair
        a request can hit once: the leaf kernel that predict, predict_raw
        and predict_leaf_index dispatch, and with bf16 the bf16 pair (of
        tree_lin_raw for a linear model; the f32 `_device` variants warm
        at their first call, as in the JAX package). Each bucket's time lands in the set-up ledger under
        `serving_bucket_<rows>`."""
        t0 = time.time()
        if self.device.type == "cuda" and self.num_trees:
            traverse_kernels.library()
            self.stats["compile_cache_hits"] = int(
                bool(traverse_kernels.LOAD_INFO.get("cache_hit")))
        kinds = [("leaf", self._dispatch_leaf)]
        if self.serving_precision == "bf16" and self.is_linear:
            kinds += [("linraw", self._dispatch_linraw),
                      ("lintr", self._dispatch_lintransformed)]
        elif self.serving_precision == "bf16":
            kinds += [("raw16", self._dispatch_raw16),
                      ("tr16", self._dispatch_transformed16)]
        for b in self.buckets:
            if not self.num_trees:
                break
            with LEDGER.label(f"serving_bucket_{b}"):
                tb = time.perf_counter()
                xb = torch.zeros((b, self.num_features), dtype=torch.float32,
                                 device=self.device)
                for kind, dispatch in kinds:
                    dispatch(xb).cpu()
                    self._warmed.add((kind, b))
                LEDGER.record("warm_bucket", time.perf_counter() - tb)
        self.stats["warmup_s"] = round(time.time() - t0, 3)
        Log.info("CompiledPredictor warm: %d trees, %d buckets (max %d "
                 "rows) on %s in %.2fs (%d kernel libraries found built)",
                 self.num_trees, len(self.buckets), self.max_batch_rows,
                 self.device, self.stats["warmup_s"],
                 self.stats["compile_cache_hits"])
        return self

    # ------------------------------------------------------------ dispatch
    def _dispatch_leaf(self, xb):
        return traverse_kernels.tree_leaf(xb, self._forest)

    def _f32_values(self):
        if self._lv32 is None:
            self._lv32 = torch.from_numpy(
                self._lv64.astype(np.float32)).to(self.device)
        return self._lv32

    def _raw(self, xb, lv):
        return traverse_kernels.tree_raw(xb, self._forest, lv,
                                         self.num_class)

    def _transform(self, raw):
        """f32 sigmoid/softmax on the device (gbdt.cpp:622-636)."""
        if self.sigmoid > 0 and self.num_class == 1:
            return 1.0 / (1.0 + torch.exp(-2.0 * self.sigmoid * raw))
        if self.num_class > 1:
            return torch.softmax(raw, dim=1)
        return raw

    def _dispatch_raw32(self, xb):
        return self._raw(xb, self._f32_values())

    def _dispatch_transformed32(self, xb):
        return self._transform(self._dispatch_raw32(xb))

    def _dispatch_raw16(self, xb):
        return self._raw(xb, self._lv16)

    def _dispatch_transformed16(self, xb):
        return self._transform(self._dispatch_raw16(xb))

    def _linear_values(self):
        """The leaf values tree_lin_raw is given: bf16 or f32 as the
        linear records were frozen (which hold them too)."""
        if self.serving_precision == "bf16":
            return self._lv16
        return self._f32_values()

    def _dispatch_linraw(self, xb):
        return traverse_kernels.tree_lin_raw(
            xb, self._forest, self._linear_values(), self._lin_dev,
            self.num_class)

    def _dispatch_lintransformed(self, xb):
        return traverse_kernels.tree_lin_raw(
            xb, self._forest, self._linear_values(), self._lin_dev,
            self.num_class, transform=True, sigmoid=self.sigmoid)

    def _linear_host_values(self, x, leaves):
        """The exact path's value stage of a linear model: (N, T) f64
        per-tree outputs at the traversed leaves, through the function
        Tree._linear_values calls (linear_leaf_values)."""
        t_idx = np.arange(self.num_trees)[None, :]
        return linear_leaf_values(
            x.astype(np.float64), self._lin_const64[t_idx, leaves],
            self._lin_coef64[t_idx, leaves], self._lin_feat[t_idx, leaves],
            self._lin_cnt[t_idx, leaves], self._lv64[t_idx, leaves])

    def _canon(self, x):
        """(N, num_features) f32 view of arbitrary row input: width is
        CANONICALIZED (narrow pads with 0.0 — absent trailing features,
        LibSVM-style; wide truncates — no split reads past
        max_feature_idx) so every dispatch reuses the warmed shapes."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float32))
        if x.ndim != 2:
            raise ValueError(f"rows must be 2-D, got shape {x.shape}")
        f = x.shape[1]
        if f < self.num_features:
            x = np.pad(x, ((0, 0), (0, self.num_features - f)))
        elif f > self.num_features:
            x = x[:, :self.num_features]
        return x

    def _bucket(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _blocks(self, x, dispatch, kernel):
        """Pad-to-bucket dispatch over row blocks; returns the stacked
        host result. Requests beyond max_batch_rows chunk through the
        largest bucket. The copy to the host waits for the kernel on
        its stream (a blocking copy)."""
        n = x.shape[0]
        outs = []
        top = self.buckets[-1]
        s = 0
        while s < n:
            xb = x[s:s + top]
            b = self._bucket(xb.shape[0])
            with self._stats_lock:
                if (kernel, b) not in self._warmed:
                    self.stats["cold_dispatches"] += 1
                    self._warmed.add((kernel, b))
                else:
                    self.stats["warm_dispatches"] += 1
            pad = b - xb.shape[0]
            if pad:
                xb = np.pad(xb, ((0, pad), (0, 0)))
            dev = torch.from_numpy(np.ascontiguousarray(xb)).to(self.device)
            outs.append(dispatch(dev).cpu().numpy()[:b - pad])
            s += top
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------- predict
    def predict_leaf_index(self, x):
        """(N, T) int32 leaf indices (predictor.hpp:108-118)."""
        x = self._canon(x)
        if self.num_trees == 0 or x.shape[0] == 0:
            return np.zeros((x.shape[0], self.num_trees), dtype=np.int32)
        return self._blocks(x, self._dispatch_leaf, "leaf")

    def predict_raw(self, x):
        """(N, K) f64 raw scores. Exact precision: device traversal +
        host f64 reduction, the JAX CompiledPredictor's bits.
        `serving_precision="bf16"`: the all-device bf16 value stage,
        within `accuracy_bound` of the exact path."""
        x = self._canon(x)
        n = x.shape[0]
        if self.num_trees == 0 or n == 0:
            return np.zeros((n, self.num_class))
        if self.serving_precision == "bf16" and self.is_linear:
            return self._blocks(x, self._dispatch_linraw,
                                "linraw").astype(np.float64)
        if self.serving_precision == "bf16":
            return self._blocks(x, self._dispatch_raw16,
                                "raw16").astype(np.float64)
        leaves = self._blocks(x, self._dispatch_leaf, "leaf")   # (N, T)
        if self.is_linear:
            vals = self._linear_host_values(x, leaves)       # (N, T) f64
            # GBDT's host path sums each class over its trees (np.sum);
            # a BLAS product would associate otherwise in the last bit
            cls = np.arange(self.num_trees) % self.num_class
            out = np.empty((x.shape[0], self.num_class))
            for k in range(self.num_class):
                out[:, k] = vals[:, cls == k].sum(axis=1)
            return out
        vals = self._lv64[np.arange(self.num_trees)[None, :], leaves]
        return vals @ self._onehot64                         # (N, K) f64

    def predict(self, x):
        """(N, K) f64 transformed predictions (binary sigmoid /
        multiclass softmax / raw passthrough). bf16 transforms on the
        device from the f32 accumulator (`accuracy_bound` covers the
        transformed value too)."""
        if self.serving_precision == "bf16" and self.num_trees > 0:
            x = self._canon(x)
            if x.shape[0] == 0:
                return np.zeros((0, self.num_class))
            if self.is_linear:
                return self._blocks(x, self._dispatch_lintransformed,
                                    "lintr").astype(np.float64)
            return self._blocks(x, self._dispatch_transformed16,
                                "tr16").astype(np.float64)
        raw = self.predict_raw(x)
        if self.sigmoid > 0 and self.num_class == 1:
            return 1.0 / (1.0 + np.exp(-2.0 * self.sigmoid * raw))
        if self.num_class > 1:
            return common.softmax(raw, axis=1)
        return raw

    def predict_raw_device(self, x):
        """All-device f32 raw scores (tree_raw; tree_lin_raw for a linear
        model, whose bf16 predictor keeps its bf16 blocks and its
        `accuracy_bound`): the throughput path; ~1e-6 of predict_raw."""
        x = self._canon(x)
        n = x.shape[0]
        if self.num_trees == 0 or n == 0:
            return np.zeros((n, self.num_class))
        if self.is_linear:
            return self._blocks(x, self._dispatch_linraw,
                                "linraw").astype(np.float64)
        return self._blocks(x, self._dispatch_raw32,
                            "raw32").astype(np.float64)

    def predict_device(self, x):
        """All-device f32 transformed predictions; ~1e-6 of predict (a
        linear model's transform runs inside its tree_lin_raw launch)."""
        x = self._canon(x)
        n = x.shape[0]
        if self.num_trees == 0 or n == 0:
            return np.zeros((n, self.num_class))
        if self.is_linear:
            return self._blocks(x, self._dispatch_lintransformed,
                                "lintr").astype(np.float64)
        return self._blocks(x, self._dispatch_transformed32,
                            "tr32").astype(np.float64)

    # --------------------------------------------------------------- info
    def describe(self):
        """JSON-ready model card for `/healthz`."""
        return {
            "num_trees": self.num_trees,
            "num_class": self.num_class,
            "num_features": self.num_features,
            "depth": self.depth,
            "sigmoid": self.sigmoid,
            "max_batch_rows": self.max_batch_rows,
            "buckets": list(self.buckets),
            "serving_precision": self.serving_precision,
            "accuracy_bound": self.accuracy_bound,
            "is_linear": self.is_linear,
            "model_path": self.model_path,
            "has_profile": self.profile is not None,
            "device": str(self.device),
        }


def _default_buckets(max_batch_rows):
    """Powers of two up to (and including a final bucket covering)
    max_batch_rows: request row counts round up to one of O(log N)
    shapes, <= 2x padded-row overhead."""
    out = []
    b = 1
    while b < max_batch_rows:
        out.append(b)
        b <<= 1
    out.append(max_batch_rows)
    return out
