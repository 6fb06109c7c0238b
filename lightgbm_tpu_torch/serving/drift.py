"""Serving-side drift & skew monitors (the port's copy of
lightgbm_tpu/serving/drift.py).

A standing prediction service rots in two distinct ways and this
module watches both, sampled and bounded (request-path monitoring must
cost ~nothing next to the predict pipe):

- **Data drift** (`DriftMonitor`): incoming rows stop looking like the
  training data. Sampled requests run through the MODEL'S OWN bin
  mappers (the training profile artifact, io/profile.py, carries the
  bounds), maintaining rolling per-feature bin histograms plus a
  prediction-distribution histogram; per-feature PSI against the
  training baseline is recomputed as the window fills. PSI over the
  usual 0.2 threshold is the classic "investigate this feature"
  signal; `psi_warn` crossings emit ONE structured warning per
  excursion (re-armed when the feature falls back under half the
  threshold).

- **Scoring skew** (`SkewMonitor`): the serving path stops agreeing
  with the reference implementation. Sampled requests are re-scored
  through the host f64 reference path (the same precision contract the
  CompiledPredictor parity tests pin) and any row diverging beyond
  `SKEW_TOL` counts as skew — with a bit-exact serving contract the
  expected count is ZERO, so `skew_warn` defaults to firing on the
  first one.

Both export on `/driftz` (full JSON), `/metricz` (scalar gauges, JSON
and Prometheus exposition) and the structured warning log
(utils/log.py Log.structured). PSI math documented in
docs/Observability.md.

**Cost discipline**: the serving hot path runs at microseconds a row,
so the monitors' request-path work is an
integer-credit sampling decision plus, for sampled rows, one slice
VIEW appended to a pending buffer. All real work — binning, PSI,
shadow scoring — is deferred to `flush()`, which runs inline once the
buffer passes `flush_rows` (so warnings still surface mid-traffic,
e.g. at `sample_rate=1.0` in tests) and on every reader
(/driftz//metricz scrapes), where one vectorized pass amortizes the
per-call numpy and reference-scorer overhead across the whole batch.
The default sample rates are sized so the steady-state monitor cost
stays under 1% of the raw predict pipe; raise them on low-traffic
services where the absolute cost is irrelevant.
"""

import threading

import numpy as np

from ..io.bin_mapper import NUMERICAL
from ..io.profile import DEFAULT_PROFILE_BINS, group_counts
from ..utils.log import Log

# Laplace pseudo-count added per group on both sides of the PSI
# log-ratio: an empty observed group then reads as "rare", not as an
# infinity (or the huge finite term a bare proportion floor produces
# at small samples)
PSI_SMOOTHING = 0.5
# serving vs host-f64-reference divergence beyond this is skew; the
# serving parity contract is ~1e-16, so 1e-6 is pure headroom
SKEW_TOL = 1e-6

# Default sample fractions (of ROWS, accumulated as integer credit per
# request). Sized against the cost model in the module docstring:
# binning a sampled row costs ~0.7 us (vectorized over all features),
# shadow-scoring one ~3 us plus a per-flush call overhead, against a
# ~1 us/row serving pipe — so the affordable sampled fraction under a
# 1% budget is around one per mille. At 1M rows/day that is still
# ~1000 drift rows and ~100 shadow scores per day, plenty for PSI
# windows and for catching systematic skew (one diverging row already
# warns).
DEFAULT_DRIFT_SAMPLE_RATE = 0.001
DEFAULT_PSI_WARN = 0.2
DEFAULT_SKEW_SAMPLE_RATE = 0.0001
DEFAULT_SKEW_WARN = 1
# PSI needs this many sampled rows PER GROUP before it is signal (and
# never fewer than MIN_PSI_ROWS total): Poisson noise at ~20 rows per
# group keeps a same-distribution PSI well under the 0.2 threshold
MIN_PSI_ROWS = 200
MIN_PSI_ROWS_PER_GROUP = 20
# pending-buffer sizes that trigger an inline flush; big enough to
# amortize per-flush overhead, small enough that warnings stay timely
DRIFT_FLUSH_ROWS = 256
SKEW_FLUSH_ROWS = 32
# drift sampling is BURSTY: credit accumulates across requests until a
# slice this big is affordable, then one contiguous slice is taken —
# same sampled fraction, ~burst x fewer enqueues and pending entries
DRIFT_BURST_ROWS = 8

# 64-bit LCG (Knuth MMIX) for the sampling decisions: one integer
# multiply per request instead of a numpy RNG call keeps the
# no-sample fast path at ~0.2 us
_LCG_MUL = 6364136223846793005
_LCG_ADD = 1442695040888963407
_LCG_MASK = (1 << 64) - 1


def psi(expected_counts, actual_counts, smoothing=PSI_SMOOTHING):
    """Population stability index between two aligned count vectors:
    sum_g (a_g - e_g) * ln(a_g / e_g) over the groups' proportions,
    Laplace-smoothed with `smoothing` pseudo-counts per group.
    0 = identical; > 0.2 is the conventional drift alert. Returns 0.0
    while either side is empty. (docs/Observability.md for the math.)"""
    e = np.asarray(expected_counts, np.float64)
    a = np.asarray(actual_counts, np.float64)
    if e.sum() <= 0 or a.sum() <= 0:
        return 0.0
    g = len(e)
    p = (e + smoothing) / (e.sum() + smoothing * g)
    q = (a + smoothing) / (a.sum() + smoothing * g)
    return float(np.sum((q - p) * np.log(q / p)))


class _PredHistogram:
    """Rolling prediction-distribution histogram. Edges fix lazily:
    transformed binary/multiclass outputs live in [0, 1] (pass
    `value_range=(0, 1)`); otherwise the first `warm_n` samples set
    the range. Caller holds the monitor lock."""

    BINS = 20

    def __init__(self, value_range=None, warm_n=256):
        self.edges = (np.linspace(value_range[0], value_range[1],
                                  self.BINS + 1)
                      if value_range else None)
        self.counts = np.zeros(self.BINS, np.int64)
        self._warm = [] if value_range is None else None
        self._warm_n = int(warm_n)
        self.n = 0
        self.total = 0.0
        self.vmin = np.inf
        self.vmax = -np.inf

    def observe(self, values):
        v = np.asarray(values, np.float64).reshape(-1)
        v = v[np.isfinite(v)]
        if not len(v):
            return
        self.n += len(v)
        self.total += float(v.sum())
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))
        if self.edges is None:
            self._warm.extend(v.tolist())
            if len(self._warm) < self._warm_n:
                return
            lo, hi = self.vmin, self.vmax
            if hi <= lo:
                hi = lo + 1.0
            span = hi - lo
            self.edges = np.linspace(lo - 0.05 * span, hi + 0.05 * span,
                                     self.BINS + 1)
            v = np.asarray(self._warm)
            self._warm = None
        idx = np.clip(np.searchsorted(self.edges, v, side="right") - 1,
                      0, self.BINS - 1)
        np.add.at(self.counts, idx, 1)

    def snapshot(self):
        out = {"count": int(self.n)}
        if self.n:
            out.update({"mean": round(self.total / self.n, 6),
                        "min": round(self.vmin, 6),
                        "max": round(self.vmax, 6)})
        if self.edges is not None:
            out["edges"] = [round(float(e), 6) for e in self.edges]
            out["counts"] = [int(c) for c in self.counts]
        return out


class DriftMonitor:
    """Rolling per-feature bin histograms + PSI against the training
    profile (module docstring). Thread-safe. `observe` is the only
    request-path call: it draws `sample_rate * n` rows of integer
    credit, appends one contiguous slice view to the pending buffer,
    and returns — binning and PSI run in `flush()` (inline once
    `flush_rows` sampled rows accumulate, and on every reader).

    The flush bins ALL numerical features in one broadcast comparison
    against a per-feature group-edge matrix. The edges are the mapper
    upper bounds at `group_counts` fold boundaries, so
    `#(edges < value)` is EXACTLY `fold(mapper.value_to_bin(value))`
    (searchsorted side='left' counts bounds strictly below the value)
    without 28 per-feature mapper calls. Categorical features take the
    per-feature mapper path (dict lookup; rare in wide numeric data).

    `window_rows` bounds the rolling window: once twice that many rows
    accumulate, all counts halve (exponential forget) so the PSI
    tracks current traffic instead of the process lifetime."""

    def __init__(self, profile, sample_rate=DEFAULT_DRIFT_SAMPLE_RATE,
                 psi_warn=DEFAULT_PSI_WARN,
                 profile_bins=DEFAULT_PROFILE_BINS,
                 window_rows=100_000, pred_range=None, seed=12345,
                 flush_rows=DRIFT_FLUSH_ROWS):
        self.profile = profile
        self.sample_rate = float(sample_rate)
        self.psi_warn = float(psi_warn)
        self.profile_bins = int(profile_bins)
        self.window_rows = int(window_rows)
        self.flush_rows = int(flush_rows)
        self._lcg = int(seed) & _LCG_MASK
        self._credit = 0.0
        self._lock = threading.Lock()
        self._columns = [int(f["column"]) for f in profile.features]
        self._names = [str(f["name"]) for f in profile.features]
        baseline = [group_counts(f["counts"], self.profile_bins)
                    for f in profile.features]
        u_n = profile.num_features
        gmax = max((len(b) for b in baseline), default=1)
        self._gmax = gmax
        self._g = np.asarray([len(b) for b in baseline], np.float64)
        self._mask = np.arange(gmax)[None, :] < self._g[:, None]
        self._base = np.zeros((u_n, gmax), np.float64)
        for u, b in enumerate(baseline):
            self._base[u, :len(b)] = b
        self._counts = np.zeros((u_n, gmax), np.int64)
        # numerical features: group-edge matrix (padded +inf so absent
        # groups never match); categoricals keep their mapper
        self._num_u, self._cat = [], []
        edges = []
        for u, f in enumerate(profile.features):
            g = len(baseline[u])
            if f["bin_type"] == NUMERICAL:
                ub = np.asarray(f["upper_bounds"], np.float64)
                b = max(int(f["num_bin"]), 1)
                row = np.full(gmax - 1, np.inf) if gmax > 1 \
                    else np.zeros(0)
                if g > 1:
                    gi = np.arange(1, g)
                    hi = (gi * b + g - 1) // g - 1   # last bin of gi-1
                    row[:g - 1] = ub[np.minimum(hi, len(ub) - 1)]
                edges.append(row)
                self._num_u.append(u)
            else:
                self._cat.append((u, profile.mapper(u),
                                  int(f["num_bin"]), g))
        self._edges = (np.asarray(edges)
                       if edges else np.zeros((0, max(gmax - 1, 0))))
        self._num_u = np.asarray(self._num_u, np.int64)
        self._cols_arr = np.asarray(self._columns, np.int64)
        self._pending = []          # (rows_view, predictions_or_None)
        self._pending_rows = 0
        self.pred_hist = _PredHistogram(value_range=pred_range)
        self.rows_seen = 0
        self.rows_sampled = 0
        self._psi = np.zeros(u_n)
        self._warned = set()
        self.warnings = []          # bounded list of warning dicts
        self.min_psi_rows = max(MIN_PSI_ROWS,
                                MIN_PSI_ROWS_PER_GROUP * gmax)

    # ------------------------------------------------------------ intake
    def observe(self, rows, predictions=None):
        """One request's rows (N, F raw values; narrower inputs mean
        absent trailing features = NaN) and optionally its served
        predictions (multiclass outputs reduce to the winning-class
        confidence at flush). Request-path cost is the sampling
        decision + a slice view append; array normalization only runs
        on the (rare) sampled branch."""
        shape = getattr(rows, "shape", None)
        if shape is None or len(shape) != 2:
            rows = np.atleast_2d(np.asarray(rows))
            shape = rows.shape
        n = shape[0]
        with self._lock:
            self.rows_seen += n
            self._credit += n * self.sample_rate
            k = int(self._credit)
            if k <= 0 or (k < DRIFT_BURST_ROWS and k < n):
                return              # let credit accumulate to a burst
            k = min(k, n)
            self._credit -= k       # deduct only what is taken
            if k < n:
                self._lcg = (self._lcg * _LCG_MUL + _LCG_ADD) & _LCG_MASK
                start = (self._lcg >> 33) % (n - k + 1)
                # copies, not views: a view would pin the WHOLE request
                # array in the pending buffer until the next flush
                sampled = np.array(rows[start:start + k])
                preds = (None if predictions is None
                         else np.array(predictions[start:start + k]))
            else:
                sampled, preds = np.asarray(rows), predictions
            self._pending.append((sampled, preds))
            self._pending_rows += k
            if self._pending_rows >= self.flush_rows:
                self._flush_locked()

    def flush(self):
        """Run the deferred binning + PSI pass now (readers call this;
        request threads hit it via the flush_rows threshold)."""
        with self._lock:
            self._flush_locked()

    def _flush_locked(self):
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        self._pending_rows = 0
        u_n = len(self._names)
        # group by request width so the column gather runs ONCE per
        # width instead of once per (often single-row) pending entry
        by_width, preds = {}, {}
        for r, p in pending:
            by_width.setdefault(r.shape[1], []).append(r)
            if p is not None:
                p = np.asarray(p)
                preds.setdefault(p.shape[1:], []).append(p)
        mats = []
        for width, parts in by_width.items():
            r = (np.concatenate(parts) if len(parts) > 1 else parts[0])
            v = np.full((len(r), u_n), np.nan)
            ok = self._cols_arr < width
            v[:, ok] = r[:, self._cols_arr[ok]]
            mats.append(v)
        vals = np.concatenate(mats) if len(mats) > 1 else mats[0]
        # the binning rule: NaN (and absent trailing features) -> 0.0
        # -> the zero bin, exactly like training ingestion
        np.copyto(vals, 0.0, where=np.isnan(vals))
        grp = np.zeros(vals.shape, np.int64)
        if len(self._num_u):
            grp[:, self._num_u] = (
                vals[:, self._num_u, None] > self._edges[None]).sum(
                    axis=2, dtype=np.int64)
        for u, mapper, nb, g in self._cat:
            bins = mapper.value_to_bin(vals[:, u]).astype(np.int64)
            if nb > g:
                bins = (bins * g) // nb
            grp[:, u] = np.clip(bins, 0, g - 1)
        flat = (grp + np.arange(u_n, dtype=np.int64)[None, :]
                * self._gmax).ravel()
        self._counts += np.bincount(
            flat, minlength=u_n * self._gmax).reshape(u_n, self._gmax)
        for parts in preds.values():
            p = np.asarray(np.concatenate(parts) if len(parts) > 1
                           else parts[0], np.float64)
            if p.ndim > 1:      # multiclass: winning-class confidence
                p = p[:, 0] if p.shape[1] == 1 else p.max(axis=1)
            self.pred_hist.observe(p)
        self.rows_sampled += len(vals)
        if self.rows_sampled > 2 * self.window_rows:
            self._counts //= 2
            self.rows_sampled //= 2
        self._refresh_psi()

    def _refresh_psi(self):
        """Vectorized per-feature PSI + threshold bookkeeping (lock
        held). One structured warning per excursion over psi_warn; a
        feature re-arms after falling below half the threshold."""
        if self.rows_sampled < self.min_psi_rows or not len(self._psi):
            return
        e, a = self._base, self._counts.astype(np.float64)
        s = PSI_SMOOTHING
        esum, asum = e.sum(axis=1), a.sum(axis=1)
        p = (e + s) / (esum + s * self._g)[:, None]
        q = (a + s) / (asum + s * self._g)[:, None]
        terms = np.where(self._mask,
                         (q - p) * np.log(np.where(self._mask, q / p, 1.0)),
                         0.0)
        vals = terms.sum(axis=1)
        vals[(esum <= 0) | (asum <= 0)] = 0.0
        self._psi = vals
        for u in np.nonzero(vals >= self.psi_warn)[0]:
            name = self._names[u]
            if name in self._warned:
                continue
            self._warned.add(name)
            rec = {"feature": name, "psi": round(float(vals[u]), 4),
                   "threshold": self.psi_warn,
                   "rows_sampled": int(self.rows_sampled)}
            self.warnings.append(rec)
            del self.warnings[:-50]
            Log.structured("Warning", "drift_warn", **rec)
        for u in np.nonzero(vals < 0.5 * self.psi_warn)[0]:
            self._warned.discard(self._names[u])

    # ----------------------------------------------------------- readers
    def psi_by_feature(self):
        with self._lock:
            self._flush_locked()
            return {self._names[u]: round(float(self._psi[u]), 6)
                    for u in range(len(self._names))}

    def gauges(self):
        """Scalar fields for /metricz (JSON and Prometheus)."""
        with self._lock:
            self._flush_locked()
            top = int(np.argmax(self._psi)) if len(self._psi) else 0
            return {
                "drift_rows_seen": int(self.rows_seen),
                "drift_rows_sampled": int(self.rows_sampled),
                "drift_psi_max": round(float(self._psi.max())
                                       if len(self._psi) else 0.0, 6),
                "drift_features_over_warn": int(
                    (self._psi >= self.psi_warn).sum()
                    if self.rows_sampled >= self.min_psi_rows else 0),
                "drift_top_feature": (self._names[top]
                                      if len(self._names) else ""),
            }

    def snapshot(self):
        """The /driftz document."""
        with self._lock:
            self._flush_locked()
            features = {}
            for u, name in enumerate(self._names):
                g = int(self._g[u])
                features[name] = {
                    "psi": round(float(self._psi[u]), 6),
                    "column": self._columns[u],
                    "baseline_rows": int(self._base[u, :g].sum()),
                    "observed_rows": int(self._counts[u, :g].sum()),
                    "baseline_zero_rate": round(
                        self.profile.zero_rate(u), 6),
                }
            psi_max = float(self._psi.max()) if len(self._psi) else 0.0
            return {
                "sample_rate": self.sample_rate,
                "psi_warn": self.psi_warn,
                "profile_bins": self.profile_bins,
                "window_rows": self.window_rows,
                "rows_seen": int(self.rows_seen),
                "rows_sampled": int(self.rows_sampled),
                "min_psi_rows": self.min_psi_rows,
                "psi_max": round(psi_max, 6),
                "features": features,
                "prediction": self.pred_hist.snapshot(),
                "warnings": list(self.warnings),
            }


class SkewMonitor:
    """Shadow-scoring skew detector: sampled rows re-score through the
    host f64 reference path and any row diverging beyond SKEW_TOL from
    the served output counts as skew. `reference_fn(kind, rows)` is
    built by `host_reference_scorer` (a plain GBDT loaded from the
    same model file, device predict forced off).

    Request-path `observe` only enqueues slice views (credit sampling,
    `max_rows_per_check` cap per request); the reference scoring runs
    batched in `flush()` — inline past `flush_rows` pending rows and
    on every reader — one reference call per endpoint kind, which
    amortizes the reference path's fixed per-call cost (~0.2 ms)
    across the whole buffered sample."""

    def __init__(self, reference_fn,
                 sample_rate=DEFAULT_SKEW_SAMPLE_RATE,
                 skew_warn=DEFAULT_SKEW_WARN, tol=SKEW_TOL,
                 max_rows_per_check=16, seed=54321,
                 flush_rows=SKEW_FLUSH_ROWS):
        self.reference_fn = reference_fn
        self.sample_rate = float(sample_rate)
        self.skew_warn = int(skew_warn)
        self.tol = float(tol)
        self.max_rows_per_check = int(max_rows_per_check)
        self.flush_rows = int(flush_rows)
        self._lcg = int(seed) & _LCG_MASK
        self._credit = 0.0
        self._lock = threading.Lock()
        self._pending = []          # (rows_view, served_slice, kind)
        self._pending_rows = 0
        self.rows_checked = 0
        self.skew_count = 0
        self.max_abs_diff = 0.0
        self._warned_at = 0

    def observe(self, rows, served, kind):
        """Enqueue a bounded sample of a request's (rows, served
        output) for shadow scoring. `kind` is the endpoint
        ("predict"/"raw"; leaf indices are already int-exact and
        skipped)."""
        if kind not in ("predict", "raw") or self.sample_rate <= 0.0:
            return
        shape = getattr(rows, "shape", None)
        if shape is None or len(shape) != 2:
            rows = np.atleast_2d(np.asarray(rows))
            shape = rows.shape
        n = shape[0]
        with self._lock:
            self._credit += n * self.sample_rate
            k = int(self._credit)
            if k <= 0:
                return
            k = min(k, n, self.max_rows_per_check)
            self._credit -= k       # deduct only what is taken; cap
            self._credit = min(     # the carry-over so a rate above
                self._credit,       # cap/request-size cannot grow it
                4.0 * self.max_rows_per_check)   # without bound
            self._lcg = (self._lcg * _LCG_MUL + _LCG_ADD) & _LCG_MASK
            start = (self._lcg >> 33) % (n - k + 1)
            # copies, not views (see DriftMonitor.observe)
            self._pending.append((np.array(rows[start:start + k]),
                                  np.array(served[start:start + k]),
                                  kind))
            self._pending_rows += k
            do_flush = self._pending_rows >= self.flush_rows
        if do_flush:
            self.flush()

    def flush(self):
        """Shadow-score everything pending. The reference call runs
        OUTSIDE the lock so a slow reference model never blocks the
        request threads' enqueues."""
        with self._lock:
            batch, self._pending = self._pending, []
            self._pending_rows = 0
        # one reference call per (endpoint, request width) — widths
        # can differ between clients and must not concatenate
        groups = {}
        for r, s, kind in batch:
            groups.setdefault((kind, r.shape[1]), []).append((r, s))
        for (kind, _), part in groups.items():
            self._check(kind,
                        np.concatenate([
                            np.asarray(r, np.float64)
                            for r, _ in part]),
                        np.concatenate([
                            np.asarray(s, np.float64).reshape(
                                len(r), -1)
                            for r, s in part]))

    def _check(self, kind, rows, got):
        try:
            ref = np.asarray(self.reference_fn(kind, rows), np.float64)
        except Exception as e:    # the monitor must never fail serving
            Log.warning("skew monitor reference scoring failed: %s", e)
            return
        ref = ref.reshape(len(rows), -1)
        if ref.shape != got.shape:
            Log.warning("skew monitor shape mismatch: served %s vs "
                        "reference %s", got.shape, ref.shape)
            return
        diff = np.abs(got - ref)
        row_max = diff.max(axis=1) if diff.size else np.zeros(0)
        bad = int((row_max > self.tol).sum())
        with self._lock:
            self.rows_checked += len(rows)
            self.max_abs_diff = max(self.max_abs_diff,
                                    float(row_max.max())
                                    if len(row_max) else 0.0)
            if bad:
                self.skew_count += bad
                if (self.skew_warn > 0
                        and self.skew_count >= self.skew_warn
                        # warn at the first crossing, then once per
                        # doubling — a persistent skew must not flood
                        and self.skew_count >= 2 * self._warned_at):
                    self._warned_at = max(self.skew_count, 1)
                    Log.structured(
                        "Warning", "skew_warn", kind=kind,
                        skew_count=int(self.skew_count),
                        rows_checked=int(self.rows_checked),
                        max_abs_diff=float(self.max_abs_diff),
                        threshold=self.skew_warn, tol=self.tol)

    def gauges(self):
        self.flush()
        with self._lock:
            return {"skew_rows_checked": int(self.rows_checked),
                    "skew_count": int(self.skew_count),
                    "skew_max_abs_diff": float(self.max_abs_diff)}

    def snapshot(self):
        out = self.gauges()
        out.update({"sample_rate": self.sample_rate,
                    "skew_warn": self.skew_warn, "tol": self.tol,
                    "max_rows_per_check": self.max_rows_per_check})
        return out


def host_reference_scorer(model_path):
    """Load the model text format into a plain GBDT and return
    `fn(kind, rows)` scoring on the HOST f64 path (device predict
    forced off) — the serving skew monitor's ground truth."""
    from ..models.gbdt import create_boosting
    booster = create_boosting("gbdt", "cpu", input_model=model_path)
    with open(model_path) as f:
        booster.load_model_from_string(f.read())
    # hard host routing: beats even LIGHTGBM_TPU_DEVICE_PREDICT=force,
    # which a throughput-tuned deployment may export — the reference
    # must never score on the device f32 path it is checking against
    booster.force_host_predict = True
    width = booster.max_feature_idx + 1

    def fn(kind, rows):
        x = np.atleast_2d(np.asarray(rows, np.float64))
        f = x.shape[1]
        if f < width:          # same canonicalization as the predictor
            x = np.pad(x, ((0, 0), (0, width - f)))  # 0.0, like _canon
        elif f > width:
            x = x[:, :width]
        return booster.predict_raw(x) if kind == "raw" \
            else booster.predict(x)

    # warm both paths now: the host predictor's one-time array setup
    # belongs to startup, not to the first shadow-score flush
    warm = np.zeros((1, width))
    fn("predict", warm)
    fn("raw", warm)
    return fn
