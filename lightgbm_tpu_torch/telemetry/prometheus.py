"""Prometheus text exposition of the metrics registry (the port's copy
of lightgbm_tpu/telemetry/prometheus.py).

`?format=prometheus` on /metricz (serving/server.py) renders the SAME
registry that backs the JSON view in the text exposition format
(version 0.0.4), under the JAX package's names, so one scrape job works
against either package's servers with zero extra dependencies:

    scrape_configs:
      - job_name: lightgbm_tpu
        metrics_path: /metricz
        params: {format: [prometheus]}

Counters render as `counter`, gauges as `gauge`, registry histograms
as `summary` (quantile series from the ring's nearest-rank
percentiles, plus `_sum`/`_count` over the process lifetime).

NAMING CONTRACT (the audit `lint_names` enforces and a test renders
every registry against): one canonical `lightgbm_tpu_` prefix, base
units with unit suffixes — times are `_seconds` (values converted:
internal `_ms` metrics are scaled to seconds at render), byte counts
`_bytes`, fractions `_ratio` (internal `_pct` values scaled /100),
rates `_per_second`, and every counter ends `_total`. Internal
registry names keep their short forms (`sync_wait_s`, `latency_ms`) —
`canonical_name` maps them at the exposition boundary, so the JSON
views and in-process consumers are untouched while every scraped
dashboard sees one consistent naming scheme. Names are sanitized to
the exposition charset; non-numeric extra values are skipped rather
than corrupting the page.
"""

import re

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")

# legacy internal suffix -> (canonical suffix, value scale). Order
# matters: `_per_s` must match before `_s`.
_UNIT_MAP = (("_per_s", "_per_second", 1.0),
             ("_ms", "_seconds", 1e-3),
             ("_s", "_seconds", 1.0),
             ("_secs", "_seconds", 1.0),
             ("_pct", "_ratio", 1e-2))

# suffixes the lint rejects: a name still carrying one escaped the
# canonical mapping (or was minted after this audit without a unit)
_LEGACY_SUFFIXES = ("_s", "_ms", "_secs", "_sec", "_pct", "_millis")


def sanitize_name(name, prefix="lightgbm_tpu"):
    """Metric name -> exposition-legal name (`[a-zA-Z_:][a-zA-Z0-9_:]*`),
    prefixed. Every illegal char becomes `_`."""
    name = _BAD_CHARS.sub("_", str(name))
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return f"{prefix}_{name}" if prefix else name


def canonical_name(name, kind="gauge"):
    """Internal metric name -> (canonical exposition name, value
    scale): unit suffixes normalized to base units (`_s`/`_ms` ->
    `_seconds`, `_pct` -> `_ratio` with the matching value scale,
    `_per_s` -> `_per_second`), counters forced to end `_total`
    (`_count` counters are renamed, not double-suffixed). Applied
    AFTER sanitize/prefix by the render path; pure so the lint and the
    tests can call it standalone."""
    name = name.lower()   # the contract is lowercase (feature-derived
    #                       names like drift_psi_<Feature> arrive mixed)
    scale = 1.0
    for suffix, repl, sc in _UNIT_MAP:
        if name.endswith(suffix):
            name = name[: -len(suffix)] + repl
            scale = sc
            break
    if kind == "counter":
        if name.endswith("_count"):
            name = name[: -len("_count")] + "_total"
        elif not name.endswith("_total"):
            name += "_total"
    return name, scale


def _fmt(v):
    """Exposition float formatting (no exponent-less NaN/Inf problems:
    Prometheus accepts NaN/+Inf/-Inf literals, but the registry never
    stores them — JSON-sanitized upstream)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _label_str(labels, extra=None):
    """{k: v} -> '{k="v",...}' ('' when empty). Label values escape
    backslash/quote/newline per the exposition format."""
    items = list((labels or {}).items()) + list((extra or {}).items())
    if not items:
        return ""
    def esc(v):
        return (str(v).replace("\\", r"\\").replace('"', r'\"')
                .replace("\n", r"\n"))
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in items) + "}"


def _scaled(v, scale):
    if scale == 1.0 or not isinstance(v, (int, float)) \
            or isinstance(v, bool):
        return v
    return v * scale


def families(snapshot, prefix="lightgbm_tpu", extra_gauges=None,
             labels=None):
    """Registry snapshot -> ordered {family_name: (kind, [sample
    lines])}. The shared core of `render` (one source) and
    `render_multi` (the aggregator's many labeled sources, where each
    family's TYPE line must appear exactly once across all of them)."""
    out = {}
    lab = _label_str(labels)

    def add(name, kind, samples):
        existing = out.get(name)
        if existing is None:
            out[name] = (kind, list(samples))
        else:
            existing[1].extend(samples)

    for name, value in sorted((snapshot.get("counters") or {}).items()):
        if not isinstance(value, (int, float)):
            continue
        n, scale = canonical_name(sanitize_name(name, prefix), "counter")
        add(n, "counter", [f"{n}{lab} {_fmt(_scaled(value, scale))}"])
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        if not isinstance(value, (int, float)):
            continue
        n, scale = canonical_name(sanitize_name(name, prefix), "gauge")
        add(n, "gauge", [f"{n}{lab} {_fmt(_scaled(value, scale))}"])
    for name, summ in sorted((snapshot.get("histograms") or {}).items()):
        if not isinstance(summ, dict):
            continue
        n, scale = canonical_name(sanitize_name(name, prefix), "summary")
        samples = []
        for pct, q in ((50, "0.5"), (95, "0.95"), (99, "0.99")):
            v = summ.get(f"p{pct}")
            if isinstance(v, (int, float)):
                samples.append(
                    f'{n}{_label_str(labels, {"quantile": q})} '
                    f"{_fmt(_scaled(v, scale))}")
        if isinstance(summ.get("total"), (int, float)):
            samples.append(
                f"{n}_sum{lab} {_fmt(_scaled(summ['total'], scale))}")
        if isinstance(summ.get("count"), (int, float)):
            # observation counts are unitless — never unit-scaled
            samples.append(f"{n}_count{lab} {_fmt(summ['count'])}")
        if samples:
            add(n, "summary", samples)
    for name, value in sorted((extra_gauges or {}).items()):
        if not isinstance(value, (int, float)):
            continue
        n, scale = canonical_name(sanitize_name(name, prefix), "gauge")
        add(n, "gauge", [f"{n}{lab} {_fmt(_scaled(value, scale))}"])
    return out


def _emit(fam):
    lines = []
    for name, (kind, samples) in fam.items():
        lines.append(f"# TYPE {name} {kind}")
        lines.extend(samples)
    return "\n".join(lines) + "\n"


def render(snapshot, prefix="lightgbm_tpu", extra_gauges=None,
           labels=None):
    """Registry snapshot (MetricsRegistry.snapshot(): counters/gauges/
    histograms) -> exposition text. `extra_gauges` is a flat
    {name: number} dict appended as gauges (serving warmup stats,
    queue depth, roofline numbers...); `labels` attach to every sample
    (the aggregator's `rank`/`role`)."""
    return _emit(families(snapshot, prefix, extra_gauges, labels))


def render_multi(parts, prefix="lightgbm_tpu"):
    """Many labeled sources -> ONE exposition page with each family's
    TYPE line emitted exactly once (repeating it per source is a
    format violation a real Prometheus server rejects). `parts` is an
    iterable of (labels, snapshot, extra_gauges); sources sharing a
    family must carry distinguishing labels or the duplicate-sample
    rule trips downstream. On a kind conflict across sources the first
    wins and later samples of that family are dropped (conflicting
    types in one family are unscrapable anyway)."""
    merged = {}
    for labels, snapshot, extra in parts:
        for name, (kind, samples) in families(
                snapshot or {}, prefix, extra, labels).items():
            existing = merged.get(name)
            if existing is None:
                merged[name] = (kind, list(samples))
            elif existing[0] == kind:
                existing[1].extend(samples)
    return _emit(merged)


def lint_family_name(base, kind=None):
    """Violation strings for ONE family name against the naming
    contract (empty = conformant): the per-name core of
    `lint_names`."""
    if not base.startswith("lightgbm_tpu_"):
        return [f"{base!r} lacks the lightgbm_tpu_ prefix"]
    violations = []
    if not re.fullmatch(r"[a-z][a-z0-9_]*", base) or "__" in base:
        violations.append(
            f"{base!r} is not lowercase [a-z0-9_] without __ runs")
    for suffix in _LEGACY_SUFFIXES:
        if base.endswith(suffix):
            violations.append(
                f"{base!r} ends with legacy unit suffix {suffix!r} "
                "(use _seconds/_bytes/_ratio/_total)")
            break
    if kind == "counter" and not base.endswith("_total"):
        violations.append(f"counter {base!r} must end _total")
    return violations


def lint_names(text):
    """Audit one exposition page against the naming contract. Returns
    a list of violation strings (empty = conformant):

    - every family carries the `lightgbm_tpu_` prefix and is
      lowercase `[a-z0-9_]` (no `__` runs);
    - no family ends with a legacy unit suffix (`_s`, `_ms`, `_pct`,
      ...) — times must be `_seconds`, fractions `_ratio`;
    - every `counter` family ends `_total`;
    - no duplicate samples, and every sample parses.

    Per-family checks are `lint_family_name`; this adds the page-level
    ones (duplicates, summary sub-series attribution).
    """
    violations = []
    kinds = {}
    seen = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        name = line.rsplit(" ", 1)[0]
        if name in seen:
            violations.append(f"line {lineno}: duplicate sample {name!r}")
        seen.add(name)
        base = name.split("{", 1)[0]
        # summary sub-series lint against their family name
        for sub in ("_sum", "_count"):
            if base.endswith(sub) and base[: -len(sub)] in kinds:
                base = base[: -len(sub)]
                break
        violations.extend(f"line {lineno}: {v}"
                          for v in lint_family_name(base, kinds.get(base)))
    return violations


def parse(text):
    """Minimal exposition parser: {name: value} for plain samples,
    {name{labels}: value} kept verbatim for labeled ones. Raises
    ValueError on a malformed line — the round-trip check tests and
    `make verify-obs` rely on."""
    out = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(" ", 1)
        if len(parts) != 2:
            raise ValueError(f"line {lineno}: not 'name value': {line!r}")
        name, value = parts
        base = name.split("{", 1)[0]
        if not _NAME_OK.match(base):
            raise ValueError(f"line {lineno}: bad metric name {base!r}")
        if name in out:
            # the exposition format forbids duplicate series — a real
            # Prometheus server rejects the whole scrape on one
            raise ValueError(f"line {lineno}: duplicate sample {name!r}")
        out[name] = float(value)   # ValueError on a bad float
    return out
