"""prometheus-naming: metric name literals must survive the exposition
naming contract.

Provenance (lightgbm_tpu/analysis/rules/prom_naming.py, aimed at the
port's own telemetry/prometheus.py): telemetry/prometheus.py maps internal registry names to
canonical exposition names at the render boundary (`canonical_name`:
``_s``/``_ms`` -> ``_seconds`` with value scaling, ``_pct`` ->
``_ratio``, counters forced ``*_total``) and `lint_names` audits every
served page. But the runtime audit only sees pages a test actually
renders — a metric minted on a rarely-scraped path (or behind a knob)
ships unchecked. This rule runs the SAME per-family check statically
over every metric-name string literal at registry call sites:
``.inc("...")`` (counter), ``.observe("...")`` (summary),
``.set("...", v)`` / ``.counter/.gauge/.histogram("...")``. Each
literal is passed through the real ``sanitize_name`` +
``canonical_name`` + ``lint_family_name`` — imported from
telemetry/prometheus.py itself (loaded by file path, so the linter
never imports the package), which is what makes the static and runtime
lint a single implementation.

Names built dynamically (f-strings over feature names, etc.) are
skipped; the runtime page audit still covers those.
"""

import ast
import importlib.util
import os

from ..core import Fixture, Rule, Severity, register

# call attr -> metric kind for the canonical mapping
_KINDS = {"inc": "counter", "counter": "counter",
          "observe": "summary", "histogram": "summary",
          "set": "gauge", "gauge": "gauge"}

PROM_REL = "lightgbm_tpu_torch/telemetry/prometheus.py"

_PROM_CACHE = {}


def _prometheus(project=None):
    """The real telemetry/prometheus.py, loaded by file path (its only
    import is `re`, so this works without the parent package).

    Resolution order: the LINTED project's copy (so linting another
    checkout applies THAT tree's contract, same as journal-schema
    reading the linted tree's SCHEMA), falling back to the copy shipped
    next to this rule (fixture projects carry no prometheus.py but
    still lint against the real contract)."""
    path = None
    if project is not None:
        pf = project.get(PROM_REL)
        if pf is not None:
            path = pf.path
    if path is None:
        path = os.path.normpath(os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            os.pardir, os.pardir, "telemetry", "prometheus.py"))
    mod = _PROM_CACHE.get(path)
    if mod is None:
        try:
            spec = importlib.util.spec_from_file_location(
                "_port_lint_prometheus", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            for attr in ("sanitize_name", "canonical_name",
                         "lint_family_name"):
                getattr(mod, attr)
        except Exception:
            # the linted tree's copy is broken/incomplete: fall back
            # to the shipped contract rather than crashing the run
            if project is not None:
                return _prometheus(None)
            raise
        _PROM_CACHE[path] = mod
    return mod


@register
class PrometheusNamingRule(Rule):
    name = "prometheus-naming"
    doc = ("metric name literal violates the exposition naming "
           "contract (telemetry/prometheus.py lint_family_name)")
    severity = Severity.ERROR

    def check(self, project):
        prom = _prometheus(project)
        out = []
        for pf in project.in_package():
            if pf.rel.startswith("lightgbm_tpu_torch/analysis/"):
                continue   # rule fixtures carry deliberate violations
            for call in pf.calls():
                hit = self._metric_literal(call)
                if hit is None:
                    continue
                literal, kind = hit
                base, _scale = prom.canonical_name(
                    prom.sanitize_name(literal), kind)
                for msg in prom.lint_family_name(base, kind):
                    out.append(self.violation(
                        pf, call,
                        f"metric name {literal!r} renders as {base!r}: "
                        f"{msg} (naming contract, "
                        f"telemetry/prometheus.py)"))
        return out

    def _metric_literal(self, call):
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        kind = _KINDS.get(attr)
        if kind is None or not call.args:
            return None
        first = call.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            return None
        # .set() is too generic a method name to trust on arity != 2
        if attr == "set" and len(call.args) != 2:
            return None
        return first.value, kind

    def fixtures(self):
        bad = {
            "lightgbm_tpu_torch/telemetry/consumers.py": (
                "def account(m, dt):\n"
                "    m.observe('request_millis', dt)\n"
                "    m.inc('swap!!count')\n"
            ),
        }
        good = {
            "lightgbm_tpu_torch/telemetry/consumers.py": (
                "def account(m, dt):\n"
                "    m.observe('request_ms', dt)\n"
                "    m.inc('swap_count')\n"
                "    m.set('queue_depth', 3)\n"
            ),
        }
        good_dynamic = {
            "lightgbm_tpu_torch/telemetry/consumers.py": (
                "def account(m, feature, v):\n"
                "    m.set(f'drift_psi_{feature}', v)\n"
            ),
        }
        return [
            # 'request_millis' keeps its legacy suffix through
            # canonical_name (only _ms/_s/_secs/_pct/_per_s are
            # mapped); 'swap!!count' sanitizes to a __-run name
            Fixture("bad-literals", bad, expect=2),
            Fixture("canonical-internal-names", good, expect=0),
            Fixture("dynamic-name-skipped", good_dynamic, expect=0),
        ]
