"""The port's lint engine: load rules, run them, apply suppression
(lightgbm_tpu/analysis/engine.py).

Suppression precedence: an inline
``# graftlint: disable=<rule>`` pragma wins first (the suppression
lives next to the code, visible in review), then the committed
baseline (lightgbm_tpu_torch/analysis/lint_baseline.json). A violation suppressed by a
pragma never consumes a baseline entry, so baselines can't mask code
that already carries (or later gains) a pragma — the unused-entry
report stays truthful.
"""

import time
from dataclasses import dataclass, field

from .baseline import Baseline
from .core import REGISTRY, Project, Severity


def load_rules():
    """Import every rule module (populating REGISTRY) and return it."""
    from . import rules  # noqa: F401  (import side effect: @register)
    return REGISTRY


@dataclass
class LintResult:
    violations: list = field(default_factory=list)   # active
    suppressed: list = field(default_factory=list)   # pragma/baseline
    baseline_unused: list = field(default_factory=list)
    parse_errors: list = field(default_factory=list)
    files: int = 0
    elapsed_s: float = 0.0
    rules: tuple = ()

    @property
    def errors(self):
        return [v for v in self.violations
                if v.severity == Severity.ERROR]

    @property
    def warnings(self):
        return [v for v in self.violations
                if v.severity == Severity.WARNING]

    def as_dict(self):
        return {
            "version": 1,
            "files": self.files,
            "elapsed_s": round(self.elapsed_s, 3),
            "rules": list(self.rules),
            "violations": [v.as_dict() for v in self.violations],
            "suppressed": [v.as_dict() for v in self.suppressed],
            "baseline_unused": self.baseline_unused,
            "parse_errors": [{"file": f, "message": m}
                             for f, m in self.parse_errors],
            "error_count": len(self.errors),
            "warning_count": len(self.warnings),
        }


def lint_project(root, rule_names=None, use_baseline=True, project=None):
    """Run the (selected) rules over the project at ``root``.

    Returns a LintResult; raises BaselineError on a malformed baseline
    (a bad baseline must fail CI loudly, not silently un-suppress)."""
    t0 = time.perf_counter()
    registry = load_rules()
    names = tuple(rule_names) if rule_names else tuple(sorted(registry))
    unknown = [n for n in names if n not in registry]
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(unknown)}; "
                         f"known: {', '.join(sorted(registry))}")
    proj = project if project is not None else Project(root)
    baseline = Baseline.load(proj.root) if use_baseline else Baseline()

    result = LintResult(files=len(proj.files), rules=names,
                        parse_errors=list(proj.errors))
    raw = []
    for name in names:
        raw.extend(registry[name].check(proj))
    raw.sort(key=lambda v: (v.path, v.line, v.rule))
    for v in raw:
        pf = proj.get(v.path)
        if pf is not None and pf.suppressed(v.line, v.rule):
            v.suppressed_by = "pragma"
            result.suppressed.append(v)
        elif baseline.suppresses(v):
            v.suppressed_by = "baseline"
            result.suppressed.append(v)
        else:
            result.violations.append(v)
    # a partial --rule run can only judge its own rules' entries:
    # entries for rules that didn't run are NOT unused, just untested
    result.baseline_unused = [e for e in baseline.unused()
                              if e["rule"] in names]
    result.elapsed_s = time.perf_counter() - t0
    return result
