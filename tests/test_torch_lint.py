"""lightgbm_tpu_torch's own lint (lightgbm_tpu_torch/analysis/).

Every rule's known-bad/known-good fixtures replay through the engine
(the fixtures live in the rule modules), the self-check and the CLI's
exit codes hold, the live port tree lints clean modulo its justified
baseline, a planted `import jax` in a copy of the tree is flagged, and
the port's rules never reach the JAX lint's registry.
"""

import io
import json
import os
import shutil

import pytest

from lightgbm_tpu_torch.analysis import REGISTRY, lint_project, load_rules
from lightgbm_tpu_torch.analysis.baseline import BASELINE_REL, Baseline
from lightgbm_tpu_torch.analysis.cli import main, self_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

load_rules()


def _write(root, files):
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return str(root)


@pytest.mark.parametrize("rule_name,fx", [
    pytest.param(name, fx, id=f"{name}-{fx.name}")
    for name in sorted(REGISTRY) for fx in REGISTRY[name].fixtures()])
def test_rule_fixture(tmp_path, rule_name, fx):
    result = lint_project(_write(tmp_path, fx.files), rule_names=[rule_name],
                          use_baseline=False)
    got = [v for v in result.violations if v.rule == rule_name]
    assert len(got) == fx.expect, [v.format() for v in got]


def test_rule_set_and_self_check():
    assert sorted(REGISTRY) == [
        "config-doc-drift", "journal-schema", "no-jax-import",
        "non-atomic-shared-write", "nondeterminism", "precision-contract",
        "prometheus-naming", "trace-context-propagation", "unbounded-io",
        "unguarded-collective"]
    for rule in REGISTRY.values():
        expects = [fx.expect for fx in rule.fixtures()]
        assert any(expects) and 0 in expects, rule.name
    out = io.StringIO()
    assert self_check(out) == 0
    assert "self-check: OK (38 fixtures, 10 rules)" in out.getvalue()


def test_live_port_tree_lints_clean(tmp_path):
    result = lint_project(REPO)
    assert not result.violations, [v.format() for v in result.violations]
    assert not result.parse_errors and not result.baseline_unused
    assert result.files > 100
    assert {v.path for v in result.suppressed} <= {
        e["file"] for e in Baseline.load(REPO).entries} | {
        "lightgbm_tpu_torch/config.py"}
    report = tmp_path / "lint.json"
    assert main([REPO, "--json", str(report)]) == 0
    assert json.loads(report.read_text())["error_count"] == 0


def test_planted_jax_import_is_flagged(tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(REPO, "lightgbm_tpu_torch"),
                    root / "lightgbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build",
                                                  "*.cu", "*.cuh", "*.cpp"))
    for rel in ("chip_smoke.py", "README.md",
                os.path.join("docs", "Parameters.md")):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), root / rel)
    target = root / "lightgbm_tpu_torch" / "ops" / "split.py"
    target.write_text(target.read_text() + "\nimport jax.numpy as jnp\n")
    result = lint_project(str(root))
    assert [(v.rule, v.path) for v in result.violations] == [
        ("no-jax-import", "lightgbm_tpu_torch/ops/split.py")]
    assert main([str(root)]) == 1


def test_port_rules_stay_out_of_the_jax_registry():
    from lightgbm_tpu.analysis import core as jax_core
    from lightgbm_tpu.analysis import load_rules as jax_load_rules
    jax_load_rules()
    before = dict(jax_core.REGISTRY)
    load_rules()
    assert jax_core.REGISTRY == before
    assert jax_core.REGISTRY is not REGISTRY
    assert "no-jax-import" not in jax_core.REGISTRY
    assert "callback-in-mesh" not in REGISTRY
    assert BASELINE_REL.startswith("lightgbm_tpu_torch")
