"""The port's lint CLI.

    python -m lightgbm_tpu_torch.analysis [ROOT] [options]

Options:
    --json [PATH]       machine-readable report (stdout when PATH is -)
    --rule NAME         run only this rule (repeatable)
    --list-rules        print the rule catalogue and exit
    --no-baseline       ignore the baseline file
    --update-baseline   rewrite the baseline from the current tree
                        (preserves surviving justifications; new
                        entries get a FIXME placeholder the loader
                        rejects until a human justifies them)
    --self-check        replay every rule's known-bad/known-good
                        fixture corpus against the engine and exit
    --strict            warnings fail too

Exit codes: 0 clean (errors all suppressed), 1 violations (or fixture
failures under --self-check), 2 usage / malformed baseline.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

from .baseline import BASELINE_REL, Baseline, BaselineError
from .core import Project, Severity
from .engine import lint_project, load_rules


def repo_root():
    """The checkout containing this package (two levels up)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def self_check(out=sys.stdout):
    """Replay the fixture corpus: every rule must flag its known-bad
    snippets (exact count) and stay silent on its known-good ones —
    through the full engine, so pragma handling is exercised too.
    Returns 0/1."""
    registry = load_rules()
    failures = []
    total = 0
    for name in sorted(registry):
        rule = registry[name]
        for fx in rule.fixtures():
            total += 1
            tmp = tempfile.mkdtemp(prefix="torchlint_fx_")
            try:
                for rel, text in fx.files.items():
                    path = os.path.join(tmp, rel)
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "w", encoding="utf-8") as f:
                        f.write(text)
                result = lint_project(tmp, rule_names=[name],
                                      use_baseline=False)
                got = len([v for v in result.violations if v.rule == name])
                if got != fx.expect:
                    failures.append(
                        f"{name}/{fx.name}: expected {fx.expect} "
                        f"violation(s), got {got}: "
                        + "; ".join(v.format() for v in result.violations))
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        print(f"lint self-check: FAIL "
              f"({len(failures)}/{total} fixtures)", file=out)
        for f in failures:
            print("  " + f, file=out)
        return 1
    print(f"lint self-check: OK ({total} fixtures, "
          f"{len(registry)} rules)", file=out)
    return 0


def list_rules(out=sys.stdout):
    registry = load_rules()
    for name in sorted(registry):
        r = registry[name]
        print(f"{name:26s} [{r.severity}] {r.doc}", file=out)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.analysis",
        description="AST-based invariant linter for the lightgbm_tpu_torch "
                    "package and chip_smoke.py")
    ap.add_argument("root", nargs="?", default=None,
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH", help="write the JSON report")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only this rule (repeatable)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--self-check", action="store_true")
    ap.add_argument("--strict", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        return list_rules()
    if args.self_check:
        return self_check()

    root = os.path.abspath(args.root or repo_root())
    try:
        # the update path must be able to rewrite a ROTTEN baseline,
        # so it lints baseline-free and loads the old file leniently
        result = lint_project(
            root, rule_names=args.rule,
            use_baseline=not (args.no_baseline or args.update_baseline))
    except BaselineError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        # lenient load: keep whatever well-formed, justified entries
        # the old file has so their justifications survive the rewrite
        old = Baseline.load(root, strict=False)
        # regenerate from EVERYTHING not pragma-suppressed
        keep = result.violations + [v for v in result.suppressed
                                    if v.suppressed_by == "baseline"]
        carried = []
        if args.rule:
            # a partial run only re-derives the selected rules'
            # entries — rules that didn't run keep theirs verbatim
            # (and their justifications)
            carried = [e for e in old.entries
                       if e["rule"] not in set(args.rule)]
        text = Baseline.render(keep, old, carry=carried)
        path = os.path.join(root, BASELINE_REL)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        n = len(json.loads(text)["entries"])
        print(f"lint: baseline rewritten: {path} "
              f"({n} entr{'y' if n == 1 else 'ies'}; "
              f"fill in any FIXME justifications)")
        return 0

    if args.json is not None:
        payload = json.dumps(result.as_dict(), indent=1)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as f:
                f.write(payload + "\n")

    for v in result.violations:
        print(v.format())
    for rel, msg in result.parse_errors:
        print(f"{rel}:0 parse-error {msg}")
    for e in result.baseline_unused:
        print(f"{BASELINE_REL}: unused entry "
              f"({e['rule']} {e['file']}: {e['line_text'][:60]!r}) — "
              f"the violation is gone, drop the entry")
    n_err = len(result.errors)
    n_warn = len(result.warnings)
    print(f"lint: {result.files} files, "
          f"{n_err} error(s), {n_warn} warning(s), "
          f"{len(result.suppressed)} suppressed "
          f"(baseline+pragma), {result.elapsed_s:.2f}s")
    failed = bool(n_err or result.parse_errors
                  or (args.strict and (n_warn or result.baseline_unused)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
