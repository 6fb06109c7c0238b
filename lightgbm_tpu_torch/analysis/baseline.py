"""Committed suppression baseline
(lightgbm_tpu_torch/analysis/lint_baseline.json; the format of the JAX
package's tools/lint_baseline.json).

Existing accepted violations must not block CI, but every acceptance
must be *explained*: each entry carries a mandatory non-empty
``justification`` string (the engine refuses a baseline without one).
Entries match on (rule, file, stripped flagged-line text) — line
CONTENT, not line numbers, so surrounding edits don't invalidate the
baseline while any change to the flagged line itself (the thing that
was actually reviewed) does. One entry suppresses every identical
occurrence in its file. Unused entries are reported so the file can't
silently rot; ``--update-baseline`` rewrites it from the current tree
(justifications of surviving entries are preserved, new entries get a
FIXME placeholder the engine then rejects until a human fills it in).
"""

import json
import os

BASELINE_REL = os.path.join("lightgbm_tpu_torch", "analysis",
                            "lint_baseline.json")
PLACEHOLDER = "FIXME: justify or fix"


class BaselineError(Exception):
    """The baseline file is malformed (bad JSON, missing fields, or an
    entry without a justification)."""


class Baseline:
    def __init__(self, entries=None, path=None):
        self.entries = list(entries or [])
        self.path = path
        self._used = [False] * len(self.entries)

    @classmethod
    def load(cls, root, strict=True):
        """Load the baseline file. ``strict`` (the lint path)
        rejects malformed entries and placeholder justifications;
        ``strict=False`` (the --update-baseline path, which exists to
        REWRITE a rotten baseline) keeps whatever well-formed entries
        it can so their justifications survive the rewrite."""
        path = os.path.join(root, BASELINE_REL)
        if not os.path.exists(path):
            return cls(path=path)
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except ValueError as e:
            if not strict:
                return cls(path=path)
            raise BaselineError(f"{path}: not valid JSON: {e}")
        entries = data.get("entries")
        if not isinstance(entries, list):
            if not strict:
                return cls(path=path)
            raise BaselineError(f"{path}: top-level 'entries' list missing")
        kept = []
        for i, e in enumerate(entries):
            ok = isinstance(e, dict) and all(
                isinstance(e.get(key), str) and e[key].strip()
                for key in ("rule", "file", "line_text", "justification"))
            if not ok:
                if strict:
                    raise BaselineError(
                        f"{path}: entry {i} missing a non-empty "
                        f"rule/file/line_text/justification")
                continue
            if e["justification"].startswith("FIXME"):
                if strict:
                    raise BaselineError(
                        f"{path}: entry {i} ({e['rule']} {e['file']}) "
                        f"still carries the placeholder justification — "
                        f"write a real one or fix the violation")
                continue   # a placeholder is not worth preserving
            kept.append(e)
        return cls(kept, path=path)

    def suppresses(self, violation):
        hit = False
        for i, e in enumerate(self.entries):
            if (e["rule"] == violation.rule and e["file"] == violation.path
                    and e["line_text"] == violation.line_text
                    and violation.line_text):
                self._used[i] = True
                hit = True
        return hit

    def unused(self):
        return [e for i, e in enumerate(self.entries) if not self._used[i]]

    @staticmethod
    def render(violations, old=None, carry=()):
        """Baseline JSON text for ``violations`` (the still-unsuppressed
        ones), inheriting justifications from ``old`` when the same
        (rule, file, line_text) key survives. ``carry`` entries are
        preserved verbatim — a partial (``--rule``) regeneration passes
        the non-selected rules' entries through so their justifications
        are never dropped by a run that didn't re-derive them."""
        inherit = {}
        for e in (old.entries if old else []):
            inherit[(e["rule"], e["file"], e["line_text"])] = \
                e["justification"]
        entries = []
        seen = set()
        for e in carry:
            key = (e["rule"], e["file"], e["line_text"])
            if key not in seen:
                seen.add(key)
                entries.append(dict(e))
        for v in sorted(violations, key=lambda v: (v.path, v.line, v.rule)):
            key = (v.rule, v.path, v.line_text)
            if key in seen:
                continue
            seen.add(key)
            entries.append({
                "rule": v.rule, "file": v.path, "line_text": v.line_text,
                "justification": inherit.get(key, PLACEHOLDER)})
        entries.sort(key=lambda e: (e["file"], e["rule"], e["line_text"]))
        return json.dumps({"version": 1, "entries": entries}, indent=1) + "\n"
