"""journal-schema: every journal ``.event("<type>", ...)`` call must
name a record type declared in telemetry/journal.py ``SCHEMA``.

Provenance: the journal is the machine-readable training timeline;
the port's ``telemetry/journal.py validate_record`` checks *produced*
records against SCHEMA at runtime (an unknown record type is an error).
A writer emitting an undeclared event therefore produces journals that
fail validation — but only on the code path that actually ran. This rule is the
static face of the same contract: it reads the SCHEMA dict *from the
linted tree's own source* (AST extraction, no imports, so the linter
never imports the package and the two can't diverge) and checks every event-name
string literal at the write sites. (lightgbm_tpu/analysis/rules/
journal_schema.py, aimed at lightgbm_tpu_torch/telemetry/journal.py.)

Write-site heuristic: attribute calls ``<recv>.event("lit", ...)``
where the receiver text looks journal-ish (contains ``journal``, or is
the conventional one-letter handle ``j``). ``RunJournal.iteration()``
is schema-valid by construction. Dynamically computed event names are
skipped — the runtime lint still covers those.
"""

import ast
import re

from ..core import Fixture, Rule, Severity, node_source, register

JOURNAL_REL = "lightgbm_tpu_torch/telemetry/journal.py"
_RECV_RE = re.compile(r"(journal|(^|\.)j$)", re.I)


def extract_schema_keys(pf):
    """Top-level ``SCHEMA = {...}`` string keys of journal.py, by AST.
    None when the module or the dict is missing (rule then skips —
    there is no contract to check against)."""
    for node in pf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "SCHEMA" \
                and isinstance(node.value, ast.Dict):
            keys = set()
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
            return keys
    return None


@register
class JournalSchemaRule(Rule):
    name = "journal-schema"
    doc = ("journal .event() record type not declared in "
           "telemetry/journal.py SCHEMA")
    severity = Severity.ERROR

    def check(self, project):
        jf = project.get(JOURNAL_REL)
        if jf is None:
            return []
        keys = extract_schema_keys(jf)
        if not keys:
            return []
        out = []
        for pf in project.files:
            for call in pf.calls():
                if not isinstance(call.func, ast.Attribute) \
                        or call.func.attr != "event" or not call.args:
                    continue
                first = call.args[0]
                if not (isinstance(first, ast.Constant)
                        and isinstance(first.value, str)):
                    continue
                recv = node_source(pf, call.func.value)
                if not _RECV_RE.search(recv):
                    continue
                if first.value not in keys:
                    out.append(self.violation(
                        pf, call,
                        f"journal event {first.value!r} is not declared "
                        f"in telemetry/journal.py SCHEMA — "
                        f"validate_record will reject every journal "
                        f"this path writes; add the record type to "
                        f"SCHEMA first"))
        return out

    def fixtures(self):
        schema_src = (
            "SCHEMA = {\n"
            "    'run_start': {'required': {}, 'optional': {}},\n"
            "    'iteration': {'required': {}, 'optional': {}},\n"
            "}\n"
        )
        bad = {
            "lightgbm_tpu_torch/telemetry/journal.py": schema_src,
            "lightgbm_tpu_torch/models/writer.py": (
                "def note(journal, n):\n"
                "    journal.event('leaf_stats', leaves=n)\n"
            ),
        }
        good = {
            "lightgbm_tpu_torch/telemetry/journal.py": schema_src,
            "lightgbm_tpu_torch/models/writer.py": (
                "def note(journal, n):\n"
                "    journal.event('iteration', iteration=n)\n"
            ),
        }
        good_nonjournal = {
            "lightgbm_tpu_torch/telemetry/journal.py": schema_src,
            "lightgbm_tpu_torch/models/writer.py": (
                "def fire(bus):\n"
                "    bus.event('leaf_stats')\n"
            ),
        }
        return [
            Fixture("undeclared-event", bad, expect=1),
            Fixture("declared-event", good, expect=0),
            Fixture("non-journal-receiver", good_nonjournal, expect=0),
        ]
