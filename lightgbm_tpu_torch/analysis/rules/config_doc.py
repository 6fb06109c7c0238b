"""config-doc-drift: every knob in the port's config.py must have a
documentation row and at least one read site.

Provenance (lightgbm_tpu/analysis/rules/config_doc.py): a knob is added
in three places — the ``Config`` dataclass, a table row, and the code
that reads it. The port shares most knobs with the JAX package, whose
docs/Parameters.md documents them (read here, never written); the
port's own knobs (the CUDA engines', the process gang's, ...) get rows
in the table of README.md's port section. Drift modes:

- a knob with no row in either table (users can't discover it);
- a knob no code ever reads (``cfg.<name>`` attribute access or
  ``getattr(cfg, "<name>")`` anywhere outside the Config class body) —
  either dead, or its wiring was lost in a refactor;
- (warning) a README port row naming a knob that doesn't exist in the
  port's config.py. (Parameters.md rows the port lacks are the JAX
  package's own.)

Derived (non-knob) Config fields carry an inline
``# graftlint: disable=config-doc-drift`` pragma in config.py.
"""

import ast
import os
import re

from ..core import Fixture, Rule, Severity, call_name, register

CONFIG_REL = "lightgbm_tpu_torch/config.py"
PARAMS_REL = "docs/Parameters.md"
README_REL = "README.md"
# the port's section of the README: from its heading to the next "## "
PORT_SECTION = "## The PyTorch/CUDA port"
_ROW_RE = re.compile(r"^\|\s*`([a-z0-9_]+)`(?P<rest>[^|]*)\|", re.M)


def config_fields(pf):
    """[(name, lineno)] of Config dataclass AnnAssign fields."""
    for node in pf.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            return [(s.target.id, s.lineno) for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)], node
    return [], None


def port_section(text):
    """The README's port section ('' when it has none)."""
    start = text.find(PORT_SECTION)
    if start < 0:
        return ""
    end = text.find("\n## ", start + len(PORT_SECTION))
    return text[start:end if end >= 0 else len(text)]


def doc_rows(text):
    """{name: is_cli_only} from Parameters.md table rows. Rows whose
    first cell carries a ``*(serving)*`` marker are serve-CLI flags."""
    rows = {}
    for m in _ROW_RE.finditer(text):
        rows[m.group(1)] = "(serving)" in m.group("rest")
    return rows


@register
class ConfigDocDriftRule(Rule):
    name = "config-doc-drift"
    doc = ("config.py knob without a docs/Parameters.md or README port "
           "row, or without any read site")
    severity = Severity.ERROR

    def check(self, project):
        cfg = project.get(CONFIG_REL)
        if cfg is None:
            return []
        fields, cls_node = config_fields(cfg)
        if not fields:
            return []
        shared, own = {}, {}
        documented = False
        for rel, pick in ((PARAMS_REL, lambda t: t),
                          (README_REL, port_section)):
            path = os.path.join(project.root, rel)
            if os.path.exists(path):
                documented = True
                with open(path, "r", encoding="utf-8") as f:
                    rows = doc_rows(pick(f.read()))
                (shared if rel == PARAMS_REL else own).update(rows)
        rows = {**shared, **own}

        reads = self._read_sites(project, cfg, cls_node,
                                 {name for name, _ in fields})
        out = []

        class _Loc:
            def __init__(self, lineno):
                self.lineno = lineno
                self._g_func = None

        for name, lineno in fields:
            if documented and name not in rows:
                out.append(self.violation(
                    cfg, _Loc(lineno),
                    f"knob {name!r} has no row in docs/Parameters.md or "
                    f"in README.md's port section — every key=value "
                    f"parameter must be documented"))
            if name not in reads:
                out.append(self.violation(
                    cfg, _Loc(lineno),
                    f"knob {name!r} is never read (no `.{name}` "
                    f"attribute access or getattr(_, '{name}') outside "
                    f"the Config class) — dead knob or lost wiring"))
        field_names = {name for name, _ in fields}
        for row, cli_only in sorted(own.items()):
            if row not in field_names and not cli_only:
                out.append(self.violation(
                    cfg, _Loc(1),
                    f"README.md's port section documents {row!r} but "
                    f"the port's config.py has no such knob (stale row? "
                    f"mark serve-CLI-only flags with *(serving)*)",
                    severity=Severity.WARNING))
        return out

    def _read_sites(self, project, cfg_pf, cls_node, names):
        """Knob names with >=1 read: attribute access ``x.<name>`` or
        ``getattr(x, "<name>")`` anywhere in the project except the
        Config class body (validate()/check_param_conflict() reading
        their own fields is bookkeeping, not wiring)."""
        cls_range = (cls_node.lineno, cls_node.end_lineno) \
            if cls_node is not None else (0, -1)
        reads = set()
        for pf in project.files:
            if pf.rel.startswith("lightgbm_tpu_torch/analysis/"):
                continue   # tests/fixtures don't count as wiring
            for node in ast.walk(pf.tree):
                in_cfg_cls = (pf is cfg_pf
                              and cls_range[0] <= getattr(node, "lineno", 0)
                              <= cls_range[1])
                if in_cfg_cls:
                    continue
                if isinstance(node, ast.Attribute) and node.attr in names \
                        and isinstance(node.ctx, ast.Load):
                    reads.add(node.attr)
                elif isinstance(node, ast.Call):
                    if call_name(node) == "getattr" and \
                            len(node.args) >= 2 and \
                            isinstance(node.args[1], ast.Constant) and \
                            node.args[1].value in names:
                        reads.add(node.args[1].value)
        return reads

    def fixtures(self):
        doc = ("# Parameters\n\n"
               "| Parameter | Default | Aliases |\n"
               "|---|---|---|\n"
               "| `num_leaves` | 127 |  |\n"
               "| `serving_precision` *(serving)* | f32 |  |\n")
        bad = {
            "lightgbm_tpu_torch/config.py": (
                "from dataclasses import dataclass\n"
                "@dataclass\n"
                "class Config:\n"
                "    num_leaves: int = 127\n"
                "    mystery_knob: int = 0\n"
            ),
            "docs/Parameters.md": doc,
            "lightgbm_tpu_torch/engine.py": (
                "def train(cfg):\n"
                "    return cfg.num_leaves\n"
            ),
        }
        good = {
            "lightgbm_tpu_torch/config.py": (
                "from dataclasses import dataclass\n"
                "@dataclass\n"
                "class Config:\n"
                "    num_leaves: int = 127\n"
            ),
            "docs/Parameters.md": doc,
            "lightgbm_tpu_torch/engine.py": (
                "def train(cfg):\n"
                "    return cfg.num_leaves\n"
            ),
        }
        readme = ("# Project\n\n"
                  "## The PyTorch/CUDA port\n\n"
                  "| Parameter | Default | Meaning |\n"
                  "|---|---|---|\n"
                  "| `port_knob` | 1 | the port's own |\n\n"
                  "## Elsewhere\n\n"
                  "| `not_a_port_row` | 0 |  |\n")
        good_port_row = {
            "lightgbm_tpu_torch/config.py": (
                "from dataclasses import dataclass\n"
                "@dataclass\n"
                "class Config:\n"
                "    num_leaves: int = 127\n"
                "    port_knob: int = 1\n"
            ),
            "docs/Parameters.md": doc + "| `jax_only_knob` | 1 |  |\n",
            "README.md": readme,
            "lightgbm_tpu_torch/engine.py": (
                "def train(cfg):\n"
                "    return cfg.num_leaves + cfg.port_knob\n"
            ),
        }
        bad_stale_row = {
            "lightgbm_tpu_torch/config.py": (
                "from dataclasses import dataclass\n"
                "@dataclass\n"
                "class Config:\n"
                "    num_leaves: int = 127\n"
            ),
            "docs/Parameters.md": doc,
            "README.md": readme,
            "lightgbm_tpu_torch/engine.py": (
                "def train(cfg):\n"
                "    return cfg.num_leaves\n"
            ),
        }
        good_pragma = {
            "lightgbm_tpu_torch/config.py": (
                "from dataclasses import dataclass\n"
                "@dataclass\n"
                "class Config:\n"
                "    num_leaves: int = 127\n"
                "    # derived, not a user knob\n"
                "    is_parallel: bool = False  "
                "# graftlint: disable=config-doc-drift\n"
            ),
            "docs/Parameters.md": doc,
            "lightgbm_tpu_torch/engine.py": (
                "def train(cfg):\n"
                "    return cfg.num_leaves and cfg.is_parallel\n"
            ),
        }
        return [
            # mystery_knob: no doc row AND no read site -> 2
            Fixture("undocumented-unread-knob", bad, expect=2),
            Fixture("documented-read-knob", good, expect=0),
            Fixture("stale-port-row", bad_stale_row, expect=1),
            # a README port row documents the port's own knob; a
            # Parameters.md row the port lacks is the JAX package's
            Fixture("port-row-and-shared-doc", good_port_row, expect=0),
            # the derived field's missing doc row is pragma-suppressed
            Fixture("derived-field-pragma", good_pragma, expect=0),
        ]
