"""The port's lint core: parsed-file model, rule registry, pragmas
(a copy of lightgbm_tpu/analysis/core.py with its own scope and its own
REGISTRY).

Stdlib-``ast`` only. Every source file is parsed once into a
``ParsedFile`` that annotates each node with (a) its parent chain,
(b) the enclosing function, and (c) the set of context-manager *guard
names* lexically wrapping it (``with collective_guard(...):`` marks
every node in its body with ``"collective_guard"``) — the three facts
most rules are made of. Rules are small classes in
``lightgbm_tpu_torch/analysis/rules/`` registered via ``@register``;
each ships its own known-bad/known-good fixture corpus (``Fixture``)
that ``--self-check`` and tests/test_torch_lint.py replay against the
engine.
"""

import ast
import os
import re
from dataclasses import dataclass, field


class Severity:
    ERROR = "error"
    WARNING = "warning"


@dataclass
class Violation:
    rule: str
    path: str           # repo-relative, forward slashes
    line: int
    message: str
    severity: str = Severity.ERROR
    symbol: str = ""    # enclosing function qualname, when known
    line_text: str = ""  # stripped source of the flagged line
    suppressed_by: str = ""  # "", "pragma", or "baseline"

    def format(self):
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def as_dict(self):
        return {"rule": self.rule, "file": self.path, "line": self.line,
                "severity": self.severity, "message": self.message,
                "symbol": self.symbol, "line_text": self.line_text,
                "suppressed_by": self.suppressed_by}


@dataclass
class Fixture:
    """One self-check case: a mini project tree and the number of
    violations the owning rule must raise on it (0 for known-good)."""
    name: str
    files: dict          # relpath -> source text
    expect: int          # exact violation count for the owning rule


# ------------------------------------------------------------- pragmas

_PRAGMA_RE = re.compile(r"#\s*graftlint:\s*disable=([a-z0-9_,\- ]+)")


def parse_pragmas(source):
    """{lineno: set(rule names)} for every ``# graftlint: disable=...``
    comment. A pragma suppresses matching violations on its OWN line
    and on the LINE BELOW it (so it can sit above a long statement)."""
    pragmas = {}
    for lineno, text in enumerate(source.splitlines(), 1):
        m = _PRAGMA_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            pragmas[lineno] = rules
    return pragmas


# -------------------------------------------------------- parsed files

def dotted_name(node):
    """Best-effort dotted name of an expression: ``torch.cuda.synchronize``,
    ``heartbeat.collective_guard``, ``name``; '' when not a name
    chain. Call nodes resolve through their func (``super().train()``
    -> ``super.train``)."""
    parts = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            break
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            break
    return ".".join(reversed(parts))


def call_name(call):
    """Dotted name of a Call node's callee ('' when not a name)."""
    return dotted_name(call.func)


def node_source(pf, node):
    """Source text of a node, sliced straight off the parsed file's
    line table (ast.get_source_segment re-splits the whole file per
    call — 17s over this tree)."""
    try:
        l0, c0 = node.lineno - 1, node.col_offset
        l1, c1 = node.end_lineno - 1, node.end_col_offset
    except AttributeError:
        return ""
    lines = pf.lines
    if not (0 <= l0 <= l1 < len(lines)):
        return ""
    if l0 == l1:
        return lines[l0][c0:c1]
    parts = [lines[l0][c0:]]
    parts.extend(lines[l0 + 1:l1])
    parts.append(lines[l1][:c1])
    return "\n".join(parts)


# Guard context-manager names rules care about. A ``with`` whose item is
# a call (or attribute) whose dotted name ENDS with one of these marks
# its body as guarded by that name.
GUARD_NAMES = ("collective_guard", "armed")


class ParsedFile:
    """One parsed source file with node annotations.

    Node attributes set by the annotation pass:
      ``_g_parent``  parent AST node
      ``_g_func``    nearest enclosing FunctionDef/AsyncFunctionDef
      ``_g_guards``  frozenset of guard names lexically wrapping the node
    """

    def __init__(self, root, rel):
        self.rel = rel.replace(os.sep, "/")
        self.path = os.path.join(root, rel)
        with open(self.path, "r", encoding="utf-8", errors="replace") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.rel)
        self.pragmas = parse_pragmas(self.source)
        self._annotate()

    def _annotate(self):
        def withs_guards(node):
            names = set()
            for item in node.items:
                nm = dotted_name(item.context_expr)
                for g in GUARD_NAMES:
                    if nm == g or nm.endswith("." + g):
                        names.add(g)
            return names

        def walk(node, func, guards):
            for child in ast.iter_child_nodes(node):
                child._g_parent = node
                child._g_func = func
                child._g_guards = guards
                nf = child if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
                ng = guards
                if isinstance(child, ast.With):
                    extra = withs_guards(child)
                    if extra:
                        ng = guards | extra
                walk(child, nf, ng)

        self.tree._g_parent = None
        self.tree._g_func = None
        self.tree._g_guards = frozenset()
        walk(self.tree, None, frozenset())

    # ------------------------------------------------------- accessors

    def calls(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                yield node

    def functions(self):
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    def qualname(self, node):
        """Dotted Class.func qualname of a function node."""
        parts = []
        cur = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = getattr(cur, "_g_parent", None)
        return ".".join(reversed(parts))

    def line_text(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, lineno, rule):
        """Inline-pragma check: same line or the line above."""
        for ln in (lineno, lineno - 1):
            rules = self.pragmas.get(ln)
            if rules and (rule in rules or "all" in rules):
                return True
        return False


# ------------------------------------------------------------- project

PACKAGE = "lightgbm_tpu_torch"
DEFAULT_SCOPE = (PACKAGE,)
DEFAULT_FILES = ("chip_smoke.py",)


class Project:
    """The file set one lint run covers: every ``*.py`` under
    lightgbm_tpu_torch/ plus chip_smoke.py, rooted at the repo checkout
    (or a fixture temp dir)."""

    def __init__(self, root, scope_dirs=DEFAULT_SCOPE,
                 scope_files=DEFAULT_FILES):
        self.root = os.path.abspath(os.fspath(root))
        self.files = []
        self.errors = []    # (rel, message) for unparseable files
        rels = []
        for d in scope_dirs:
            base = os.path.join(self.root, d)
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(
                    n for n in dirnames
                    if n != "__pycache__" and not n.startswith("."))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        rels.append(os.path.relpath(
                            os.path.join(dirpath, fn), self.root))
        for fn in scope_files:
            if os.path.exists(os.path.join(self.root, fn)):
                rels.append(fn)
        for rel in rels:
            try:
                self.files.append(ParsedFile(self.root, rel))
            except (SyntaxError, ValueError) as e:
                self.errors.append((rel.replace(os.sep, "/"), str(e)))
        self._by_rel = {pf.rel: pf for pf in self.files}

    def get(self, rel):
        return self._by_rel.get(rel)

    def in_package(self):
        return [pf for pf in self.files
                if pf.rel.startswith(PACKAGE + "/")]


# ------------------------------------------------------- rule registry

# the port's rules only: the JAX package's engine keeps a registry of
# its own, and neither sees the other's rules in a shared process
REGISTRY = {}


class Rule:
    """Base rule. Subclasses set ``name``/``doc``/``severity`` and
    implement ``check(project) -> [Violation]`` (whole-project; rules
    that are per-file just loop). ``fixtures()`` returns the self-check
    corpus."""

    name = ""
    doc = ""
    severity = Severity.ERROR

    def check(self, project):
        raise NotImplementedError

    def fixtures(self):
        return []

    # helper for subclasses
    def violation(self, pf, node, message, severity=None):
        lineno = getattr(node, "lineno", 1)
        func = getattr(node, "_g_func", None)
        return Violation(
            rule=self.name, path=pf.rel, line=lineno, message=message,
            severity=severity or self.severity,
            symbol=pf.qualname(func) if func is not None else "",
            line_text=pf.line_text(lineno))


def register(cls):
    inst = cls()
    if not inst.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if inst.name in REGISTRY:
        raise ValueError(f"duplicate rule name {inst.name}")
    REGISTRY[inst.name] = inst
    return cls
