"""non-atomic-shared-write: shared run artifacts must be written with
the tmp+fsync+rename (or append-only / manifest-last) discipline.

Provenance (lightgbm_tpu/analysis/rules/atomic_writes.py, on the port's
own modules): crash-safety across the checkpoint store
(utils/checkpoint.py ``atomic_open``: sibling tmp -> flush -> fsync ->
``os.replace`` -> dir fsync), the block store (blocks and a manifest
written last), the supervisor's restart barrier, the heartbeat/marker
files (tmp+``os.replace``; fsync deliberately
skipped — losing a beat is harmless, a torn concurrent read is not)
and the journal (single ``os.write`` of a full line to an O_APPEND
fd). A plain ``open(path, "w")`` of any of these artifacts reverts a
kill-at-any-instant guarantee to "sometimes a torn file that a peer
then reads".

Scope: the port's modules that own shared on-disk artifacts (snapshot
/ journal / history / block-store / heartbeat / supervisor / profile /
binary-cache / model-file writers, and the kernel and C API libraries
that several processes build into one directory). Detection is per enclosing function: a write-mode ``open``
(or ``np.save*`` / ``json.dump`` / ``Path.write_text``) is accepted
when
  (a) it goes through ``atomic_open`` / ``atomic_write_*``; or
  (b) the target expression (or the local Name it was assigned from)
      mentions a tmp path AND the same function pairs it with
      ``os.replace`` / ``os.rename``; or
  (c) it's an append (``"a"`` modes; O_APPEND fds are handled by
      ``os.open``, which the rule doesn't flag); or
  (d) it writes into an in-memory buffer, not a path.
Everything else is flagged.
"""

import ast
import re

from ..core import (Fixture, Rule, Severity, call_name, node_source,
                    register)

SCOPE_RES = tuple(re.compile(p) for p in (
    r"^lightgbm_tpu_torch/utils/checkpoint\.py$",
    r"^lightgbm_tpu_torch/parallel/heartbeat\.py$",
    r"^lightgbm_tpu_torch/supervisor\.py$",
    r"^lightgbm_tpu_torch/data/block_store\.py$",
    r"^lightgbm_tpu_torch/telemetry/(journal|export|history)\.py$",
    r"^lightgbm_tpu_torch/fleet/",
    r"^lightgbm_tpu_torch/io/(dataset|profile)\.py$",
    r"^lightgbm_tpu_torch/models/gbdt\.py$",
    r"^lightgbm_tpu_torch/ops/hist_kernels\.py$",
    r"^lightgbm_tpu_torch/native/__init__\.py$",
))

WRITE_MODES = ("w", "wb", "w+", "wb+", "wt", "xb", "x")
ATOMIC_HELPERS = frozenset({"atomic_open", "atomic_write_bytes",
                            "atomic_write_text", "atomic_write_json",
                            "atomic_save_npy", "_atomic_write_bytes",
                            "_atomic_save_npy"})
RENAMES = frozenset({"os.replace", "os.rename"})


def _in_scope(rel):
    return any(p.match(rel) for p in SCOPE_RES)


@register
class NonAtomicSharedWriteRule(Rule):
    name = "non-atomic-shared-write"
    doc = ("shared artifact written without tmp+fsync+rename / "
           "append-only discipline")
    severity = Severity.ERROR

    def check(self, project):
        out = []
        for pf in project.files:
            if not _in_scope(pf.rel):
                continue
            for func in pf.functions():
                out.extend(self._check_function(pf, func))
        return out

    def _check_function(self, pf, func):
        has_rename = False
        tmp_names = set()     # local Names assigned from tmp-ish exprs
        handles = set()       # `with <call>(...) as f:` handle Names —
        #                       the opening call is where atomicity is
        #                       checked; writes INTO the handle aren't
        writes = []           # (call, target_expr, kind)
        for node in ast.walk(func):
            if isinstance(node, ast.With):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call) and \
                            isinstance(item.optional_vars, ast.Name):
                        handles.add(item.optional_vars.id)
            # nested defs are visited as their own functions
            if getattr(node, "_g_func", None) is not func and node is not func:
                continue
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                src = node_source(pf, node.value)
                if "tmp" in src.lower() or "mkstemp" in src \
                        or "TemporaryDirectory" in src:
                    tmp_names.add(node.targets[0].id)
                if "BytesIO" in src or "StringIO" in src:
                    handles.add(node.targets[0].id)   # in-memory buffer
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if not name:
                continue
            if name in RENAMES:
                has_rename = True
            last = name.rsplit(".", 1)[-1]
            if last in ATOMIC_HELPERS:
                continue
            target = self._write_target(node, name, last)
            if target is not None and not (
                    isinstance(target, ast.Name) and target.id in handles):
                writes.append((node, target, name))

        out = []
        for call, target, name in writes:
            src = node_source(pf, target)
            tmpish = ("tmp" in src.lower()
                      or (isinstance(target, ast.Name)
                          and target.id in tmp_names))
            if tmpish and has_rename:
                continue
            out.append(self.violation(
                pf, call,
                f"{name}(...) writes a shared artifact non-atomically "
                f"— use utils/checkpoint.py atomic_open/atomic_write_* "
                f"or the tmp+os.replace idiom (a kill mid-write leaves "
                f"a torn file peers will read)"))
        return out

    def _write_target(self, call, name, last):
        """The path expression being written, or None when this call is
        not a path write (read mode, append, in-memory buffer)."""
        if last == "open" and name in ("open", "io.open"):
            if not call.args:
                return None
            mode = "r"
            if len(call.args) >= 2 and isinstance(call.args[1],
                                                  ast.Constant):
                mode = str(call.args[1].value)
            for kw in call.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = str(kw.value.value)
            if mode not in WRITE_MODES:
                return None
            return call.args[0]
        if last in ("save", "savez", "savez_compressed") and \
                name.startswith(("np.", "numpy.")):
            if not call.args:
                return None
            target = call.args[0]
            if isinstance(target, ast.Call) and \
                    "BytesIO" in call_name(target):
                return None   # in-memory archive
            return target
        if last in ("write_text", "write_bytes"):
            return call.func.value if isinstance(call.func,
                                                 ast.Attribute) else None
        if name == "json.dump":
            # file target is the 2nd positional; writing into a handle
            # opened atomically is caught at the open() site instead,
            # so only flag dumps straight into open(...) write modes
            if len(call.args) >= 2 and isinstance(call.args[1], ast.Call):
                inner = call.args[1]
                return self._write_target(inner, call_name(inner),
                                          call_name(inner).rsplit(".", 1)[-1])
            return None
        return None

    def fixtures(self):
        bad = {
            "lightgbm_tpu_torch/fleet/registry.py": (
                "import json, os\n"
                "def write_pointer(directory, version):\n"
                "    path = os.path.join(directory, 'CURRENT')\n"
                "    with open(path, 'w') as f:\n"
                "        f.write(str(version))\n"
            ),
        }
        good_tmp = {
            "lightgbm_tpu_torch/fleet/registry.py": (
                "import json, os\n"
                "def write_pointer(directory, version):\n"
                "    path = os.path.join(directory, 'CURRENT')\n"
                "    tmp = f'{path}.tmp.{os.getpid()}'\n"
                "    with open(tmp, 'w') as f:\n"
                "        f.write(str(version))\n"
                "        f.flush()\n"
                "        os.fsync(f.fileno())\n"
                "    os.replace(tmp, path)\n"
            ),
        }
        good_helper = {
            "lightgbm_tpu_torch/fleet/registry.py": (
                "from ..utils.checkpoint import atomic_write_text\n"
                "def write_pointer(directory, version):\n"
                "    atomic_write_text(directory + '/CURRENT', "
                "str(version))\n"
            ),
        }
        good_out_of_scope = {
            "lightgbm_tpu_torch/io/parser.py": (
                "def dump_debug(path, text):\n"
                "    with open(path, 'w') as f:\n"
                "        f.write(text)\n"
            ),
        }
        good_read = {
            "lightgbm_tpu_torch/fleet/registry.py": (
                "import json\n"
                "def read_pointer(path):\n"
                "    with open(path) as f:\n"
                "        return json.load(f)\n"
            ),
        }
        return [
            Fixture("plain-write", bad, expect=1),
            Fixture("tmp-replace-idiom", good_tmp, expect=0),
            Fixture("atomic-helper", good_helper, expect=0),
            Fixture("out-of-scope-module", good_out_of_scope, expect=0),
            Fixture("read-mode", good_read, expect=0),
        ]
