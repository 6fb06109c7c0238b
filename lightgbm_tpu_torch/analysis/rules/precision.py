"""precision-contract: the f32-Kahan / host-f64 split must not blur.

Provenance (lightgbm_tpu/analysis/rules/precision.py, in torch's
idioms): the histogram engines' serial==parallel bit-parity rests on
chunked float32 Kahan-pair arithmetic on the device (csrc/chunk_hist.cuh
and the plain versions in ops/histogram.py), with float64 only on the
host (the prediction path's traversal and per-class sums, the linear
leaves' normal equations). Three ways code can blur that line:

- ``torch.float64`` (or ``torch.double``, ``.double()``) in device
  builder code: a float64 device tensor changes the arithmetic the
  kernels and their plain versions agree on bit for bit, and runs at a
  sixtieth of the H100's float32 rate;
- float32 accumulation inside a host reduction whose docstring documents
  float64 (``np.sum(..., dtype=np.float32)`` in a "reduces in f64"
  function);
- raw ``float(...)`` on a Kahan pair value: collapsing (value,
  residual) by truncation instead of through the fold helpers drops the
  compensation term.

Scope: ``lightgbm_tpu_torch/{ops,parallel}/`` and the device builders
``models/{tree_learner,partitioned}.py`` for the first check; the
second and third over ``{ops,models,parallel,data}/``. A float64 host
tensor in builder scope (a statistic read back for a log) carries a
pragma saying so.
"""

import ast
import re

from ..core import Fixture, Rule, Severity, call_name, node_source, register

SCOPE_RE = re.compile(r"^lightgbm_tpu_torch/(ops|models|parallel|data)/")
DEVICE_SCOPE_RE = re.compile(
    r"^lightgbm_tpu_torch/(ops|parallel)/"
    r"|^lightgbm_tpu_torch/models/(tree_learner|partitioned)\.py$")
_F64_DOC = re.compile(r"\bf64\b|float64", re.I)
_PAIRISH = re.compile(r"pair|kahan", re.I)
_HOST_REDUCERS = frozenset({"sum", "cumsum", "dot", "einsum", "add.reduce"})


@register
class PrecisionContractRule(Rule):
    name = "precision-contract"
    doc = ("float64 in device builder code, f32 accumulation in "
           "documented-f64 host reductions, or raw float() on Kahan "
           "pairs")
    severity = Severity.ERROR

    def check(self, project):
        out = []
        for pf in project.files:
            if not SCOPE_RE.match(pf.rel):
                continue
            out.extend(self._check_file(pf))
        return out

    def _check_file(self, pf):
        out = []
        device_scope = bool(DEVICE_SCOPE_RE.match(pf.rel))
        for node in ast.walk(pf.tree):
            # (1) torch float64 in device builder scope
            if device_scope and isinstance(node, ast.Attribute) \
                    and node.attr in ("float64", "double") \
                    and node_source(pf, node.value) == "torch":
                out.append(self.violation(
                    pf, node,
                    f"torch.{node.attr} in device builder scope — device "
                    f"arithmetic is float32 by contract (the kernels and "
                    f"their plain versions agree bit for bit in float32)"))
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if device_scope and name.endswith(".double") and \
                    isinstance(node.func, ast.Attribute) and \
                    not node.args and not node.keywords:
                out.append(self.violation(
                    pf, node,
                    ".double() in device builder scope — device "
                    "arithmetic is float32 by contract"))
            # (3) raw float() on a Kahan pair expression
            if name == "float" and len(node.args) == 1:
                src = node_source(pf, node.args[0])
                if _PAIRISH.search(src):
                    out.append(self.violation(
                        pf, node,
                        f"raw float() on a Kahan pair expression "
                        f"({src[:40]!r}) — collapse through the fold "
                        f"helpers or the compensation term is silently "
                        f"dropped"))
        # (2) f32 accumulation in documented-f64 host reductions
        for func in pf.functions():
            doc = ast.get_docstring(func) or ""
            if not _F64_DOC.search(doc):
                continue
            for node in ast.walk(func):
                if getattr(node, "_g_func", None) is not func:
                    continue
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                last = name.rsplit(".", 1)[-1]
                if last not in _HOST_REDUCERS or \
                        not name.startswith(("np.", "numpy.")):
                    continue
                for kw in node.keywords:
                    if kw.arg == "dtype" and \
                            "float32" in node_source(pf, kw.value):
                        out.append(self.violation(
                            pf, node,
                            f"{name}(dtype=float32) inside a function "
                            f"whose docstring documents f64 "
                            f"accumulation — the reduction no longer "
                            f"matches its contract"))
        return out

    def fixtures(self):
        bad = {
            "lightgbm_tpu_torch/ops/newkern.py": (
                "import numpy as np\n"
                "import torch\n"
                "def fold(x):\n"
                "    return x.to(torch.float64) + x.double()\n"
                "def collapse(hist_pair):\n"
                "    return float(hist_pair[0])\n"
                "def reduce_host(x):\n"
                "    \"\"\"Reduces leaf values in f64.\"\"\"\n"
                "    return np.sum(x, dtype=np.float32)\n"
            ),
        }
        good = {
            "lightgbm_tpu_torch/ops/newkern.py": (
                "import numpy as np\n"
                "import torch\n"
                "def fold(x):\n"
                "    return x.to(torch.float32)\n"
                "def collapse(hist_pair):\n"
                "    hi, lo = hist_pair\n"
                "    return hi + lo\n"
                "def reduce_host(x):\n"
                "    \"\"\"Reduces leaf values in f64.\"\"\"\n"
                "    return np.sum(x, dtype=np.float64)\n"
            ),
        }
        good_host_f64 = {
            # float64 on the host side of models/ (the prediction path's
            # traversal) is the contract, not a violation
            "lightgbm_tpu_torch/models/hostpath.py": (
                "import numpy as np\n"
                "import torch\n"
                "def gather(leaves):\n"
                "    t = torch.from_numpy(leaves).to(torch.float64)\n"
                "    return np.asarray(leaves, dtype=np.float64), t\n"
            ),
        }
        leaf_solver_bad = {
            "lightgbm_tpu_torch/models/linsolve.py": (
                "import numpy as np\n"
                "def accumulate_normal_eq(xw, g):\n"
                "    \"\"\"Accumulates the per-leaf normal equations in\n"
                "    host f64 over canonical fit chunks.\"\"\"\n"
                "    return np.einsum('ni,nj->ij', xw, xw,\n"
                "                     dtype=np.float32)\n"
            ),
        }
        return [
            Fixture("f64-device-f32-doc-float-pair", bad, expect=4),
            Fixture("contract-respected", good, expect=0),
            Fixture("host-f64-legit", good_host_f64, expect=0),
            Fixture("leaf-solver-f32-downgrade", leaf_solver_bad,
                    expect=1),
        ]
