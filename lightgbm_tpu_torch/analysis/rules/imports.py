"""no-jax-import: the port and chip_smoke.py import neither ``jax`` nor
``lightgbm_tpu``.

Provenance: the port stands beside the JAX package and is tested
against it, but at run time it imports neither: the H100 machine has no
JAX, and a module of the JAX package that imports no JAX still ties the
port to a tree it must never need (the port keeps its own copy of what
it uses). Only the tests import both. Flagged, in every file of the
lint's scope (``lightgbm_tpu_torch/`` and ``chip_smoke.py``):

- an ``import`` or ``from ... import`` of ``jax``, ``jax.numpy`` or any
  module under them (and ``jaxlib``);
- the same of ``lightgbm_tpu`` or a module under it (relative imports
  inside the port are its own);
- ``importlib.import_module("<one of those>")`` and
  ``__import__("<one of those>")`` with a constant name.
"""

import ast

from ..core import Fixture, Rule, Severity, call_name, register

FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def forbidden(module):
    """True when a dotted module name is one of FORBIDDEN or under it."""
    return bool(module) and any(module == f or module.startswith(f + ".")
                                for f in FORBIDDEN)


@register
class NoJaxImportRule(Rule):
    name = "no-jax-import"
    doc = ("the port or chip_smoke.py imports jax or lightgbm_tpu — the "
           "port runs where neither exists")
    severity = Severity.ERROR

    def check(self, project):
        out = []
        for pf in project.files:
            for node in ast.walk(pf.tree):
                module = self._imported(node)
                if module is not None:
                    out.append(self.violation(
                        pf, node,
                        f"imports {module!r}: the port and chip_smoke.py "
                        f"import neither jax nor lightgbm_tpu (keep a copy "
                        f"of what is needed in lightgbm_tpu_torch)"))
        return out

    @staticmethod
    def _imported(node):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if forbidden(alias.name):
                    return alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and forbidden(node.module):
                return node.module
        elif isinstance(node, ast.Call):
            name = call_name(node)
            if (name in ("importlib.import_module", "import_module",
                         "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and forbidden(node.args[0].value)):
                return node.args[0].value
        return None

    def fixtures(self):
        # the forbidden names come in through FORBIDDEN, so that no line
        # of this file reads as an import of them
        jax, pkg = FORBIDDEN[0], FORBIDDEN[2]
        bad = {
            "lightgbm_tpu_torch/ops/newkern.py": (
                "import importlib\n"
                f"import {jax}.numpy as jnp\n"
                f"from {pkg}.config import Config\n"
                "def load():\n"
                f"    import {pkg}\n"
                f"    return importlib.import_module('{jax}')\n"
            ),
            "chip_smoke.py": f"from {jax} import numpy\n",
        }
        good = {
            "lightgbm_tpu_torch/ops/newkern.py": (
                "import torch\n"
                "import lightgbm_tpu_torch\n"
                "from lightgbm_tpu_torch.config import Config\n"
                "from ..config import str2map\n"
                "from . import jax_free\n"
                "def load(importlib):\n"
                "    return importlib.import_module('lightgbm_tpu_torch')\n"
            ),
            "chip_smoke.py": "import numpy as np\n",
        }
        return [
            Fixture("jax-and-package-imports", bad, expect=5),
            Fixture("port-imports", good, expect=0),
        ]
