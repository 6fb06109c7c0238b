"""nondeterminism: wall clocks and unseeded RNG must stay out of the
modules under the bit-parity / byte-identical-resume contracts.

Provenance (lightgbm_tpu/analysis/rules/determinism.py, with torch's
generators): trees must be bit-identical across the serial, parallel
and out-of-core engines (ops/, models/, data/) and byte-identical
across a checkpoint resume — which also pins the sampling streams
(utils/random.py Random wraps a seeded np.random.RandomState; bagging
draws from a torch.Generator seeded from the config and the window). A
stray ``np.random.rand()`` or ``torch.rand(...)`` (process-global
streams), an unseeded ``default_rng()``, a ``torch.manual_seed`` or a
``time.time()`` feeding computation breaks those contracts in ways the
parity tests only catch for the paths they exercise.

Checks (scope ``lightgbm_tpu_torch/{ops,models,io,data,parallel}/`` +
``lightgbm_tpu_torch/utils/random.py``):

- unseeded constructors: ``np.random.RandomState()`` /
  ``np.random.default_rng()`` with no arguments;
- process-global numpy draws/seeding: ``np.random.rand`` / ``randn`` /
  ``randint`` / ``random`` / ``choice`` / ``shuffle`` /
  ``permutation`` / ``uniform`` / ``normal`` / ``seed``;
- torch's process-global stream: ``torch.manual_seed`` /
  ``torch.seed``, and ``torch.rand`` / ``randn`` / ``randint`` /
  ``randperm`` / ``bernoulli`` / ``multinomial`` / ``normal`` /
  ``rand_like`` / ``randn_like`` / ``randint_like`` without a
  ``generator=``;
- stdlib ``random`` module draws (the module, not a local named
  ``random``: only flagged when the file ``import random``s);
- ``time.time()`` in ``ops/`` / ``models/`` / ``io/`` only — wall
  clock as *data* in an engine path (``time.perf_counter`` for
  durations and telemetry wall stamps in parallel/data are
  legitimate and unflagged).
"""

import ast
import re

from ..core import Fixture, Rule, Severity, call_name, register

SCOPE_RE = re.compile(
    r"^lightgbm_tpu_torch/(ops|models|io|data|parallel)/|"
    r"^lightgbm_tpu_torch/utils/random\.py$")
TIME_SCOPE_RE = re.compile(r"^lightgbm_tpu_torch/(ops|models|io)/")

_GLOBAL_DRAWS = frozenset({"rand", "randn", "randint", "random", "choice",
                           "shuffle", "permutation", "uniform", "normal",
                           "seed"})
_TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm",
                          "bernoulli", "multinomial", "normal", "rand_like",
                          "randn_like", "randint_like"})
_STDLIB_DRAWS = frozenset({"random", "randint", "randrange", "choice",
                           "shuffle", "sample", "uniform", "seed",
                           "gauss"})


@register
class NondeterminismRule(Rule):
    name = "nondeterminism"
    doc = ("wall clock / unseeded or process-global RNG in a module "
           "under the bit-parity or byte-identical-resume contract")
    severity = Severity.ERROR

    def check(self, project):
        out = []
        for pf in project.files:
            if not SCOPE_RE.match(pf.rel):
                continue
            imports_random = self._imports_stdlib_random(pf)
            for call in pf.calls():
                name = call_name(call)
                if not name:
                    continue
                v = self._classify(pf, call, name, imports_random)
                if v:
                    out.append(self.violation(pf, call, v))
        return out

    def _imports_stdlib_random(self, pf):
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "random" and alias.asname is None:
                        return True
        return False

    def _classify(self, pf, call, name, imports_random):
        if name in ("np.random.RandomState", "np.random.default_rng",
                    "numpy.random.RandomState",
                    "numpy.random.default_rng"):
            if not call.args and not call.keywords:
                return (f"{name}() without a seed — every RNG stream in "
                        f"parity/resume-contract modules must derive "
                        f"from the config seed fan-out (config.py)")
            return None
        parts = name.split(".")
        if len(parts) == 3 and parts[0] in ("np", "numpy") \
                and parts[1] == "random" and parts[2] in _GLOBAL_DRAWS:
            return (f"{name}() uses the process-global numpy RNG stream "
                    f"— draws are order-dependent across the whole "
                    f"process, breaking bit-parity and resume; use a "
                    f"seeded utils/random.py Random")
        if name in ("torch.manual_seed", "torch.seed",
                    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"):
            return (f"{name}() seeds torch's process-global stream — "
                    f"seed a torch.Generator of your own from the config")
        if len(parts) == 2 and parts[0] == "torch" \
                and parts[1] in _TORCH_DRAWS \
                and not any(kw.arg == "generator" for kw in call.keywords):
            return (f"{name}() without generator= draws from torch's "
                    f"process-global stream — order-dependent across the "
                    f"process; pass a seeded torch.Generator")
        if imports_random and len(parts) == 2 and parts[0] == "random" \
                and parts[1] in _STDLIB_DRAWS:
            return (f"{name}() uses the process-global stdlib RNG — "
                    f"use a seeded utils/random.py Random")
        if name == "time.time" and TIME_SCOPE_RE.match(pf.rel):
            return ("time.time() in an engine module — wall clock as "
                    "data breaks reproducibility; use "
                    "time.perf_counter() for durations, or journal "
                    "timestamps at the telemetry layer")
        return None

    def fixtures(self):
        bad = {
            "lightgbm_tpu_torch/models/sampler.py": (
                "import random\n"
                "import time\n"
                "import numpy as np\n"
                "import torch\n"
                "def draw(n):\n"
                "    rng = np.random.default_rng()\n"
                "    np.random.seed(0)\n"
                "    torch.manual_seed(0)\n"
                "    perm = torch.randperm(n)\n"
                "    t = time.time()\n"
                "    return random.randint(0, n), t, perm\n"
            ),
        }
        good = {
            "lightgbm_tpu_torch/models/sampler.py": (
                "import time\n"
                "import numpy as np\n"
                "import torch\n"
                "from ..utils.random import Random\n"
                "def draw(n, seed):\n"
                "    rng = np.random.default_rng(seed)\n"
                "    r = Random(seed)\n"
                "    gen = torch.Generator()\n"
                "    gen.manual_seed(seed)\n"
                "    perm = torch.randperm(n, generator=gen)\n"
                "    t0 = time.perf_counter()\n"
                "    return r.next_int(0, n), time.perf_counter() - t0\n"
            ),
        }
        good_parallel_wallclock = {
            # heartbeat-style wall stamps in parallel/ are protocol
            # data, not engine data — time.time is only flagged in
            # ops/models/io
            "lightgbm_tpu_torch/parallel/beats.py": (
                "import time\n"
                "def beat():\n"
                "    return {'time': time.time()}\n"
            ),
        }
        return [
            Fixture("unseeded-and-global", bad, expect=6),
            Fixture("seeded-and-perf-counter", good, expect=0),
            Fixture("parallel-wallclock-ok", good_parallel_wallclock,
                    expect=0),
        ]
