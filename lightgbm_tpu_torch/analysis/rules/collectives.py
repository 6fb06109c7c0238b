"""unguarded-collective: blocking device syncs and collectives in the
training paths must be armed by ``collective_guard``.

Provenance (lightgbm_tpu/analysis/rules/collectives.py, in torch's
idioms): the collective watchdog (parallel/heartbeat.py
``collective_guard`` / ``CollectiveWatchdog.armed``) only sees syncs it
brackets. An unguarded blocking sync in a training path means a dead or
straggling peer wedges the process with the watchdog blind (no named
abort, no exit 117), and the comm profiler cannot attribute the wait.

Scope: ``lightgbm_tpu_torch/{parallel,models,data}/`` — the modules
that run the training paths (heartbeat.py, the guard machinery itself,
excepted). Flagged:

- zero-argument ``.item()``, ``.tolist()`` and ``.cpu()`` (a device
  tensor pulled to the host) and a work handle's ``.wait()``;
- ``torch.cuda.synchronize(...)``;
- the ``torch.distributed`` collectives and point-to-point calls
  (``all_reduce``, ``all_gather*``, ``all_to_all*``, ``broadcast*``,
  ``reduce_scatter*``, ``barrier``, ``send``/``recv``, ...), called
  through ``torch.distributed.`` or the conventional alias ``dist.``.

A call is fine lexically inside ``with collective_guard(...)`` /
``WATCHDOG.armed(...)``. ``np.asarray``/``.numpy()`` on a host tensor
is plumbing, not a sync, and is not flagged. A sync that is not a
collective's (a host copy of the serial learner's own result) carries
a pragma or a baseline entry saying so.
"""

import ast
import re

from ..core import Fixture, Rule, Severity, call_name, register

SCOPE_RE = re.compile(r"^lightgbm_tpu_torch/(parallel|models|data)/")
SYNC_GUARDS = frozenset({"collective_guard", "armed"})
# zero-argument methods that block on the device or on a peer
METHOD_SYNCS = frozenset({"item", "tolist", "cpu", "wait"})
DIST_CALLS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "barrier", "monitored_barrier", "gather",
    "scatter", "send", "recv", "isend", "irecv"})


def sync_name(call):
    """The dotted name of a blocking sync call, or None."""
    name = call_name(call)
    if not name:
        return None
    parts = name.split(".")
    last = parts[-1]
    if last in METHOD_SYNCS:
        if (call.args or call.keywords
                or not isinstance(call.func, ast.Attribute)):
            return None
        return name
    if name in ("torch.cuda.synchronize", "cuda.synchronize"):
        return name
    if last in DIST_CALLS and (name.startswith("torch.distributed.")
                               or (len(parts) == 2 and parts[0] == "dist")):
        return name
    return None


@register
class UnguardedCollectiveRule(Rule):
    name = "unguarded-collective"
    doc = ("blocking device sync or collective in a training path outside "
           "collective_guard — watchdog/straggler attribution is blind "
           "to it")
    severity = Severity.ERROR

    def check(self, project):
        out = []
        for pf in project.files:
            if not SCOPE_RE.match(pf.rel):
                continue
            if pf.rel.endswith("parallel/heartbeat.py"):
                continue  # the guard machinery itself
            for call in pf.calls():
                name = sync_name(call)
                if name is None:
                    continue
                if getattr(call, "_g_guards", frozenset()) & SYNC_GUARDS:
                    continue
                out.append(self.violation(
                    pf, call,
                    f"blocking device sync {name!r} outside "
                    f"collective_guard — wrap it so the watchdog can "
                    f"name a hang and the comm profiler can attribute "
                    f"the wait (parallel/heartbeat.py)"))
        return out

    def fixtures(self):
        bad = {
            "lightgbm_tpu_torch/parallel/sync.py": (
                "import torch\n"
                "import torch.distributed as dist\n"
                "def fetch(out, buf, work):\n"
                "    dist.all_reduce(buf)\n"
                "    torch.cuda.synchronize()\n"
                "    work.wait()\n"
                "    host = out['leaf_value'].cpu()\n"
                "    return out['n'].item(), host.tolist()\n"
            ),
        }
        good = {
            "lightgbm_tpu_torch/parallel/sync.py": (
                "import torch\n"
                "import torch.distributed as dist\n"
                "from .heartbeat import collective_guard\n"
                "def fetch(out, buf, work):\n"
                "    with collective_guard('leaf_value_fetch'):\n"
                "        dist.all_reduce(buf)\n"
                "        torch.cuda.synchronize()\n"
                "        work.wait()\n"
                "        host = out['leaf_value'].cpu()\n"
                "        return out['n'].item(), host.tolist()\n"
            ),
        }
        out_of_scope = {
            "lightgbm_tpu_torch/serving/sync.py": (
                "def fetch(out):\n"
                "    return out.cpu().numpy()\n"
            ),
        }
        not_sync = {
            "lightgbm_tpu_torch/models/clean.py": (
                "def walk(d, ev, t):\n"
                "    ev.wait(1.0)\n"
                "    return sorted(d.items()), t.to('cpu', non_blocking=True)\n"
            ),
        }
        return [
            Fixture("unguarded-syncs", bad, expect=6),
            Fixture("guarded-syncs", good, expect=0),
            Fixture("serving-out-of-scope", out_of_scope, expect=0),
            Fixture("not-a-sync", not_sync, expect=0),
        ]
