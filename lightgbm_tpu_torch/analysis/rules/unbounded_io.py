"""unbounded-io: outbound network calls in the serving/fleet stack
must carry an explicit timeout.

Provenance (lightgbm_tpu/analysis/rules/unbounded_io.py, aimed at the
port's serving stack): every hang the resilience layer defends against
(docs/Resilience.md) re-enters through one unbounded socket — a
health probe against a wedged replica, an aggregator scrape of a dead
rank, a router proxy call into a stalled batcher. The stdlib defaults
are INFINITE (`urllib.request.urlopen`, `http.client.HTTPConnection`,
`socket.create_connection` all block forever without a timeout), so a
single forgotten kwarg turns "one replica is slow" into "the router's
handler pool is gone". The RegistryFollower and aggregator polled over
HTTP for two PRs with nothing guarding this; now the front door
multiplies the number of outbound calls, the invariant gets a lint.

Scope: ``lightgbm_tpu_torch/serving/``, ``lightgbm_tpu_torch/fleet/``
and ``lightgbm_tpu_torch/telemetry/aggregate.py`` — the processes that
talk to other processes. Flagged calls:

- ``urlopen(...)`` without a ``timeout=`` kwarg (or third positional);
- ``HTTPConnection(...)`` / ``HTTPSConnection(...)`` without a
  ``timeout=`` kwarg;
- ``socket.create_connection(...)`` without a timeout (second
  positional or kwarg).

A timeout passed positionally counts — the rule wants the bound to
exist, not a style. Genuinely inherited timeouts (a connection object
configured elsewhere) go in the baseline with a justification.
"""

import re

from ..core import Fixture, Rule, Severity, register

SCOPE_RE = re.compile(
    r"^lightgbm_tpu_torch/(serving|fleet)/"
    r"|^lightgbm_tpu_torch/telemetry/aggregate\.py$")

# last dotted segment -> how many positionals until the timeout slot
# (urlopen(url, data, timeout) / create_connection(addr, timeout) /
# HTTP(S)Connection(host, port, timeout))
TIMEOUT_POSITION = {
    "urlopen": 2,
    "create_connection": 1,
    "HTTPConnection": 2,
    "HTTPSConnection": 2,
}


@register
class UnboundedIoRule(Rule):
    name = "unbounded-io"
    doc = ("outbound network call in serving/fleet without an explicit "
           "timeout — the stdlib default blocks forever")
    severity = Severity.ERROR

    def check(self, project):
        out = []
        for pf in project.files:
            if not SCOPE_RE.match(pf.rel):
                continue
            for call in pf.calls():
                name = self._unbounded_name(call)
                if name is None:
                    continue
                out.append(self.violation(
                    pf, call,
                    f"{name!r} without an explicit timeout — the "
                    f"stdlib default blocks forever; one wedged peer "
                    f"would pin this thread (pass timeout=..., "
                    f"docs/Resilience.md)"))
        return out

    def _unbounded_name(self, call):
        from ..core import call_name
        name = call_name(call)
        if not name:
            return None
        last = name.rsplit(".", 1)[-1]
        slot = TIMEOUT_POSITION.get(last)
        if slot is None:
            return None
        if last == "create_connection" and "." in name \
                and not name.endswith("socket.create_connection"):
            return None   # some other module's create_connection
        if any(kw.arg == "timeout" for kw in call.keywords):
            return None
        if len(call.args) > slot:
            return None   # timeout passed positionally
        return name

    def fixtures(self):
        bad = {
            "lightgbm_tpu_torch/serving/probe.py": (
                "import socket\n"
                "import urllib.request\n"
                "from http.client import HTTPConnection\n"
                "def poke(url, host, port):\n"
                "    urllib.request.urlopen(url)\n"
                "    HTTPConnection(host, port)\n"
                "    socket.create_connection((host, port))\n"
            ),
        }
        good = {
            "lightgbm_tpu_torch/fleet/probe.py": (
                "import socket\n"
                "import urllib.request\n"
                "from http.client import HTTPConnection\n"
                "def poke(url, host, port):\n"
                "    urllib.request.urlopen(url, timeout=5.0)\n"
                "    HTTPConnection(host, port, 5.0)\n"
                "    socket.create_connection((host, port), 5.0)\n"
            ),
        }
        out_of_scope = {
            "lightgbm_tpu_torch/models/probe.py": (
                "import urllib.request\n"
                "def poke(url):\n"
                "    return urllib.request.urlopen(url)\n"
            ),
        }
        not_network = {
            "lightgbm_tpu_torch/fleet/clean.py": (
                "def create_connection(pool):\n"
                "    return pool.create_connection()\n"
            ),
        }
        return [
            Fixture("unbounded-calls", bad, expect=3),
            Fixture("bounded-calls", good, expect=0),
            Fixture("out-of-scope", out_of_scope, expect=0),
            Fixture("non-network-name", not_network, expect=0),
        ]
