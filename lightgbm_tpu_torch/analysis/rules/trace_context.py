"""trace-context-propagation: outbound HTTP calls in the serving/fleet
stack that set headers must route them through the trace helper.

Provenance (lightgbm_tpu/analysis/rules/trace_context.py, aimed at the
port's serving stack): the distributed-tracing layer (telemetry/disttrace.py,
docs/Observability.md) only works when EVERY hop forwards the
`X-Trace-Ctx` header — one call site that builds its own header dict
and skips `disttrace.inject_headers(...)` silently severs the trace
tree at that hop, and the break is invisible until an incident needs
exactly the trace that no longer stitches. The fleet router forwards
the context, the replicas continue it, the load generator originates
it; this rule keeps the invariant as new hops appear.

Scope: ``lightgbm_tpu_torch/fleet/`` and
``lightgbm_tpu_torch/serving/`` — the processes that forward requests
to other processes. Flagged calls:

- ``conn.request(method, path, body, headers=...)`` (http.client)
  passing headers, in a function that never calls ``inject_headers``;
- ``urllib.request.Request(url, data, headers)`` passing headers, in
  a function that never calls ``inject_headers``;
- ``conn.putheader(...)`` under the same condition.

`inject_headers` passes header dicts through UNSTAMPED when no trace
context is active, so routing every outbound header dict through it
costs one dict copy and never forces tracing on — there is no reason
for a header-setting hop to skip it. A genuinely trace-free protocol
(none today) goes in the baseline with a justification.
"""

import re

from ..core import Fixture, Rule, Severity, register, call_name

SCOPE_RE = re.compile(r"^lightgbm_tpu_torch/(fleet|serving)/")

# callee last-segment -> index of the headers positional
# (HTTPConnection.request(method, url, body, headers) / urllib
# Request(url, data, headers)); putheader always sets a header
HEADERS_POSITION = {"request": 3, "Request": 2}


@register
class TraceContextRule(Rule):
    name = "trace-context-propagation"
    doc = ("outbound HTTP call sets headers without routing them "
           "through disttrace.inject_headers — the trace tree severs "
           "at this hop")
    severity = Severity.ERROR

    def check(self, project):
        out = []
        for pf in project.files:
            if not SCOPE_RE.match(pf.rel):
                continue
            injected = self._injecting_funcs(pf)
            for call in pf.calls():
                name = self._header_setting_name(call)
                if name is None:
                    continue
                func = getattr(call, "_g_func", None)
                if (func or pf.tree) in injected:
                    continue
                out.append(self.violation(
                    pf, call,
                    f"{name!r} sets outbound headers but the "
                    f"enclosing function never calls "
                    f"disttrace.inject_headers(...) — the X-Trace-Ctx "
                    f"hop breaks here (docs/Observability.md)"))
        return out

    @staticmethod
    def _injecting_funcs(pf):
        """Set of function nodes (plus the module tree for top-level
        code) containing an ``inject_headers`` call."""
        import ast
        found = set()
        for call in pf.calls():
            nm = call_name(call)
            if nm == "inject_headers" or nm.endswith(".inject_headers"):
                found.add(getattr(call, "_g_func", None) or pf.tree)
        # a nested helper's call also covers its enclosing function:
        # walk up so `def outer(): def _send(): inject_headers(...)`
        # marks both (the outbound call may sit in either)
        for node in list(found):
            cur = getattr(node, "_g_parent", None)
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    found.add(cur)
                cur = getattr(cur, "_g_parent", None)
        return found

    @staticmethod
    def _header_setting_name(call):
        name = call_name(call)
        if not name:
            return None
        last = name.rsplit(".", 1)[-1]
        if last == "putheader" and "." in name:
            return name
        slot = HEADERS_POSITION.get(last)
        if slot is None:
            return None
        if last == "request" and "." not in name:
            return None   # bare request() is not an HTTP client call
        has_headers = any(kw.arg == "headers" for kw in call.keywords) \
            or len(call.args) > slot
        return name if has_headers else None

    def fixtures(self):
        bad = {
            "lightgbm_tpu_torch/fleet/hop.py": (
                "import urllib.request\n"
                "from http.client import HTTPConnection\n"
                "def forward(url, host, port, body, hdrs):\n"
                "    req = urllib.request.Request(url, data=body,\n"
                "                                 headers=hdrs)\n"
                "    conn = HTTPConnection(host, port, timeout=5.0)\n"
                "    conn.request('POST', '/predict', body,\n"
                "                 headers=hdrs)\n"
            ),
        }
        good = {
            "lightgbm_tpu_torch/serving/hop.py": (
                "import urllib.request\n"
                "from ..telemetry import disttrace\n"
                "def forward(url, body, hdrs):\n"
                "    hdrs = disttrace.inject_headers(hdrs)\n"
                "    return urllib.request.Request(url, data=body,\n"
                "                                  headers=hdrs)\n"
            ),
        }
        no_headers = {
            "lightgbm_tpu_torch/fleet/probe.py": (
                "from http.client import HTTPConnection\n"
                "def probe(host, port):\n"
                "    conn = HTTPConnection(host, port, timeout=2.0)\n"
                "    conn.request('GET', '/healthz')\n"
            ),
        }
        out_of_scope = {
            "lightgbm_tpu_torch/telemetry/pull.py": (
                "import urllib.request\n"
                "def pull(url, hdrs):\n"
                "    return urllib.request.Request(url, headers=hdrs)\n"
            ),
        }
        nested_helper = {
            "lightgbm_tpu_torch/fleet/nested.py": (
                "from http.client import HTTPConnection\n"
                "from ..telemetry import disttrace\n"
                "def forward(host, port, body, hdrs):\n"
                "    def _stamp(h):\n"
                "        return disttrace.inject_headers(h)\n"
                "    conn = HTTPConnection(host, port, timeout=5.0)\n"
                "    conn.request('POST', '/p', body, _stamp(hdrs))\n"
            ),
        }
        return [
            Fixture("headers-without-helper", bad, expect=2),
            Fixture("headers-through-helper", good, expect=0),
            Fixture("no-headers-set", no_headers, expect=0),
            Fixture("out-of-scope", out_of_scope, expect=0),
            Fixture("nested-helper-counts", nested_helper, expect=0),
        ]
