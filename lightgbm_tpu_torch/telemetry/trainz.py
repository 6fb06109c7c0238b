"""Live training introspection endpoint: GET /trainz (the port of
lightgbm_tpu/telemetry/trainz.py; the same document and sources).

An opt-in stdlib HTTP thread exposing the current state of a training
run as one JSON document:

- `iteration`: the booster's completed-iteration count
- `phases`: the span tracer's per-phase accumulated seconds
- `spans`: the most recent completed spans (path/start/duration)
- `metrics`: the metrics registry snapshot (counters/gauges/histograms)
- `heartbeats`: per-rank seconds since each peer's beat last changed
  (process gangs with the heartbeat service up; parallel/heartbeat.py)
- `journal_tail`: the last records of this rank's run journal
- `memory`: device/host memory watermarks (telemetry/ledger.py)
- `compile`: the set-up ledger (telemetry/ledger.py LEDGER: kernel
  library builds and warm-ups, where the JAX package kept its XLA
  compiles)
- `roofline`: per-kernel achieved bandwidth against the measured copy
  peak (telemetry/roofline.py); launches replayed inside a CUDA graph
  are not recorded, and the document says so
- `comm`: per-collective wait attribution, comm_overlap_pct and the
  per-rank straggler deltas (telemetry/comm_profile.py)
- `quality`: split-ledger totals and top features by gain
  (telemetry/quality.py), with `quality_telemetry`

Also serves /healthz and /metricz (the registry alone).
`?format=prometheus` on /trainz and /metricz renders the registry in
text exposition format (telemetry/prometheus.py).

Enabled by `telemetry_port > 0`; `start_trainz(..., port=0)` binds an
ephemeral port (tests). The handler thread only reads shared state.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from ..utils.log import Log
from . import journal as journal_mod
from . import prometheus


class TrainzHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    sources = None   # bound by start_trainz

    def log_message(self, fmt, *args):   # route access logs through ours
        Log.debug("trainz: " + fmt, *args)

    def _reply(self, code, obj):
        data = json.dumps(obj, default=str).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _reply_text(self, code, text, content_type):
        data = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _source(self, name):
        fn = (self.sources or {}).get(name)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:   # a dead source must not 500 the page
            return None

    def _prometheus(self):
        """The single registry (plus the scalar extras a scraper
        wants: iteration, compile totals, memory watermarks, per-
        kernel roofline bandwidth) in text exposition format."""
        snapshot = self._source("metrics") or {}
        extra = {}
        it = self._source("iteration")
        if it is not None:
            extra["iteration"] = it
        comp = self._source("compile")
        if isinstance(comp, dict):
            extra.update({f"compile_{k}": v for k, v in comp.items()
                          if isinstance(v, (int, float))})
        mem = self._source("memory")
        if isinstance(mem, dict):
            extra.update(mem)
        roof = self._source("roofline")
        if isinstance(roof, dict):
            if roof.get("peak_bytes_per_s"):
                extra["stream_peak_bytes_per_s"] = roof["peak_bytes_per_s"]
            for kname, k in (roof.get("kernels") or {}).items():
                for field in ("bytes_per_s", "rows_per_s", "calls"):
                    if isinstance(k.get(field), (int, float)):
                        extra[f"roofline_{kname}_{field}"] = k[field]
        # GBDT mirrors the memory sample into registry gauges — drop
        # any extra whose name the registry already owns: a duplicate
        # metric name makes a real Prometheus server reject the WHOLE
        # scrape (the exposition format forbids it)
        owned = (set(snapshot.get("counters") or ())
                 | set(snapshot.get("gauges") or ())
                 | set(snapshot.get("histograms") or ()))
        extra = {k: v for k, v in extra.items() if k not in owned}
        return prometheus.render(snapshot, extra_gauges=extra)

    def do_GET(self):
        parts = urlsplit(self.path)
        path = parts.path
        fmt = (parse_qs(parts.query).get("format") or [""])[0]
        if path.startswith("/healthz"):
            self._reply(200, {"status": "ok"})
            return
        if not (path.startswith("/trainz") or path.startswith("/metricz")):
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        if fmt == "prometheus":
            self._reply_text(200, self._prometheus(),
                             prometheus.CONTENT_TYPE)
            return
        if path.startswith("/metricz"):
            # the registry alone: the training-side scrape document
            out = {"metrics": self._source("metrics")}
            for name in ("iteration", "memory", "compile"):
                val = self._source(name)
                if val is not None:
                    out[name] = val
            self._reply(200, out)
            return
        out = {}
        for name, fn in (self.sources or {}).items():
            try:
                out[name] = fn()
            except Exception as e:   # a dead source must not 500 the page
                out[name] = {"error": str(e)}
        self._reply(200, out)


def build_sources(iteration_fn=None, tracer=None, registry=None,
                  journal=None, tail_n=20, roofline_warn_fraction=0.0,
                  quality_fn=None, comm_fn=None):
    """Assemble the /trainz source map from whatever exists. The
    heartbeat service is resolved lazily per request (it may start
    after the endpoint does); memory/compile/roofline read the
    process-wide telemetry singletons."""
    sources = {}
    if iteration_fn is not None:
        sources["iteration"] = lambda: int(iteration_fn())
    if tracer is not None:
        sources["phases"] = tracer.snapshot
        sources["spans"] = tracer.recent
    if registry is not None:
        sources["metrics"] = registry.snapshot
    if quality_fn is not None:
        # split-ledger totals + top features by gain
        # (telemetry/quality.py QualityTracker.snapshot)
        sources["quality"] = quality_fn
    if comm_fn is not None:
        # collective latency attribution: per-collective waits,
        # comm_overlap_pct, per-rank straggler deltas
        # (telemetry/comm_profile.py CommProfiler.snapshot)
        sources["comm"] = comm_fn

    def heartbeats():
        from ..parallel import heartbeat
        svc = heartbeat.service()
        if svc is None:
            return None
        return {"rank": svc.rank,
                "peer_age_s": {str(r): round(a, 3)
                               for r, a in svc.peer_ages().items()},
                "dead_peers": svc.dead_peers()}

    sources["heartbeats"] = heartbeats
    if journal is not None:
        sources["journal_tail"] = lambda: journal_mod.tail(journal.path,
                                                           tail_n)

    def memory():
        from . import ledger
        return ledger.sample_memory()

    def compile_ledger():
        from . import ledger
        return ledger.LEDGER.snapshot()

    def roofline_view():
        from . import roofline
        view = roofline.TABLE.snapshot(
            warn_fraction=roofline_warn_fraction)
        view["note"] = ("kernels launched inside a CUDA graph replay are "
                        "not recorded (captured_unrecorded counts their "
                        "captures); the fused trainer's kernels show "
                        "only in a profiler trace")
        return view

    sources["memory"] = memory
    sources["compile"] = compile_ledger
    sources["roofline"] = roofline_view
    return sources


def start_trainz(sources, port, host="127.0.0.1"):
    """Start the daemon /trainz server; returns it (server_address[1]
    carries the bound port — pass port=0 for ephemeral). Returns None
    when the bind fails: telemetry must never kill training."""
    handler = type("BoundTrainzHandler", (TrainzHandler,),
                   {"sources": dict(sources)})
    try:
        srv = ThreadingHTTPServer((host, int(port)), handler)
    except OSError as e:
        Log.warning("/trainz disabled (cannot bind %s:%s: %s)",
                    host, port, e)
        return None
    srv.daemon_threads = True
    thread = threading.Thread(target=srv.serve_forever, daemon=True,
                              name="lgbm-torch-trainz")
    thread.start()
    Log.info("/trainz live on http://%s:%d/trainz", host,
             srv.server_address[1])
    return srv


def stop_trainz(srv):
    if srv is None:
        return
    try:
        srv.shutdown()
        srv.server_close()
    except Exception:
        pass
