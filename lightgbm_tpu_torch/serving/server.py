"""Serving endpoint: stdlib HTTP server around a CompiledPredictor (the
port's copy of lightgbm_tpu/serving/server.py).

`python -m lightgbm_tpu_torch.serve model.txt --port 8099` loads the
text model, freezes and warms it on the card (serving/compiled_model.py;
`--device cpu` serves from the CPU), starts the micro-batching queue
(serving/batcher.py) and serves:

- POST /predict          transformed predictions (sigmoid/softmax)
- POST /predict_raw      raw scores
- POST /predict_leaf     leaf indices
- GET  /healthz          liveness + model card (+ served model version)
- GET  /metricz          request/row/batch counters, batch occupancy,
                         queue depth, p50/p95/p99 latency, warm-up and
                         kernel-library stats, drift/skew gauges, model
                         version + hot-swap counters
                         (`?format=prometheus`: text exposition)
- GET  /driftz           the drift & skew monitors' full view
                         (serving/drift.py; needs a <model>.profile.json
                         baseline for drift)
- GET  /quiescez         admin drain check: 200 when no request is in
                         flight and the batcher is idle, 503 otherwise
- GET  /tracez           request-tracing state: the recorder's counters
                         and the newest kept spans (with --trace-dir)

Hot-swap: `swap_model` flips the served model atomically under the
batcher (one predictor snapshot per coalesced batch — a response is
never scored by two model versions). SIGTERM drains: connections keep
being ACCEPTED but new POSTs bounce with a retryable 503 while in-flight
requests finish (bounded by --drain-timeout-s); only then does the
listener close and the process exit. `--registry DIR` serves the
registry's CURRENT version (fleet/registry.py, manifest verified) and
`--follow` hot-swaps to every later promotion or rollback
(fleet/hotswap.py).

Resilience: an `X-Deadline-Ms` header carries the client's remaining
budget — requests that expire in the queue are dropped BEFORE dispatch
(504), and the admission controller (serving/admission.py) sheds with
429 + Retry-After when the estimated queue wait exceeds the budget,
browning out the drift/skew monitors first. `/healthz?strict=1` goes
non-200 while draining. Chaos faults (utils/faults.py: slow_replica_ms,
error_rate, drop_connection, wedge_batcher) are injectable per server.

Request body: JSON `{"rows": [[...], ...]}` (or `{"row": [...]}` for a
single row), or `text/csv` — one comma/tab-separated row per line.
Response: JSON `{"predictions": [[...], ...], "rows": N,
"latency_ms": ...}`.

ThreadingHTTPServer + MicroBatcher is the whole concurrency story:
each connection's handler thread blocks on its request's Future while
the single batcher worker coalesces everything that arrived within
`max_wait_ms` into one padded device dispatch. stdlib-only apart from
the predictor.
"""

import argparse
import json
import re
import signal
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..io.parser import NA_VALUES
from ..telemetry import disttrace
from ..telemetry import prometheus
from ..telemetry.journal import read_journal
from ..utils import faults
from ..utils.log import Log
from .admission import AdmissionController
from .batcher import DeadlineExceeded, MicroBatcher
from .compiled_model import DEFAULT_MAX_BATCH_ROWS, CompiledPredictor
from .metrics import ServingMetrics

DEFAULT_SLOW_REQUEST_MS = 1000.0

_REQUEST_ID_OK = re.compile(r"[^\w.\-]")


def _parse_rows(body, content_type):
    """Request body -> (N, F) float32 rows. JSON `rows`/`row` keys, or
    CSV/TSV lines (NaN/empty cells allowed — they ride the model's
    missing-value routing)."""
    if "csv" in (content_type or ""):
        lines = [ln for ln in body.decode("utf-8").splitlines()
                 if ln.strip()]
        sep = "\t" if lines and "\t" in lines[0] else ","
        na = set(NA_VALUES) | {""}  # the project-wide missing markers
        rows = [[float(tok) if tok.strip() not in na else float("nan")
                 for tok in ln.split(sep)]
                for ln in lines]
        return np.asarray(rows, dtype=np.float32)
    payload = json.loads(body)
    if isinstance(payload, dict):
        rows = payload.get("rows", payload.get("row"))
        if rows is None:
            raise ValueError('JSON body needs a "rows" (or "row") key')
    else:
        rows = payload  # bare list-of-lists
    if rows and not isinstance(rows[0], (list, tuple)):
        rows = [rows]
    # JSON null = missing value -> NaN (rides the model's NaN routing)
    arr = [[float("nan") if v is None else float(v) for v in r]
           for r in rows]
    return np.asarray(arr, dtype=np.float32).reshape(len(arr), -1)


class ServingHandler(BaseHTTPRequestHandler):
    """One request per handler-thread; heavy lifting rides the shared
    batcher."""

    protocol_version = "HTTP/1.1"
    # set by make_server():
    batcher = None
    metrics = None
    slow_request_ms = DEFAULT_SLOW_REQUEST_MS
    # (owner_predictor, drift, skew) — THE monitor reference, swapped
    # as ONE tuple assignment: _observe_quality reads it atomically
    # and only feeds the monitors results their OWN model scored, so a
    # hot-swap mid-request cannot pair one model's output with
    # another's baseline/reference (a false, unretractable skew_warn
    # otherwise). The read-only endpoints (/driftz, /metricz) view the
    # same tuple through the drift/skew properties below.
    monitor_state = (None, None, None)

    @property
    def drift(self):
        return self.monitor_state[1]   # serving/drift.py DriftMonitor

    @property
    def skew(self):
        return self.monitor_state[2]   # serving/drift.py SkewMonitor

    @property
    def predictor(self):
        # the batcher's reference is THE served model — reading it here
        # keeps /healthz + /metricz consistent with what dispatches
        # score, including across a hot-swap (swap_model)
        return self.batcher.predictor

    def log_message(self, fmt, *args):
        # the structured access-log record (one per request, with id +
        # latency split) replaces the default per-line noise; keep the
        # raw lines reachable at debug for protocol-level forensics
        Log.debug("http: " + fmt, *args)

    def _request_id(self):
        """Caller's X-Request-Id (sanitized, bounded) or a fresh one —
        either way the response echoes it, so a slow request is
        greppable across client logs, access log and headers."""
        rid = _REQUEST_ID_OK.sub("", self.headers.get("X-Request-Id")
                                 or "")[:64]
        return rid or uuid.uuid4().hex[:16]

    def _reply(self, code, obj, headers=None):
        root = getattr(self, "_trace_root", None)
        if root is not None:
            # every reply path funnels here: the root span's outcome
            # tag (what tail sampling keys on) cannot be missed
            root.set_tag("http.status", int(code))
        data = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def _access_log(self, request_id, rows, status, timing_ms):
        """One structured record per request (request id, path, rows,
        status, latency split) — a JSON object under
        LIGHTGBM_TPU_LOG_JSON, key=value text otherwise."""
        Log.structured("Info", "access", request_id=request_id,
                       path=self.path.split("?")[0], rows=int(rows),
                       status=int(status), **(timing_ms or {}))

    def _metricz_snapshot(self):
        snap = self.metrics.snapshot()
        snap["queue_depth"] = self.batcher.queue_depth()
        predictor = self.predictor
        stats = predictor.stats
        snap["warmup_s"] = stats["warmup_s"]
        snap["compile_cache_hits"] = stats["compile_cache_hits"]
        # True when AOT warmup was served by the persistent compile
        # cache (warm-process startup; config.py)
        snap["compile_cache_hit"] = stats["compile_cache_hits"] > 0
        snap["warm_dispatches"] = stats["warm_dispatches"]
        snap["cold_dispatches"] = stats["cold_dispatches"]
        snap["buckets"] = stats["buckets"]
        # fleet surface: which model generation is serving, how it got
        # here (docs/Fleet.md)
        srv = self.server
        snap["model_version"] = getattr(srv, "model_version", None)
        snap["swap_count"] = int(getattr(srv, "swap_count", 0))
        snap["serving_precision"] = getattr(predictor,
                                            "serving_precision", "f32")
        snap["accuracy_bound"] = float(getattr(predictor,
                                               "accuracy_bound", 0.0))
        snap["in_flight"] = int(getattr(srv, "inflight").count
                                if hasattr(srv, "inflight") else 0)
        snap["draining"] = bool(getattr(srv, "draining", False))
        # drift/skew scalar gauges ride the same page (full view on
        # /driftz); absent monitors contribute nothing
        if self.drift is not None:
            snap.update(self.drift.gauges())
        if self.skew is not None:
            snap.update(self.skew.gauges())
        return snap

    def _prometheus(self):
        """The serving registry + the derived scalars (occupancy,
        queue depth, warmup stats) in text exposition format — the
        same page shape the training-side /metricz serves."""
        reg = self.metrics.registry.snapshot()
        owned = (set(reg.get("counters") or ())
                 | set(reg.get("gauges") or ())
                 | set(reg.get("histograms") or ()))
        extra = {k: v for k, v in self._metricz_snapshot().items()
                 if k not in owned
                 and isinstance(v, (int, float))
                 and not isinstance(v, bool)}
        if self.drift is not None:
            # one gauge per profiled feature: the scrape-side alerting
            # surface (`lightgbm_tpu_drift_psi_<feature>`)
            for name, value in self.drift.psi_by_feature().items():
                extra[f"drift_psi_{name}"] = value
        return prometheus.render(reg, extra_gauges=extra)

    def _tracez(self, recent_n=50):
        """The trace recorder's counters and its newest journaled
        spans; {"enabled": false} when tracing is off."""
        rec = getattr(self.server, "trace_recorder", None)
        if rec is None or not rec.enabled:
            return {"enabled": False}
        out = {"enabled": True, **rec.stats()}
        path = getattr(rec.journal, "path", None)
        spans = []
        if path:
            records, _ = read_journal(path)
            spans = [r for r in records if r.get("event") == "trace"]
        out["recent_spans"] = spans[-recent_n:]
        return out

    def do_GET(self):
        parts = urlsplit(self.path)
        fmt = (parse_qs(parts.query).get("format") or [""])[0]
        if parts.path.startswith("/healthz"):
            # the router ejects on `?strict=1`: a DRAINING replica is
            # alive (plain probes stay 200 for process supervisors)
            # but must stop receiving new traffic before its listener
            # closes — strict probes go non-200 the moment the drain
            # flag is set (docs/Resilience.md)
            draining = bool(getattr(self.server, "draining", False))
            strict = (parse_qs(parts.query).get("strict") or ["0"])[0]
            code = 503 if draining and strict not in ("", "0") else 200
            self._reply(code, {"status": "draining" if draining
                                         else "ok",
                               "draining": draining,
                               "model": self.predictor.describe(),
                               "model_version": getattr(
                                   self.server, "model_version", None)})
        elif parts.path.startswith("/quiescez"):
            # admin drain check: a clean flip/restart waits for 200
            srv = self.server
            in_flight = (srv.inflight.count
                         if hasattr(srv, "inflight") else 0)
            queued = self.batcher.queue_depth()
            idle = self.batcher.quiescent()
            quiescent = in_flight == 0 and queued == 0 and idle
            self._reply(200 if quiescent else 503, {
                "quiescent": quiescent,
                "draining": bool(getattr(srv, "draining", False)),
                "in_flight": int(in_flight),
                "queue_depth": int(queued),
                "batcher_idle": bool(idle)})
        elif parts.path.startswith("/driftz"):
            out = {"enabled": self.drift is not None
                   or self.skew is not None}
            if self.drift is not None:
                out.update(self.drift.snapshot())
            out["skew"] = (self.skew.snapshot()
                           if self.skew is not None else None)
            self._reply(200, out)
        elif parts.path.startswith("/tracez"):
            self._reply(200, self._tracez())
        elif parts.path.startswith("/metricz"):
            if fmt == "prometheus":
                data = self._prometheus().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", prometheus.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._reply(200, self._metricz_snapshot())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        srv = self.server
        gauge = getattr(srv, "inflight", None)
        # the gauge increments BEFORE the draining check: the reverse
        # order would let drain() observe a false quiescent between a
        # handler passing the check and registering itself, tearing
        # the batcher down under a live request
        if gauge is not None:
            gauge.inc()
        try:
            if getattr(srv, "draining", False):
                # shutting down: refuse new work with a retryable
                # status so the drain converges (in-flight requests
                # still finish). Bounced requests stay auditable:
                # they count as errors and land in the access log
                req_id = self._request_id()
                self.close_connection = True
                self.metrics.record_error()
                self._reply(503, {"error": "draining: server is "
                                           "shutting down",
                                  "request_id": req_id},
                            {"X-Request-Id": req_id,
                             # a sibling replica can take this NOW —
                             # the hint just stops tight retry loops
                             "Retry-After": "1"})
                self._access_log(req_id, 0, 503, None)
                return
            self._handle_post()
        finally:
            if gauge is not None:
                gauge.dec()

    def _handle_post(self):
        """Trace shell around the predict path: opens the replica-side
        root span (continuing the router's X-Trace-Ctx when present),
        keeps it active for the handler thread so the batcher future
        inherits it, and closes it with the reply's http.status. An
        unhandled exception dumps the flight recorder first — the
        blackbox is most valuable exactly when the handler dies."""
        rec = getattr(self.server, "trace_recorder", None)
        if rec is None or not rec.enabled:
            self._serve_predict()
            return
        ctx = disttrace.parse_header(
            self.headers.get(disttrace.TRACE_HEADER) or "")
        root = rec.start("serve.request", ctx=ctx, kind="server",
                         tags={"component": "serving",
                               "path": self.path.split("?")[0]})
        self._trace_root = root
        t0 = time.monotonic()
        try:
            with disttrace.activate(root.context()):
                self._serve_predict()
        except Exception:
            disttrace.FLIGHT.dump("unhandled_server_exception",
                                  path=self.path.split("?")[0])
            rec.finish(root, status="error",
                       elapsed=time.monotonic() - t0)
            self._trace_root = None
            raise
        code = root.tags.get("http.status")
        rec.finish(root,
                   status="error" if isinstance(code, int)
                   and code >= 500 else "ok",
                   elapsed=time.monotonic() - t0)
        self._trace_root = None

    def _trace_observe(self, name, start, duration_s, **tags):
        """Synthesize a child span of this request's root from stamps
        taken elsewhere (parse split, queue wait). No-op untraced."""
        root = getattr(self, "_trace_root", None)
        rec = getattr(self.server, "trace_recorder", None)
        if root is None or rec is None:
            return
        rec.observe(name, root.context(), start, max(0.0, duration_s),
                    tags=tags or None)

    def _serve_predict(self):
        req_id = self._request_id()
        id_hdr = {"X-Request-Id": req_id}
        # drain the body BEFORE any reply: on an HTTP/1.1 keep-alive
        # connection unread body bytes would be parsed as the next
        # request line, poisoning the client's next call
        if "chunked" in (self.headers.get("Transfer-Encoding")
                         or "").lower():
            self.close_connection = True  # un-drainable without a length
            self._reply(411, {"error": "chunked bodies not supported; "
                                       "send Content-Length",
                              "request_id": req_id}, id_hdr)
            self._access_log(req_id, 0, 411, None)
            return
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            self.close_connection = True  # length unknown: can't drain
            self._reply(400, {"error": "malformed Content-Length",
                              "request_id": req_id}, id_hdr)
            self._access_log(req_id, 0, 400, None)
            return
        body = self.rfile.read(length) if length > 0 else b""
        # the clock starts AFTER the body drain: latency_ms and the
        # parse/queue/compute split measure server-side work only — a
        # slow client upload must not pollute the /metricz percentiles
        # or fire slow_request alerts
        t0 = time.monotonic()
        w0 = time.time()   # wall anchor for synthesized trace spans
        kind = {"/predict": "predict", "/predict_raw": "raw",
                "/predict_leaf": "leaf"}.get(self.path.split("?")[0])
        if kind is None:
            self._reply(404, {"error": f"unknown path {self.path}",
                              "request_id": req_id}, id_hdr)
            self._access_log(req_id, 0, 404, None)
            return
        try:
            rows = _parse_rows(body, self.headers.get("Content-Type"))
            if rows.size == 0:
                raise ValueError("no rows in request body")
        except Exception as e:  # malformed request: the CALLER's fault
            self.metrics.record_error()
            self._reply(400, {"error": str(e), "request_id": req_id},
                        id_hdr)
            self._access_log(req_id, 0, 400, None)
            return
        t_parsed = time.monotonic()
        self._trace_observe("serve.parse", w0, t_parsed - t0,
                            rows=int(rows.shape[0]))
        srv = self.server
        # ---- chaos hooks (utils/faults serving faults; no-ops unless
        # a fault is armed globally or on this server's overrides dict)
        chaos = faults.serving_chaos(getattr(srv, "chaos", None))
        if chaos:
            slow = chaos.get("slow_replica_ms")
            if slow:
                time.sleep(float(slow) / 1e3)
            if faults.consume_from("drop_connection",
                                   getattr(srv, "chaos", None)):
                # torn connection: no response bytes at all — the
                # router must see a transport error, not a status
                self.close_connection = True
                self._access_log(req_id, rows.shape[0], 0, None)
                return
            if faults.error_rate_fires(
                    getattr(srv, "chaos_error_state", {}),
                    chaos.get("error_rate")):
                self.metrics.record_error()
                self._reply(500, {"error": "injected fault: error_rate",
                                  "request_id": req_id}, id_hdr)
                self._access_log(req_id, rows.shape[0], 500, None)
                return
        # ---- deadline + admission (serving/admission.py): refuse work
        # we cannot finish in time BEFORE it costs a device dispatch
        admission = getattr(srv, "admission", None)
        deadline = None
        if admission is not None:
            t_adm0 = time.monotonic()
            deadline = admission.deadline_from_header(
                self.headers.get("X-Deadline-Ms"), now=t_parsed)
            if deadline is not None and deadline <= time.monotonic():
                self.metrics.record_deadline_expired()
                root = getattr(self, "_trace_root", None)
                if root is not None:
                    root.set_tag("decision", "deadline_expired")
                self._reply(504, {"error": "deadline already expired",
                                  "request_id": req_id}, id_hdr)
                self._access_log(req_id, rows.shape[0], 504, None)
                return
            verdict, retry_after = admission.assess(deadline)
            self._trace_observe(
                "serve.admission", w0 + (t_adm0 - t0),
                time.monotonic() - t_adm0, decision=verdict,
                **admission.trace_tags())
            if verdict == "shed":
                root = getattr(self, "_trace_root", None)
                if root is not None:
                    root.set_tag("decision", "shed")
                headers = dict(id_hdr)
                headers["Retry-After"] = str(
                    max(1, int(round(retry_after))))
                self._reply(429, {"error": "shedding load: queue wait "
                                           "exceeds deadline budget",
                                  "retry_after_s": round(retry_after, 3),
                                  "request_id": req_id}, headers)
                self._access_log(req_id, rows.shape[0], 429, None)
                return
        fut = None
        try:
            fut = self.batcher.submit(rows, kind=kind, deadline=deadline)
            out = fut.result(timeout=60.0)
        except DeadlineExceeded:
            # expired while queued: the batcher dropped it before any
            # device time was spent (504 — the client already moved on)
            self.metrics.record_deadline_expired()
            root = getattr(self, "_trace_root", None)
            if root is not None:
                root.set_tag("decision", "expired_in_queue")
            self._reply(504, {"error": "deadline expired in queue",
                              "request_id": req_id}, id_hdr)
            self._access_log(req_id, rows.shape[0], 504, None)
            return
        except Exception as e:  # dispatch fault/timeout: OUR fault — a
            self.metrics.record_error()  # 4xx would read as a caller
            self._reply(500, {"error": str(e),  # error and stop retries
                              "request_id": req_id}, id_hdr)
            self._access_log(req_id, rows.shape[0], 500, None)
            return
        latency = time.monotonic() - t0
        # the per-request latency split (docs/Serving.md): parse is this
        # handler thread, queue is enqueue->batch dispatch (time spent
        # waiting for company), compute is the coalesced device call the
        # request rode (batcher future timestamps)
        timing = {"parse_ms": round((t_parsed - t0) * 1e3, 3),
                  "total_ms": round(latency * 1e3, 3)}
        if fut.t_dispatch is not None and fut.t_done is not None:
            timing["queue_ms"] = round(
                (fut.t_dispatch - fut.t_enqueue) * 1e3, 3)
            timing["compute_ms"] = round(
                (fut.t_done - fut.t_dispatch) * 1e3, 3)
            # queue = enqueue -> batch dispatch; the dispatch + kernel
            # spans themselves come from the batcher worker (with links
            # to every coalesced member)
            self._trace_observe("serve.queue",
                                w0 + (fut.t_enqueue - t0),
                                fut.t_dispatch - fut.t_enqueue)
        self.metrics.record_request(rows.shape[0], latency)
        headers = dict(id_hdr)
        headers["X-Timing-Ms"] = ";".join(
            f"{k[:-3]}={v}" for k, v in sorted(timing.items()))
        self._reply(200, {"predictions": np.asarray(out).tolist(),
                          "rows": int(rows.shape[0]),
                          "latency_ms": round(latency * 1e3, 3),
                          "request_id": req_id,
                          "timing_ms": timing}, headers)
        slow = self.slow_request_ms
        if slow and latency * 1e3 >= slow:
            Log.structured("Warning", "slow_request", request_id=req_id,
                           path=self.path.split("?")[0],
                           rows=int(rows.shape[0]),
                           threshold_ms=slow, **timing)
        self._access_log(req_id, rows.shape[0], 200, timing)
        # drift/skew intake AFTER the reply: sampled monitoring must
        # never add to the latency the client (or /metricz) sees
        self._observe_quality(kind, rows, out, fut)

    def _observe_quality(self, kind, rows, out, fut=None):
        """Feed the drift monitor (sampled row histograms + the
        prediction distribution) and the skew monitor (sampled host
        f64 shadow scoring). Never raises — a monitor defect must not
        poison the keep-alive connection. A request whose batch was
        scored by a DIFFERENT predictor than the monitors' owner (a
        hot-swap landed mid-request) is skipped: sampled monitoring
        can drop one sample, a false skew alarm cannot be retracted."""
        owner, drift, skew = self.monitor_state   # ONE atomic read
        if drift is None and skew is None:
            return
        admission = getattr(self.server, "admission", None)
        if admission is not None and admission.brownout_active:
            # brownout: quality monitoring is the FIRST thing shed
            # under pressure — monitors drop samples gracefully, predict
            # traffic does not (docs/Resilience.md)
            return
        scored_by = getattr(fut, "scored_by", None)
        if scored_by is not None and scored_by is not owner:
            return
        try:
            if drift is not None:
                # the monitor reduces multiclass outputs to the
                # winning-class confidence at flush — pass the batcher
                # output through untouched (request path stays cheap)
                drift.observe(
                    rows, predictions=out if kind == "predict" else None)
            if skew is not None and kind in ("predict", "raw"):
                skew.observe(rows, out, kind)
        except Exception as e:
            Log.warning("drift/skew monitor failed: %s", e)


class _InflightGauge:
    """Count of POST requests currently inside a handler thread (the
    /quiescez drain check's second leg — the batcher queue only sees a
    request between submit and future-resolve)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def inc(self):
        with self._lock:
            self._count += 1

    def dec(self):
        with self._lock:
            self._count -= 1

    @property
    def count(self):
        with self._lock:
            return self._count


def build_monitors(predictor, drift_sample_rate=0.0, psi_warn=None,
                   profile_bins=None, skew_sample_rate=0.0,
                   skew_warn=None, profile_path=None):
    """Construct the (drift, skew) monitor pair for one predictor from
    the serve CLI's monitor knobs. The drift baseline comes from the
    predictor's auto-discovered profile sidecar
    (CompiledPredictor.from_model_file) unless `profile_path`
    overrides; the skew reference loads from `predictor.model_path`,
    and its tolerance is widened to the predictor's pinned
    `accuracy_bound` so a reduced-precision model keeps shadow scoring
    armed AND quiet (compiled_model.py). Either monitor is None when
    its inputs are off/absent. Hot-swaps rebuild both against the new
    model (fleet/hotswap.py)."""
    from ..io.profile import DEFAULT_PROFILE_BINS, DatasetProfile
    from .drift import (DEFAULT_PSI_WARN, DEFAULT_SKEW_WARN, SKEW_TOL,
                        DriftMonitor, SkewMonitor, host_reference_scorer)
    drift = skew = None
    if drift_sample_rate and drift_sample_rate > 0:
        profile = predictor.profile
        if profile_path:
            try:
                profile = DatasetProfile.load(profile_path)
            except (OSError, ValueError) as e:
                # a stale --profile path degrades to drift-off with a
                # warning (the pre-fleet behavior), never a boot crash
                Log.warning("cannot load profile %s (%s); falling back "
                            "to the model's own sidecar", profile_path, e)
                profile = predictor.profile
        if profile is not None:
            pred_range = ((0.0, 1.0)
                          if predictor.sigmoid > 0
                          or predictor.num_class > 1 else None)
            drift = DriftMonitor(
                profile, sample_rate=drift_sample_rate,
                psi_warn=(DEFAULT_PSI_WARN if psi_warn is None
                          else psi_warn),
                profile_bins=(DEFAULT_PROFILE_BINS if profile_bins is None
                              else profile_bins),
                pred_range=pred_range)
        else:
            Log.warning("drift monitor off: predictor has no profile "
                        "baseline (train with a build that writes "
                        "<model>.profile.json, or pass --profile)")
    if skew_sample_rate and skew_sample_rate > 0:
        if predictor.model_path:
            skew = SkewMonitor(
                host_reference_scorer(predictor.model_path),
                sample_rate=skew_sample_rate,
                skew_warn=(DEFAULT_SKEW_WARN if skew_warn is None
                           else skew_warn),
                tol=max(SKEW_TOL,
                        float(getattr(predictor, "accuracy_bound", 0.0))))
        else:
            Log.warning("skew monitor off: predictor has no model file "
                        "to load the host reference from")
    return drift, skew


def swap_model(srv, predictor, drift=None, skew=None, version=None):
    """Atomically flip a live server to a new (already warmed)
    predictor. Order matters: the batcher flips FIRST (dispatch
    provenance — one model per coalesced batch, fleet/hotswap.py),
    then the monitor/metadata surfaces follow; the monitor_owner tag
    keeps in-flight requests scored by the OTHER model out of the new
    monitors (ServingHandler._observe_quality). Returns the retired
    predictor."""
    old = srv.batcher.swap_predictor(predictor)
    handler = srv.RequestHandlerClass
    handler.monitor_state = (predictor, drift, skew)
    srv.model_version = version
    srv.swap_count = int(getattr(srv, "swap_count", 0)) + 1
    Log.info("hot-swap: now serving version=%s trees=%d leaves=%s "
             "precision=%s", version, predictor.num_trees,
             "linear" if getattr(predictor, "is_linear", False)
             else "constant", predictor.serving_precision)
    return old


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose `predictor` delegates to the batcher —
    the batcher's reference is THE served model (one source of truth),
    so a caller flipping via `batcher.swap_predictor` directly can
    never desync the server-level view."""

    @property
    def predictor(self):
        return self.batcher.predictor


def make_server(predictor, host="127.0.0.1", port=8099, max_wait_ms=2.0,
                max_batch_rows=None,
                slow_request_ms=DEFAULT_SLOW_REQUEST_MS,
                drift=None, skew=None, model_version=None,
                monitor_settings=None, deadline_default_ms=0.0,
                shed_queue_budget=1.0, trace_dir=None, trace_rank=0,
                trace_sample_rate=disttrace.DEFAULT_SAMPLE_RATE,
                trace_slow_only=False):
    """Wire predictor + batcher + metrics (+ optional drift/skew
    monitors, serving/drift.py) into a ThreadingHTTPServer (not yet
    serving — call serve_forever, or use it from tests).
    `monitor_settings` (the build_monitors kwargs) are remembered on
    the server so a hot-swap can rebuild monitors for the new model.
    `trace_dir` arms distributed tracing (telemetry/disttrace.py):
    request spans journal there, tail-sampled, for the aggregator's
    collector; the flight recorder registers this server's evidence."""
    metrics = ServingMetrics()
    batcher = MicroBatcher(predictor,
                           max_batch_rows=max_batch_rows,
                           max_wait_ms=max_wait_ms, metrics=metrics)
    handler = type("BoundServingHandler", (ServingHandler,),
                   {"batcher": batcher, "metrics": metrics,
                    "slow_request_ms": float(slow_request_ms or 0.0),
                    "monitor_state": (predictor, drift, skew)})
    srv = ServingHTTPServer((host, port), handler)
    srv.batcher = batcher
    srv.metrics = metrics
    srv.trace_recorder = None
    if trace_dir:
        srv.trace_recorder = disttrace.TraceRecorder(
            directory=trace_dir, rank=trace_rank, service="serving",
            sample_rate=trace_sample_rate,
            slow_ms=float(slow_request_ms or 0.0),
            slow_only=trace_slow_only)
        batcher.trace_recorder = srv.trace_recorder
        # arm the blackbox beside the trace journal: on an unhandled
        # handler exception / SIGQUIT the last seconds land on disk
        disttrace.FLIGHT.configure(trace_dir, rank=trace_rank)
        disttrace.FLIGHT.add_source(
            "serving_metrics", lambda: metrics.snapshot())
        disttrace.FLIGHT.add_source(
            "trace_stats", srv.trace_recorder.stats)
    srv.model_version = model_version
    srv.swap_count = 0
    srv.inflight = _InflightGauge()
    srv.draining = False
    srv.monitor_settings = dict(monitor_settings or {})
    # resilience layer (serving/admission.py, docs/Resilience.md)
    srv.admission = AdmissionController(
        batcher, metrics=metrics,
        deadline_default_ms=deadline_default_ms,
        shed_queue_budget=shed_queue_budget)
    # per-server chaos overrides (utils/faults.serving_chaos): the
    # chaos harness slows/breaks ONE in-process replica through this
    # dict; the batcher shares it for `wedge_batcher`
    srv.chaos = {}
    srv.chaos_error_state = {}
    batcher.chaos = srv.chaos
    return srv


def drain(srv, timeout_s=30.0, poll_s=0.05):
    """Wait until no POST is in flight and the batcher is idle (or the
    timeout passes). Callers set `srv.draining = True` first so new
    work bounces with 503 and the wait converges. Returns True when
    fully quiesced."""
    deadline = time.monotonic() + float(timeout_s)
    while time.monotonic() < deadline:
        if srv.inflight.count == 0 and srv.batcher.quiescent():
            return True
        time.sleep(poll_s)
    return srv.inflight.count == 0 and srv.batcher.quiescent()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.serve",
        description="Serve a trained model over HTTP with micro-batching "
                    "(docs/Serving.md)")
    ap.add_argument("model", nargs="?", default=None,
                    help="model file (text format)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve from (default: the "
                         "current CUDA card; `cpu` runs the kernels' "
                         "plain versions)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8099)
    ap.add_argument("--registry", default="",
                    help="fleet model-registry directory: serve its "
                         "CURRENT version (the model argument is the "
                         "fallback while nothing is promoted)")
    ap.add_argument("--follow", action="store_true",
                    help="poll the registry and hot-swap to every "
                         "promotion or rollback (needs --registry)")
    ap.add_argument("--poll-s", type=float, default=2.0,
                    help="registry poll interval for --follow")
    ap.add_argument("--serving-precision", default="f32",
                    choices=("f32", "bf16"),
                    help="f32 = exact serving contract; bf16 = reduced-"
                         "precision value stage with a pinned accuracy "
                         "bound the skew monitor adopts "
                         "(docs/Serving.md)")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0,
                    help="SIGTERM drain: how long to wait for in-flight "
                         "requests before exiting")
    ap.add_argument("--max-batch-rows", type=int,
                    default=DEFAULT_MAX_BATCH_ROWS,
                    help="largest coalesced dispatch; also the largest "
                         "warmed row bucket")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="how long a lone request waits for company")
    ap.add_argument("--slow-request-ms", type=float,
                    default=DEFAULT_SLOW_REQUEST_MS,
                    help="requests slower than this emit a structured "
                         "slow-request log line (0 = off; mirrors the "
                         "slow_request_ms config knob)")
    ap.add_argument("--deadline-default-ms", type=float, default=0.0,
                    help="deadline budget assumed for requests without "
                         "an X-Deadline-Ms header (0 = such requests "
                         "are never deadline-shed; mirrors the "
                         "deadline_default_ms config knob)")
    ap.add_argument("--shed-queue-budget", type=float, default=1.0,
                    help="shed (429) when estimated queue wait exceeds "
                         "this fraction of the deadline budget; "
                         "brownout engages at half of it (mirrors the "
                         "shed_queue_budget config knob)")
    ap.add_argument("--num-iteration", type=int, default=-1,
                    help="serve only the first N iterations of the model")
    ap.add_argument("--trace-dir", default="",
                    help="arm distributed tracing: journal tail-sampled "
                         "trace records here for the aggregator's "
                         "collector (telemetry/disttrace.py, "
                         "docs/Observability.md)")
    ap.add_argument("--trace-rank", type=int, default=0,
                    help="journal rank suffix for this replica's trace "
                         "records (keep distinct per process sharing "
                         "--trace-dir)")
    ap.add_argument("--trace-sample-rate", type=float, default=0.01,
                    help="deterministic hash(trace_id) fraction of "
                         "healthy traces to keep; error/slow traces "
                         "are always kept (mirrors the "
                         "trace_sample_rate config knob)")
    ap.add_argument("--trace-slow-only", action="store_true",
                    help="keep only error/slow traces, dropping even "
                         "hash-sampled healthy ones (mirrors "
                         "trace_slow_only)")
    ap.add_argument("--no-blackbox", action="store_true",
                    help="disable the crash flight recorder dump "
                         "(blackbox-<rank>.json; mirrors the blackbox "
                         "config knob)")
    from .drift import (DEFAULT_DRIFT_SAMPLE_RATE, DEFAULT_PSI_WARN,
                        DEFAULT_SKEW_SAMPLE_RATE, DEFAULT_SKEW_WARN)
    from ..io.profile import DEFAULT_PROFILE_BINS
    ap.add_argument("--profile", default="",
                    help="training dataset profile JSON (default: "
                         "<model>.profile.json when it exists); the "
                         "drift monitor's baseline distribution")
    ap.add_argument("--drift-sample-rate", type=float,
                    default=DEFAULT_DRIFT_SAMPLE_RATE,
                    help="fraction of request rows fed to the drift "
                         "monitor (0 = off; mirrors the "
                         "drift_sample_rate config knob)")
    ap.add_argument("--psi-warn", type=float, default=DEFAULT_PSI_WARN,
                    help="per-feature PSI threshold for the structured "
                         "drift_warn log (mirrors psi_warn)")
    ap.add_argument("--profile-bins", type=int,
                    default=DEFAULT_PROFILE_BINS,
                    help="max histogram groups per feature for PSI "
                         "(mirrors profile_bins)")
    ap.add_argument("--skew-sample-rate", type=float,
                    default=DEFAULT_SKEW_SAMPLE_RATE,
                    help="fraction of request rows shadow-scored "
                         "through the host f64 reference path (0 = "
                         "off; mirrors skew_sample_rate)")
    ap.add_argument("--skew-warn", type=int, default=DEFAULT_SKEW_WARN,
                    help="diverging-row count that triggers the "
                         "structured skew_warn log (mirrors skew_warn)")
    args = ap.parse_args(argv)
    if args.follow and not args.registry:
        ap.error("--follow requires --registry")

    t0 = time.time()
    registry = None
    model_path, model_version = args.model, None
    if args.registry:
        from ..fleet.registry import ModelRegistry
        registry = ModelRegistry(args.registry)
        cur = registry.current()
        if cur is not None:
            model_version = int(cur["version"])
            # same CRC discipline as every follower hot-swap: bit rot
            # in the live version must fail the boot, not get served
            registry.verify(model_version)
            model_path = registry.model_path(model_version)
            Log.info("serving registry %s CURRENT v%d (manifest "
                     "verified)", args.registry, model_version)
    if not model_path:
        ap.error("no model: pass a model file or --registry with a "
                 "promoted version")
    predictor = CompiledPredictor.from_model_file(
        model_path, num_iteration=args.num_iteration,
        max_batch_rows=args.max_batch_rows,
        serving_precision=args.serving_precision, device=args.device)
    monitor_settings = dict(
        drift_sample_rate=args.drift_sample_rate,
        psi_warn=args.psi_warn, profile_bins=args.profile_bins,
        skew_sample_rate=args.skew_sample_rate,
        skew_warn=args.skew_warn)
    drift, skew = build_monitors(predictor, profile_path=args.profile,
                                 **monitor_settings)
    if drift is not None:
        Log.info("drift monitor on: %d profiled features, sample rate "
                 "%.3f, psi_warn %.2f", drift.profile.num_features,
                 args.drift_sample_rate, args.psi_warn)
    if skew is not None:
        Log.info("skew monitor on: sample rate %.3f, warn at %d "
                 "diverging row(s), tol %.3g", args.skew_sample_rate,
                 args.skew_warn, skew.tol)
    srv = make_server(predictor, host=args.host, port=args.port,
                      max_wait_ms=args.max_wait_ms,
                      max_batch_rows=args.max_batch_rows,
                      slow_request_ms=args.slow_request_ms,
                      drift=drift, skew=skew,
                      model_version=model_version,
                      monitor_settings=monitor_settings,
                      deadline_default_ms=args.deadline_default_ms,
                      shed_queue_budget=args.shed_queue_budget,
                      trace_dir=args.trace_dir or None,
                      trace_rank=args.trace_rank,
                      trace_sample_rate=args.trace_sample_rate,
                      trace_slow_only=args.trace_slow_only)
    if args.no_blackbox:
        disttrace.FLIGHT.disarm()
    elif args.trace_dir:
        # SIGQUIT -> blackbox without killing the process: live
        # inspection of a replica that looks wedged
        disttrace.FLIGHT.install_sigquit()
    # the swap path re-applies this knob to every challenger
    # (fleet/hotswap.py HotSwapper)
    srv.num_iteration = args.num_iteration
    Log.info("serving %s on http://%s:%d (%d trees, %s on %s, load+warm "
             "%.2fs, %d kernel libraries found built)", model_path,
             args.host, args.port, predictor.num_trees,
             args.serving_precision, predictor.device, time.time() - t0,
             predictor.stats["compile_cache_hits"])
    # the readiness line: tests and orchestrators wait
    # for this exact prefix on stdout before sending traffic
    print(f"SERVING http://{args.host}:{srv.server_address[1]}",
          flush=True)

    stop = threading.Event()

    def shut(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, shut)
    serve_thread = threading.Thread(target=srv.serve_forever,
                                    daemon=True)
    serve_thread.start()
    follower = None
    if args.follow:
        from ..fleet.hotswap import attach_follower
        follower = attach_follower(srv, registry, poll_s=args.poll_s,
                                   serving_precision=args.serving_precision)
        Log.info("following registry %s every %.1fs", args.registry,
                 args.poll_s)
    try:
        while not stop.wait(0.2):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        # graceful drain: KEEP accepting while draining (so brand-new
        # connections get the retryable 503 from a handler instead of
        # hanging on an un-accepted socket), let in-flight requests
        # finish, THEN stop the listener and tear down
        srv.draining = True
        if follower is not None:
            follower.stop()
        drained = drain(srv, timeout_s=args.drain_timeout_s)
        srv.shutdown()
        serve_thread.join(timeout=10)
        srv.server_close()
        srv.batcher.close()
        if srv.trace_recorder is not None:
            srv.trace_recorder.close()
        Log.structured("Info", "drain", drained=bool(drained),
                       in_flight=srv.inflight.count,
                       queue_depth=srv.batcher.queue_depth())
        Log.info("serving stopped (%s)",
                 "drained" if drained else "drain timeout")
    return 0


if __name__ == "__main__":
    sys.exit(main())
