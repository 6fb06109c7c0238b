"""Fleet-wide telemetry aggregator: one scrape answers "where is the
pod slow" (the port's copy of lightgbm_tpu/telemetry/aggregate.py).

Every rank of a training run serves its own /trainz and every serving
replica its own /metricz (telemetry/trainz.py, serving/server.py) —
deep per-process views that force an operator to chase N endpoints to
answer fleet questions: which rank is the straggler, is any replica's
p99 blown, did prefetch overlap collapse somewhere. This module is the
cross-process layer: ONE stdlib poller scrapes every target into a
single merged snapshot served as

- `/fleetz` — the full merged JSON: per-target documents plus the
  computed `fleet` view (max-over-ranks sync wait, per-rank straggler
  deltas, min comm/prefetch overlap, iteration lag, worst replica
  p99, summed request/error counts);
- `/metricz` — the same content as one Prometheus exposition page:
  each target's registry rendered with `rank`/`replica` + `role`
  labels (prometheus.render_multi keeps every family's TYPE line
  unique), fleet-level values as `fleet_*` gauges;
- `/healthz` — aggregator liveness + per-target reachability;
- `/tracez` — with `--trace-dir`, the distributed-trace collector's
  view: per-process `trace` journal records (telemetry/disttrace.py)
  stitched into cross-process trees, error traces first then slowest,
  each with a per-hop breakdown (router root -> attempt -> replica
  parse/admission/queue -> batch dispatch -> kernel).

Targets are `[role=]host:port` specs; `role` is `train`, `serve`,
`router`, or `auto` (default — probe /trainz first, fall back to
/metricz; a front-door router self-identifies via the `"router": true`
marker in its /metricz). A dead target stays in the snapshot with
`ok: false` and its last error so a vanished rank is a visible fact,
not a silent gap. Router targets contribute the resilience rollup
(`router_retry_count`, `router_breaker_open_count`,
`router_min_healthy_replicas`, ...) to the `fleet` view.

CLI (`aggregate_port` in config.py is the default port):

    python -m lightgbm_tpu_torch.telemetry.aggregate \
        --port 9280 --poll-s 2 127.0.0.1:9100 127.0.0.1:9101
    python -m lightgbm_tpu_torch.telemetry.aggregate --once TARGET...

`--once` polls every target one time and prints the merged JSON to
stdout (scripting / debugging). stdlib-only, like the rest of the
telemetry package.
"""

import argparse
import json
import os
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.log import Log
from . import prometheus

ROLES = ("auto", "train", "serve", "router")

# flat serving-/metricz fields that are counters in the replica's own
# registry (serving/metrics.py) — the aggregator must render them with
# the same kind + canonical name the replica's exposition uses
# (swap_count/failed_swaps are NOT here: they are plain server fields
# the replica itself renders as gauges)
SERVING_COUNTER_FIELDS = frozenset((
    "request_count", "rows_served", "error_count", "batch_count",
    "batched_rows", "batched_requests", "shed_count",
    "deadline_expired_count"))

# a front-door router's /metricz counters; same render-as-counter rule
# as the serving fields above
ROUTER_COUNTER_FIELDS = frozenset((
    "request_count", "upstream_attempt_count", "retry_count",
    "hedge_count", "hedge_cancelled_count", "no_replica_count",
    "breaker_open_count", "breaker_close_count", "eject_count",
    "error_count", "deadline_expired_count"))


class Target:
    """One scrape target: `[role=]host:port`."""

    def __init__(self, spec):
        spec = str(spec).strip()
        role = "auto"
        if "=" in spec:
            role, spec = spec.split("=", 1)
            role = role.strip().lower()
        if role not in ROLES:
            raise ValueError(f"target role must be one of {ROLES}, "
                             f"got {role!r}")
        if ":" not in spec:
            raise ValueError(f"target must be [role=]host:port, got "
                             f"{spec!r}")
        self.role = role
        self.host_port = spec

    def url(self, path):
        return f"http://{self.host_port}{path}"


def _get_json(url, timeout_s):
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return json.loads(r.read())


def _num(v, default=None):
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else default


# ---------------------------------------------------------------- tracing
def read_trace_records(directory):
    """Every `trace` record from every rank journal under `directory`
    (router, replicas and training ranks write to the SAME trace dir
    with distinct ranks, so one read sees the whole fleet's spans)."""
    from . import journal as journal_mod
    records = []
    for path in journal_mod.rank_files(directory):
        recs, _bad = journal_mod.read_journal(path)
        records.extend(r for r in recs if r.get("event") == "trace")
    return records


def _span_error(rec):
    if rec.get("status") == "error":
        return True
    code = (rec.get("tags") or {}).get("http.status")
    return isinstance(code, int) and code >= 400


def stitch_traces(records):
    """Group per-process `trace` records into cross-process trees.

    Spans keyed by trace_id form the tree; a span carrying `links`
    (the coalesced-batch spans from serving/batcher.py list every
    OTHER member request's trace_id) is grafted into each linked tree
    too, marked `shared` — so a member request's trace still shows the
    batch-dispatch/kernel hop it rode even though the span was
    journaled under the head request's trace_id. Returns trace
    documents sorted error-first then slowest-first, each with a
    per-hop breakdown ordered by wall start."""
    by_trace = {}
    for rec in records:
        tid = rec.get("trace_id")
        if tid and isinstance(rec.get("start"), (int, float)):
            by_trace.setdefault(tid, []).append(rec)
    for rec in records:
        for linked in (rec.get("links") or ()):
            if linked in by_trace and linked != rec.get("trace_id"):
                by_trace[linked].append(dict(rec, shared=True))
    traces = []
    for tid, spans in by_trace.items():
        spans.sort(key=lambda r: (r.get("start", 0.0),
                                  r.get("span_id", "")))
        t0 = min(s["start"] for s in spans)
        t1 = max(s["start"] + float(s.get("duration_s") or 0.0)
                 for s in spans)
        ids = {s.get("span_id") for s in spans}
        root = next((s for s in spans
                     if not s.get("parent_span_id")
                     or s.get("parent_span_id") not in ids), spans[0])
        traces.append({
            "trace_id": tid,
            "start": round(t0, 6),
            "duration_ms": round((t1 - t0) * 1e3, 3),
            "status": ("error" if any(_span_error(s) for s in spans)
                       else "ok"),
            "root": root.get("name"),
            "services": sorted({s.get("service") or "?"
                                for s in spans}),
            "span_count": len(spans),
            "spans": [{
                "name": s.get("name"),
                "service": s.get("service") or "?",
                "span_id": s.get("span_id"),
                "parent_span_id": s.get("parent_span_id"),
                "kind": s.get("kind", "internal"),
                "offset_ms": round((s["start"] - t0) * 1e3, 3),
                "duration_ms": round(
                    float(s.get("duration_s") or 0.0) * 1e3, 3),
                "status": s.get("status", "ok"),
                **({"shared": True} if s.get("shared") else {}),
                **({"tags": s["tags"]} if s.get("tags") else {}),
            } for s in spans],
        })
    traces.sort(key=lambda t: (t["status"] != "error",
                               -t["duration_ms"]))
    return traces


class TraceCollector:
    """The /tracez backend: re-stitches the trace dir on demand (rank
    journals are append-only JSONL; a full re-read per request is
    cheap at journal scale and needs no offset bookkeeping), keeping
    the `max_traces` most interesting trees (errors, then slowest)."""

    def __init__(self, directory, max_traces=100):
        self.directory = os.fspath(directory)
        self.max_traces = int(max_traces)

    def refresh(self):
        return stitch_traces(read_trace_records(self.directory))

    def tracez(self, n=None):
        traces = self.refresh()
        keep = self.max_traces if n is None else min(int(n),
                                                     self.max_traces)
        return {"trace_dir": self.directory,
                "trace_count": len(traces),
                "error_count": sum(1 for t in traces
                                   if t["status"] == "error"),
                "traces": traces[:keep]}


class FleetAggregator:
    """Poll + merge (see module docstring). `poll_once` is synchronous
    (tests and --once call it directly); `start` runs it on a daemon
    thread every `poll_s` seconds."""

    def __init__(self, targets, poll_s=2.0, timeout_s=5.0,
                 trace_dir=None):
        self.targets = [t if isinstance(t, Target) else Target(t)
                        for t in targets]
        if not self.targets:
            raise ValueError("aggregator needs at least one target")
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self.trace_collector = (TraceCollector(trace_dir)
                                if trace_dir else None)
        self._lock = threading.Lock()
        self._state = {}          # host_port -> scrape doc
        self._polls = 0
        self._stop = threading.Event()
        self._thread = None
        self._server = None

    # ------------------------------------------------------------ scraping
    def _scrape(self, target):
        doc = {"role": target.role, "ok": False, "ts": time.time()}
        try:
            if target.role in ("train", "auto"):
                try:
                    data = _get_json(target.url("/trainz"),
                                     self.timeout_s)
                    doc.update(ok=True, role="train", data=data,
                               label=self._train_label(target, data))
                    return doc
                except Exception:
                    if target.role == "train":
                        raise
            data = _get_json(target.url("/metricz"), self.timeout_s)
            # a front-door router's /metricz self-identifies
            # (`"router": true`) so `auto` targets resolve without a
            # dedicated probe path
            role = ("router" if data.get("router") is True
                    or target.role == "router" else "serve")
            doc.update(ok=True, role=role, data=data,
                       label=str(self.targets.index(target)))
            return doc
        except Exception as e:
            doc["error"] = f"{type(e).__name__}: {e}"
            return doc

    def _train_label(self, target, data):
        """Rank label for a /trainz document: the comm profiler and
        the heartbeat view both carry the rank; fall back to the
        target's position."""
        for path in (("comm", "rank"), ("heartbeats", "rank")):
            node = data
            for key in path:
                node = node.get(key) if isinstance(node, dict) else None
            if isinstance(node, int):
                return str(node)
        return str(self.targets.index(target))

    def poll_once(self):
        """Scrape every target once; returns the merged snapshot."""
        state = {t.host_port: self._scrape(t) for t in self.targets}
        with self._lock:
            self._state = state
            self._polls += 1
        return self.snapshot()

    # ------------------------------------------------------------- merging
    def snapshot(self):
        with self._lock:
            state = dict(self._state)
            polls = self._polls
        return {"ts": time.time(), "polls": polls,
                "poll_s": self.poll_s,
                "targets": state,
                "fleet": fleet_view(state)}

    def prometheus(self):
        """Every reachable target's registry on one labeled page, plus
        the fleet view as `fleet_*` gauges."""
        with self._lock:
            state = dict(self._state)
        parts = []
        for host_port, doc in sorted(state.items()):
            if not doc.get("ok"):
                continue
            data = doc.get("data") or {}
            if doc["role"] == "train":
                labels = {"rank": doc.get("label", "?"), "role": "train"}
                snap = data.get("metrics") or {}
                extra = {}
                it = _num(data.get("iteration"))
                if it is not None:
                    extra["iteration"] = it
                comm = data.get("comm") or {}
                ov = _num(comm.get("overlap_pct"))
                if ov is not None:
                    extra["comm_overlap_pct"] = ov
                parts.append((labels, snap, extra))
            else:
                # serving and router /metricz are flat scalar
                # documents; their counter fields must render as
                # COUNTERS so the aggregator page carries the same
                # canonical names (lightgbm_tpu_request_total, ...) as
                # the process's own exposition — a dashboard built
                # against one page must match the other
                role = doc["role"]
                counter_fields = (ROUTER_COUNTER_FIELDS
                                  if role == "router"
                                  else SERVING_COUNTER_FIELDS)
                labels = {("router" if role == "router"
                           else "replica"): doc.get("label", "?"),
                          "role": role}
                counters = {k: v for k, v in data.items()
                            if k in counter_fields
                            and _num(v) is not None}
                extra = {k: v for k, v in data.items()
                         if k not in counter_fields
                         and _num(v) is not None}
                parts.append((labels, {"counters": counters}, extra))
        fleet = fleet_view(state)
        fleet_flat = {}
        for key, value in fleet.items():
            if _num(value) is not None:
                fleet_flat[f"fleet_{key}"] = value
            elif isinstance(value, dict):
                # per-rank maps flatten with the unit suffix kept LAST
                # so the canonical-name mapping still applies
                # (straggler_s -> fleet_straggler_rank_0_s -> _seconds)
                base, unit = key, ""
                for suffix in ("_s", "_pct", "_ms", "_bytes"):
                    if key.endswith(suffix):
                        base, unit = key[: -len(suffix)], suffix
                        break
                for sub, v in value.items():
                    if _num(v) is not None:
                        fleet_flat[f"fleet_{base}_rank_{sub}{unit}"] = v
        parts.append(({}, {}, fleet_flat))
        return prometheus.render_multi(parts)

    # ------------------------------------------------------------- serving
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            daemon=True,
                                            name="lgbm-tpu-aggregate")
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:   # the poller must never die
                Log.warning("aggregator poll failed: %s", e)
            self._stop.wait(self.poll_s)

    def serve(self, port, host="127.0.0.1"):
        """Bind the HTTP view (trainz.py's daemon-thread pattern);
        returns the server or None on bind failure."""
        agg = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                Log.debug("aggregate: " + fmt, *args)

            def _send(self, code, data, content_type):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                fmt = ("prometheus" if "format=prometheus" in self.path
                       else "json")
                try:
                    if path.startswith("/healthz"):
                        snap = agg.snapshot()
                        ok = {hp: d.get("ok", False)
                              for hp, d in snap["targets"].items()}
                        self._send(200, json.dumps(
                            {"status": "ok", "polls": snap["polls"],
                             "targets": ok}).encode(),
                            "application/json")
                    elif path.startswith("/metricz"):
                        if fmt == "prometheus":
                            self._send(200, agg.prometheus().encode(),
                                       prometheus.CONTENT_TYPE)
                        else:
                            self._send(200, json.dumps(
                                agg.snapshot(), default=str).encode(),
                                "application/json")
                    elif path.startswith("/fleetz"):
                        self._send(200, json.dumps(
                            agg.snapshot(), default=str).encode(),
                            "application/json")
                    elif path.startswith("/tracez"):
                        if agg.trace_collector is None:
                            self._send(404, json.dumps(
                                {"error": "tracing not configured "
                                          "(start with --trace-dir)"}
                            ).encode(), "application/json")
                        else:
                            self._send(200, json.dumps(
                                agg.trace_collector.tracez(),
                                default=str).encode(),
                                "application/json")
                    else:
                        self._send(404, json.dumps(
                            {"error": f"unknown path {self.path}"}
                        ).encode(), "application/json")
                except Exception as e:   # a scrape race must not 500-loop
                    self._send(500, json.dumps(
                        {"error": str(e)}).encode(), "application/json")

        try:
            srv = ThreadingHTTPServer((host, int(port)), Handler)
        except OSError as e:
            Log.warning("aggregator bind failed (%s:%s): %s",
                        host, port, e)
            return None
        srv.daemon_threads = True
        threading.Thread(target=srv.serve_forever, daemon=True,
                         name="lgbm-tpu-aggregate-http").start()
        self._server = srv
        Log.info("fleet aggregator on http://%s:%d/fleetz (%d targets)",
                 host, srv.server_address[1], len(self.targets))
        return srv

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2 * self.poll_s, 1.0))
            self._thread = None
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except Exception:
                pass
            self._server = None


def fleet_view(state):
    """Cross-target rollup of one poll's scrape docs. Training ranks:
    max/sum sync wait with per-rank straggler deltas (cumulative wait
    minus the fleet's fastest — delta ~0 marks the straggler itself),
    min comm/prefetch overlap, iteration lag (max - min completed
    iteration: a lagging rank is mid-collective while peers wait).
    Serving replicas: worst p99 (max is the honest cross-replica p99
    merge — the true fleet p99 lies at or below it), summed
    request/error counts."""
    fleet = {"train_ranks": 0, "serve_replicas": 0, "routers": 0,
             "unreachable": 0}
    sync_waits, overlaps, prefetch, iters = {}, {}, {}, {}
    p99s, req_total, err_total = [], 0, 0
    rt_retries = rt_hedges = rt_breaker_opens = rt_shed = 0
    rt_healthy = []
    for host_port, doc in sorted(state.items()):
        if not doc.get("ok"):
            fleet["unreachable"] += 1
            continue
        data = doc.get("data") or {}
        if doc["role"] == "router":
            # the front door's own rollup: how hard is the resilience
            # layer working (retries/hedges/breaker flips) and how much
            # of the fleet it still considers routable
            fleet["routers"] += 1
            rt_retries += int(_num(data.get("retry_count"), 0) or 0)
            rt_hedges += int(_num(data.get("hedge_count"), 0) or 0)
            rt_breaker_opens += int(
                _num(data.get("breaker_open_count"), 0) or 0)
            rt_shed += int(_num(data.get("no_replica_count"), 0) or 0)
            healthy = _num(data.get("healthy_replica_count"))
            if healthy is not None:
                rt_healthy.append(int(healthy))
        elif doc["role"] == "train":
            fleet["train_ranks"] += 1
            label = doc.get("label", host_port)
            comm = data.get("comm") or {}
            wait = _num(comm.get("cum_wait_s"))
            if wait is None:
                hist = ((data.get("metrics") or {}).get("histograms")
                        or {}).get("sync_wait_s") or {}
                wait = _num(hist.get("total"))
            if wait is not None:
                sync_waits[label] = wait
            ov = _num(comm.get("overlap_pct"))
            if ov is not None:
                overlaps[label] = ov
            pf = _num(((data.get("metrics") or {}).get("gauges")
                       or {}).get("prefetch_overlap_pct"))
            if pf is not None:
                prefetch[label] = pf
            it = _num(data.get("iteration"))
            if it is not None:
                iters[label] = it
        else:
            fleet["serve_replicas"] += 1
            p99 = _num(data.get("latency_p99_ms"))
            if p99 is not None:
                p99s.append(p99)
            req_total += int(_num(data.get("request_count"), 0) or 0)
            err_total += int(_num(data.get("error_count"), 0) or 0)
    if sync_waits:
        fleet["max_sync_wait_s"] = round(max(sync_waits.values()), 6)
        fastest = min(sync_waits.values())
        fleet["straggler_s"] = {r: round(w - fastest, 6)
                                for r, w in sorted(sync_waits.items())}
    if overlaps:
        fleet["min_comm_overlap_pct"] = round(min(overlaps.values()), 2)
    if prefetch:
        fleet["min_prefetch_overlap_pct"] = round(
            min(prefetch.values()), 2)
    if len(iters) >= 2:
        fleet["iteration_lag"] = int(max(iters.values())
                                     - min(iters.values()))
    if p99s:
        fleet["worst_latency_p99_ms"] = round(max(p99s), 4)
    if fleet["serve_replicas"]:
        fleet["request_count"] = req_total
        fleet["error_count"] = err_total
    if fleet["routers"]:
        fleet["router_retry_count"] = rt_retries
        fleet["router_hedge_count"] = rt_hedges
        fleet["router_breaker_open_count"] = rt_breaker_opens
        fleet["router_no_replica_count"] = rt_shed
        if rt_healthy:
            fleet["router_min_healthy_replicas"] = min(rt_healthy)
    return fleet


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.telemetry.aggregate",
        description="Fleet telemetry aggregator: scrape every rank's "
                    "/trainz and every replica's /metricz into one "
                    "merged snapshot (JSON + labeled Prometheus).")
    ap.add_argument("targets", nargs="+",
                    help="scrape targets, [role=]host:port "
                         "(role: train|serve|auto)")
    ap.add_argument("--port", type=int, default=None,
                    help="bind port for /fleetz + /metricz (default: "
                         "the `aggregate_port` config knob, 0 = "
                         "ephemeral)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--poll-s", type=float, default=2.0)
    ap.add_argument("--timeout-s", type=float, default=5.0)
    ap.add_argument("--once", action="store_true",
                    help="poll once, print the merged JSON, exit")
    ap.add_argument("--trace-dir", default="",
                    help="telemetry dir the fleet's trace journals "
                         "land in; enables /tracez (stitched "
                         "cross-process request traces)")
    args = ap.parse_args(argv)
    if args.port is None:
        # the `aggregate_port` knob is the documented default for this
        # CLI (config.py); imported lazily — --help shouldn't need it
        from ..config import Config
        args.port = int(Config().aggregate_port)
    try:
        agg = FleetAggregator(args.targets, poll_s=args.poll_s,
                              timeout_s=args.timeout_s,
                              trace_dir=args.trace_dir or None)
    except ValueError as e:
        print(f"aggregate: {e}", file=sys.stderr)
        return 2
    if args.once:
        print(json.dumps(agg.poll_once(), indent=2, default=str))
        return 0
    srv = agg.serve(args.port, host=args.host)
    if srv is None:
        return 1
    # the parseable readiness line tests and wrappers key off
    print(f"AGGREGATE listening on http://{args.host}:"
          f"{srv.server_address[1]}/fleetz", flush=True)
    agg.poll_once()
    agg.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        agg.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
