"""Chrome trace-event export: the run journal as one zoomable timeline
(the port's copy of lightgbm_tpu/telemetry/export.py, with the command
line of the JAX package's tools/export_trace.py as `main`).

`python -m lightgbm_tpu_torch.telemetry.export <journal dir>` turns a
run's journal files
(plus the tracer's span-ring dump when `telemetry_trace=true`) into
trace-event JSON (the Chrome `chrome://tracing` / Perfetto format), so
a multi-rank crash → restart → resume run reads as one timeline:

- one **process track per rank** (pid = rank, named `rank N`), with a
  `train` thread for training records and a `supervisor` thread for
  the supervisor's restart bookkeeping (`source:"supervisor"`);
- **iteration / fused-block records** become duration slices whose
  children are the record's per-phase deltas laid end to end — the
  per-iteration breakdown, zoomable;
- **checkpoints** (`write_s`) and **compiles** (`seconds`) are slices;
  **aborts / restarts / resumes / run boundaries** are flagged instant
  events, so the watchdog's exit-117 story is visible at a glance;
- **grad/hess norms, leaf counts, metric values, memory watermarks
  and model-quality deltas** (`quality` records: gain/split deltas,
  importance shift, eval values, drift psi_max / skew counts) become
  counter tracks (Perfetto plots them);
- a journal `spans` record (the recent-span ring dumped at close)
  becomes fine-grained slices on per-thread lanes — concurrent
  batcher/heartbeat threads get their own tracks via the span tid;
- **`comm` records** (collective latency attribution,
  telemetry/comm_profile.py) get a dedicated `comm` lane per rank:
  one slice per collective wait, a `comm_overlap` counter track, and
  cross-rank **flow events** (the Chrome `s`/`t`/`f` arrows)
  connecting the SAME iteration's matching collective slice on every
  rank — a hung or skewed exchange is a visibly broken/stretched
  arrow between rank tracks.

Everything maps through wall-clock epoch seconds (journal `ts`; span
offsets + the dump's `epoch_ts`), rebased to the run's first event so
Perfetto opens at t=0. Output is a single JSON object
(`{"traceEvents": [...]}`), valid for Perfetto's legacy-JSON loader.
stdlib-only, like the rest of the telemetry package.

    python -m lightgbm_tpu_torch.telemetry.export <dir-or-jsonl> [-o trace.json]
    python -m lightgbm_tpu_torch.telemetry.export <dir> --validate

Exit codes: 0 = written (and valid), 1 = invariant violations in the
built trace, 2 = no journal records found.
"""

import argparse
import json
import os
import sys

from . import journal as journal_mod

# fixed thread lanes inside each rank's process track
TID_TRAIN = 0
TID_SUPERVISOR = 1
TID_COMM = 2         # collective wait slices (`comm` records)
TID_TRACE = 3        # distributed-request spans (`trace` records)
TID_SPAN_BASE = 16   # span recording threads map to 16, 17, ...

_INSTANT_EVENTS = {"run_start", "run_end", "resume", "truncate",
                   "abort", "restart", "note", "config", "mesh",
                   "promote", "reject", "rollback"}


def collect_records(source):
    """Journal records from a directory (every `journal.rank*.jsonl`;
    the merged file is redundant with them) or a single JSONL file.
    Returns (records, n_torn)."""
    source = os.fspath(source)
    paths = ([source] if os.path.isfile(source)
             else journal_mod.rank_files(source))
    if not paths and os.path.isdir(source):
        merged = os.path.join(source, journal_mod.MERGED_NAME)
        if os.path.exists(merged):
            paths = [merged]
    records, torn = [], 0
    for path in paths:
        recs, bad = journal_mod.read_journal(path)
        records.extend(recs)
        torn += bad
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records, torn


def _num(v, default=0.0):
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else default


class _TraceBuilder:
    def __init__(self, t0):
        self.t0 = t0
        self.events = []
        self._procs = {}       # rank -> set of named tids
        self._span_tids = {}   # (rank, raw span tid) -> lane

    def _us(self, ts):
        return max(0, int(round((ts - self.t0) * 1e6)))

    def _ensure_thread(self, rank, tid, name):
        rank = int(rank)
        named = self._procs.setdefault(rank, set())
        if not named:
            self.events.append({"name": "process_name", "ph": "M",
                                "pid": rank, "tid": 0,
                                "args": {"name": f"rank {rank}"}})
        if tid not in named:
            named.add(tid)
            self.events.append({"name": "thread_name", "ph": "M",
                                "pid": rank, "tid": tid,
                                "args": {"name": name}})

    def _span_lane(self, rank, raw_tid):
        key = (int(rank), raw_tid)
        lane = self._span_tids.get(key)
        if lane is None:
            lane = TID_SPAN_BASE + len(
                [k for k in self._span_tids if k[0] == int(rank)])
            self._span_tids[key] = lane
            self._ensure_thread(rank, lane, f"spans thread-{raw_tid}")
        return lane

    def slice(self, rank, tid, name, start_ts, dur_s, args=None):
        self.events.append({"name": str(name), "ph": "X", "cat": "journal",
                            "ts": self._us(start_ts),
                            "dur": max(1, int(round(dur_s * 1e6))),
                            "pid": int(rank), "tid": tid,
                            **({"args": args} if args else {})})

    def instant(self, rank, tid, name, ts, args=None):
        self.events.append({"name": str(name), "ph": "i", "cat": "journal",
                            "s": "p",   # process-scoped flag line
                            "ts": self._us(ts), "pid": int(rank),
                            "tid": tid,
                            **({"args": args} if args else {})})

    def counter(self, rank, name, ts, values):
        values = {k: _num(v) for k, v in values.items()
                  if isinstance(v, (int, float))
                  and not isinstance(v, bool)}
        if values:
            self.events.append({"name": str(name), "ph": "C",
                                "cat": "journal", "ts": self._us(ts),
                                "pid": int(rank), "tid": TID_TRAIN,
                                "args": values})


def build_trace(records):
    """Journal records (any order; each carries `rank`/`ts`) -> the
    trace-event JSON object. Raises ValueError when there is nothing
    to export."""
    records = [r for r in records
               if isinstance(r, dict) and isinstance(r.get("ts"),
                                                     (int, float))]
    if not records:
        raise ValueError("no journal records to export")
    records.sort(key=lambda r: r["ts"])
    # rebase to the earliest wall time any event can start: iteration /
    # checkpoint / compile slices start their duration BEFORE the
    # record's ts, and a spans dump can reach back to its tracer epoch
    # — missing one would clamp that slice at t=0 and shift its end
    t0 = records[0]["ts"]
    for rec in records:
        event = rec.get("event")
        if event == "iteration":
            t0 = min(t0, rec["ts"] - sum(
                _num(v) for v in (rec.get("phases") or {}).values()))
        elif event == "checkpoint":
            t0 = min(t0, rec["ts"] - _num(rec.get("write_s")))
        elif event == "compile":
            t0 = min(t0, rec["ts"] - _num(rec.get("seconds")))
        elif event == "spans":
            starts = [_num(s.get("start_s")) for s in rec.get("spans", [])
                      if isinstance(s, dict)]
            if starts:
                t0 = min(t0, _num(rec.get("epoch_ts"), t0) + min(starts))
        elif event == "trace":
            # request spans carry their own wall start, earlier than
            # the journal ts the fragment was flushed at
            t0 = min(t0, _num(rec.get("start"), rec["ts"]))
    b = _TraceBuilder(t0)
    # (iteration, collective) -> [(rank, anchor_ts_us)] for the
    # cross-rank flow pass below
    comm_anchors = {}
    # trace_id -> [(anchor_ts_us, rank)] for the cross-process
    # request-flow pass (router track -> replica track arrows)
    trace_anchors = {}

    for rec in records:
        event = rec.get("event")
        rank = int(rec.get("rank", 0) or 0)
        ts = rec["ts"]
        supervisor = rec.get("source") == "supervisor"
        tid = TID_SUPERVISOR if supervisor else TID_TRAIN
        b._ensure_thread(rank, tid,
                         "supervisor" if supervisor else "train")

        if event == "iteration":
            phases = {k: _num(v) for k, v in (rec.get("phases")
                                              or {}).items()}
            dur = sum(phases.values())
            it = rec.get("iteration", 0)
            name = (f"block -> iter {it}" if rec.get("fused")
                    else f"iteration {it}")
            args = {k: rec[k] for k in ("iteration", "block", "leaf_count",
                                        "compile_cache_hit")
                    if k in rec and rec[k] is not None}
            b.slice(rank, tid, name, ts - dur, max(dur, 1e-6), args)
            cursor = ts - dur
            for pname, psecs in phases.items():
                if psecs > 0:
                    b.slice(rank, tid, pname, cursor, psecs)
                    cursor += psecs
            b.counter(rank, "training_health", ts,
                      {k: rec[k] for k in ("grad_norm", "hess_norm",
                                           "leaf_count") if k in rec})
            comm = rec.get("collective_bytes")
            if isinstance(comm, dict):
                # meshed-learner wire-byte track (parallel/mesh.py
                # CommPlan deltas): plots hist_reduce/split_gather/
                # leaf_sync next to the phase slices, so a comms-bound
                # iteration is visible at a glance
                vals = {k: v for k, v in comm.items()
                        if isinstance(v, (int, float))}
                if vals:
                    b.counter(rank, "collective_bytes", ts, vals)
        elif event == "comm":
            # one slice per collective wait on the rank's comm lane,
            # laid end to end backwards from the record's ts (the
            # per-phase convention); each slice's midpoint is the flow
            # anchor — the arrow binds to the enclosing slice
            b._ensure_thread(rank, TID_COMM, "comm")
            waits = {k: _num(v) for k, v in (rec.get("waits")
                                             or {}).items()}
            it = rec.get("iteration", 0)
            cursor = ts - sum(waits.values())
            for cname, csecs in sorted(waits.items()):
                if csecs <= 0:
                    continue
                b.slice(rank, TID_COMM, cname, cursor, csecs,
                        {"iteration": it})
                anchor = b._us(cursor + csecs / 2.0)
                comm_anchors.setdefault((it, cname), []).append(
                    (rank, anchor))
                cursor += csecs
            b.counter(rank, "comm_overlap", ts,
                      {k: rec[k] for k in ("overlap_pct", "wait_s",
                                           "dispatch_s") if k in rec})
        elif event == "metrics":
            b.counter(rank, "metrics", ts, rec.get("values") or {})
        elif event == "quality":
            # model-quality counter track (quality_telemetry knob):
            # split/gain deltas, importance drift, plus the serving-
            # side psi_max/skew_count when a drift e2e journaled them;
            # the record's eval values ride the same track so the
            # metric curve lines up with the gain curve
            vals = {k: rec[k] for k in ("gain_total", "splits", "trees",
                                        "importance_shift", "psi_max",
                                        "skew_count") if k in rec}
            vals.update(rec.get("values") or {})
            b.counter(rank, "quality", ts, vals)
        elif event == "memory":
            b.counter(rank, "memory_bytes", ts,
                      {k: rec[k] for k in ("device_bytes_in_use",
                                           "device_peak_bytes",
                                           "host_rss_bytes",
                                           "host_peak_rss_bytes")
                       if k in rec})
        elif event == "checkpoint":
            dur = _num(rec.get("write_s"), 1e-6)
            b.slice(rank, tid, f"checkpoint @{rec.get('iteration')}",
                    ts - dur, dur, {"path": str(rec.get("path", ""))})
        elif event == "compile":
            dur = _num(rec.get("seconds"), 0.0)
            label = rec.get("label") or "jit"
            b.slice(rank, tid, f"compile {label}", ts - dur,
                    max(dur, 1e-6),
                    {"cache_hit": bool(rec.get("cache_hit"))})
        elif event == "trace":
            # one distributed-request span per record on the rank's
            # `requests` lane; the trace_id groups them and the flow
            # pass below draws the cross-process arrows
            trace_id = rec.get("trace_id")
            if not isinstance(trace_id, str) or not trace_id:
                continue
            b._ensure_thread(rank, TID_TRACE, "requests")
            dur = max(_num(rec.get("duration_s")), 1e-6)
            start = _num(rec.get("start"), ts)
            args = {"trace_id": trace_id,
                    "span_id": rec.get("span_id", ""),
                    "status": rec.get("status", "ok"),
                    "service": rec.get("service", "")}
            tags = rec.get("tags")
            if isinstance(tags, dict) and tags:
                args["tags"] = tags
            b.slice(rank, TID_TRACE, rec.get("name", "span"),
                    start, dur, args)
            trace_anchors.setdefault(trace_id, []).append(
                (b._us(start + dur / 2.0), rank))
        elif event == "spans":
            epoch = _num(rec.get("epoch_ts"), ts)
            for span in rec.get("spans") or []:
                if not isinstance(span, dict):
                    continue
                dur = _num(span.get("duration_s"), 0.0)
                lane = b._span_lane(rank, span.get("tid", 0))
                b.slice(rank, lane, span.get("name", "span"),
                        epoch + _num(span.get("start_s")), max(dur, 1e-6),
                        {"path": span.get("path", "")})
        elif event in _INSTANT_EVENTS:
            args = {k: v for k, v in rec.items()
                    if k not in ("ts", "event", "rank") and v is not None}
            name = event
            if event == "abort":
                name = f"abort exit={rec.get('exit_code')}"
            elif event == "restart":
                name = f"restart attempt={rec.get('attempt')}"
            elif event == "resume":
                name = f"resume @{rec.get('iteration')}"
            elif event == "mesh":
                # mesh (re-)derivation marker: across an elastic shrink
                # the shards/f_loc args change between two of these
                name = f"mesh {rec.get('shards')} shard(s)"
            elif event in ("promote", "reject", "rollback"):
                # fleet registry transitions: model generations as
                # markers on the same timeline as training progress
                name = f"{event} v{rec.get('version')}"
            b.instant(rank, tid, name, ts, args or None)
        # unknown events are skipped: the exporter must keep working on
        # journals from a newer schema

    # cross-rank flow events: one arrow chain per (iteration,
    # collective) that >= 2 ranks recorded — start (`s`) on the
    # lowest rank's slice, steps (`t`) through the middle, finish
    # (`f`) on the last; matching name+cat+id is what the Chrome/
    # Perfetto loaders chain on, and each event's ts lies inside its
    # rank's slice so the arrow binds to it
    flow_id = 0
    for (it, cname), anchors in sorted(comm_anchors.items()):
        ranks = sorted(set(anchors))
        if len({r for r, _ in ranks}) < 2:
            continue
        flow_id += 1
        last = len(ranks) - 1
        for idx, (rank, ts_us) in enumerate(ranks):
            ph = "s" if idx == 0 else ("f" if idx == last else "t")
            ev = {"name": f"{cname} it{it}", "ph": ph,
                  "cat": "comm_flow", "id": flow_id, "pid": rank,
                  "tid": TID_COMM, "ts": ts_us}
            if ph == "f":
                ev["bp"] = "e"   # bind to the enclosing slice
            b.events.append(ev)

    # cross-process request flows: one arrow chain per trace_id whose
    # spans landed on >= 2 process tracks (router pid -> replica pid).
    # String flow ids ("trace:<id>") keep the namespace disjoint from
    # the integer comm-flow ids above; same one-`s`-one-`f` rule
    for trace_id, anchors in sorted(trace_anchors.items()):
        anchors = sorted(set(anchors))
        if len({r for _, r in anchors}) < 2:
            continue
        last = len(anchors) - 1
        for idx, (ts_us, rank) in enumerate(anchors):
            ph = "s" if idx == 0 else ("f" if idx == last else "t")
            ev = {"name": f"request {trace_id[:8]}", "ph": ph,
                  "cat": "trace_flow", "id": f"trace:{trace_id}",
                  "pid": rank, "tid": TID_TRACE, "ts": ts_us}
            if ph == "f":
                ev["bp"] = "e"
            b.events.append(ev)

    # stable nesting: same-timestamp slices sort longest-first so
    # children fall inside their parent when Perfetto infers stacks
    b.events.sort(key=lambda e: (e.get("pid", 0), e.get("tid", 0),
                                 e.get("ts", 0), -e.get("dur", 0)))
    return {"traceEvents": b.events, "displayTimeUnit": "ms"}


def validate_trace(trace):
    """Invariant check of a built/loaded trace object; returns a list
    of error strings (empty = valid). `main --validate` runs it on the
    built trace."""
    errors = []
    if not isinstance(trace, dict):
        return ["trace is not an object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errors.append(f"event {i}: not an object")
            continue
        if not isinstance(e.get("name"), str) or not e.get("name"):
            errors.append(f"event {i}: missing name")
        if e.get("ph") not in ("X", "i", "C", "M", "s", "t", "f"):
            errors.append(f"event {i}: unknown phase {e.get('ph')!r}")
        if e.get("ph") != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errors.append(f"event {i}: bad ts {ts!r}")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                errors.append(f"event {i}: missing int {key}")
        if e.get("ph") == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur <= 0:
                errors.append(f"event {i}: X event needs dur > 0")
        if e.get("ph") in ("s", "t", "f"):
            # flow events must carry a binding id, and a flow id used
            # by only one event draws nothing — every id needs a
            # start AND a finish
            if not isinstance(e.get("id"), (int, str)):
                errors.append(f"event {i}: flow event needs an id")
        if e.get("ph") == "C":
            # counter tracks (training_health, metrics, memory_bytes,
            # quality) must carry a non-empty all-numeric args dict —
            # Perfetto silently drops anything else
            args = e.get("args")
            if not isinstance(args, dict) or not args:
                errors.append(f"event {i}: C event needs non-empty args")
            elif any(not isinstance(v, (int, float))
                     or isinstance(v, bool) for v in args.values()):
                errors.append(f"event {i}: C event args must be numeric")
    flows = {}
    for e in events:
        if isinstance(e, dict) and e.get("ph") in ("s", "t", "f"):
            flows.setdefault(e.get("id"), []).append(e.get("ph"))
    for fid, phases in flows.items():
        if phases.count("s") != 1 or phases.count("f") != 1:
            errors.append(f"flow id {fid!r}: needs exactly one 's' and "
                          f"one 'f', got {sorted(phases)}")
    try:
        json.dumps(trace, allow_nan=False)
    except (TypeError, ValueError) as exc:
        errors.append(f"not strict-JSON serializable: {exc}")
    return errors


def export_trace(source, out_path=None):
    """Journal dir/file -> trace JSON written to `out_path` (default
    `<dir>/trace.json`). Returns (trace_object, out_path)."""
    records, torn = collect_records(source)
    if torn:
        from ..utils.log import Log
        Log.warning("trace export: skipped %d torn journal line(s)", torn)
    trace = build_trace(records)
    if out_path is None:
        base = source if os.path.isdir(source) else os.path.dirname(source)
        out_path = os.path.join(base or ".", "trace.json")
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(trace, f, separators=(",", ":"), allow_nan=False)
    os.replace(tmp, out_path)
    return trace, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.telemetry.export",
        description="Run journal -> Chrome trace-event JSON")
    ap.add_argument("source",
                    help="journal directory (rank files) or one .jsonl")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default <dir>/trace.json)")
    ap.add_argument("--validate", action="store_true",
                    help="run the trace invariant check after export")
    args = ap.parse_args(argv)

    try:
        trace, out_path = export_trace(args.source, args.out)
    except ValueError as e:
        print(f"export_trace: {e}", file=sys.stderr)
        return 2
    events = trace["traceEvents"]
    ranks = sorted({e.get("pid") for e in events})
    named = sum(e.get("ph") == "M" for e in events)
    span_ms = max((e.get("ts", 0) + e.get("dur", 0)
                   for e in events if e.get("ph") != "M"), default=0) / 1e3
    print(f"export_trace: {len(events)} events ({named} metadata), "
          f"{len(ranks)} rank track(s) {ranks}, {span_ms:.1f} ms span "
          f"-> {out_path}")
    if args.validate:
        errors = validate_trace(trace)
        for err in errors:
            print(f"export_trace: INVALID: {err}", file=sys.stderr)
        if errors:
            return 1
        print("export_trace: trace invariants OK")
    print("open in https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
