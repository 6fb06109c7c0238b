"""Structured run journal: the append-only JSONL training timeline (the
port's copy of lightgbm_tpu/telemetry/journal.py, record for record).

One record per completed boosting iteration (or per fused block: the
block is one captured CUDA graph replayed T times, so per-iteration host
phases do not exist inside it) plus run-start / config / checkpoint /
resume / abort / restart / run-end events, all in one file, so a
supervisor restart or a watchdog abort (exit 117/118,
parallel/heartbeat.py) lands in the same timeline as training progress.

Write discipline:

- one file per rank (`journal.rank0000.jsonl`) in a shared directory;
- every record is ONE `os.write` of a complete line to an O_APPEND fd:
  appends from concurrent processes (the training child and its
  supervisor share rank files) interleave at line granularity, and an
  `os._exit` kill (utils/faults.py hard_crash) loses at most the record
  being written;
- readers (`read_journal`) skip unparseable lines, so a resumed run
  appends past a torn tail;
- rank 0 merges all rank files into `journal.jsonl` in wall-time order
  (`merge_journals`) at the end of training.

The records keep the JAX package's shapes (`SCHEMA`), so its
`validate_record` and `merge_journals` accept the port's files and its
aggregator reads them. Distributed tracing (telemetry/disttrace.py)
writes its `trace` records through the same class. stdlib only.
"""

import glob
import json
import os
import threading
import time

from ..utils.log import Log

SCHEMA_VERSION = 1
MERGED_NAME = "journal.jsonl"

# --------------------------------------------------------------- schema
#
# Per-event REQUIRED fields (name -> type). Every record also carries
# the COMMON fields. OPTIONAL fields are type-checked when present;
# unknown extra fields are allowed (forward compatibility), unknown
# event names are not.

COMMON_FIELDS = {"ts": float, "event": str, "rank": int}

# present on every record written by this version, but OPTIONAL in the
# schema so journals from older runs stay valid: `mono` is the writing
# process's time.monotonic() — within one rank it orders records even
# when the wall clock steps (NTP slew, a skewed host), which is what
# `merge_journals` sorts each rank file by before interleaving ranks
OPTIONAL_COMMON_FIELDS = {"mono": float, "source": str}

SCHEMA = {
    "run_start": {"required": {"schema": int, "pid": int},
                  "optional": {"run_id": str, "argv": list,
                               "num_ranks": int, "source": str}},
    "config": {"required": {"params": dict}, "optional": {}},
    "iteration": {"required": {"iteration": int},
                  "optional": {"phases": dict, "block": int,
                               "grad_norm": float, "hess_norm": float,
                               "leaf_count": int,
                               "compile_cache_hit": bool,
                               "fused": bool,
                               # out-of-core streaming (data/ooc_learner)
                               "prefetch_wait_s": float,
                               "prefetch_bytes": int,
                               "prefetch_overlap_pct": float,
                               # per-kind collective wire bytes this
                               # iteration (parallel/mesh.py CommPlan)
                               "collective_bytes": dict}},
    "metrics": {"required": {"iteration": int, "values": dict},
                "optional": {}},
    # model-quality deltas per iteration/block (`quality_telemetry`
    # knob; telemetry/quality.py QualityTracker): split ledger deltas,
    # top features by gain, leaf-value distribution of the new trees,
    # normalized-gain-importance L1 shift, latest eval values; the
    # serving-side drift e2e also journals psi_max/skew_count here
    "quality": {"required": {"iteration": int},
                "optional": {"trees": int, "splits": int,
                             "gain_total": float, "top_gain": dict,
                             "leaf_values": dict,
                             "importance_shift": float, "values": dict,
                             "psi_max": float, "skew_count": int,
                             "source": str}},
    "checkpoint": {"required": {"iteration": int, "path": str},
                   "optional": {"write_s": float}},
    "resume": {"required": {"iteration": int},
               "optional": {"path": str, "source": str}},
    "truncate": {"required": {"iteration": int, "dropped_iters": int},
                 "optional": {"reason": str}},
    "abort": {"required": {"exit_code": int, "reason": str},
              "optional": {"collective": str, "iteration": int,
                           "dead_ranks": list, "source": str}},
    "restart": {"required": {"attempt": int, "exit_code": int},
                "optional": {"reason": str, "survivors": list,
                             "new_rank": int, "source": str,
                             # world shrank: the relaunch re-derives
                             # the mesh and feature ownership
                             "mesh_reshard": bool}},
    # one record per meshed-learner incarnation (parallel/learners.py):
    # shard count + feature ownership — across an elastic shrink the
    # journal shows the mesh re-sharding, not just the machine list
    "mesh": {"required": {"shards": int},
             "optional": {"processes": int, "precision": str,
                          "exchange": str, "f_pad": int, "f_loc": int,
                          "learner": str, "source": str}},
    # one record per out-of-core learner incarnation: this rank's owned
    # block range over the shared store (data/ooc_learner.py). Across
    # an elastic shrink/grow the journal shows block ownership
    # re-sharding (shards/block_lo/block_hi change, attempt advances)
    # with ZERO `binning` events between — the proof that survivors
    # adopted blocks instead of re-binning
    "block_reshard": {"required": {"blocks": int, "shards": int},
                      "optional": {"rank": int, "block_lo": int,
                                   "block_hi": int, "rows": int,
                                   "attempt": int, "learner": str,
                                   "source": str}},
    # one record per block-store BUILD (the two-round streaming binning
    # pass, data/block_store.py) — elastic restarts assert none of
    # these appear after the first incarnation
    "binning": {"required": {"rows": int, "blocks": int},
                "optional": {"directory": str, "features": int,
                             "build_count": int, "source": str}},
    "run_end": {"required": {"iterations": int},
                "optional": {"train_s": float, "source": str}},
    # per-iteration/block collective latency attribution (`comm_telemetry`
    # knob; telemetry/comm_profile.py): host-visible seconds blocked in
    # each armed collective section since the last record (`waits`),
    # split into pure sync waits (`wait_s` — leaf_count_sync,
    # row_leaf_gather, ...) vs dispatch windows that contain compute
    # (`dispatch_s` — tree_build, fused_block), plus the wall seconds
    # the record covers and the derived comm_overlap_pct
    "comm": {"required": {"iteration": int},
             "optional": {"waits": dict, "wait_s": float,
                          "dispatch_s": float, "wall_s": float,
                          "overlap_pct": float, "source": str}},
    # one compact per-run summary appended to RUN_HISTORY.jsonl
    # (telemetry/history.py) — NOT part of the per-run journal
    # timeline, but the same schema machinery checks it
    "run_summary": {"required": {"kind": str},
                    "optional": {"run_id": str, "label": str,
                                 "platform": str, "rows": int,
                                 "iterations": int, "train_s": float,
                                 "auc": float, "metrics": dict,
                                 "peak_memory_bytes": int,
                                 "collective_bytes": int,
                                 "collective_bytes_per_tree": float,
                                 "comm_overlap_pct": float,
                                 "prefetch_overlap_pct": float,
                                 "serving_p99_ms": float,
                                 "telemetry_overhead_pct": float,
                                 "source": str}},
    # fleet registry transitions: one record per pointer move /
    # quarantine, with the validation metrics that drove the decision
    "promote": {"required": {"version": int},
                "optional": {"from_version": int, "generation": int,
                             "reason": str, "metric": float,
                             "metric_name": str,
                             "incumbent_metric": float, "source": str}},
    "reject": {"required": {"version": int},
               "optional": {"reason": str, "metric": float,
                            "metric_name": str,
                            "incumbent_metric": float, "source": str}},
    "rollback": {"required": {"version": int},
                 "optional": {"from_version": int, "generation": int,
                              "reason": str, "source": str}},
    # device-memory watermarks sampled at iteration/block boundaries
    # (telemetry/ledger.py sample_memory; device_* absent without an
    # initialised card)
    "memory": {"required": {"iteration": int},
               "optional": {"device_bytes_in_use": int,
                            "device_peak_bytes": int,
                            "host_rss_bytes": int,
                            "host_peak_rss_bytes": int}},
    # one set-up entry (telemetry/ledger.py SetupLedger): label names
    # what it was paid for ("serving_bucket_256", a kernel library),
    # seconds its wall time, cache_hit whether a build was found done
    "compile": {"required": {"label": str},
                "optional": {"seconds": float, "cache_hit": bool,
                             "count": int, "source": str}},
    # dump of the tracer's recent-span ring at close (telemetry_trace
    # knob): epoch_ts maps span start offsets to wall time, spans is
    # the Span.as_dict() list (telemetry/trace.py)
    "spans": {"required": {"epoch_ts": float, "spans": list},
              "optional": {"source": str}},
    # one completed distributed-trace span (telemetry/disttrace.py):
    # start is wall epoch seconds (cross-process comparable), links
    # lists other trace_ids a batch span coalesced (the collector
    # follows them when stitching), flags carries the propagated
    # head-sampling bit. The aggregator's TraceCollector stitches
    # these per-process fragments into /tracez trees
    "trace": {"required": {"trace_id": str, "span_id": str,
                           "name": str, "start": float,
                           "duration_s": float},
              "optional": {"parent_span_id": str, "kind": str,
                           "status": str, "flags": int, "tags": dict,
                           "links": list, "service": str,
                           "source": str}},
    "note": {"required": {}, "optional": {"msg": str, "source": str}},
}

# json types are exact; bool is an int subclass in Python, so int
# checks must reject bools while float checks accept ints
_NUMERIC = (int, float)


def _type_ok(value, expected):
    if expected is float:
        return isinstance(value, _NUMERIC) and not isinstance(value, bool)
    if expected is int:
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, expected)


def validate_record(rec):
    """Validate one parsed record against SCHEMA. Returns a list of
    error strings (empty = valid)."""
    errors = []
    if not isinstance(rec, dict):
        return [f"record is not an object: {type(rec).__name__}"]
    for name, typ in COMMON_FIELDS.items():
        if name not in rec:
            errors.append(f"missing common field {name!r}")
        elif not _type_ok(rec[name], typ):
            errors.append(f"field {name!r} has type "
                          f"{type(rec[name]).__name__}, want {typ.__name__}")
    for name, typ in OPTIONAL_COMMON_FIELDS.items():
        if name in rec and rec[name] is not None \
                and not _type_ok(rec[name], typ):
            errors.append(f"common field {name!r} has type "
                          f"{type(rec[name]).__name__}, want {typ.__name__}")
    event = rec.get("event")
    if not isinstance(event, str):
        return errors
    spec = SCHEMA.get(event)
    if spec is None:
        errors.append(f"unknown event {event!r}")
        return errors
    for name, typ in spec["required"].items():
        if name not in rec:
            errors.append(f"{event}: missing required field {name!r}")
        elif not _type_ok(rec[name], typ):
            errors.append(f"{event}: field {name!r} has type "
                          f"{type(rec[name]).__name__}, want {typ.__name__}")
    for name, typ in spec["optional"].items():
        # None is legal anywhere optional: the writer null-sanitizes
        # non-finite floats (JSON has no NaN/Inf literal)
        if name in rec and rec[name] is not None \
                and not _type_ok(rec[name], typ):
            errors.append(f"{event}: optional field {name!r} has type "
                          f"{type(rec[name]).__name__}, want {typ.__name__}")
    if event == "iteration":
        for k, v in (rec.get("phases") or {}).items():
            if v is not None and not _type_ok(v, float):
                errors.append(f"iteration: phases[{k!r}] is not a number")
    return errors


# -------------------------------------------------------------- writing

def _sanitize(value):
    """Deep-replace non-finite floats with None so the record stays
    strict JSON."""
    if isinstance(value, float):
        return value if value == value and abs(value) != float("inf") \
            else None
    if isinstance(value, dict):
        return {k: _sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    return value


def journal_path(directory, rank):
    return os.path.join(os.fspath(directory),
                        f"journal.rank{int(rank):04d}.jsonl")


class RunJournal:
    """One rank's append-only journal (see module docstring).

    `emit_run_start=False` attaches to an EXISTING rank file without
    opening a new run (the supervisor appending restart events, a
    resumed child continuing the timeline). `source` tags every record
    from this writer (e.g. "supervisor")."""

    def __init__(self, directory, rank=0, emit_run_start=True, meta=None,
                 source=None):
        self.directory = os.fspath(directory)
        self.rank = int(rank)
        self.source = source
        self.path = journal_path(self.directory, self.rank)
        self._lock = threading.Lock()
        self._fd = None
        try:
            os.makedirs(self.directory, exist_ok=True)
            self._fd = os.open(self.path,
                               os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                               0o644)
        except OSError as e:
            Log.warning("run journal disabled (cannot open %s: %s)",
                        self.path, e)
        if emit_run_start:
            self.event("run_start", schema=SCHEMA_VERSION, pid=os.getpid(),
                       **(meta or {}))

    @property
    def enabled(self):
        return self._fd is not None

    def event(self, event, **fields):
        """Append one record: a single O_APPEND write of a complete
        line. Never raises — a full disk must not kill training."""
        if self._fd is None:
            return
        rec = {"ts": time.time(), "mono": round(time.monotonic(), 6),
               "event": event, "rank": self.rank}
        if self.source is not None:
            rec["source"] = self.source
        rec.update(fields)
        try:
            line = json.dumps(rec, separators=(",", ":"),
                              allow_nan=False) + "\n"
        except (TypeError, ValueError):
            # NaN/Inf (JSON has no literal for them) or a non-JSON
            # value: sanitize rather than drop the record — readers
            # need every line to parse
            line = json.dumps(_sanitize(rec), separators=(",", ":"),
                              allow_nan=False, default=str) + "\n"
        try:
            os.write(self._fd, line.encode("utf-8"))
        except OSError as e:
            Log.warning("journal write failed (%s): %s", self.path, e)

    def iteration(self, iteration, phases=None, **fields):
        if phases:
            fields["phases"] = phases
        self.event("iteration", iteration=int(iteration), **fields)

    def close(self):
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None

    def __del__(self):
        # Python-API runs may drop a booster without an explicit
        # close_telemetry(); the raw fd must not outlive the journal
        try:
            self.close()
        except Exception:
            pass


# -------------------------------------------------------------- reading

def read_journal(path, strict=False):
    """Parse one JSONL journal file. Torn/garbled lines are skipped
    (and counted) unless `strict`; returns (records, n_bad)."""
    records, bad = [], 0
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    bad += 1
                    if strict:
                        raise
    except OSError:
        return [], 0
    return records, bad


def rank_files(directory):
    return sorted(glob.glob(os.path.join(os.fspath(directory),
                                         "journal.rank*.jsonl")))


def tail(path, n=20):
    """Last `n` parsed records of a journal file (newest last)."""
    records, _ = read_journal(path)
    return records[-int(n):]


def detect_clock_skew(per_rank_records):
    """Cross-rank wall-clock skew estimate from a merged run's records:
    the same completed iteration N is a near-synchronization point
    across ranks (a data-parallel iteration cannot finish on one rank
    while peers are still many seconds inside it — the collectives
    serialize them), so the spread of `iteration`-record wall
    timestamps at the same iteration index, minimized over iterations,
    bounds the wall-clock disagreement. Straggling inflates individual
    spreads, which is why the MINIMUM over iterations is the estimate.
    Returns (skew_s, iteration) or (0.0, None) with fewer than two
    ranks' worth of matching records."""
    by_iter = {}
    for rank, records in per_rank_records.items():
        for rec in records:
            if rec.get("event") != "iteration":
                continue
            it = rec.get("iteration")
            ts = rec.get("ts")
            if isinstance(it, int) and isinstance(ts, (int, float)):
                # last record per (rank, iteration): restarts replay
                by_iter.setdefault(it, {})[rank] = float(ts)
    best = None
    for it, ranks in by_iter.items():
        if len(ranks) < 2:
            continue
        spread = max(ranks.values()) - min(ranks.values())
        if best is None or spread < best[0]:
            best = (spread, it)
    return best if best is not None else (0.0, None)


def merge_journals(directory, out_path=None, skew_threshold_s=2.0):
    """Merge every rank's journal into one timeline (rank 0 calls this
    at end of training).

    Each rank file is first ordered by its own `mono` timestamps (wall
    clocks can step mid-run; monotonic time cannot), then ranks are
    interleaved by wall time — the only cross-host ordering available.
    When the cross-rank wall-clock skew estimate (`detect_clock_skew`)
    exceeds `skew_threshold_s`, the merge does not silently interleave
    a lie: it logs a warning and appends a `note` record naming the
    measured skew so readers of the merged timeline know cross-rank
    order is unreliable at that scale. Returns the merged path or None
    when there was nothing to merge."""
    files = rank_files(directory)
    if not files:
        return None
    per_rank = {}
    for path in files:
        records, bad = read_journal(path)
        if bad:
            Log.warning("journal merge: skipped %d torn line(s) in %s",
                        bad, path)
        # within-rank order IS file order: O_APPEND writes land in real
        # time order even when the supervisor and child co-write one
        # rank file, and a stepped wall clock cannot reorder them. Do
        # NOT sort by `mono` here — CLOCK_MONOTONIC resets on reboot,
        # so a crash -> reboot -> resume run's resumed records would
        # sort before its pre-crash ones. `mono` exists for readers
        # comparing two records of one incarnation.
        per_rank[path] = records
    # k-way interleave by wall time that NEVER reorders within a rank:
    # wall clocks only decide which rank's next record comes first —
    # each rank's own append-ordered stream is consumed in order even
    # when its wall clock stepped backwards mid-run
    import heapq
    streams = [recs for recs in per_rank.values() if recs]
    heap = [(recs[0].get("ts", 0.0), i, 0)
            for i, recs in enumerate(streams)]
    heapq.heapify(heap)
    merged = []
    while heap:
        _, i, pos = heapq.heappop(heap)
        merged.append(streams[i][pos])
        if pos + 1 < len(streams[i]):
            heapq.heappush(heap, (streams[i][pos + 1].get("ts", 0.0),
                                  i, pos + 1))
    skew_s, skew_iter = detect_clock_skew(per_rank)
    if skew_s > skew_threshold_s:
        Log.warning(
            "journal merge: cross-rank wall-clock skew ~%.2fs "
            "(iteration %s timestamps disagree by that much; threshold "
            "%.1fs) — cross-rank ordering in the merged timeline is "
            "unreliable, trust within-rank order only", skew_s,
            skew_iter, skew_threshold_s)
        merged.append({"ts": time.time(),
                       "mono": round(time.monotonic(), 6),
                       "event": "note", "rank": 0,
                       "msg": (f"clock_skew: cross-rank wall-clock skew "
                               f"~{skew_s:.2f}s measured at iteration "
                               f"{skew_iter} (threshold "
                               f"{skew_threshold_s:.1f}s); merged "
                               "cross-rank order is unreliable")})
    out_path = out_path or os.path.join(os.fspath(directory), MERGED_NAME)
    tmp = f"{out_path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in merged:
                f.write(json.dumps(rec, separators=(",", ":"),
                                   default=str) + "\n")
        os.replace(tmp, out_path)
    except OSError as e:
        Log.warning("journal merge failed (%s): %s", out_path, e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return out_path


# --------------------------------------------------- process-wide handle
#
# Cross-cutting emitters (the collective watchdog's abort path, the
# heartbeat monitor's peer-loss path) need the active journal without a
# booster reference — one training run per process, same singleton
# shape as parallel/heartbeat.py.

_CURRENT = None


def set_current(journal):
    global _CURRENT
    _CURRENT = journal


def current():
    return _CURRENT
