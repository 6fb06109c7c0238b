"""Run-history store: one compact `run_summary` record per run (the port
of lightgbm_tpu/telemetry/history.py).

Every training run with `run_history=<path>` appends the handful of
numbers that define "did we get worse" to one append-only JSONL file:
train wall seconds, eval metrics, peak memory, collective bytes per
tree, comm and prefetch overlap. Rank 0 of the CLI writes it at the end
of training. Write discipline is the journal's (telemetry/journal.py):
one O_APPEND `os.write` of a complete line, so concurrent writers
interleave at line granularity and a killed run tears at most its own
record. The record is `run_summary` in journal.SCHEMA, the JAX
package's shape. stdlib only.
"""

import os
import time

from ..utils.log import Log
from . import journal as journal_mod

HISTORY_NAME = "RUN_HISTORY.jsonl"


def default_path(base_dir="."):
    return os.path.join(os.fspath(base_dir), HISTORY_NAME)


def append_run_summary(path, kind, **fields):
    """Append one `run_summary` record. None-valued fields are
    dropped; the record is schema-validated before the write (a
    violation logs a warning but still writes — history must not be
    lost to a typo'd optional field, and unknown extras are legal).
    Returns the path, or None when the write failed."""
    rec = {"ts": time.time(), "mono": round(time.monotonic(), 6),
           "event": "run_summary", "rank": 0, "kind": str(kind)}
    rec.update({k: v for k, v in fields.items() if v is not None})
    rec = journal_mod._sanitize(rec)
    errors = journal_mod.validate_record(rec)
    if errors:
        Log.warning("run_summary record has schema violations "
                    "(written anyway): %s", "; ".join(errors))
    import json
    line = json.dumps(rec, separators=(",", ":"), allow_nan=False,
                      default=str) + "\n"
    try:
        parent = os.path.dirname(os.fspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        fd = os.open(os.fspath(path),
                     os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            os.write(fd, line.encode("utf-8"))
        finally:
            os.close(fd)
    except OSError as e:
        Log.warning("run history append failed (%s): %s", path, e)
        return None
    return os.fspath(path)


def read_history(path):
    """Parsed, valid `run_summary` records (oldest first). Torn lines
    and foreign/invalid records are skipped — an old or co-written
    file must not break trend detection."""
    records, _ = journal_mod.read_journal(path)
    return [r for r in records
            if isinstance(r, dict) and r.get("event") == "run_summary"
            and not journal_mod.validate_record(r)]


def booster_summary(booster, train_s=None, rows=None):
    """Assemble the summary fields one trained GBDT can attest to:
    iteration count, last eval metric values, memory watermarks
    (telemetry/ledger.py), total collective bytes (+ per tree), the
    comm profiler's latest overlap, and the streaming learner's
    prefetch overlap. Used by the CLI's run_end write."""
    fields = {"iterations": int(getattr(booster, "iter", 0) or 0)}
    if train_s is not None:
        fields["train_s"] = round(float(train_s), 3)
    if rows is None:
        data = getattr(booster, "train_data", None)
        rows = getattr(data, "global_num_data", None) \
            or getattr(data, "num_data", None)
    if rows:
        fields["rows"] = int(rows)
    metrics = getattr(booster, "_last_metric_values", None)
    if metrics:
        fields["metrics"] = {str(k): float(v)
                             for k, v in metrics.items()
                             if isinstance(v, (int, float))}
        auc = fields["metrics"].get("auc")
        if auc is not None:
            fields["auc"] = auc
    try:
        from . import ledger
        mem = ledger.sample_memory()
        peak = mem.get("device_peak_bytes") or mem.get(
            "host_peak_rss_bytes")
        if peak:
            fields["peak_memory_bytes"] = int(peak)
    except Exception:
        pass
    reg = getattr(booster, "metrics", None)
    if reg is not None:
        snap = reg.snapshot()
        total = snap["counters"].get("collective_bytes")
        if total:
            fields["collective_bytes"] = int(total)
            trees = len(getattr(booster, "models", ()) or ())
            if trees:
                fields["collective_bytes_per_tree"] = round(
                    total / trees, 1)
        pf = snap["gauges"].get("prefetch_overlap_pct")
        if pf:
            fields["prefetch_overlap_pct"] = float(pf)
    prof = getattr(booster, "comm_profile", None)
    if prof is not None and prof.last:
        # run-aggregate overlap (cum wait over cum wall) — trending a
        # single iteration's number would gate on noise
        overlap = prof.snapshot().get("run_overlap_pct")
        if overlap is not None:
            fields["comm_overlap_pct"] = float(overlap)
    return fields
