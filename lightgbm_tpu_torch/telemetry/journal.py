"""Append-only JSONL journal (the part of lightgbm_tpu/telemetry/journal.py
that distributed tracing writes through).

One file per rank (`journal.rank0000.jsonl`) in a shared directory, in
the JAX package's record shape, so its aggregator reads the port's trace
records. Every record is ONE `os.write` of a complete line to an
O_APPEND fd: concurrent writers interleave at line granularity and a
kill loses at most the record being written. `read_journal` skips torn
lines. The training timeline (iteration records, merging, the schema
lint) belongs to the port's telemetry slice, still to come.
"""

import json
import os
import threading
import time

from ..utils.log import Log

SCHEMA_VERSION = 1


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
    """One rank's append-only journal; `source` tags every record."""

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
        line. Never raises."""
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
            line = json.dumps(_sanitize(rec), separators=(",", ":"),
                              allow_nan=False, default=str) + "\n"
        try:
            os.write(self._fd, line.encode("utf-8"))
        except OSError as e:
            Log.warning("journal write failed (%s): %s", self.path, e)

    def close(self):
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


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
