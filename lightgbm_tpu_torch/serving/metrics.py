"""Serving-side metrics: counters, batch occupancy, latency ring.

No reference equivalent — the reference predictor is a library call
(predictor.hpp); a standing service needs its own accounting. Built on
the telemetry registry primitives (telemetry/registry.py: the
training-side metrics share the same lock discipline and ring-
percentile semantics — this module used to carry its own copies of
both). All methods are thread-safe (the HTTP handler pool and the
batcher worker update concurrently) and snapshot() is what `/metricz`
serializes (serving/server.py).

Latency percentiles come from a fixed-size ring buffer of the most
recent request latencies: O(1) record, O(ring log ring) on read, and a
bounded-memory view that tracks the CURRENT tail behavior instead of
averaging over the process lifetime.
"""

import time

from ..telemetry.registry import MetricsRegistry

RING_SIZE = 4096


class ServingMetrics:
    """Request/row/batch counters + latency ring for one serving
    process. The legacy attribute surface (`request_count`, ...) is
    kept as properties over the registry instruments."""

    def __init__(self, ring_size=RING_SIZE):
        self.registry = MetricsRegistry()
        self._requests = self.registry.counter("request_count")
        self._rows = self.registry.counter("rows_served")
        self._batches = self.registry.counter("batch_count")
        self._batched_rows = self.registry.counter("batched_rows")
        self._batched_requests = self.registry.counter("batched_requests")
        self._errors = self.registry.counter("error_count")
        # resilience layer (serving/admission.py, docs/Resilience.md):
        # requests refused before dispatch, split by cause
        self._shed = self.registry.counter("shed_count")
        self._deadline_expired = self.registry.counter(
            "deadline_expired_count")
        self._brownout = self.registry.gauge("brownout_active")
        self._latency = self.registry.histogram("latency_ms", ring_size)
        self.started_at = time.time()

    # ------------------------------------------------------------- writers
    def record_request(self, rows, latency_s):
        """One client request completed (rows served, end-to-end
        seconds). The group updates under ONE lock hold (reentrant
        registry lock) so a concurrent /metricz scrape never sees the
        count without its latency sample."""
        with self.registry.lock:
            self._requests.inc()
            self._rows.inc(int(rows))
            self._latency.observe(latency_s * 1e3)

    def record_batch(self, rows, n_requests):
        """One coalesced device dispatch (batcher drain)."""
        with self.registry.lock:
            self._batches.inc()
            self._batched_rows.inc(int(rows))
            self._batched_requests.inc(int(n_requests))

    def record_error(self):
        self._errors.inc()

    def record_shed(self):
        """One request refused by admission control (429/503)."""
        self._shed.inc()

    def record_deadline_expired(self):
        """One request dropped because its deadline passed (504)."""
        self._deadline_expired.inc()

    def set_brownout(self, active):
        """Publish the brownout state (1 = quality monitors disabled
        to save headroom, 0 = full service)."""
        self._brownout.set(1 if active else 0)

    # ------------------------------------------------------------- readers
    @property
    def request_count(self):
        return self._requests.value

    @property
    def rows_served(self):
        return self._rows.value

    @property
    def batch_count(self):
        return self._batches.value

    @property
    def batched_rows(self):
        return self._batched_rows.value

    @property
    def batched_requests(self):
        return self._batched_requests.value

    @property
    def error_count(self):
        return self._errors.value

    @property
    def shed_count(self):
        return self._shed.value

    @property
    def deadline_expired_count(self):
        return self._deadline_expired.value

    def latency_percentiles(self, pcts=(50, 95, 99)):
        """{p: milliseconds} over the ring's recorded window; empty dict
        before the first request (nearest-rank — see
        telemetry/registry.py Histogram.percentiles)."""
        return self._latency.percentiles(pcts)

    def snapshot(self):
        """One JSON-ready dict for `/metricz` (field set unchanged by
        the registry refactor; tests/test_telemetry.py pins parity).
        Reads under one lock hold — a consistent point-in-time view."""
        with self.registry.lock:
            pct = self.latency_percentiles()
            batches = self.batch_count
            occ = self.batched_rows / batches if batches else 0.0
            per_batch = self.batched_requests / batches if batches else 0.0
            snap = {
                "uptime_s": round(time.time() - self.started_at, 3),
                "request_count": self.request_count,
                "rows_served": self.rows_served,
                "error_count": self.error_count,
                "shed_count": self.shed_count,
                "deadline_expired_count": self.deadline_expired_count,
                "brownout_active": self._brownout.value,
                "batch_count": batches,
                "batch_occupancy_rows": round(occ, 3),
                "batch_occupancy_requests": round(per_batch, 3),
                "latency_p50_ms": round(pct.get(50, 0.0), 4),
                "latency_p95_ms": round(pct.get(95, 0.0), 4),
                "latency_p99_ms": round(pct.get(99, 0.0), 4),
                "latency_window": self._latency.window,
            }
        return snap
