"""Admission control: deadline budgets, load shedding, brownout.

No reference equivalent — the reference predictor is a library call;
a standing replica under overload needs to refuse work it cannot
finish in time, and refuse it CHEAPLY (before any device dispatch).

The controller sits in front of the MicroBatcher and answers one
question per predict request: given the queue backlog and the EWMA
batch service time, will this request's deadline budget survive the
wait? Three outcomes, in order of escalation:

- admit: estimated wait fits the budget; the request queues normally.
- brownout: pressure is building (estimated wait above half the shed
  threshold) — the request is still served, but the quality monitors
  (drift/skew sampling, shadow scoring) are switched off to shed
  their overhead first. `/healthz` and `/metricz` are never touched:
  they bypass admission entirely (GET path).
- shed: estimated wait exceeds `shed_queue_budget` x budget — refuse
  with 429 + Retry-After sized to the backlog, before the request
  costs anything. A request whose deadline ALREADY passed gets 504
  (server.py checks expiry before calling assess()).

Deadline budgets come from the `X-Deadline-Ms` request header
(remaining milliseconds, the cross-service propagation idiom), falling
back to `deadline_default_ms`; with neither, the request has no
deadline and is never shed — admission is strictly opt-in, so the
PR-11 serving paths behave exactly as before unless a budget exists.

Wait estimation: queued requests coalesce (the whole point of the
batcher), so the backlog is counted in BATCHES — queue depth divided
by the observed requests-per-batch — times the EWMA service time, plus
one batch of slack for an in-flight dispatch and the coalescing wait
itself. Deliberately a cheap upper bound, not a simulation: shedding
a hair early under real overload beats queue collapse.

Brownout has hysteresis (engage at 0.5x the shed threshold, release
at 0.25x) so a flapping queue does not toggle the monitors per
request. State lands on /metricz (`brownout_active`, `shed_count`,
`deadline_expired_count`) — see docs/Resilience.md.
"""

import math
import threading
import time

# brownout engages when estimated wait crosses this fraction of the
# shed threshold, and releases below half of it (hysteresis)
BROWNOUT_ENGAGE = 0.5
BROWNOUT_RELEASE = 0.25

# floor for Retry-After so a shed client never busy-loops us
MIN_RETRY_AFTER_S = 0.05


class AdmissionController:
    """Per-server admission state. Thread-safe: handler threads call
    `assess` concurrently; brownout transitions happen under a lock."""

    def __init__(self, batcher, metrics=None, deadline_default_ms=0.0,
                 shed_queue_budget=1.0):
        self.batcher = batcher
        self.metrics = metrics
        self.deadline_default_ms = float(deadline_default_ms)
        self.shed_queue_budget = float(shed_queue_budget)
        self._lock = threading.Lock()
        self._brownout = False

    # ------------------------------------------------------------ deadlines
    def deadline_from_header(self, header_value, now=None):
        """Parse an `X-Deadline-Ms` header (remaining milliseconds)
        into an ABSOLUTE time.monotonic() deadline; unparsable or
        missing values fall back to `deadline_default_ms`. Returns
        None when the request carries no deadline at all."""
        now = time.monotonic() if now is None else now
        ms = None
        if header_value is not None:
            try:
                ms = float(header_value)
            except (TypeError, ValueError):
                ms = None
        if ms is None and self.deadline_default_ms > 0:
            ms = self.deadline_default_ms
        if ms is None:
            return None
        return now + ms / 1e3

    # ------------------------------------------------------------- estimate
    def estimated_wait_s(self):
        """Upper-bound estimate of how long a request admitted NOW
        waits before its batch completes: the coalescing wait plus
        (backlog batches + one in-flight batch) x EWMA service time."""
        est = self.batcher.estimated_service_s()
        if est <= 0.0:
            # cold start: no dispatch observed yet — assume one
            # coalescing window per batch so we never shed before the
            # first request has even been scored
            est = self.batcher.max_wait_s
        depth = self.batcher.queue_depth()
        per_batch = 1.0
        m = self.metrics
        if m is not None:
            batches = m.batch_count
            if batches:
                per_batch = max(1.0, m.batched_requests / batches)
        backlog_batches = math.ceil(depth / per_batch) if depth else 0
        return self.batcher.max_wait_s + (backlog_batches + 1) * est

    # --------------------------------------------------------------- verdict
    @property
    def brownout_active(self):
        return self._brownout

    def assess(self, deadline, now=None):
        """Admission verdict for one predict request. Returns
        ('admit', None) or ('shed', retry_after_s). Updates brownout
        state as a side effect (every request is a pressure sample).
        `deadline` is absolute monotonic or None (deadline-less
        requests are never shed but still sample pressure)."""
        now = time.monotonic() if now is None else now
        wait = self.estimated_wait_s()
        if deadline is None:
            self._update_brownout(0.0)
            return "admit", None
        budget = max(0.0, deadline - now)
        threshold = self.shed_queue_budget * budget
        pressure = wait / threshold if threshold > 0 else float("inf")
        self._update_brownout(pressure)
        if pressure <= 1.0:
            return "admit", None
        # Retry-After: when the CURRENT backlog should have drained
        retry_after = max(MIN_RETRY_AFTER_S, wait - budget)
        if self.metrics is not None:
            self.metrics.record_shed()
        return "shed", retry_after

    def trace_tags(self):
        """The controller's state as span tags (telemetry/disttrace.py):
        WHY a request was shed or browned out, readable straight off
        the /tracez per-hop breakdown."""
        return {"estimated_wait_ms": round(self.estimated_wait_s() * 1e3,
                                           3),
                "queue_depth": int(self.batcher.queue_depth()),
                "brownout": bool(self._brownout)}

    def _update_brownout(self, pressure):
        with self._lock:
            if not self._brownout and pressure >= BROWNOUT_ENGAGE:
                self._brownout = True
            elif self._brownout and pressure < BROWNOUT_RELEASE:
                self._brownout = False
            else:
                return
        if self.metrics is not None:
            self.metrics.set_brownout(self._brownout)
