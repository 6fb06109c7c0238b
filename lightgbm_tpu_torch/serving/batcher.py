"""Micro-batching queue: coalesce concurrent requests into one dispatch.

A single-row device dispatch and a 256-row dispatch cost nearly the
same wall time (the per-dispatch overhead dominates at serving batch
sizes), so under concurrency the winning shape is: queue requests for
at most `max_wait_ms`, concatenate whatever arrived into ONE padded
device call (CompiledPredictor pads to its row-count buckets), then
slice the result back per request. Classic dynamic batching — the same
design GPU inference servers use — implemented here with a single
worker thread and stdlib primitives only.

Latency contract: a lone request waits at most `max_wait_ms` beyond
its own dispatch; a full batch (`max_batch_rows` queued) dispatches
immediately. Requests of different kinds (predict / raw / leaf) never
share a dispatch — the worker drains the oldest kind first.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np

from ..telemetry import disttrace
from ..utils import faults

KINDS = ("predict", "raw", "leaf")

# EWMA weight of the newest dispatch in the service-time estimate the
# admission controller reads (serving/admission.py): ~last 10 batches
EWMA_ALPHA = 0.2


class DeadlineExceeded(RuntimeError):
    """A request's deadline expired before its batch dispatched; the
    HTTP layer maps this to 504 (no device time was spent on it)."""


class MicroBatcher:
    """Coalesces `submit()`ed row batches into bucketed device
    dispatches against a CompiledPredictor (or anything exposing
    predict / predict_raw / predict_leaf_index)."""

    def __init__(self, predictor, max_batch_rows=None, max_wait_ms=2.0,
                 metrics=None):
        self.predictor = predictor
        self.max_batch_rows = int(max_batch_rows
                                  or getattr(predictor, "max_batch_rows",
                                             4096))
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.metrics = metrics
        # per-server chaos overrides (utils/faults.serving_chaos); the
        # serving server shares its dict here so `wedge_batcher` can
        # target one in-process replica
        self.chaos = None
        # distributed tracing (telemetry/disttrace.py): set by
        # make_server; the worker emits batch-dispatch + kernel spans
        # onto the first member's trace, linking the other members
        self.trace_recorder = None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = []    # [(kind, rows, future, t_enqueue, deadline)]
        self._est_service_s = 0.0   # EWMA batch service time (0=unknown)
        self._closed = False
        self._busy = False        # worker is mid-dispatch (quiesce check)
        self._worker = threading.Thread(target=self._run,
                                        name="micro-batcher", daemon=True)
        self._worker.start()

    # ---------------------------------------------------------------- client
    def submit(self, rows, kind="predict", deadline=None):
        """Enqueue one request; returns a concurrent.futures.Future
        resolving to that request's own result rows. `deadline` is an
        ABSOLUTE time.monotonic() instant: a request still queued past
        it fails with DeadlineExceeded before any device time is spent
        on it (the worker drops expired entries as it assembles each
        batch)."""
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float32))
        canon = getattr(self.predictor, "_canon", None)
        if canon is not None:
            # canonicalize width HERE so requests that are valid alone
            # (narrow/wide rows) also concatenate with each other
            rows = canon(rows)
        fut = Future()
        # request-trace timestamps (serving/server.py splits latency
        # into queue-wait vs batch-compute from these): t_enqueue here,
        # t_dispatch/t_done stamped by the worker BEFORE it resolves
        # the future, so a woken waiter always sees all three
        fut.t_enqueue = time.monotonic()
        fut.t_dispatch = fut.t_done = fut.scored_by = None
        # the submitting thread's trace context rides the future into
        # the worker: the batch span knows every member it coalesced
        fut.trace_ctx = disttrace.current()
        with self._cond:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append((kind, rows, fut, fut.t_enqueue, deadline))
            self._cond.notify()
        return fut

    def predict(self, rows, kind="predict", timeout=None):
        """Blocking submit: the calling thread rides the next coalesced
        batch."""
        return self.submit(rows, kind).result(timeout=timeout)

    def queue_depth(self):
        with self._lock:
            return len(self._queue)

    def estimated_service_s(self):
        """EWMA of recent batch service (dispatch->done) seconds; 0.0
        until the first dispatch completes. The admission controller
        multiplies this by the queue backlog to estimate wait
        (serving/admission.py)."""
        return self._est_service_s

    def quiescent(self):
        """True when nothing is queued AND the worker is not
        mid-dispatch (the `/quiescez` admin check)."""
        with self._lock:
            return not self._queue and not self._busy

    def swap_predictor(self, predictor):
        """Atomically replace the predictor (hot-swap, fleet/hotswap).
        The worker snapshots the predictor ONCE per coalesced batch, so
        every batch — including one already queued — is scored entirely
        by a single model version; requests enqueued after this call
        ride the new one. Returns the retired predictor."""
        with self._cond:
            old, self.predictor = self.predictor, predictor
        return old

    def close(self, timeout=5.0):
        """Drain and stop the worker. Pending futures still resolve."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._worker.join(timeout=timeout)

    # ---------------------------------------------------------------- worker
    def _take_batch(self):
        """Wait for work, give the head request `max_wait_s` to attract
        company, then pull every same-kind request (up to
        max_batch_rows). Returns (kind, [(rows, future)]) or None when
        closed and drained. Runs with the lock held via _cond."""
        with self._cond:
            # chaos: `wedge_batcher` parks the worker in this wait loop
            # even when work is queued (queue grows, admission control
            # must shed); clearing the fault un-wedges without a
            # restart, and close() still drains what queued up
            while not self._closed and (
                    not self._queue
                    or faults.serving_chaos(self.chaos).get(
                        "wedge_batcher")):
                self._cond.wait(timeout=0.05 if self._queue else None)
            if not self._queue:
                return None  # closed and drained
            # the single worker is the only consumer, so the head (and
            # its arrival time) cannot change while we wait for company
            wait_until = self._queue[0][3] + self.max_wait_s
            kind = self._queue[0][0]
            while True:
                rows_queued = sum(r.shape[0]
                                  for k, r, _, _, _ in self._queue
                                  if k == kind)
                remaining = wait_until - time.monotonic()
                if (rows_queued >= self.max_batch_rows or remaining <= 0
                        or self._closed):
                    break
                self._cond.wait(timeout=remaining)
            now = time.monotonic()
            batch, rest, expired, taken = [], [], [], 0
            for item in self._queue:
                k, rows, fut, _, req_deadline = item
                if req_deadline is not None and now > req_deadline:
                    # expired while queued: fail it BEFORE dispatch —
                    # the client already gave up, so device time spent
                    # on it would be pure waste (504 at the HTTP layer)
                    expired.append(fut)
                elif k == kind and taken < self.max_batch_rows:
                    batch.append((rows, fut))
                    taken += rows.shape[0]
                else:
                    rest.append(item)
            self._queue = rest
            self._busy = True   # cleared by _run after futures resolve
        for fut in expired:
            fut.t_dispatch = fut.t_done = time.monotonic()
            fut.set_exception(DeadlineExceeded(
                "deadline expired before dispatch"))
        if not batch:
            with self._lock:
                self._busy = False
            return kind, []
        return kind, batch

    def _emit_trace(self, kind, batch, w_dispatch, dispatch_s,
                    kernel_offset_s, kernel_s, total_rows, status):
        """Batch-dispatch + kernel spans for one coalesced dispatch.
        They attach to the FIRST traced member's trace; every other
        member's trace_id is carried in `links` so the collector can
        stitch the shared dispatch into all of them. Emitted BEFORE
        the futures resolve, while the member roots are still open."""
        rec = self.trace_recorder
        if rec is None or not rec.enabled:
            return
        ctxs = [f.trace_ctx for _, f in batch
                if getattr(f, "trace_ctx", None) is not None]
        if not ctxs:
            return
        head = ctxs[0]
        links = sorted({c.trace_id for c in ctxs[1:]
                        if c.trace_id != head.trace_id}) or None
        span = rec.observe(
            "batch.dispatch", head, w_dispatch, dispatch_s,
            status=status, links=links,
            tags={"kind": kind, "rows": int(total_rows),
                  "requests": len(batch)})
        if kernel_s is not None:
            rec.observe("serve.kernel", head,
                        w_dispatch + kernel_offset_s, kernel_s,
                        status=status,
                        parent=span.span_id if span is not None
                        else None)

    def _run(self):
        while True:
            got = self._take_batch()
            if got is None:
                return
            kind, batch = got
            if not batch:
                continue    # every queued entry had expired
            # ONE predictor snapshot per batch: a concurrent hot-swap
            # (swap_predictor) lands between batches, never inside one —
            # a coalesced dispatch is scored entirely by one model
            pred = self.predictor
            t_dispatch = time.monotonic()
            w_dispatch = time.time()
            t_k0 = t_k1 = None
            try:
                # inside the try: ANY failure (even a concat shape
                # mismatch) must fail this batch's futures, never kill
                # the single worker thread
                parts = [r for r, _ in batch]
                if len({r.shape[1] for r in parts}) > 1:
                    # widths were canonicalized at submit time against
                    # the THEN-current predictor; a swap to a different
                    # feature width can strand mixed widths in one
                    # batch — re-canonicalize against the snapshot
                    canon = getattr(pred, "_canon", None)
                    if canon is not None:
                        parts = [canon(r) for r in parts]
                rows = np.concatenate(parts, axis=0)
                t_k0 = time.monotonic()
                if kind == "leaf":
                    out = pred.predict_leaf_index(rows)
                elif kind == "raw":
                    out = pred.predict_raw(rows)
                else:
                    out = pred.predict(rows)
                t_k1 = time.monotonic()
            except Exception as e:
                # errors are counted per REQUEST by whoever consumes the
                # futures (the HTTP handler) — counting the batch here
                # too would double-book one failure
                t_done = time.monotonic()
                self._emit_trace(
                    kind, batch, w_dispatch, t_done - t_dispatch,
                    None, None,
                    sum(r.shape[0] for r, _ in batch), "error")
                for _, fut in batch:
                    fut.t_dispatch, fut.t_done = t_dispatch, t_done
                    fut.scored_by = pred
                    fut.set_exception(e)
                with self._lock:
                    self._busy = False
                continue
            t_done = time.monotonic()
            dt = t_done - t_dispatch
            self._est_service_s = (
                dt if self._est_service_s == 0.0
                else (1.0 - EWMA_ALPHA) * self._est_service_s
                + EWMA_ALPHA * dt)
            if self.metrics is not None:
                self.metrics.record_batch(rows.shape[0], len(batch))
            self._emit_trace(kind, batch, w_dispatch, dt,
                             t_k0 - t_dispatch, t_k1 - t_k0,
                             rows.shape[0], "ok")
            s = 0
            for r, fut in batch:
                fut.t_dispatch, fut.t_done = t_dispatch, t_done
                # which model scored this request: the handler's
                # monitor intake checks it against the monitors' owner
                # so a hot-swap mid-request cannot shadow-score one
                # model's output against another's reference
                fut.scored_by = pred
                fut.set_result(out[s:s + r.shape[0]])
                s += r.shape[0]
            with self._lock:
                self._busy = False
