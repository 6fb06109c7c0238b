"""Distributed request tracing + the crash flight recorder (the port's
copy of lightgbm_tpu/telemetry/disttrace.py, stdlib only).

One request is followable across process boundaries (router ->
replicas -> batcher -> kernel), W3C trace-context style:

- **Context**: every hop carries ``X-Trace-Ctx: trace_id/span_id/flags``
  (hex ids, int flags). `parse_header` accepts it, `inject_headers`
  stamps it onto outbound calls, and a thread-local stack keeps the
  active context so nested spans parent correctly without plumbing
  arguments.

- **Spans**: `TraceRecorder.span(...)` times one hop (root, per-attempt
  child, parse/admission/queue/batch/kernel stages); `observe(...)`
  lands externally-timed spans (the batcher worker's stamps). Completed
  spans buffer per trace until the process-local root closes, then the
  whole fragment is journaled as `trace` records (telemetry/journal.py,
  the JAX package's record shape) — or dropped.

- **Tail-based sampling**: the keep decision runs at fragment close,
  when the outcome is known. 100% of error traces (any span status
  "error", any http.status >= 400 — shed 429s and deadline 504s
  included) and of slow traces (fragment wall span over `slow_ms`, the
  serving `slow_request_ms` bar) are kept; the rest keep a
  deterministic hash(trace_id) fraction (`sample_rate`), identical on
  every process so a kept trace is kept at EVERY hop and a collector
  can stitch complete trees. The head also sets FLAG_SAMPLED in the
  propagated flags so downstream processes need not recompute.

- **Flight recorder**: `FLIGHT` dumps the registered evidence sources
  (span rings, registry snapshots) atomically to
  `<dir>/blackbox-<rank>.json` on SIGQUIT and on unhandled serving
  exceptions, so a post-mortem starts with the final seconds.
"""

import json
import os
import random
import signal
import threading
import time
import zlib
from collections import deque

from ..utils.log import Log

TRACE_HEADER = "X-Trace-Ctx"
# env fallback: a child process (canary retrain, spawned rank) joins
# its parent's trace without an HTTP hop to carry the header
ENV_CONTEXT = "LGBM_TPU_TRACE_CTX"

# flags bits (propagated verbatim)
FLAG_SAMPLED = 1   # head's hash decision said keep; downstream honors it

DEFAULT_SAMPLE_RATE = 0.01
# tail-sampling buffers at most this many distinct in-flight traces
# per recorder; beyond it the oldest fragment is dropped (bounded
# memory beats complete evidence under a trace-id flood)
MAX_PENDING_TRACES = 512
# backstop on the recorder's event queue: if the drain thread ever
# wedges, producers drop new spans rather than grow without bound
MAX_QUEUED_EVENTS = 65536
# how long a completed span may sit in the queue before the drain
# thread folds it into its fragment (teardown/stats drain on demand)
DRAIN_INTERVAL_S = 0.02

_HEX = set("0123456789abcdef")

# span/trace ids come off a thread-local PRNG, not uuid4: ids are
# correlation keys, not secrets, and getrandbits is ~10x cheaper than
# the uuid machinery on the per-request path
_RNG = threading.local()


def _rand_hex16():
    r = getattr(_RNG, "r", None)
    if r is None:
        r = _RNG.r = random.Random(
            int.from_bytes(os.urandom(8), "big") ^ threading.get_ident())
    return f"{r.getrandbits(64):016x}"


def new_trace_id():
    return _rand_hex16()


def new_span_id():
    return _rand_hex16()


def hash_fraction(trace_id):
    """Deterministic [0, 1) hash of a trace id — the SAME value on
    every process, so independent tail samplers agree on keep/drop."""
    return (zlib.crc32(trace_id.encode("ascii", "replace"))
            & 0xFFFFFFFF) / 2.0 ** 32


class TraceContext:
    """One hop's identity: which trace, which span is the parent of
    anything started under this context, and the propagated flags."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id, span_id, flags=0):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = int(flags)

    def header_value(self):
        return f"{self.trace_id}/{self.span_id}/{self.flags:d}"

    def __repr__(self):
        return f"TraceContext({self.header_value()})"


def _hex_ok(s, lo=8, hi=32):
    return lo <= len(s) <= hi and all(c in _HEX for c in s)


def parse_header(value):
    """``trace_id/span_id/flags`` -> TraceContext, or None for
    anything malformed (a garbled header must degrade to a fresh
    trace, never to a 4xx)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("/")
    if len(parts) != 3:
        return None
    trace_id, span_id, flags = (p.strip().lower() for p in parts)
    if not _hex_ok(trace_id) or not _hex_ok(span_id):
        return None
    try:
        flags_i = int(flags)
    except ValueError:
        return None
    return TraceContext(trace_id, span_id, flags_i)


# ------------------------------------------------------ thread context

_LOCAL = threading.local()


def current():
    """The active TraceContext on THIS thread, or None."""
    return getattr(_LOCAL, "ctx", None)


class _Activation:
    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx):
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_LOCAL, "ctx", None)
        _LOCAL.ctx = self._ctx
        return self._ctx

    def __exit__(self, exc_type, exc, tb):
        _LOCAL.ctx = self._prev
        return False


def activate(ctx):
    """Context manager installing `ctx` as this thread's current
    context (None deactivates for the scope)."""
    return _Activation(ctx)


def from_env(environ=None):
    """TraceContext from the LGBM_TPU_TRACE_CTX env var, or None —
    how a spawned training child joins the spawning request's trace."""
    return parse_header((environ or os.environ).get(ENV_CONTEXT, ""))


def inject_headers(headers=None, ctx=None):
    """Return `headers` (a new dict) carrying the trace context header
    — THE helper every outbound HTTP call in fleet|serving must route
    header dicts through (lint rule `trace-context-propagation`). With
    no explicit ctx and no current() context the headers pass through
    unstamped: probes and untraced traffic stay headerless."""
    out = dict(headers or {})
    ctx = ctx or current()
    if ctx is not None:
        out[TRACE_HEADER] = ctx.header_value()
    return out


# -------------------------------------------------------------- spans

class DistSpan:
    """One completed (or open) cross-process span. `start` is wall
    epoch seconds (time.time(): journal-comparable across processes;
    per-rank NTP skew is visible, not corrected)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name",
                 "kind", "start", "duration", "status", "flags",
                 "tags", "links")

    def __init__(self, trace_id, span_id, parent_span_id, name,
                 kind="internal", start=None, flags=0, tags=None,
                 links=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.name = name
        self.kind = kind
        self.start = time.time() if start is None else float(start)
        self.duration = None
        self.status = "ok"
        self.flags = int(flags)
        self.tags = dict(tags) if tags else {}
        self.links = list(links) if links else None

    def context(self):
        """The context a child hop (or downstream process) continues."""
        return TraceContext(self.trace_id, self.span_id, self.flags)

    def set_tag(self, key, value):
        self.tags[key] = value

    def as_record(self):
        rec = {"trace_id": self.trace_id, "span_id": self.span_id,
               "name": self.name, "start": round(self.start, 6),
               "duration_s": round(self.duration or 0.0, 6),
               "kind": self.kind, "status": self.status,
               "flags": self.flags}
        if self.parent_span_id:
            rec["parent_span_id"] = self.parent_span_id
        if self.tags:
            rec["tags"] = self.tags
        if self.links:
            rec["links"] = self.links
        return rec


class _SpanHandle:
    """Context manager for one recorder-owned span: activates the
    span's context for the scope (children/downstream parent to it),
    closes the span exception-safely."""

    __slots__ = ("recorder", "span", "_activation", "_t0")

    def __init__(self, recorder, span):
        self.recorder = recorder
        self.span = span
        self._activation = None
        self._t0 = None

    @property
    def ctx(self):
        return self.span.context()

    def set_tag(self, key, value):
        self.span.set_tag(key, value)

    def __enter__(self):
        self._t0 = time.monotonic()
        self._activation = _Activation(self.span.context())
        self._activation.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._activation.__exit__(exc_type, exc, tb)
        status = None
        if exc_type is not None and self.span.status == "ok":
            status = "error"
            self.span.set_tag("exception", repr(exc)[:200])
        self.recorder.finish(self.span, status=status,
                             elapsed=time.monotonic() - self._t0)
        return False


class _NoopHandle:
    """Shared do-nothing span handle: the disabled-recorder fast path
    costs one attribute read and no allocation per request."""

    __slots__ = ()
    ctx = None
    span = None

    def set_tag(self, key, value):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopHandle()


class TraceRecorder:
    """Per-process (or per-server) span sink with tail-based sampling.

    Completed spans buffer per trace until no span of that trace is
    still open HERE; then the whole local fragment is either appended
    to the journal as `trace` records or dropped (policy in the
    module docstring).

    The REQUEST PATH only allocates the span and appends one event to
    a deque (GIL-atomic, no lock): fragment bookkeeping, the tail
    decision and the journal writes all run on a background drain
    thread, so the serving p99 never pays for a kept trace's I/O (the
    <1% overhead bar, tools/verify_perf.py --trace). `flush_pending`
    / `stats` / `close` drain synchronously first, so teardown-then-
    read sees every span. `enabled=False` turns every call into a
    near-free no-op."""

    def __init__(self, directory=None, rank=0, journal=None, service="",
                 sample_rate=DEFAULT_SAMPLE_RATE, slow_ms=0.0,
                 slow_only=False, enabled=True):
        self.service = service or ""
        self.sample_rate = float(sample_rate)
        self.slow_ms = float(slow_ms or 0.0)
        self.slow_only = bool(slow_only)
        self.rank = int(rank)
        self._own_journal = False
        self.journal = journal
        if journal is None and directory:
            from . import journal as journal_mod
            self.journal = journal_mod.RunJournal(
                directory, rank=self.rank,
                source=self.service or "trace")
            self._own_journal = True
        self.enabled = bool(enabled) and self.journal is not None
        # producers append ("+", trace_id) / ("-", span) / ("o", span)
        # events; ONLY the drain passes (serialized by _lock) touch
        # _pending and the counters
        self._events = deque()
        self._lock = threading.Lock()
        self._pending = {}   # trace_id -> {"open": int, "spans": [...]}
        self._stop = threading.Event()
        self._thread = None
        self.spans_recorded = 0
        self.traces_kept = 0
        self.traces_dropped = 0
        if self.enabled:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"lgbm-tpu-trace-drain-{self.rank}")
            self._thread.start()

    # ------------------------------------------------------------ create
    def _head_flags(self, trace_id):
        return FLAG_SAMPLED \
            if hash_fraction(trace_id) < self.sample_rate else 0

    def _enqueue(self, op, payload):
        if len(self._events) < MAX_QUEUED_EVENTS:
            self._events.append((op, payload))
        else:   # wedged drain: drop rather than grow without bound
            self.traces_dropped += 1   # racy counter; evidence only

    def start(self, name, ctx=None, kind="internal", links=None,
              tags=None):
        """Open a span. `ctx` (or the thread's current context) makes
        it a child; without either it roots a NEW trace, deciding the
        head sampling flag. Returns the open DistSpan (pair with
        `finish`) — use `span()` for the with-statement form."""
        ctx = ctx or current()
        if ctx is None:
            trace_id = new_trace_id()
            parent = None
            flags = self._head_flags(trace_id)
        else:
            trace_id, parent, flags = ctx.trace_id, ctx.span_id, ctx.flags
        span = DistSpan(trace_id, new_span_id(), parent, name,
                        kind=kind, flags=flags, tags=tags, links=links)
        if self.enabled:
            self._enqueue("+", trace_id)
        return span

    def finish(self, span, status=None, elapsed=None, **tags):
        """Close a span opened with `start`. `elapsed` (monotonic
        seconds) beats wall-clock subtraction when the caller timed
        the hop itself; without it the wall delta is used."""
        if status is not None:
            span.status = status
        if tags:
            span.tags.update(tags)
        if span.duration is None:
            span.duration = (float(elapsed) if elapsed is not None
                             else max(0.0, time.time() - span.start))
        if self.enabled:
            self._enqueue("-", span)

    def span(self, name, ctx=None, kind="internal", **tags):
        """`with recorder.span("router.request") as sp:` — times the
        body, activates the span's context for it, journals through
        the tail sampler. The disabled path returns a shared no-op."""
        if not self.enabled:
            return _NOOP
        return _SpanHandle(self, self.start(name, ctx=ctx, kind=kind,
                                            tags=tags or None))

    def observe(self, name, ctx, start, duration_s, kind="internal",
                status="ok", tags=None, links=None, parent=None):
        """Land an externally-timed span (batcher worker stamps,
        mirrored SpanTracer phases). `start` is wall epoch seconds.
        Joins the trace's pending fragment when one is open here,
        otherwise flushes as its own single-span fragment."""
        if not self.enabled or ctx is None:
            return None
        span = DistSpan(ctx.trace_id, new_span_id(),
                        parent if parent is not None else ctx.span_id,
                        name, kind=kind, start=start, flags=ctx.flags,
                        tags=tags, links=links)
        span.duration = float(duration_s)
        span.status = status
        self._enqueue("o", span)
        return span

    # ------------------------------------------------------------- drain
    def _run(self):
        while not self._stop.wait(DRAIN_INTERVAL_S):
            try:
                self.drain()
            except Exception as e:   # the drain must never die
                Log.warning("trace drain failed: %s", e)

    def drain(self, burst=16):
        """Fold every queued event into its fragment, flushing closed
        fragments through the tail sampler. Runs on the background
        thread every DRAIN_INTERVAL_S; `flush_pending`/`stats`/`close`
        call it inline (the lock serializes passes, the deque keeps
        producers wait-free). Events are processed in bursts of
        `burst` with a GIL yield between bursts, so a request thread
        colliding with a big backlog never waits out the whole pass."""
        while True:
            with self._lock:
                flushes = []
                n = 0
                while n < burst:
                    try:
                        op, payload = self._events.popleft()
                    except IndexError:
                        break
                    n += 1
                    if op == "+":
                        frag = self._pending.get(payload)
                        if frag is None:
                            self._evict_locked()
                            frag = self._pending[payload] = \
                                {"open": 0, "spans": []}
                        frag["open"] += 1
                    elif op == "-":
                        frag = self._pending.get(payload.trace_id)
                        if frag is None:
                            frag = {"open": 1, "spans": []}
                            self._pending[payload.trace_id] = frag
                        frag["spans"].append(payload)
                        frag["open"] -= 1
                        if frag["open"] <= 0:
                            self._pending.pop(payload.trace_id, None)
                            flushes.append((payload.trace_id,
                                            frag["spans"]))
                    else:   # "o": externally-timed span
                        frag = self._pending.get(payload.trace_id)
                        if frag is not None:
                            frag["spans"].append(payload)
                        else:
                            flushes.append((payload.trace_id,
                                            [payload]))
                for trace_id, spans in flushes:
                    self._flush_locked(trace_id, spans)
            if n < burst:
                return
            time.sleep(0)   # yield the GIL between bursts

    # ----------------------------------------------------------- sampling
    def _evict_locked(self):
        while len(self._pending) >= MAX_PENDING_TRACES:
            oldest = next(iter(self._pending))
            self._pending.pop(oldest)
            self.traces_dropped += 1

    def _keep(self, trace_id, spans):
        """The tail decision (module docstring): errors and slowness
        always keep; otherwise the deterministic head fraction."""
        slow_s = self.slow_ms / 1e3 if self.slow_ms > 0 else None
        t_lo = t_hi = None
        for s in spans:
            if s.status == "error":
                return True
            code = s.tags.get("http.status")
            if isinstance(code, int) and code >= 400:
                return True
            end = s.start + (s.duration or 0.0)
            t_lo = s.start if t_lo is None else min(t_lo, s.start)
            t_hi = end if t_hi is None else max(t_hi, end)
        if slow_s is not None and t_lo is not None \
                and (t_hi - t_lo) >= slow_s:
            return True
        if self.slow_only:
            return False
        if any(s.flags & FLAG_SAMPLED for s in spans):
            return True
        return hash_fraction(trace_id) < self.sample_rate

    def _flush_locked(self, trace_id, spans):
        if not spans:
            return
        if not self._keep(trace_id, spans):
            self.traces_dropped += 1
            return
        self.traces_kept += 1
        self.spans_recorded += len(spans)
        j = self.journal
        if j is None:
            return
        for s in spans:
            rec = s.as_record()
            if self.service and "service" not in rec:
                rec["service"] = self.service
            j.event("trace", **rec)

    def flush_pending(self):
        """Drain the queue, then force the tail decision on every
        still-buffered fragment (server teardown; tests). Open counts
        are ignored — anything still nominally open is journaled with
        its current duration."""
        self.drain()
        with self._lock:
            pending, self._pending = self._pending, {}
            for trace_id, frag in pending.items():
                spans = [s for s in frag["spans"]
                         if s.duration is not None]
                self._flush_locked(trace_id, spans)

    def stats(self):
        self.drain()
        with self._lock:
            return {"trace_spans_recorded": self.spans_recorded,
                    "traces_kept": self.traces_kept,
                    "traces_dropped": self.traces_dropped,
                    "trace_sample_rate": self.sample_rate}

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * DRAIN_INTERVAL_S + 1.0)
            self._thread = None
        self.flush_pending()
        if self._own_journal and self.journal is not None:
            self.journal.close()
        self.enabled = False


# a permanently-disabled recorder: call sites can hold it instead of
# None and skip every `if recorder is not None` branch
NOOP_RECORDER = TraceRecorder(enabled=False)

_DEFAULT = NOOP_RECORDER
_DEFAULT_LOCK = threading.Lock()


def get_recorder():
    """The process-default recorder (training-side spans mirror into
    it; servers usually hold their own instance)."""
    return _DEFAULT


def set_recorder(recorder):
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, (recorder or NOOP_RECORDER)
    return prev


def configure(**kwargs):
    """Build + install the process-default TraceRecorder (the training
    CLI path; models/gbdt.py wires it from the trace_* knobs)."""
    rec = TraceRecorder(**kwargs)
    set_recorder(rec)
    return rec


# ------------------------------------------------------ flight recorder

BLACKBOX_PREFIX = "blackbox"


def blackbox_path(directory, rank):
    return os.path.join(os.fspath(directory),
                        f"{BLACKBOX_PREFIX}-{int(rank)}.json")


class FlightRecorder:
    """Last-seconds evidence dump for post-mortems (`blackbox` knob).

    Sources register lazily (`add_source`) — each is a zero-argument
    callable returning JSON-serializable evidence (span ring, registry
    snapshot, journal tail). `dump(reason)` collects every source
    (per-source failures are recorded, never raised), then writes
    `blackbox-<rank>.json` atomically (tmp + os.replace). It is called
    from abort paths microseconds before os._exit, so it must never
    raise and never block on a lock the dying thread might hold."""

    def __init__(self):
        self.directory = None
        self.rank = 0
        self._sources = {}
        self._lock = threading.Lock()
        self.last_path = None

    @property
    def enabled(self):
        return self.directory is not None

    def configure(self, directory, rank=0):
        """Arm the recorder (idempotent). Returns self."""
        self.directory = os.fspath(directory) if directory else None
        self.rank = int(rank)
        if self.directory:
            try:
                os.makedirs(self.directory, exist_ok=True)
            except OSError as e:
                Log.warning("flight recorder disabled (%s): %s",
                            self.directory, e)
                self.directory = None
        return self

    def disarm(self):
        self.directory = None
        with self._lock:
            self._sources.clear()

    def add_source(self, name, fn):
        with self._lock:
            self._sources[str(name)] = fn

    def dump(self, reason, **extra):
        """Write the blackbox; returns its path or None. Never raises."""
        try:
            if not self.enabled:
                return None
            with self._lock:
                sources = dict(self._sources)
            payload = {"ts": time.time(), "reason": str(reason),
                       "rank": self.rank, "pid": os.getpid()}
            payload.update(extra)
            evidence = {}
            for name, fn in sources.items():
                try:
                    evidence[name] = fn()
                except Exception as e:   # one bad source must not void
                    evidence[name] = {"error": repr(e)[:200]}  # the rest
            payload["sources"] = evidence
            path = blackbox_path(self.directory, self.rank)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, separators=(",", ":"), default=str)
            os.replace(tmp, path)
            self.last_path = path
            Log.warning("flight recorder: %s -> %s", reason, path)
            return path
        except Exception as e:
            # the dump is best-effort evidence; the abort it rides on
            # must proceed regardless
            try:
                Log.warning("flight recorder dump failed: %s", e)
            except Exception:
                pass
            return None

    def install_sigquit(self):
        """SIGQUIT -> dump (live process inspection: `kill -QUIT <pid>`
        leaves a blackbox without killing the process). Main-thread
        only; elsewhere it is a recorded no-op."""
        try:
            signal.signal(signal.SIGQUIT,
                          lambda signum, frame: self.dump("sigquit"))
            return True
        except (ValueError, OSError, AttributeError):
            # not the main thread / platform without SIGQUIT
            return False


FLIGHT = FlightRecorder()
