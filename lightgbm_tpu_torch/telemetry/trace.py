"""Span tracer: nested, tagged wall-clock spans for the training loop (the
port of lightgbm_tpu/telemetry/trace.py).

One tracer per Booster, on the host clock. Three views of the same
spans:

- **Accumulator** (`acc`/`cnt`/`snapshot`/`report`): per-phase total
  seconds and call counts;
- **Deltas** (`delta_snapshot`): per-phase seconds since the previous
  call, what the run journal attaches to each iteration record;
- **Recent spans** (`recent`): a bounded ring of completed spans with
  nesting path, start offset and tags, the `/trainz` live breakdown.

Spans nest through a thread-local stack ("train/build" paths) and are
exception-safe. A span times the host: it never synchronises the card,
so a span around queued device work measures the enqueueing. With the
`telemetry_jax_annotations` knob each span also opens a
`torch.profiler.record_function` range, so host spans line up with the
device kernels in a `torch.profiler` trace (the CLI's `profile` knob),
where the JAX package opened a `jax.profiler.TraceAnnotation`.
"""

import threading
import time
from collections import defaultdict, deque

from . import disttrace

RECENT_SPANS = 256


class Span:
    """One completed (or open) span. `path` includes parents:
    "train/build". `tid` is the recording thread's ident, so concurrent
    threads (batcher worker, heartbeat monitor, the training loop) land
    on separate tracks in an exported trace."""

    __slots__ = ("name", "path", "start", "duration", "tags", "tid")

    def __init__(self, name, path, start, duration=None, tags=None,
                 tid=0):
        self.name = name
        self.path = path
        self.start = start
        self.duration = duration
        self.tags = tags or {}
        self.tid = tid

    def as_dict(self):
        return {"name": self.name, "path": self.path,
                "start_s": round(self.start, 6),
                "duration_s": (round(self.duration, 6)
                               if self.duration is not None else None),
                "tid": self.tid,
                **({"tags": self.tags} if self.tags else {})}


class _SpanContext:
    """Context manager for one span; created by SpanTracer.span()."""

    __slots__ = ("_tracer", "_name", "_tags", "_t0", "_path", "_ann")

    def __init__(self, tracer, name, tags):
        self._tracer = tracer
        self._name = name
        self._tags = tags
        self._t0 = None
        self._path = None
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self._path = ("/".join(s for s in stack) + "/" + self._name
                      if stack else self._name)
        stack.append(self._name)
        if tr.profiler_annotations:
            self._ann = tr._annotation(self._name)
            if self._ann is not None:
                self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        elapsed = time.perf_counter() - self._t0
        tr = self._tracer
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        stack = tr._stack()
        if stack and stack[-1] == self._name:
            stack.pop()
        tr._record(self._name, self._path, elapsed, self._t0, self._tags)
        return False


class SpanTracer:
    """Per-Booster span registry (see module docstring).

    The accumulator keys on the LEAF name (not the path) so nested and
    flat call sites aggregate the same way.
    Thread-safe: concurrent threads keep independent nesting stacks and
    the shared accumulator mutates under one lock.
    """

    def __init__(self, rank=0, profiler_annotations=False):
        self.rank = int(rank)
        self.profiler_annotations = bool(profiler_annotations)
        self.acc = defaultdict(float)
        self.cnt = defaultdict(int)
        self._lock = threading.Lock()
        self._last = {}            # delta_snapshot baseline
        self._recent = deque(maxlen=RECENT_SPANS)
        self._local = threading.local()
        self._epoch = time.perf_counter()
        # wall-clock time of the perf_counter epoch: span start offsets
        # + epoch_wall = journal-comparable epoch seconds, the mapping
        # that lines spans up with journal records (the `spans` record)
        self.epoch_wall = time.time()

    # ------------------------------------------------------------- spans
    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @staticmethod
    def _annotation(name):
        """A torch.profiler range named after the span (a host-side
        marker: no device sync)."""
        try:
            import torch
            return torch.profiler.record_function(name)
        except Exception:   # profiler API drift: the span still times
            return None

    def span(self, name, **tags):
        """Context manager timing one (possibly nested) span."""
        return _SpanContext(self, name, tags)

    # the training loop's name for it: `with tracer.phase("build"): ...`
    phase = span

    def _record(self, name, path, elapsed, t0, tags):
        with self._lock:
            self.acc[name] += elapsed
            self.cnt[name] += 1
            self._recent.append(Span(name, path, t0 - self._epoch,
                                     elapsed, tags,
                                     tid=threading.get_ident()))
        # distributed-trace mirror: when this thread runs under an
        # active X-Trace-Ctx (a traced canary retrain, a request that
        # reached training code), the span ALSO lands on that trace so
        # /tracez shows training phases inside the cross-process tree.
        # One thread-local read when no context is active
        ctx = disttrace.current()
        if ctx is not None:
            rec = disttrace.get_recorder()
            if rec.enabled:
                rec.observe("train." + name, ctx,
                            time.time() - elapsed, elapsed,
                            tags=dict(tags) if tags else None)

    def add(self, name, seconds):
        """Accumulate an externally-timed phase (e.g. a graph capture). Also lands a synthetic span in the recent ring
        — ending NOW, `seconds` long — so externally-timed phases show
        up on /trainz and in exported traces instead of vanishing from
        every per-span view."""
        seconds = float(seconds)
        with self._lock:
            self.acc[name] += seconds
            self.cnt[name] += 1
            start = time.perf_counter() - seconds - self._epoch
            self._recent.append(Span(name, name, start, seconds,
                                     {"synthetic": True},
                                     tid=threading.get_ident()))

    # ----------------------------------------------------------- readers
    def reset(self):
        with self._lock:
            self.acc.clear()
            self.cnt.clear()
            self._last.clear()
            self._recent.clear()
            self._epoch = time.perf_counter()
            self.epoch_wall = time.time()

    def snapshot(self):
        """{phase: total_seconds}, machine-readable."""
        with self._lock:
            return {k: round(v, 6) for k, v in self.acc.items()}

    def delta_snapshot(self):
        """{phase: seconds since the previous delta_snapshot call} —
        only phases that moved. The run journal attaches this to each
        iteration record so per-record phase seconds sum back to the
        run totals."""
        out = {}
        with self._lock:
            for name, total in self.acc.items():
                d = total - self._last.get(name, 0.0)
                if d > 0:
                    out[name] = round(d, 6)
                self._last[name] = total
        return out

    def recent(self, n=32):
        """Last `n` completed spans, oldest first (`/trainz`); `n=None`
        dumps the whole ring (the journal `spans` record at close)."""
        with self._lock:
            spans = list(self._recent)
        if n is not None:
            spans = spans[-int(n):]
        return [s.as_dict() for s in spans]

    def report(self):
        """One line per phase, largest first."""
        with self._lock:
            items = sorted(self.acc.items(), key=lambda kv: -kv[1])
            lines = ["%-12s %8.3fs total, %7.2fms/call x%d"
                     % (name, total, 1e3 * total / max(self.cnt[name], 1),
                        self.cnt[name])
                     for name, total in items]
        return "\n".join(lines)
