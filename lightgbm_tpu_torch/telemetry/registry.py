"""Metrics registry: counters, gauges, histograms under one lock (the
port's copy of lightgbm_tpu/telemetry/registry.py).

No reference equivalent. The serving layer's request accounting
(serving/metrics.py) is built on these primitives: every writer path
takes the registry's single lock, every reader snapshot is consistent,
and histograms are fixed-size rings of the most recent observations so
percentiles track CURRENT behavior in bounded memory.
"""

import threading

import numpy as np

DEFAULT_RING = 4096


def nearest_rank(sorted_values, p):
    """Nearest-rank percentile of an ascending-sorted sequence:
    ceil(n*p/100) - 1 (int() would bias one rank high — p50 of 2
    samples must be the lower one, and p99 of 100 samples rank 98, not
    the absolute max). THE percentile convention every surface shares:
    the serving /metricz latency ring and the fleet load generator's
    gated p99-during-swap must never diverge."""
    n = len(sorted_values)
    # int(): a float p (the router's hedge_quantile * 100) floor-divides
    # to a float rank, which numpy refuses as an index
    return float(sorted_values[int(max(0, -(-n * p // 100) - 1))])


class Counter:
    """Monotonic counter (int/float adds)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0

    def inc(self, n=1):
        with self._lock:
            self.value += n
        return self


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v):
        with self._lock:
            self.value = v
        return self


class Histogram:
    """Ring of the most recent observations with nearest-rank
    percentiles (the serving latency ring's semantics, shared)."""

    __slots__ = ("_lock", "_ring", "_n", "_sum", "last")

    def __init__(self, lock, ring_size=DEFAULT_RING):
        self._lock = lock
        self._ring = np.zeros(int(ring_size), dtype=np.float64)
        self._n = 0          # total observations ever recorded
        self._sum = 0.0
        self.last = 0.0

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._ring[self._n % len(self._ring)] = v
            self._n += 1
            self._sum += v
            self.last = v
        return self

    @property
    def count(self):
        return self._n

    @property
    def total(self):
        return self._sum

    @property
    def window(self):
        """Observations currently inside the ring."""
        return min(self._n, len(self._ring))

    def percentiles(self, pcts=(50, 95, 99)):
        """{p: value} over the ring's recorded window; empty dict
        before the first observation (nearest-rank — see
        `nearest_rank`)."""
        with self._lock:
            n = min(self._n, len(self._ring))
            if n == 0:
                return {}
            window = np.sort(self._ring[:n])
        return {p: nearest_rank(window, p) for p in pcts}

    def summary(self):
        pct = self.percentiles()
        with self._lock:
            return {"count": self._n, "total": round(self._sum, 6),
                    "last": round(self.last, 6),
                    "p50": round(pct.get(50, 0.0), 6),
                    "p95": round(pct.get(95, 0.0), 6),
                    "p99": round(pct.get(99, 0.0), 6)}


class MetricsRegistry:
    """Named counters/gauges/histograms sharing ONE lock (writers are
    short critical sections; a single lock keeps snapshot() consistent
    without lock ordering concerns — the serving metrics' discipline).
    get-or-create accessors are themselves locked so concurrent first
    touches of the same name return the same instrument.

    The lock is REENTRANT and exposed (`lock`) so a caller updating
    several instruments that must stay mutually consistent (e.g. the
    serving layer's request counters + latency ring) can hold it across
    the whole group while the individual `inc`/`observe` calls
    re-acquire it harmlessly."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters = {}
        self._gauges = {}
        self._hists = {}

    @property
    def lock(self):
        return self._lock

    # ------------------------------------------------------ instruments
    def counter(self, name):
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(self._lock)
        return c

    def gauge(self, name):
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(self._lock)
        return g

    def histogram(self, name, ring_size=DEFAULT_RING):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(self._lock, ring_size)
        return h

    # ------------------------------------------------------ conveniences
    def inc(self, name, n=1):
        return self.counter(name).inc(n)

    def set(self, name, v):
        return self.gauge(name).set(v)

    def observe(self, name, v):
        return self.histogram(name).observe(v)

    # ----------------------------------------------------------- readers
    def snapshot(self):
        """One JSON-ready dict: counters and gauges verbatim, histograms
        as {count,total,last,p50,p95,p99} summaries."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hist_names = list(self._hists)
        hists = {k: self._hists[k].summary() for k in hist_names}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}
