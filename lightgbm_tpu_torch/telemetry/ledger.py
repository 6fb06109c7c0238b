"""Set-up ledger and device-memory sampling (the port's
lightgbm_tpu/telemetry/ledger.py).

The JAX package's ledger records XLA compiles from jax.monitoring. The
port compiles nothing per shape; what a process pays for before its
first answer is its own:

- kernel-library builds: nvcc at first use, or a library found already
  built in csrc/build/ (ops/traverse_kernels.py library()), event
  "kernel_library";
- per-bucket warm-up: each (kernel, row bucket) pair a CompiledPredictor
  runs once at load (serving/compiled_model.py warm_up), event
  "warm_bucket", under the label `serving_bucket_<rows>`.

`LEDGER.label(name)` attributes records on the current thread (innermost
label wins); `snapshot()` is the /metricz-style view; `drain()` hands new
entries to a writer exactly once each. `sample_memory()` reads the CUDA
allocator (torch.cuda.memory_stats) when a card is initialised, and the
host RSS and peak RSS always.
"""

import os
import threading
import time
from collections import deque

RECENT_ENTRIES = 256


class SetupLedger:
    """Process-wide ledger of set-up work (see module docstring)."""

    def __init__(self, ring=RECENT_ENTRIES):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._recent = deque(maxlen=ring)
        self._undrained = []
        self.entries = 0
        self.total_s = 0.0
        self.cache_hits = 0
        self.cache_misses = 0

    # ----------------------------------------------------------- labels
    def _labels(self):
        stack = getattr(self._local, "labels", None)
        if stack is None:
            stack = self._local.labels = []
        return stack

    def current_label(self):
        stack = self._labels()
        return stack[-1] if stack else ""

    def label(self, name):
        """Context manager attributing records inside it to `name`."""
        return _LabelContext(self, str(name))

    # ------------------------------------------------------------ record
    def record(self, event, seconds, cache_hit=None):
        """One entry: `event` took `seconds`; `cache_hit` says whether a
        build was found done (None where the question does not apply)."""
        entry = {"label": self.current_label(), "event": str(event),
                 "seconds": float(seconds), "ts": time.time(),
                 "cache_hit": bool(cache_hit)}
        with self._lock:
            self.entries += 1
            self.total_s += float(seconds)
            if cache_hit is True:
                self.cache_hits += 1
            elif cache_hit is False:
                self.cache_misses += 1
            self._recent.append(entry)
            self._undrained.append(entry)

    # ----------------------------------------------------------- readers
    def snapshot(self, recent_n=32):
        """JSON-ready totals + the most recent entries."""
        with self._lock:
            recent = (list(self._recent)[-int(recent_n):]
                      if recent_n else [])
            return {"entries": self.entries,
                    "total_s": round(self.total_s, 6),
                    "cache_hits": self.cache_hits,
                    "cache_misses": self.cache_misses,
                    "recent": [dict(e) for e in recent]}

    def drain(self):
        """Entries recorded since the previous drain."""
        with self._lock:
            out, self._undrained = self._undrained, []
        return out

    def reset(self):
        with self._lock:
            self._recent.clear()
            self._undrained = []
            self.entries = 0
            self.total_s = 0.0
            self.cache_hits = 0
            self.cache_misses = 0


class _LabelContext:
    __slots__ = ("_ledger", "_name")

    def __init__(self, ledger, name):
        self._ledger = ledger
        self._name = name

    def __enter__(self):
        self._ledger._labels().append(self._name)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = self._ledger._labels()
        if stack and stack[-1] == self._name:
            stack.pop()
        return False


LEDGER = SetupLedger()


# ------------------------------------------------------- memory sampling

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _host_rss_bytes():
    """Current RSS from /proc/self/statm (one read, ~microseconds)."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return None


def _host_peak_rss_bytes():
    try:
        import resource
        # linux ru_maxrss is kilobytes
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


def _device_memory():
    """(bytes_in_use, peak_bytes_in_use) of the current CUDA device's
    allocator, or (None, None) without an initialised card (sampling
    never initialises one)."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None, None
    try:
        stats = torch.cuda.memory_stats()
    except Exception:
        return None, None
    in_use = stats.get("allocated_bytes.all.current")
    peak = stats.get("allocated_bytes.all.peak", in_use)
    return (int(in_use) if in_use is not None else None,
            int(peak) if peak is not None else None)


def sample_memory():
    """One point-in-time memory sample: only the fields that exist on
    this machine."""
    out = {}
    dev, dev_peak = _device_memory()
    if dev is not None:
        out["device_bytes_in_use"] = dev
    if dev_peak is not None:
        out["device_peak_bytes"] = dev_peak
    rss = _host_rss_bytes()
    if rss is not None:
        out["host_rss_bytes"] = rss
    peak = _host_peak_rss_bytes()
    if peak is not None:
        out["host_peak_rss_bytes"] = peak
    return out
