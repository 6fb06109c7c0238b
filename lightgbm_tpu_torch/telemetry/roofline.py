"""Roofline attribution: live per-kernel bandwidth against a measured peak
(the port of lightgbm_tpu/telemetry/roofline.py).

The kernel wrappers of ops/hist_kernels.py and ops/mesh_kernels.py record
each call into a process-wide table: seconds, bytes streamed and rows
scanned. `/trainz` serves every kernel's achieved bytes/s and rows/s
against a once-measured copy peak, and `roofline_warn_fraction > 0`
names the kernels below that fraction of the peak at the end of a run.

On the card a call's seconds come from a CUDA event pair recorded around
its eager launch. The pair is resolved when the table is read, never by
a sync at the call: a call costs two event records on its stream. A
launch inside a CUDA graph capture is not recorded (its replays run
without the wrapper), and the table counts those captures apart
(`captured_unrecorded`), as the JAX module says that in-graph kernels
are invisible to host timers. On the CPU a wrapper runs its plain
version synchronously and records its host seconds.

The table records only while `enabled` (a booster with `telemetry=true`
turns it on), so a run without telemetry pays one attribute read a call.

The peak is measured once a process: on the card a device-to-device copy
timed by CUDA events (read + write bytes, the STREAM COPY accounting);
without one a host numpy copy, as the JAX module measured. The
LIGHTGBM_TPU_STREAM_PEAK environment variable (bytes/s) pins it.
"""

import os
import threading
import time

PEAK_ENV = "LIGHTGBM_TPU_STREAM_PEAK"
# pending event pairs are resolved (without waiting) once this many wait
PENDING_RESOLVE = 4096

_PEAK_LOCK = threading.Lock()
_PEAK = None


def measure_host_peak(size_mb=64, reps=3):
    """STREAM-style COPY bandwidth of this host (bytes/s): the best of
    `reps` timed numpy copies, counting read + write bytes."""
    import numpy as np
    n = int(size_mb) * (1 << 20) // 8
    src = np.ones(n, dtype=np.float64)
    dst = np.empty_like(src)
    best = 0.0
    for _ in range(int(reps)):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        dt = time.perf_counter() - t0
        best = max(best, 2.0 * src.nbytes / max(dt, 1e-9))
    return best


def measure_device_peak(device=None, size_mb=256, reps=5):
    """COPY bandwidth of the card (bytes/s): the best of `reps`
    device-to-device copies of a `size_mb` buffer, each timed by a CUDA
    event pair, counting read + write bytes. One warm-up copy first."""
    import torch
    device = torch.device(device or "cuda")
    n = int(size_mb) << 20
    src = torch.ones(n, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    best = 0.0
    with torch.cuda.device(device):
        for _ in range(int(reps)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            best = max(best, 2.0 * n / max(ms * 1e-3, 1e-12))
    return best


def stream_peak_bytes_per_s():
    """The cached process-wide peak: the environment's pin, else the
    card's copy when a card is initialised, else the host's."""
    global _PEAK
    with _PEAK_LOCK:
        if _PEAK is None:
            env = os.environ.get(PEAK_ENV)
            try:
                _PEAK = float(env) if env else None
            except ValueError:
                _PEAK = None
            if _PEAK is None:
                import sys
                torch = sys.modules.get("torch")
                if torch is not None and torch.cuda.is_initialized():
                    _PEAK = measure_device_peak()
                else:
                    _PEAK = measure_host_peak()
        return _PEAK


class RooflineTable:
    """Per-kernel (calls, seconds, bytes, rows) accumulator with
    peak-relative snapshots; card calls wait as event pairs until read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._kernels = {}
        self._pending = []          # (kernel, start, end, nbytes, rows)
        self.captured_unrecorded = 0
        self.enabled = False

    def _add(self, kernel, seconds, nbytes, rows):
        k = self._kernels.get(kernel)
        if k is None:
            k = self._kernels[kernel] = {"calls": 0, "seconds": 0.0,
                                         "bytes": 0, "rows": 0}
        k["calls"] += 1
        k["seconds"] += float(seconds)
        k["bytes"] += int(nbytes)
        k["rows"] += int(rows)

    def record(self, kernel, seconds, nbytes, rows):
        """One kernel execution timed on the host: `nbytes` streamed,
        `rows` scanned, in `seconds`."""
        with self._lock:
            self._add(kernel, seconds, nbytes, rows)

    def record_events(self, kernel, start, end, nbytes, rows):
        """One card launch bracketed by the recorded CUDA events
        start/end; resolved when the table is read."""
        with self._lock:
            self._pending.append((kernel, start, end, nbytes, rows))
            if len(self._pending) >= PENDING_RESOLVE:
                self._resolve(wait=False)

    def note_captured(self):
        with self._lock:
            self.captured_unrecorded += 1

    def _resolve(self, wait):
        """Fold finished event pairs into the totals (every pair when
        `wait`: the read waits for the last recorded launch). Holds the
        lock."""
        keep = []
        for kernel, start, end, nbytes, rows in self._pending:
            if not wait and not end.query():
                keep.append((kernel, start, end, nbytes, rows))
                continue
            end.synchronize()
            self._add(kernel, start.elapsed_time(end) * 1e-3, nbytes, rows)
        self._pending = keep

    def reset(self):
        with self._lock:
            self._kernels.clear()
            self._pending = []
            self.captured_unrecorded = 0

    def snapshot(self, warn_fraction=0.0, peak=None):
        """JSON-ready per-kernel roofline view. `peak` defaults to the
        process's measured copy peak; kernels whose achieved bytes/s fall
        below `warn_fraction * peak` carry `below_peak_fraction: true`."""
        with self._lock:
            self._resolve(wait=True)
            kernels = {name: dict(k) for name, k in self._kernels.items()}
            captured = self.captured_unrecorded
        if not kernels:
            return {"peak_bytes_per_s": None, "kernels": {},
                    "captured_unrecorded": captured}
        if peak is None:
            peak = stream_peak_bytes_per_s()
        out = {}
        for name, k in kernels.items():
            secs = k["seconds"]
            entry = {"calls": k["calls"], "seconds": round(secs, 6),
                     "bytes": k["bytes"], "rows": k["rows"]}
            if secs > 0:
                bps = k["bytes"] / secs
                entry["bytes_per_s"] = round(bps, 1)
                entry["rows_per_s"] = round(k["rows"] / secs, 1)
                if peak:
                    entry["pct_of_peak"] = round(100.0 * bps / peak, 2)
                    if warn_fraction > 0:
                        entry["below_peak_fraction"] = \
                            bool(bps < warn_fraction * peak)
            out[name] = entry
        return {"peak_bytes_per_s": round(peak, 1) if peak else None,
                "kernels": out, "captured_unrecorded": captured}


TABLE = RooflineTable()


class _Timed:
    """Context manager of one wrapper call (see `timed`)."""

    __slots__ = ("_kernel", "_device", "_nbytes", "_rows", "_start",
                 "_t0")

    def __init__(self, kernel, device, nbytes, rows):
        self._kernel = kernel
        self._device = device
        self._nbytes = nbytes
        self._rows = rows
        self._start = None
        self._t0 = None

    def __enter__(self):
        if self._device.type == "cuda":
            import torch
            if torch.cuda.is_current_stream_capturing():
                TABLE.note_captured()
                self._device = None
                return self
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None or self._device is None:
            return False
        if self._start is not None:
            import torch
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            TABLE.record_events(self._kernel, self._start, end,
                                self._nbytes, self._rows)
        else:
            TABLE.record(self._kernel, time.perf_counter() - self._t0,
                         self._nbytes, self._rows)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def timed(kernel, device, nbytes, rows):
    """Bracket one kernel wrapper call on `device` for the table (a no-op
    context while the table is off). `nbytes` and `rows` may be
    callables, evaluated only when the table records."""
    if not TABLE.enabled:
        return _OFF
    if callable(nbytes):
        nbytes = nbytes()
    if callable(rows):
        rows = rows()
    return _Timed(kernel, device, int(nbytes), int(rows))
