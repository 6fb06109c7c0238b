"""Collective latency and overlap attribution across ranks (the port of
lightgbm_tpu/telemetry/comm_profile.py).

The mesh counts collective bytes exactly (parallel/mesh.py CommPlan);
this module measures the time. Every host-visible wait of a collective
runs inside a section the collective watchdog brackets
(`heartbeat.collective_guard`: `leaf_count_sync`, `ooc:hist_exchange`,
...), and on a ProcessMesh every transfer of the backend (`_transfer`,
`mesh:<collective>`) reports its own elapsed time too. The profiler
rides the `heartbeat.bind_timing_sink` hook, attributes each section's
seconds to its name, and splits them into

- **sync waits**: sections that only wait for a device or cross-rank
  result; the comm latency that compute did not hide, plus straggler
  skew;
- **dispatch windows**: sections that contain the compute itself
  (`*tree_build`, `fused_block`), reported apart, never counted as
  wait.

Per journal record (one per iteration or fused block):

    comm_overlap_pct = 100 * (1 - wait_s / wall_s)

Straggler attribution reads the peers' cumulative waits from their
heartbeat beats (`heartbeat.bind_beat_extra` -> beat field
`comm_wait_s`): `straggler_deltas` reports how much more each rank has
waited than the fastest. stdlib only; wired by models/gbdt.py under the
`comm_telemetry` knob.
"""

import threading
import time

# guarded sections whose elapsed time CONTAINS the tree build's compute
# (the collectives inside them are the ones overlap is supposed to
# hide) — attributed as dispatch, never as wait
DISPATCH_SECTIONS = ("tree_build", "fused_block")


def is_dispatch(name):
    return str(name).endswith(DISPATCH_SECTIONS)


def overlap_pct(wait_s, wall_s):
    """100 = all collective latency hidden under compute; clipped to
    [0, 100] (a wait can span a wall boundary by a rounding hair)."""
    if wall_s <= 0:
        return 100.0
    return max(0.0, min(100.0, 100.0 * (1.0 - wait_s / wall_s)))


class CommProfiler:
    """Per-process collective timing accumulator (see module
    docstring). `record` is the timing-sink callback — a dict update
    under one lock, cheap enough for every guarded section; `flush`
    closes one iteration/block window and returns the journal-ready
    `comm` record."""

    def __init__(self, rank=0):
        self.rank = int(rank)
        self._lock = threading.Lock()
        self._window = {}    # collective name -> seconds since flush
        self._totals = {}    # collective name -> [count, seconds]
        self._mark = time.monotonic()
        self.cum_wait_s = 0.0       # sync waits only, process-cumulative
        self.cum_dispatch_s = 0.0
        self.cum_wall_s = 0.0       # wall covered by flushed windows
        self.last = {}               # last flushed record (live views)

    # ------------------------------------------------------------ writers
    def record(self, name, seconds):
        """Timing-sink callback: one guarded section completed."""
        name = str(name)
        seconds = float(seconds)
        with self._lock:
            self._window[name] = self._window.get(name, 0.0) + seconds
            tot = self._totals.get(name)
            if tot is None:
                tot = self._totals[name] = [0, 0.0]
            tot[0] += 1
            tot[1] += seconds
            if is_dispatch(name):
                self.cum_dispatch_s += seconds
            else:
                self.cum_wait_s += seconds

    def flush(self, iteration):
        """Close the current window: per-collective waits since the
        last flush, the wall seconds the window covered, and the
        derived overlap. Returns the `comm` journal record, or None
        when nothing was measured (no sink-armed sections ran — e.g.
        telemetry off, or a serial run before the first sync)."""
        now = time.monotonic()
        with self._lock:
            wall = max(now - self._mark, 1e-9)
            self._mark = now
            self.cum_wall_s += wall
            if not self._window:
                return None
            waits = {n: round(s, 6) for n, s in self._window.items()}
            self._window = {}
        wait = sum(s for n, s in waits.items() if not is_dispatch(n))
        dispatch = sum(s for n, s in waits.items() if is_dispatch(n))
        rec = {"iteration": int(iteration), "waits": waits,
               "wait_s": round(wait, 6),
               "dispatch_s": round(dispatch, 6),
               "wall_s": round(wall, 6),
               "overlap_pct": round(overlap_pct(wait, wall), 2)}
        self.last = rec
        return rec

    # ------------------------------------------------------------ readers
    def totals(self):
        """{collective: {count, seconds}} over the process lifetime."""
        with self._lock:
            return {n: {"count": c, "seconds": round(s, 6)}
                    for n, (c, s) in sorted(self._totals.items())}

    def straggler_deltas(self, service=None):
        """{rank: seconds} of extra cumulative collective wait vs the
        fleet's fastest rank, from the heartbeat beats (peers publish
        `comm_wait_s` via the beat piggyback). None without a running
        heartbeat service or before peers have published. Reads the
        beat files directly — the monitor thread owns the service's
        freshness state, a scrape must not mutate it."""
        if service is None:
            from ..parallel import heartbeat
            service = heartbeat.service()
        if service is None:
            return None
        from ..parallel import heartbeat
        waits = {self.rank: self.cum_wait_s}
        for rank in range(service.num_ranks):
            if rank == self.rank:
                continue
            beat = heartbeat.read_heartbeat(
                heartbeat.heartbeat_path(service.directory, rank))
            if beat is not None and isinstance(
                    beat.get("comm_wait_s"), (int, float)):
                waits[rank] = float(beat["comm_wait_s"])
        if len(waits) < 2:
            return None
        fastest = min(waits.values())
        return {str(r): round(w - fastest, 6)
                for r, w in sorted(waits.items())}

    def snapshot(self, service=None):
        """The /trainz + aggregator view: lifetime per-collective
        totals, cumulative wait/dispatch split, the last flushed
        per-iteration record, and the straggler deltas when a
        heartbeat service is running."""
        with self._lock:
            cum_wait = self.cum_wait_s
            cum_dispatch = self.cum_dispatch_s
            cum_wall = self.cum_wall_s
            last = dict(self.last)
        out = {"rank": self.rank,
               "cum_wait_s": round(cum_wait, 6),
               "cum_dispatch_s": round(cum_dispatch, 6),
               "cum_wall_s": round(cum_wall, 6),
               "totals": self.totals(),
               "last": last}
        if "overlap_pct" in last:
            out["overlap_pct"] = last["overlap_pct"]
        if cum_wall > 0:
            # run-aggregate view: one number for the whole run, not
            # the latest window — what history should trend (a
            # single iteration's overlap is per-iteration noise)
            out["run_overlap_pct"] = round(
                overlap_pct(cum_wait, cum_wall), 2)
        deltas = self.straggler_deltas(service)
        if deltas is not None:
            out["straggler_s"] = deltas
        return out
