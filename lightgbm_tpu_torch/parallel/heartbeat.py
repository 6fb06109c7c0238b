"""Heartbeats and the collective watchdog of the multi-process runtime
(port of lightgbm_tpu/parallel/heartbeat.py: CollectiveWatchdog :92,
HeartbeatService :182, collective_guard :423, configure :433).

A process gang must not hang when a rank dies, so each rank both proves
its own liveness and bounds how long it waits on its peers:

- **Heartbeats**: every rank publishes a monotonic beat (seq, iteration,
  wall time, last sync timing) as one small JSON file in a shared
  directory (the snapshot directory), in the JAX package's format, so
  one supervisor reads both packages' beats. A daemon thread on every
  rank re-publishes and scans its peers: a peer whose beat has not
  changed for `heartbeat_timeout_s` of this process's monotonic time is
  declared dead, and the rank exits with EXIT_PEER_LOST.
- **Collective watchdog**: a host timer armed around each blocking
  device-sync point (a tree's `mesh.run`, the tree's fetch, the snapshot
  gathers; parallel/learners.py, models/gbdt.py, application.py). On
  expiry it logs which rank, iteration and collective hung, drops a
  marker file for the supervisor and exits with EXIT_WATCHDOG. An NCCL
  collective whose peer died blocks until then. A gloo collective
  usually fails at once instead (the peer's socket closes): the mesh
  raises CollectiveFailed, and an armed guard ends the rank the same
  way, naming the collective and the cause.

Torch-free, so a supervisor can import it without touching the device.
"""

import contextlib
import json
import os
import threading
import time

from ..utils import faults
from ..utils.log import Log

# distinct restartable exit codes (both differ from
# faults.HARD_CRASH_EXIT_CODE = 43, so an injected kill and a detected
# failure stay apart)
EXIT_WATCHDOG = 117    # this rank gave up inside a collective
EXIT_PEER_LOST = 118   # this rank saw a peer's heartbeat go stale

HEARTBEAT_SUBDIR = "heartbeats"


class CollectiveFailed(RuntimeError):
    """A collective could not complete because a peer is gone (its
    transport failed); raised by the process mesh."""


def heartbeat_dir(shared_dir):
    return os.path.join(os.fspath(shared_dir), HEARTBEAT_SUBDIR)


def heartbeat_path(directory, rank):
    return os.path.join(os.fspath(directory), f"hb.rank{int(rank):04d}.json")


def watchdog_marker_path(directory, rank):
    return os.path.join(os.fspath(directory),
                        f"watchdog.rank{int(rank):04d}.json")


def atomic_write_json(path, payload):
    """Small-file atomic publish (tmp + os.replace, no fsync: a lost beat
    is harmless, a torn concurrent read is not)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except OSError as e:
        Log.warning("heartbeat write failed (%s): %s", path, e)
        try:
            os.unlink(tmp)
        except OSError:
            pass


def read_heartbeat(path):
    """One heartbeat file; None when missing, torn or foreign."""
    try:
        with open(path) as f:
            beat = json.load(f)
    except (OSError, ValueError):
        return None
    return beat if isinstance(beat, dict) and "seq" in beat else None


class CollectiveWatchdog:
    """Host-side timer bracketing blocking device-sync points.

    `armed(name)` starts a daemon timer before the sync and cancels it
    after; if the sync outlives `timeout_s` the expiry handler logs the
    (rank, iteration, collective) triple, writes a marker file into the
    shared directory and `os._exit(EXIT_WATCHDOG)` (a blocked collective
    cannot be interrupted from Python). A CollectiveFailed raised inside
    an armed section takes the same exit, with its cause. `timeout_s`
    must exceed the slowest legitimate sync (the first tree's kernel
    builds included); 0 disables. Armed sections record their elapsed
    time (`timings`, `last_sync_s`), the straggler signal the heartbeats
    carry."""

    def __init__(self, timeout_s=0.0, rank=0, on_expire=None,
                 marker_dir=None):
        self.timeout_s = float(timeout_s)
        self.rank = int(rank)
        self.iteration = -1
        self.on_expire = on_expire  # tests inject; None = log+marker+exit
        self.marker_dir = marker_dir
        self.timings = {}           # collective name -> last elapsed s
        self.last_sync_s = 0.0

    def set_iteration(self, iteration):
        self.iteration = int(iteration)

    def _expire(self, name, iteration, cause=None):
        if cause is None:
            Log.warning(
                "collective watchdog expired: rank %d hung in %r at "
                "iteration %d for more than %.1fs: a peer is dead or "
                "stalled; aborting with exit code %d",
                self.rank, name, iteration, self.timeout_s, EXIT_WATCHDOG)
        else:
            Log.warning(
                "collective watchdog: rank %d lost a peer in %r at "
                "iteration %d (%s); aborting with exit code %d",
                self.rank, name, iteration, cause, EXIT_WATCHDOG)
        if self.marker_dir:
            marker = {"rank": self.rank, "collective": name,
                      "iteration": iteration, "timeout_s": self.timeout_s,
                      "time": time.time()}
            if cause is not None:
                marker["cause"] = str(cause)
            atomic_write_json(
                watchdog_marker_path(self.marker_dir, self.rank), marker)
        _flight_dump("collective_watchdog", collective=name,
                     iteration=int(iteration), timeout_s=self.timeout_s)
        # the abort lands in the run journal's timeline, where the
        # supervisor's restart and the resume follow it
        _journal_abort(EXIT_WATCHDOG, "collective_watchdog",
                       collective=name, iteration=int(iteration))
        if self.on_expire is not None:
            self.on_expire(name, iteration)
            return
        os._exit(EXIT_WATCHDOG)

    @contextlib.contextmanager
    def armed(self, name):
        # disarmed and no timing sink: zero overhead
        if self.timeout_s <= 0 and _TIMING_SINK is None:
            yield
            return
        timer = None
        if self.timeout_s > 0:
            timer = threading.Timer(self.timeout_s, self._expire,
                                    (name, self.iteration))
            timer.daemon = True
            timer.start()
        start = time.monotonic()
        _GUARDED.depth = getattr(_GUARDED, "depth", 0) + 1
        try:
            yield
        except CollectiveFailed as e:
            if timer is not None:
                timer.cancel()
                self._expire(name, self.iteration, cause=e)
            raise
        finally:
            _GUARDED.depth -= 1
            if timer is not None:
                timer.cancel()
            elapsed = time.monotonic() - start
            self.timings[name] = elapsed
            self.last_sync_s = elapsed
            if _TIMING_SINK is not None:
                try:
                    _TIMING_SINK(name, elapsed)
                except Exception:   # telemetry must never kill training
                    pass


class HeartbeatService:
    """Per-rank heartbeat publisher and peer monitor (one daemon thread).

    Publishes this rank's beat every `interval_s` (default timeout / 4)
    and scans its peers; `dead_peers()` lists ranks whose beat has not
    advanced for `timeout_s` of local monotonic time. A rank that never
    publishes gets one full timeout of grace from monitor start. On
    detection the monitor calls `on_peer_lost(ranks)` once; by default it
    logs and `os._exit(EXIT_PEER_LOST)`, while the main thread may still
    be blocked in a collective."""

    def __init__(self, directory, rank, num_ranks, timeout_s,
                 interval_s=None, iteration_fn=None, watchdog=None,
                 on_peer_lost=None):
        self.directory = os.fspath(directory)
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self.timeout_s = float(timeout_s)
        self.interval_s = (float(interval_s) if interval_s
                           else max(self.timeout_s / 4.0, 0.05))
        self.iteration_fn = iteration_fn      # () -> current iteration
        self.watchdog = watchdog              # straggler timing source
        self.on_peer_lost = on_peer_lost      # tests inject
        self.last_snapshot = None             # (iteration, path)
        self._seq = 0
        self._peers = {}   # rank -> [last (pid, seq), last change, done]
        self._started = None
        self._stop = threading.Event()
        self._thread = None
        self._fired = False
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------ publish
    def publish(self, done=False):
        """Write this rank's beat (skipped under the `heartbeat_stale`
        fault: the process lives on but looks dead to its peers)."""
        if faults.heartbeat_suppressed(self.rank):
            return
        self._seq += 1
        iteration = -1
        if self.iteration_fn is not None:
            try:
                iteration = int(self.iteration_fn())
            except Exception:   # a booster mid-teardown must not kill it
                iteration = -1
        beat = {"rank": self.rank, "seq": self._seq, "pid": os.getpid(),
                "iteration": iteration, "time": time.time(),
                "sync_s": round(getattr(self.watchdog, "last_sync_s", 0.0)
                                or 0.0, 6)}
        if done:
            beat["done"] = True
        if self.last_snapshot is not None:
            beat["snapshot_iteration"] = int(self.last_snapshot[0])
        if _BEAT_EXTRA is not None:
            # the telemetry piggyback: this rank's cumulative collective
            # wait (telemetry/comm_profile.py), for the peers' straggler
            # deltas
            try:
                extra = _BEAT_EXTRA() or {}
                beat.update({k: v for k, v in extra.items()
                             if k not in beat})
            except Exception:   # telemetry must never kill the beat
                pass
        atomic_write_json(heartbeat_path(self.directory, self.rank), beat)

    def notify_snapshot(self, iteration, path):
        """Record the newest saved snapshot, so the beats say where a
        restart would resume from."""
        self.last_snapshot = (int(iteration), os.fspath(path))

    # -------------------------------------------------------------- scan
    def scan(self):
        """Refresh the peers' freshness. Returns {rank: beat or None}."""
        now = time.monotonic()
        if self._started is None:
            self._started = now
        beats = {}
        for rank in range(self.num_ranks):
            if rank == self.rank:
                continue
            beat = read_heartbeat(heartbeat_path(self.directory, rank))
            beats[rank] = beat
            state = self._peers.get(rank)
            if state is None:
                # first sight (or still missing): full grace from start
                state = self._peers[rank] = [None, self._started, False]
            if beat is not None:
                key = (beat.get("pid"), beat["seq"])
                if key != state[0]:
                    state[0] = key
                    state[1] = now
                state[2] = bool(beat.get("done"))
        return beats

    def peer_ages(self):
        """{rank: seconds since this process last saw its beat change}."""
        now = time.monotonic()
        return {rank: now - state[1] for rank, state in self._peers.items()}

    def dead_peers(self):
        """Ranks stale past `timeout_s` (finished ranks never count)."""
        return sorted(rank for rank, age in self.peer_ages().items()
                      if age > self.timeout_s and not self._peers[rank][2])

    def straggler_report(self, beats):
        """The slowest rank's delta of the last published sync timings,
        e.g. 'rank 1 slowest (+2.31s sync delta at iteration 7)'; None
        with fewer than two live timings."""
        timings = {self.rank: getattr(self.watchdog, "last_sync_s", 0.0)
                   or 0.0}
        iteration = -1
        for rank, beat in beats.items():
            if beat is not None and not beat.get("done"):
                timings[rank] = float(beat.get("sync_s", 0.0))
                iteration = max(iteration, int(beat.get("iteration", -1)))
        if len(timings) < 2:
            return None
        slowest = max(timings, key=timings.get)
        delta = timings[slowest] - min(timings.values())
        return (f"rank {slowest} slowest (+{delta:.2f}s sync delta at "
                f"iteration {iteration})")

    # ------------------------------------------------------------ thread
    def check_once(self):
        """One publish and scan; fires on_peer_lost on new deaths."""
        self.publish()
        beats = self.scan()
        report = self.straggler_report(beats)
        if report:
            Log.debug("heartbeat monitor: %s", report)
        dead = self.dead_peers()
        if dead and not self._fired:
            self._fired = True
            ages = self.peer_ages()
            Log.warning(
                "heartbeat monitor: rank(s) %s declared dead: no heartbeat "
                "for %s (timeout %.1fs); last straggler state: %s",
                dead, ", ".join(f"{ages[r]:.1f}s" for r in dead),
                self.timeout_s, report or "n/a")
            _flight_dump("peer_lost", dead_ranks=[int(r) for r in dead])
            _journal_abort(EXIT_PEER_LOST, "peer_lost",
                           dead_ranks=[int(r) for r in dead])
            if self.on_peer_lost is not None:
                self.on_peer_lost(dead)
            else:
                Log.warning("aborting with exit code %d so a supervisor "
                            "can restart from the newest shared snapshot",
                            EXIT_PEER_LOST)
                os._exit(EXIT_PEER_LOST)
        return dead

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception as e:  # the monitor must never kill training
                Log.warning("heartbeat monitor error: %s", e)

    def start(self):
        if self._thread is not None:
            return self
        self._started = time.monotonic()
        self.publish()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lgbm-torch-heartbeat")
        self._thread.start()
        return self

    def stop(self, done=True):
        """Stop the monitor; a final `done` beat tells the peers this rank
        finished cleanly (a finished rank must never look dead)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2 * self.interval_s, 1.0))
            self._thread = None
        if done:
            self.publish(done=True)


# ---------------------------------------------------------- module state
#
# One watchdog and at most one heartbeat service a process, configured
# by the CLI (application.py) or an embedder. WATCHDOG is mutated in
# place so call sites can bind `collective_guard` once.

WATCHDOG = CollectiveWatchdog(0.0)
_SERVICE = None
_TIMING_SINK = None   # (collective name, elapsed s) -> None
_BEAT_EXTRA = None    # () -> dict merged into each published beat
_GUARDED = threading.local()   # depth of measuring guarded sections


def bind_timing_sink(fn):
    """Route every guarded section's elapsed time into `fn`; None
    unbinds. A bound sink makes guarded sections measure even with the
    watchdog disarmed."""
    global _TIMING_SINK
    _TIMING_SINK = fn


def bind_beat_extra(fn):
    """Merge `fn()`'s dict into every published beat; None unbinds."""
    global _BEAT_EXTRA
    _BEAT_EXTRA = fn


def report_timing(name, elapsed):
    """Hand one measured wait to the bound timing sink (a no-op without
    one, or inside a guarded section, which times it already): the
    process mesh reports its transfers through it."""
    if _TIMING_SINK is not None and not getattr(_GUARDED, "depth", 0):
        try:
            _TIMING_SINK(name, elapsed)
        except Exception:   # telemetry must never kill training
            pass


def _flight_dump(reason, **fields):
    """Best-effort blackbox dump (telemetry/disttrace.py FLIGHT) from an
    abort path: the dump is evidence, the abort proceeds regardless."""
    try:
        from ..telemetry import disttrace
        disttrace.FLIGHT.dump(reason, **fields)
    except Exception:   # evidence collection must never mask the abort
        pass


def _journal_abort(exit_code, reason, **fields):
    """Best-effort `abort` record into the active run journal (no-op
    without one): one O_APPEND line, safe from the watchdog or monitor
    thread just before os._exit."""
    try:
        from ..telemetry import journal as run_journal
        j = run_journal.current()
        if j is not None:
            j.event("abort", exit_code=int(exit_code), reason=reason,
                    **fields)
    except Exception:   # telemetry must never mask the abort itself
        pass


def collective_guard(name):
    """Context manager arming the process watchdog around one blocking
    device-sync point; no-op until `configure` enables it."""
    return WATCHDOG.armed(name)


def service():
    return _SERVICE


def configure(config, shared_dir, rank, num_ranks, iteration_fn=None):
    """Enable the primitives from config knobs: `collective_timeout_s`
    arms the watchdog, `heartbeat_timeout_s` (> 0, several ranks, a
    shared directory) starts the heartbeat service. Returns the service
    (or None). Idempotent per process."""
    global _SERVICE
    WATCHDOG.timeout_s = float(getattr(config, "collective_timeout_s", 0.0)
                               or 0.0)
    WATCHDOG.rank = int(rank)
    timeout = float(getattr(config, "heartbeat_timeout_s", 0.0) or 0.0)
    if shared_dir:
        WATCHDOG.marker_dir = heartbeat_dir(shared_dir)
        if WATCHDOG.timeout_s > 0:
            os.makedirs(WATCHDOG.marker_dir, exist_ok=True)
    if _SERVICE is not None:
        return _SERVICE
    if timeout > 0 and num_ranks > 1 and shared_dir:
        _SERVICE = HeartbeatService(
            heartbeat_dir(shared_dir), rank, num_ranks, timeout,
            iteration_fn=iteration_fn, watchdog=WATCHDOG).start()
        Log.info("heartbeat service: rank %d of %d publishing to %s every "
                 "%.2fs (peer timeout %.1fs)", rank, num_ranks,
                 _SERVICE.directory, _SERVICE.interval_s, timeout)
    return _SERVICE


def notify_checkpoint(iteration, path):
    """Record a freshly saved snapshot in the published beats."""
    if _SERVICE is not None:
        _SERVICE.notify_snapshot(iteration, path)


def shutdown(done=True):
    """Stop the service and disarm the watchdog (the end of a run)."""
    global _SERVICE
    if _SERVICE is not None:
        _SERVICE.stop(done=done)
        _SERVICE = None
    WATCHDOG.timeout_s = 0.0
    bind_timing_sink(None)
    bind_beat_extra(None)
