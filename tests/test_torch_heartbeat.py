"""lightgbm_tpu_torch's heartbeats, collective watchdog and rank faults
(parallel/heartbeat.py, utils/faults.py), the cases of
tests/test_supervisor.py:29-184 against the port's modules, plus:
- a beat file written by the port reads back through the JAX package's
  read_heartbeat with the same fields, and the other way round;
- an armed guard turns a collective that failed because a peer is gone
  (CollectiveFailed, what the process mesh raises) into the watchdog's
  exit at once, naming the collective, the iteration and the rank;
  disarmed, the error propagates;
- `Log.set_rank` prefixes every line with the rank.
"""

import json
import os
import time

import pytest

from lightgbm_tpu_torch.parallel import heartbeat as hb
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.log import Log


@pytest.fixture(autouse=True)
def _clean_faults_and_log():
    saved = faults.active()
    level = Log._level
    faults.clear_faults()
    Log.reset_log_level(1)   # an earlier test's verbose=-1 hides warnings
    yield
    Log.reset_log_level(level)
    faults.clear_faults()
    for k, v in saved.items():
        faults.set_fault(k, v)
    faults._rank = None


# ------------------------------------------------------------- heartbeats

def test_heartbeat_publish_and_expiry(tmp_path):
    lost = []
    s0 = hb.HeartbeatService(tmp_path, 0, 2, timeout_s=0.5,
                             interval_s=0.1, on_peer_lost=lost.append)
    s1 = hb.HeartbeatService(tmp_path, 1, 2, timeout_s=0.5, interval_s=0.1)
    s1.publish()
    s0.publish()
    beats = s0.scan()
    assert beats[1]["rank"] == 1 and beats[1]["seq"] == 1
    assert s0.dead_peers() == []
    # rank 1 keeps beating: alive past the timeout window
    deadline = time.monotonic() + 0.8
    while time.monotonic() < deadline:
        s1.publish()
        s0.check_once()
        time.sleep(0.1)
    assert s0.dead_peers() == [] and not lost
    # rank 1 goes silent: dead after timeout_s, the callback once
    deadline = time.monotonic() + 3.0
    while not lost and time.monotonic() < deadline:
        s0.check_once()
        time.sleep(0.1)
    assert lost == [[1]]
    assert s0.peer_ages()[1] > 0.5


def test_heartbeat_missing_peer_gets_startup_grace_then_dies(tmp_path):
    s0 = hb.HeartbeatService(tmp_path, 0, 2, timeout_s=0.4,
                             interval_s=0.1, on_peer_lost=lambda r: None)
    s0.scan()
    assert s0.dead_peers() == []
    time.sleep(0.6)
    s0.scan()
    assert s0.dead_peers() == [1]


def test_heartbeat_done_rank_never_declared_dead(tmp_path):
    s0 = hb.HeartbeatService(tmp_path, 0, 2, timeout_s=0.3, interval_s=0.1)
    s1 = hb.HeartbeatService(tmp_path, 1, 2, timeout_s=0.3, interval_s=0.1)
    s1.publish(done=True)
    time.sleep(0.5)
    s0.scan()
    assert s0.dead_peers() == []


def test_heartbeat_stale_fault_suppresses_publish(tmp_path):
    s1 = hb.HeartbeatService(tmp_path, 1, 2, timeout_s=0.5, interval_s=0.1)
    with faults.injected_faults(heartbeat_stale=1):
        s1.publish()
    assert not os.path.exists(hb.heartbeat_path(tmp_path, 1))
    with faults.injected_faults(heartbeat_stale=1):
        s0 = hb.HeartbeatService(tmp_path, 0, 2, timeout_s=0.5,
                                 interval_s=0.1)
        s0.publish()
    assert os.path.exists(hb.heartbeat_path(tmp_path, 0))
    with faults.injected_faults(heartbeat_stale=-1):
        s1.publish()
    assert not os.path.exists(hb.heartbeat_path(tmp_path, 1))


def test_heartbeat_beats_carry_snapshot_and_straggler_info(tmp_path):
    wd = hb.CollectiveWatchdog(0.0, rank=1)
    wd.last_sync_s = 2.5
    s1 = hb.HeartbeatService(tmp_path, 1, 2, timeout_s=1.0,
                             interval_s=0.1, watchdog=wd)
    s1.notify_snapshot(4, str(tmp_path / "snap"))
    s1.publish()
    beat = hb.read_heartbeat(hb.heartbeat_path(tmp_path, 1))
    assert beat["sync_s"] == 2.5 and beat["snapshot_iteration"] == 4
    s0 = hb.HeartbeatService(tmp_path, 0, 2, timeout_s=1.0, interval_s=0.1)
    report = s0.straggler_report(s0.scan())
    assert "rank 1 slowest" in report


def test_beat_files_cross_packages(tmp_path):
    from lightgbm_tpu.parallel import heartbeat as jhb
    s1 = hb.HeartbeatService(tmp_path, 1, 2, timeout_s=1.0, interval_s=0.1,
                             iteration_fn=lambda: 6)
    s1.notify_snapshot(4, str(tmp_path / "snap"))
    s1.publish(done=True)
    path = hb.heartbeat_path(tmp_path, 1)
    assert path == jhb.heartbeat_path(tmp_path, 1)
    assert hb.heartbeat_dir(tmp_path) == jhb.heartbeat_dir(tmp_path)
    beat = jhb.read_heartbeat(path)
    assert beat == hb.read_heartbeat(path)
    assert {k: beat[k] for k in ("rank", "seq", "iteration", "done",
                                 "snapshot_iteration")} == {
        "rank": 1, "seq": 1, "iteration": 6, "done": True,
        "snapshot_iteration": 4}
    assert set(beat) == {"rank", "seq", "pid", "iteration", "time",
                         "sync_s", "done", "snapshot_iteration"}
    # the JAX package's beat, read by the port's monitor
    j0 = jhb.HeartbeatService(tmp_path, 0, 2, timeout_s=1.0, interval_s=0.1)
    j0.publish()
    t1 = hb.HeartbeatService(tmp_path, 1, 2, timeout_s=1.0, interval_s=0.1)
    assert t1.scan()[0]["rank"] == 0 and t1.dead_peers() == []
    assert hb.EXIT_WATCHDOG == jhb.EXIT_WATCHDOG == 117
    assert hb.EXIT_PEER_LOST == jhb.EXIT_PEER_LOST == 118


# --------------------------------------------------------------- watchdog

def test_watchdog_fires_with_rank_iteration_collective(tmp_path):
    fired = []
    wd = hb.CollectiveWatchdog(0.2, rank=3, marker_dir=str(tmp_path),
                               on_expire=lambda n, i: fired.append((n, i)))
    wd.set_iteration(11)
    with wd.armed("hist_psum"):
        time.sleep(0.5)
    assert fired == [("hist_psum", 11)]
    with open(hb.watchdog_marker_path(tmp_path, 3)) as f:
        m = json.load(f)
    assert (m["rank"], m["collective"], m["iteration"]) == (3, "hist_psum",
                                                            11)
    with wd.armed("quick"):
        pass
    time.sleep(0.4)
    assert fired == [("hist_psum", 11)]
    assert wd.timings["hist_psum"] >= 0.2 and "quick" in wd.timings


def test_watchdog_disabled_is_free():
    hb.bind_timing_sink(None)
    wd = hb.CollectiveWatchdog(0.0)
    with wd.armed("anything"):
        pass
    assert wd.timings == {}
    hb.bind_timing_sink(lambda name, s: None)
    try:
        with wd.armed("measured"):
            pass
    finally:
        hb.bind_timing_sink(None)
    assert "measured" in wd.timings


def test_failed_collective_takes_the_watchdog_exit(tmp_path, capsys):
    fired = []
    wd = hb.CollectiveWatchdog(30.0, rank=0, marker_dir=str(tmp_path),
                               on_expire=lambda n, i: fired.append((n, i)))
    wd.set_iteration(2)
    t0 = time.monotonic()
    with pytest.raises(hb.CollectiveFailed):
        with wd.armed("data:tree_build"):
            raise hb.CollectiveFailed("collective 'fold_exchange' #97 "
                                      "failed: connection reset by peer")
    assert time.monotonic() - t0 < 5.0      # at once, not at the timeout
    assert fired == [("data:tree_build", 2)]
    out = capsys.readouterr().out
    assert "rank 0 lost a peer in 'data:tree_build' at iteration 2" in out
    assert "exit code 117" in out
    with open(hb.watchdog_marker_path(tmp_path, 0)) as f:
        assert "fold_exchange" in json.load(f)["cause"]
    # disarmed: the error is the caller's
    off = hb.CollectiveWatchdog(0.0, on_expire=lambda n, i: fired.append(n))
    with pytest.raises(hb.CollectiveFailed):
        with off.armed("x"):
            raise hb.CollectiveFailed("gone")
    assert len(fired) == 1


def test_configure_arms_and_shutdown_disarms(tmp_path):
    from lightgbm_tpu_torch.config import Config
    cfg = Config.from_params({"collective_timeout_s": 7,
                              "heartbeat_timeout_s": 2})
    svc = hb.configure(cfg, str(tmp_path), 1, 2, iteration_fn=lambda: 3)
    try:
        assert hb.WATCHDOG.timeout_s == 7.0 and hb.WATCHDOG.rank == 1
        assert svc is hb.service() and svc.interval_s == 0.5
        beat = hb.read_heartbeat(hb.heartbeat_path(hb.heartbeat_dir(
            tmp_path), 1))
        assert beat["iteration"] == 3
    finally:
        hb.shutdown()
    assert hb.service() is None and hb.WATCHDOG.timeout_s == 0.0
    assert hb.read_heartbeat(hb.heartbeat_path(hb.heartbeat_dir(
        tmp_path), 1))["done"] is True


# ---------------------------------------------------------- rank faults

def test_rank_fault_spec_parsing():
    faults.set_fault("rank_crash_at_iteration", "1:3")
    assert faults._rank_iter_spec("rank_crash_at_iteration") == (1, 3)
    faults.set_fault("rank_crash_at_iteration", 5)
    assert faults._rank_iter_spec("rank_crash_at_iteration") == (None, 5)
    faults.set_fault("rank_crash_at_iteration", "bogus")
    assert faults._rank_iter_spec("rank_crash_at_iteration") is None


def test_rank_faults_disarmed_on_restart_attempt(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_RESTART_ATTEMPT", "1")
    with faults.injected_faults(rank_crash_at_iteration="0:0",
                                rank_hang_at_iteration="0:0"):
        faults.set_rank(0)
        faults.rank_crash_if_reached(0)   # would os._exit(43) if armed
        faults.rank_hang_if_reached(0)    # would hang forever if armed


def test_rank_crash_only_matching_rank(monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_RESTART_ATTEMPT", raising=False)
    with faults.injected_faults(rank_crash_at_iteration="1:3",
                                rank_hang_at_iteration="1:3"):
        faults.set_rank(0)
        faults.rank_crash_if_reached(3)   # rank 0 must survive
        faults.rank_hang_if_reached(0, 5)
    assert faults.current_rank() == 0
    faults._rank = None
    monkeypatch.setenv("LIGHTGBM_TPU_RANK", "2")
    assert faults.current_rank() == 2


def test_log_lines_carry_the_rank(capsys):
    try:
        Log.set_rank(3)
        Log.warning("hello %d", 1)
    finally:
        Log.set_rank(None)
    Log.warning("bye")
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == "[LightGBM-Torch] [rank 3] [Warning] hello 1"
    assert out[-1] == "[LightGBM-Torch] [Warning] bye"
