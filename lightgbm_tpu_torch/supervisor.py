"""Elastic-restart supervisor: `python -m lightgbm_tpu_torch.supervisor ...`
(the port of lightgbm_tpu/supervisor.py).

Every machine of a distributed job runs ONE supervisor, which launches
the local training process (`python -m lightgbm_tpu_torch` with the same
arguments, on the card) and watches it:

- exit 0: done.
- any failure (a crash, a collective-watchdog abort, exit 117, a
  peer-loss abort, exit 118, a signal) is restartable: the supervisor
  relaunches the child, which resumes from the newest valid shared
  snapshot (`snapshot_freq` / `snapshot_resume`, utils/checkpoint.py), at
  most `max_restarts` times.
- before each relaunch the supervisors meet at a file-based RESTART
  BARRIER in the shared snapshot directory: each posts a marker for
  attempt k and waits for its peers' markers. Ranks that never post
  (their machine is gone) are dropped: the survivors write the shrunk
  machine list (ports shifted by the attempt number, so a lingering
  socket cannot collide), renumber their ranks, and relaunch with
  `num_machines=<survivors>`. The row partition and the snapshot's
  global train score re-slice to the new world; an out-of-core gang
  re-derives its owned blocks of the shared store (data/ooc_parallel.py).
  A previously dropped rank whose supervisor posts a marker for the
  attempt rejoins (`returned_ranks`).

The child learns its rank from LIGHTGBM_TPU_RANK and the attempt from
LIGHTGBM_TPU_RESTART_ATTEMPT (which also disarms the one-shot rank
faults, utils/faults.py). With `telemetry=true` the restarts are
journaled (`source: "supervisor"`) into the rank's run journal, beside
the child's own records. A single-machine job gets a plain crash-restart
wrapper with no barrier.

`Supervisor(argv, child_command=...)` replaces the child's command
prefix (the interpreter and module); the tests run the CLI on the CPU
that way.
"""

import os
import subprocess
import sys
import time

from .config import load_config_file, str2map
from .parallel import heartbeat
from .parallel.machines import (find_local_rank, format_machine_list,
                                parse_machine_list)
from .utils.faults import HARD_CRASH_EXIT_CODE
from .utils.log import Log

SUPERVISOR_SUBDIR = "supervisor"
_BARRIER_POLL_S = 0.25


def _load_parameters(argv):
    """Command line `k=v` tokens override config-file entries: the
    CLI's own layering (application.py), repeated here so the
    supervisor never imports torch or the training modules."""
    cmd_params = str2map(" ".join(argv))
    params = {}
    config_path = cmd_params.get("config_file", "")
    if config_path:
        params.update(load_config_file(config_path))
    params.update(cmd_params)
    params.pop("config_file", None)
    return params


def describe_exit(code):
    """Human-readable child exit diagnosis for the restart log."""
    if code == heartbeat.EXIT_WATCHDOG:
        return "collective watchdog abort (a peer hung mid-collective)"
    if code == heartbeat.EXIT_PEER_LOST:
        return "peer-loss abort (a rank's heartbeat went stale)"
    if code == HARD_CRASH_EXIT_CODE:
        return "hard crash (injected preemption)"
    if code < 0:
        return f"killed by signal {-code}"
    return "training failure"


def _barrier_dir(shared_dir):
    return os.path.join(shared_dir, SUPERVISOR_SUBDIR)


def _marker_path(shared_dir, attempt, rank):
    return os.path.join(_barrier_dir(shared_dir),
                        f"restart.attempt{attempt:04d}.rank{rank:04d}.json")


def _post_marker(shared_dir, attempt, rank, exit_code):
    path = _marker_path(shared_dir, attempt, rank)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    heartbeat.atomic_write_json(
        path, {"rank": rank, "attempt": attempt, "time": time.time(),
               "exit_code": exit_code})


def restart_barrier(shared_dir, attempt, my_rank, member_ranks, wait_s,
                    exit_code=0):
    """Post this rank's restart marker for `attempt` and wait up to
    `wait_s` for the other members'. Returns the sorted survivor ranks
    (always including my_rank): members whose marker never appears are
    gone — their machine will be dropped from the relaunch topology."""
    _post_marker(shared_dir, attempt, my_rank, exit_code)
    members = set(member_ranks)
    deadline = time.monotonic() + wait_s
    while True:
        present = {r for r in members
                   if os.path.exists(_marker_path(shared_dir, attempt, r))}
        if present == members or time.monotonic() >= deadline:
            break
        time.sleep(_BARRIER_POLL_S)
    survivors = sorted(present | {my_rank})
    missing = sorted(members - set(survivors))
    if missing:
        Log.warning("restart barrier (attempt %d): rank(s) %s did not "
                    "report within %.1fs — shrinking the world to %d "
                    "rank(s)", attempt, missing, wait_s, len(survivors))
    return survivors


def returned_ranks(shared_dir, attempt, original_members, current_members):
    """Grow-back scan: original ranks that were pruned in an earlier
    shrink but whose supervisor posted a marker for THIS attempt — the
    machine came back (operator restarted its supervisor) and is
    waiting at the same barrier. Survivor re-admission costs nothing
    extra: the barrier directory is already shared state, and ownership
    (rows, feature shards, out-of-core block ranges) re-derives from
    whatever world count the relaunch passes down."""
    current = set(current_members)
    returned = []
    for r in original_members:
        if r in current:
            continue
        if os.path.exists(_marker_path(shared_dir, attempt, r)):
            returned.append(int(r))
    return sorted(returned)


def _shift_ports(machines, attempt):
    """Fresh ports per attempt: the previous incarnation's coordinator
    socket may linger in TIME_WAIT on the same host."""
    return [(host, port + attempt) for host, port in machines]


class Supervisor:
    """One machine's restart loop (see module docstring)."""

    def __init__(self, argv, child_command=None):
        self.argv = list(argv)
        # the child's command before its k=v arguments
        self.child_command = (list(child_command) if child_command
                              else [sys.executable, "-m",
                                    "lightgbm_tpu_torch"])
        params = _load_parameters(argv)
        self.restart_on_failure = str(
            params.get("restart_on_failure", "true")).lower() not in (
                "false", "-", "0")
        self.max_restarts = int(params.get("max_restarts", 2))
        # a supervised job without an explicit detection knob would
        # have failure detection OFF in the child (config default 0)
        # and hang forever in a collective — defeating the supervisor.
        # Default the child's heartbeat timeout to the same 60s this
        # supervisor's barrier math assumes.
        self.inject_heartbeat_knob = "heartbeat_timeout_s" not in params
        self.heartbeat_timeout_s = float(params.get("heartbeat_timeout_s", 60))
        collective = float(params.get("collective_timeout_s", 0))
        # peers enter the barrier only after their own detection fires:
        # allow one full detection window plus generous slack
        self.barrier_wait_s = 2.0 * max(self.heartbeat_timeout_s,
                                        collective, 5.0)
        self.snapshot_freq = int(params.get("snapshot_freq", 0))
        self.shared_dir = (params.get("snapshot_dir")
                           or params.get("output_model",
                                         "LightGBM_model.txt")
                           + ".snapshots")
        # restart/shrink events land in the SAME rank journal file the
        # training child writes (telemetry/journal.py: O_APPEND single-
        # line writes interleave safely across processes), so the
        # merged timeline shows abort -> restart -> resume in order
        self.telemetry = str(params.get("telemetry", "false")).lower() \
            in ("true", "+", "1")
        self.telemetry_dir = params.get("telemetry_dir") or self.shared_dir
        self._journal = None
        mlist = params.get("machine_list_file", "")
        self.machines = parse_machine_list(mlist) if mlist and \
            os.path.exists(mlist) else []
        self.num_machines = int(params.get("num_machines",
                                           len(self.machines) or 1))
        self.machines = self.machines[:self.num_machines]
        env_rank = os.environ.get("LIGHTGBM_TPU_RANK")
        if env_rank is not None:
            self.rank = int(env_rank)
        elif len(self.machines) > 1:
            self.rank = find_local_rank(self.machines)
        else:
            self.rank = 0
        # identity is the ORIGINAL rank; membership shrinks across
        # restarts but original ids keep the barrier unambiguous.
        # original_members stays fixed so a pruned rank whose machine
        # comes back can be re-admitted at a later barrier (grow-back)
        self.members = list(range(max(len(self.machines), 1)))
        self.original_members = list(self.members)
        # a reused snapshot dir may hold THIS rank's restart markers
        # from a previous incarnation; left in place they would count a
        # later-dead rank as a barrier survivor and block the shrunken-
        # world path. Each supervisor cleans only its OWN rank's
        # markers (no cross-host races), so a rank whose machine dies
        # mid-run leaves nothing stale behind.
        self._clean_own_markers()
        if self.restart_on_failure and self.snapshot_freq <= 0:
            Log.warning("supervisor: snapshot_freq is 0 — a restart "
                        "will COLD-START training (set snapshot_freq>0 "
                        "to resume from shared snapshots)")

    def _journal_event(self, event, **fields):
        """Append one supervisor-sourced record to this rank's run
        journal (no-op unless `telemetry=true`)."""
        if not self.telemetry:
            return
        if self._journal is None:
            from .telemetry.journal import RunJournal
            self._journal = RunJournal(self.telemetry_dir, rank=self.rank,
                                       emit_run_start=False,
                                       source="supervisor")
        self._journal.event(event, **fields)

    def _clean_own_markers(self):
        import glob
        pattern = os.path.join(
            _barrier_dir(self.shared_dir),
            f"restart.attempt*.rank{self.rank:04d}.json")
        for stale in glob.glob(pattern):
            try:
                os.unlink(stale)
            except OSError:
                pass

    def _child_command(self, machines, mlist_override):
        cmd = self.child_command + self.argv
        # trailing k=v tokens override earlier ones (str2map)
        if self.inject_heartbeat_knob and len(self.machines) > 1:
            cmd.append(f"heartbeat_timeout_s={self.heartbeat_timeout_s:g}")
        if mlist_override is not None:
            cmd += [f"machine_list_file={mlist_override}",
                    f"num_machines={len(machines)}"]
        return cmd

    def _child_env(self, attempt, new_rank):
        env = dict(os.environ)
        env["LIGHTGBM_TPU_RANK"] = str(new_rank)
        env["LIGHTGBM_TPU_RESTART_ATTEMPT"] = str(attempt)
        return env

    def _write_shrunk_mlist(self, machines, attempt):
        """Every surviving supervisor derives the SAME list (survivor
        set + attempt are shared state), so concurrent writes of the
        identical bytes are benign."""
        path = os.path.join(_barrier_dir(self.shared_dir),
                            f"mlist.attempt{attempt:04d}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(format_machine_list(machines))
        os.replace(tmp, path)
        return path

    def run(self):
        attempt = 0
        machines = list(self.machines)
        new_rank = self.rank
        mlist_override = None
        while True:
            cmd = self._child_command(machines, mlist_override)
            Log.info("supervisor: launching rank %d (attempt %d/%d): %s",
                     new_rank, attempt, self.max_restarts, " ".join(cmd))
            child = subprocess.Popen(cmd,
                                     env=self._child_env(attempt, new_rank))
            code = child.wait()
            if code == 0:
                Log.info("supervisor: rank %d finished cleanly", new_rank)
                return 0
            Log.warning("supervisor: rank %d exited with code %d — %s",
                        new_rank, code, describe_exit(code))
            if not self.restart_on_failure or attempt >= self.max_restarts:
                Log.warning("supervisor: not restarting (%s)",
                            "restart_on_failure=false"
                            if not self.restart_on_failure
                            else f"max_restarts={self.max_restarts} "
                                 f"exhausted")
                return code
            attempt += 1
            prev_world = len(self.members)
            if len(self.original_members) > 1:
                survivors = restart_barrier(
                    self.shared_dir, attempt, self.rank, self.members,
                    self.barrier_wait_s, exit_code=code)
                # grow-back: a previously pruned rank whose supervisor
                # posted a marker for THIS attempt rejoins — ownership
                # widens back at relaunch exactly the way it shrank
                returned = returned_ranks(self.shared_dir, attempt,
                                          self.original_members, survivors)
                if returned:
                    Log.info("restart barrier (attempt %d): rank(s) %s "
                             "returned — growing the world back to %d "
                             "rank(s)", attempt, returned,
                             len(survivors) + len(returned))
                members = sorted(set(survivors) | set(returned))
                if members != self.members:
                    self.members = members
                machines = _shift_ports(
                    [self.machines[r] for r in self.members], attempt)
                new_rank = self.members.index(self.rank)
                mlist_override = self._write_shrunk_mlist(machines, attempt)
            shrunk = len(self.members) < prev_world
            grown = len(self.members) > prev_world
            self._journal_event("restart", attempt=attempt,
                                exit_code=int(code),
                                reason=describe_exit(code),
                                survivors=list(self.members),
                                new_rank=int(new_rank),
                                mesh_reshard=bool(shrunk or grown))
            Log.info("supervisor: restarting rank %d as rank %d of %d "
                     "(%sresume from newest snapshot under %s)", self.rank,
                     new_rank, max(len(machines), 1),
                     "mesh re-shards feature ownership; " if shrunk
                     else "", self.shared_dir)


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        print("usage: python -m lightgbm_tpu_torch.supervisor <lightgbm "
              "params: task=train data=... machine_list_file=... "
              "num_machines=N snapshot_freq=K ...>", file=sys.stderr)
        return 2
    return Supervisor(argv).run()


if __name__ == "__main__":
    sys.exit(main())
