"""lightgbm_tpu_torch's elastic-restart supervisor against lightgbm_tpu's,
on the CPU (supervisor.py).

Held here:
- the restart barrier, `returned_ranks`, the exit-code descriptions, the
  shifted ports and the shrunk machine list's bytes equal the JAX
  module's; the supervisor's own markers of an earlier incarnation are
  cleaned; the child's command and environment carry the rank, the
  attempt and the shrunk world;
- one 2-rank CPU drill over a shared block store, both ranks gang
  learners (tree_learner=data, out_of_core=true): rank 0 runs under a
  supervisor, rank 1 is killed at iteration 3 (rank_crash_at_iteration,
  exit 43). Rank 0's child ends with the watchdog's 117, its supervisor
  shrinks the world to 1 rank and resumes from the iteration-2
  snapshot through the serial out-of-core learner over the same store.
  The model text is byte-equal to a single-rank run resumed from the
  same snapshot; the store was built once (build_count 1); the journal
  holds no `binning` record, the supervisor's `restart` record (source
  "supervisor"), and a `block_reshard` record with shards=1 on the
  restarted attempt owning every block.
"""

import json
import os
import shutil
import sys
import time


from lightgbm_tpu import supervisor as jsup

from lightgbm_tpu_torch import supervisor as tsup
from lightgbm_tpu_torch.telemetry import journal as tjournal
from lightgbm_tpu_torch.utils import faults

from test_torch_elastic_ooc import (CLI_ON_CPU, GANG_ARGS, _free_port,
                                    _write_csv, run_ranks)

SUPERVISED = ("import sys; from lightgbm_tpu_torch.supervisor import "
              "Supervisor; sys.exit(Supervisor(sys.argv[1:], "
              "child_command=[sys.executable, '-c', " + repr(CLI_ON_CPU)
              + "]).run())")


def test_barrier_and_returned_ranks_equal_jax(tmp_path):
    for mod, tag in ((jsup, "j"), (tsup, "t")):
        d = str(tmp_path / tag)
        t0 = time.monotonic()
        # ranks 0 and 2 report, rank 1 never does
        mod._post_marker(d, 1, 2, 117)
        got = mod.restart_barrier(d, 1, 0, [0, 1, 2], 0.6, exit_code=43)
        assert got == [0, 2] and time.monotonic() - t0 < 5
        assert mod.returned_ranks(d, 1, [0, 1, 2], got) == []
        mod._post_marker(d, 1, 1, 0)      # rank 1's machine came back
        assert mod.returned_ranks(d, 1, [0, 1, 2], got) == [1]
        assert mod.restart_barrier(d, 2, 0, [0], 0.1) == [0]
    jdir, tdir = tmp_path / "j" / "supervisor", tmp_path / "t" / "supervisor"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(tdir):
        with open(jdir / name) as f:
            jm = json.load(f)
        with open(tdir / name) as f:
            tm = json.load(f)
        assert {k: v for k, v in jm.items() if k != "time"} == \
            {k: v for k, v in tm.items() if k != "time"}


def test_exit_descriptions_and_ports_equal_jax():
    for code in (0, 1, 2, 43, 117, 118, -9, -15):
        assert tsup.describe_exit(code) == jsup.describe_exit(code)
    machines = [("10.0.0.1", 12400), ("10.0.0.2", 12400)]
    for attempt in (0, 1, 3):
        assert tsup._shift_ports(machines, attempt) == \
            jsup._shift_ports(machines, attempt)


def _supervisors(tmp_path, mod, tag, extra=()):
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("127.0.0.1 12400\n127.0.0.1 12401\n127.0.0.1 12402\n")
    argv = ["task=train", "num_machines=3", f"machine_list_file={mlist}",
            f"snapshot_dir={tmp_path / tag}", "snapshot_freq=2",
            "collective_timeout_s=30", "telemetry=true"] + list(extra)
    return mod.Supervisor(argv)


def test_shrunk_machine_list_and_child_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_RANK", "2")
    j = _supervisors(tmp_path, jsup, "j")
    t = _supervisors(tmp_path, tsup, "t")
    for key in ("rank", "members", "original_members", "num_machines",
                "machines", "barrier_wait_s", "heartbeat_timeout_s",
                "max_restarts", "restart_on_failure", "snapshot_freq",
                "inject_heartbeat_knob", "telemetry"):
        assert getattr(t, key) == getattr(j, key), key
    survivors = jsup._shift_ports([j.machines[r] for r in (0, 2)], 1)
    jp = j._write_shrunk_mlist(survivors, 1)
    tp = t._write_shrunk_mlist(survivors, 1)
    assert os.path.basename(jp) == os.path.basename(tp)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    # the child: the command line, then the heartbeat default and the
    # shrunk world, as the JAX supervisor appends them
    jcmd = j._child_command(survivors, tp)
    tcmd = t._child_command(survivors, tp)
    assert jcmd[:3] == [sys.executable, "-m", "lightgbm_tpu"]
    assert tcmd[:3] == [sys.executable, "-m", "lightgbm_tpu_torch"]
    assert [a.replace(str(tmp_path / "j"), str(tmp_path / "t"))
            for a in jcmd[3:]] == tcmd[3:]
    assert tcmd[-2:] == [f"machine_list_file={tp}", "num_machines=2"]
    env = t._child_env(1, 1)
    assert (env["LIGHTGBM_TPU_RANK"], env["LIGHTGBM_TPU_RESTART_ATTEMPT"]) \
        == ("1", "1")
    cpu = tsup.Supervisor(t.argv, child_command=["python", "-c", "x"])
    assert cpu._child_command([], None)[:3] == ["python", "-c", "x"]


def test_supervisor_cleans_only_its_own_markers(tmp_path, monkeypatch):
    d = str(tmp_path / "t")
    tsup._post_marker(d, 1, 2, 117)
    tsup._post_marker(d, 1, 0, 117)
    monkeypatch.setenv("LIGHTGBM_TPU_RANK", "2")
    _supervisors(tmp_path, tsup, "t")
    assert sorted(os.listdir(os.path.join(d, "supervisor"))) == [
        "restart.attempt0001.rank0000.json"]


# ------------------------------------------------------ the shrink drill

# a dead gloo peer fails the survivor's collective at once; the timeouts
# only guard against a loaded host's stalls (the JAX test's heartbeat
# timeout), and the barrier waits 2 x max(6, 10, 5) = 20 s for the dead
# rank
KNOBS = ["heartbeat_timeout_s=6", "collective_timeout_s=10",
         "max_restarts=2", "telemetry=true", "snapshot_freq=2"]


def test_shrink_drill_resumes_byte_equal_without_rebinning(tmp_path):
    d = tmp_path
    _write_csv(d / "tr.csv")
    port = _free_port()
    (d / "mlist.txt").write_text(f"127.0.0.1 {port}\n127.0.0.1 {port + 1}\n")
    args = GANG_ARGS + KNOBS + [
        f"data={d / 'tr.csv'}", "tree_learner=data", "num_machines=2",
        f"machine_list_file={d / 'mlist.txt'}",
        f"snapshot_dir={d / 'snaps'}", f"output_model={d / 'model.txt'}"]
    (rc0, out0), (rc1, out1) = run_ranks(
        [[sys.executable, "-c", SUPERVISED] + args,
         [sys.executable, "-c", CLI_ON_CPU] + args],
        [None, {"LIGHTGBM_TPU_FAULTS": "rank_crash_at_iteration=1:3"}],
        str(d))
    assert rc1 == faults.HARD_CRASH_EXIT_CODE, out1[-2000:]
    assert rc0 == 0, out0[-4000:]
    assert "rank 0 exited with code 117" in out0
    assert "shrinking the world to 1 rank(s)" in out0
    assert "restarting rank 0 as rank 0 of 1" in out0
    assert "Resuming from checkpoint" in out0
    model = (d / "model.txt").read_text()
    assert model.count("Tree=") == 6
    with open(d / "tr.csv.blocks" / "manifest.json") as f:
        assert json.load(f)["build_count"] == 1

    records, bad = tjournal.read_journal(d / "snaps" / "journal.jsonl")
    assert bad == 0
    assert not any(r["event"] == "binning" for r in records)
    reshards = [r for r in records if r["event"] == "block_reshard"]
    assert sorted(r["shards"] for r in reshards if r["attempt"] == 0) \
        == [2, 2]
    adopted = [r for r in reshards if r["attempt"] >= 1]
    assert [(r["shards"], r["block_lo"], r["block_hi"]) for r in adopted] \
        == [(1, 0, adopted[0]["blocks"])]
    restart = [r for r in records if r["event"] == "restart"]
    assert len(restart) == 1 and restart[0]["source"] == "supervisor"
    assert restart[0]["exit_code"] == 117 and restart[0]["survivors"] == [0]
    assert restart[0]["mesh_reshard"] is True
    aborts = [r for r in records if r["event"] == "abort"]
    assert aborts and aborts[0]["exit_code"] == 117
    assert [r["iteration"] for r in records if r["event"] == "resume"] \
        == [2]

    # a single-rank run resumed from the same iteration-2 snapshot
    snap2 = d / "snaps" / "snapshot.iter00000002.ckpt"
    ref = d / "refsnaps"
    ref.mkdir()
    shutil.copy(snap2, ref / snap2.name)
    ((rc, out),) = run_ranks(
        [[sys.executable, "-c", CLI_ON_CPU] + GANG_ARGS + [
            f"data={d / 'tr.csv'}", "snapshot_freq=2",
            f"snapshot_dir={ref}", f"output_model={d / 'ref.txt'}"]],
        [None], str(d))
    assert rc == 0, out[-2000:]
    assert "Resuming from checkpoint" in out
    assert (d / "ref.txt").read_text() == model
