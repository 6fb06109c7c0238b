"""lightgbm_tpu_torch's multi-process runtime on the CPU: machine lists,
the torch.distributed process group, the ProcessMesh over gloo, per-rank
row partitions and the CLI process gang (parallel/machines.py,
parallel/distributed.py, parallel/mesh.py ProcessMesh, io/dataset.py,
application.py).

Contracts:
- machine lists parse, format and find the local rank as the JAX
  package's parallel/machines.py does, with the same errors, and
  partition_rows is the JAX function's over a grid of N, W and query
  layouts;
- init_from_config retries a failed bring-up, fails after its retries,
  and refuses an out-of-range rank or a missing list under
  LIGHTGBM_TPU_RANK (tests/test_fault_tolerance.py:201, :412, :429,
  :437); the transport follows the topology alone;
- every ProcessMesh collective and exchange at W = 2 and 3 over gloo is
  bit-equal to LocalMesh's on the same inputs (all_gather, all_to_all,
  psum, and the five exchanges at pair, f32 and bf16, at comm_groups 1
  and 2), counts the same bytes, and folds each histogram exchange with
  ONE gather_fold whose descriptors all point into one receive buffer;
  a rank that reaches another collective than its peers raises
  MeshLockstepError;
- a 2-process CLI gang (one process a rank, LIGHTGBM_TPU_RANK and a
  machine list) writes rank 0's model, byte-equal at an even N to the
  in-process mesh's at W = 2 for the data (reduce-scatter at comm_groups
  1 and 2, allgather), partitioned data, feature and voting learners,
  with every rank's trees equal to rank 0's; at an odd N (blocks of
  different lengths) the data learner's trees equal the JAX package's
  single-process run within tests/test_distributed.py:103-110's bounds;
  the rank-filtered two-round load stores fewer than N rows a rank and
  gives the same model;
- a rank killed at iteration 2 ends its peer with exit code 117 within
  collective_timeout_s plus a 10 s margin, its log naming the
  collective, the iteration and the rank; a gang crashed at iteration 3
  resumes from its snapshot at 2 to the uninterrupted gang's model, its
  ranks' heartbeats ending "done".

The ranks are this file run as a script (`__main__`), one process each.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.parallel import distributed as tdist
from lightgbm_tpu_torch.parallel import machines as tmach
from lightgbm_tpu_torch.utils import faults as tfaults
from lightgbm_tpu_torch.utils.log import LightGBMError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 4
GANG_ARGS = ["task=train", "objective=binary", "num_leaves=15",
             f"num_iterations={ROUNDS}", "min_data_in_leaf=10",
             "hist_compaction=false", "max_bin=255", "metric_freq=0",
             "verbose=1", "num_machines=2"]
LEARNERS = {
    "data_rs": ["tree_learner=data"],
    "data_rs_groups2": ["tree_learner=data", "comm_groups=2"],
    "data_allgather": ["tree_learner=data", "hist_exchange=allgather"],
    "data_partitioned": ["tree_learner=data", "partitioned_build=true"],
    "feature": ["tree_learner=feature"],
    "voting": ["tree_learner=voting", "top_k=3"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- helpers

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _machine_list(path, w):
    port = _free_port()
    path.write_text("".join(f"127.0.0.1 {port + r}\n" for r in range(w)))
    return str(path)


def _spawn(w, args, env=None, timeout=240):
    """This file as a script on W ranks (LIGHTGBM_TPU_RANK=r, one torch
    thread each); returns [(returncode, output, exit time)] in rank
    order."""
    import tempfile
    procs, logs = [], []
    with tempfile.TemporaryDirectory(prefix="torch_gang_") as tmp:
        for r in range(w):
            e = dict(os.environ, LIGHTGBM_TPU_RANK=str(r), PYTHONPATH=REPO,
                     OMP_NUM_THREADS="1")
            e.pop("LIGHTGBM_TPU_FAULTS", None)
            e.update((env or {}).get(r, {}))
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)] + list(args),
                env=e, cwd=REPO, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        done = {}
        deadline = time.monotonic() + timeout
        while len(done) < w and time.monotonic() < deadline:
            for r, p in enumerate(procs):
                if r not in done and p.poll() is not None:
                    done[r] = time.monotonic()
            time.sleep(0.05)
        out = []
        for r, p in enumerate(procs):
            if r not in done:
                p.kill()
                done[r] = time.monotonic()
            p.wait()
            logs[r].seek(0)
            out.append((p.returncode, logs[r].read(), done[r]))
            logs[r].close()
    return out


def _write_csv(path, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8)
    y = (x[:, 0] + 0.5 * x[:, 1] - x[:, 2] * x[:, 3]
         + 0.3 * rng.randn(n) > 0).astype(int)
    with open(path, "w") as f:
        for i in range(n):
            f.write(",".join([str(y[i])] + ["%.9g" % v for v in x[i]])
                    + "\n")


# -------------------------------------------------------- machine lists

MACHINE_FILES = {
    "formats": ("# header comment\n10.0.0.1 12400\n"
                "10.0.0.2:12401   # trailing comment\n"
                "[2001:db8::1]:12402\n2001:db8::2 12403\n"
                "[2001:db8::3] 12404\n\n"),
    "duplicate": "10.0.0.1 12400\n10.0.0.2 12400\n10.0.0.1 12400\n",
    "bad_port": "10.0.0.1 12400\n10.0.0.2 port\n",
    "bare_ipv6": "2001:db8::1:12400\n",
    "open_bracket": "[2001:db8::1 12400\n",
    "bracket_no_port": "[2001:db8::1]\n",
    "local_second": "10.255.0.9 12400\n127.0.0.1 12401\nlocalhost 12402\n",
    "no_local": "10.255.0.9 12400\n10.255.0.10 12400\n",
}


def _outcome(fn, *args):
    """(value, None) or (None, error message) of fn(*args)."""
    try:
        return fn(*args), None
    except Exception as e:  # noqa: B902 - compared across packages
        return None, str(e)


@pytest.mark.parametrize("name", sorted(MACHINE_FILES))
def test_machine_lists_as_the_jax_package(tmp_path, name):
    from lightgbm_tpu.parallel import machines as jmach
    path = tmp_path / "mlist.txt"
    path.write_text(MACHINE_FILES[name])
    got = _outcome(tmach.parse_machine_list, str(path))
    want = _outcome(jmach.parse_machine_list, str(path))
    assert got == want
    if got[0] is not None:
        # the local rank and the formatted text, both ways
        assert _outcome(tmach.find_local_rank, got[0]) == \
            _outcome(jmach.find_local_rank, want[0])
        text = tmach.format_machine_list(got[0])
        assert text == jmach.format_machine_list(want[0])
        path.write_text(text)
        assert tmach.parse_machine_list(str(path)) == got[0]
    errors = {"duplicate": "duplicates 10.0.0.1:12400 (first at line 1)",
              "bad_port": "port 'port' is not an integer",
              "bare_ipv6": "IPv6 addresses need",
              "bracket_no_port": "bracketed IPv6 must be"}
    if name in errors:
        assert errors[name] in got[1]
    else:
        assert got[1] is None
    if name == "formats":
        assert got[0][2] == ("2001:db8::1", 12402)
    elif name == "local_second":
        assert tmach.find_local_rank(got[0]) == 1
    elif name == "no_local":
        with pytest.raises(LightGBMError, match="local machine"):
            tmach.find_local_rank(got[0])


@pytest.mark.parametrize("queries", [False, True])
def test_partition_rows_matches_jax(queries):
    from lightgbm_tpu.parallel.distributed import partition_rows as jpart
    rng = np.random.RandomState(3)
    for n in (1, 7, 100, 2001, 4096):
        for w in (1, 2, 3, 4, 7):
            qb = None
            if queries:
                counts = rng.randint(1, 9, size=max(1, n // 4))
                qb = np.concatenate([[0], np.cumsum(counts)])
                n = int(qb[-1])
            blocks = [tdist.partition_rows(n, r, w, qb) for r in range(w)]
            assert blocks == [jpart(n, r, w, qb) for r in range(w)]
            assert blocks[0][0] == 0 and blocks[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
            assert tdist.rows_max(n, w, qb) == max(hi - lo
                                                   for lo, hi in blocks)


# -------------------------------------------------------- membership

def test_init_retries_then_succeeds(monkeypatch):
    calls = []
    monkeypatch.setattr(tdist.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    with tfaults.injected_faults(fail_distributed_init=2):
        ok = tdist._initialize_with_retry("10.0.0.1:12400", 2, 0,
                                          retries=3, backoff_s=0.0)
    assert ok and len(calls) == 1   # 2 injected failures, then success
    (backend,), kw = calls[0]
    assert backend == "gloo" and kw["init_method"] == \
        "tcp://10.0.0.1:12400" and kw["world_size"] == 2


def test_init_exhausted_retries_is_fatal():
    with tfaults.injected_faults(fail_distributed_init=-1):
        with pytest.raises(LightGBMError, match="after 3 attempts"):
            tdist._initialize_with_retry("10.0.0.1:12400", 2, 0,
                                         retries=2, backoff_s=0.0)


def test_init_already_initialized_is_tolerated(monkeypatch):
    def twice(*a, **k):
        raise ValueError("trying to initialize the default process group "
                         "twice!")

    monkeypatch.setattr(tdist.dist, "init_process_group", twice)
    assert tdist._initialize_with_retry("10.0.0.1:12400", 2, 0, retries=3,
                                        backoff_s=0.0) is False


def _cfg(**kw):
    from lightgbm_tpu_torch.config import Config
    return Config.from_params(dict({"num_machines": 2,
                                    "tree_learner": "data"}, **kw))


def test_rank_out_of_range_is_fatal(tmp_path, monkeypatch):
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("10.0.0.1 12400\n10.0.0.2 12400\n")
    monkeypatch.setenv("LIGHTGBM_TPU_RANK", "7")
    monkeypatch.setattr(tdist, "_initialized", False)
    with pytest.raises(LightGBMError, match="out of range"):
        tdist.init_from_config(_cfg(machine_list_file=str(mlist)), "cpu")


def test_missing_machine_list(tmp_path, monkeypatch):
    cfg = _cfg(machine_list_file=str(tmp_path / "absent.txt"))
    monkeypatch.setattr(tdist, "_initialized", False)
    monkeypatch.delenv("LIGHTGBM_TPU_RANK", raising=False)
    assert tdist.init_from_config(cfg, "cpu") is False   # in-process mesh
    monkeypatch.setenv("LIGHTGBM_TPU_RANK", "1")
    with pytest.raises(LightGBMError, match="not found"):
        tdist.init_from_config(cfg, "cpu")
    short = tmp_path / "short.txt"
    short.write_text("127.0.0.1 12400\n")
    with pytest.raises(LightGBMError, match="only contains 1"):
        tdist.init_from_config(_cfg(machine_list_file=str(short)), "cpu")


def test_transport_follows_the_topology(monkeypatch):
    one_host = [("127.0.0.1", 1), ("127.0.0.1", 2), ("127.0.0.1", 3)]
    assert tdist.choose_transport(one_host, 1, "cpu") == (
        "gloo", torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # three ranks on one card: NCCL refuses, gloo over pinned copies
    assert tdist.choose_transport(one_host, 2, "cuda") == (
        "gloo+pinned", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdist.choose_transport(one_host, 2, "cuda") == (
        "nccl", torch.device("cuda", 2))
    # two hosts of two ranks: each rank's index among its host's entries
    two_hosts = [("10.255.0.9", 1), ("127.0.0.1", 2), ("10.255.0.9", 3),
                 ("127.0.0.1", 4)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tdist.choose_transport(two_hosts, 3, "cuda") == (
        "nccl", torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdist.choose_transport(two_hosts, 3, "cuda")[0] == "gloo+pinned"


# ------------------------------------------------------- the mesh worker

def _mesh_cases(rng, w):
    """(name, fn(mesh, inputs) -> tensor, folds, per-shard inputs) of
    every collective and exchange, inputs made from `rng` the same on
    every rank."""
    from lightgbm_tpu_torch.parallel import mesh as pm
    cases = []
    for lead in ((), (1,), (2,)):
        f = 4 * w
        shape = (*lead, f, 5, 3)
        hi = [torch.from_numpy((rng.randn(*shape) * 1e4).astype(np.float32))
              for _ in range(w)]
        lo = [torch.from_numpy((rng.randn(*shape) * 1e-3).astype(np.float32))
              for _ in range(w)]
        hi[-1].reshape(-1)[:3] = -hi[0].reshape(-1)[:3]   # cancelling pairs
        ins = list(zip(hi, lo))
        tag = f"lead{len(lead) and lead[0]}"
        cases += [
            (f"pair_allreduce/{tag}",
             lambda m, p: pm.pair_allreduce(p, m), 1, ins),
            (f"compressed_allreduce_f32/{tag}",
             lambda m, p: pm.compressed_allreduce(p, m, "f32"), 1, ins),
            (f"compressed_allreduce_bf16/{tag}",
             lambda m, p: pm.compressed_allreduce(p, m, "bf16"), 1, ins)]
        for g in (1, 2):
            cases += [
                (f"pair_reduce_scatter_g{g}/{tag}",
                 lambda m, p, g=g: pm.pair_reduce_scatter(p, m, w, g), 1,
                 ins),
                (f"compressed_reduce_scatter_f32_g{g}/{tag}",
                 lambda m, p, g=g: pm.compressed_reduce_scatter(
                     p, m, w, g, "f32"), 1, ins),
                (f"compressed_reduce_scatter_bf16_g{g}/{tag}",
                 lambda m, p, g=g: pm.compressed_reduce_scatter(
                     p, m, w, g, "bf16"), 1, ins)]
        for prec in ("pair", "f32", "bf16"):
            cases.append((f"compressed_psum_{prec}/{tag}",
                          lambda m, p, prec=prec: pm.compressed_psum(
                              p[0], m, prec, "hist_reduce"), 0, ins))
        cases += [
            (f"all_gather/{tag}", lambda m, p: m.all_gather(
                p[0], "split_gather"), 0, ins),
            (f"all_to_all/{tag}", lambda m, p: m.all_to_all(
                p[0], p[0].dim() - 3, "leaf_sync"), 0, ins)]
    ints = [(torch.from_numpy(rng.randint(-9, 9, (w, 6)).astype(np.int32)),)
            for _ in range(w)]
    cases += [("all_gather/int32", lambda m, p: m.all_gather(p[0]), 0, ints),
              ("all_to_all/int32/axis0",
               lambda m, p: m.all_to_all(p[0], 0), 0, ints),
              ("psum/int32", lambda m, p: m.psum(p[0]), 0, ints)]
    return cases


def _mesh_worker(w, port, device, transport="auto"):
    """One rank: every case on the ProcessMesh and on an in-process
    LocalMesh of the same W over the same inputs, bit for bit; the
    folds counted and their descriptors checked; then the lockstep
    fault. On the card the transport follows the topology ("auto") or
    is forced to gloo over pinned copies, every rank on card 0. Prints
    one JSON line."""
    import datetime

    import torch.distributed as dist

    from lightgbm_tpu_torch.parallel import mesh as pm
    rank = int(os.environ["LIGHTGBM_TPU_RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if transport == "auto":
            transport, dev = tdist.choose_transport(
                [("127.0.0.1", port + r) for r in range(w)], rank, "cuda")
        else:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        transport = "gloo"
    dist.init_process_group(
        "nccl" if transport == "nccl" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", world_size=w, rank=rank,
        timeout=datetime.timedelta(seconds=60))
    tdist._state["transport"] = transport
    if transport == "nccl":
        tdist._state["host_group"] = dist.new_group(backend="gloo")
    pmesh = pm.ProcessMesh(dev)
    lmesh = pm.LocalMesh(w, dev)
    folds = []
    real = pm.gather_fold

    def counting(comps, lead, run, out, out_stride=None):
        folds.append(len({t.data_ptr() for t, _, _ in comps}))
        return real(comps, lead, run, out, out_stride)

    report = {"rank": rank, "transport": pmesh.transport, "cases": {}}
    for name, fn, n_folds, ins in _mesh_cases(np.random.RandomState(7), w):
        del folds[:]
        dins = [tuple(t.to(dev) for t in p) for p in ins]
        want = lmesh.run(lambda r: fn(lmesh, dins[r]))[rank]
        pm.gather_fold = counting
        try:
            got = pmesh.run(lambda r: fn(pmesh, dins[r]))[rank]
        finally:
            pm.gather_fold = real
        bits = (got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(got.cpu().view(torch.uint8)
                                if got.dtype.is_floating_point
                                else got.cpu(),
                                want.cpu().view(torch.uint8)
                                if want.dtype.is_floating_point
                                else want.cpu()))
        report["cases"][name] = {
            "bits": bool(bits), "folds": len(folds),
            "fold_buffers": sorted(set(folds)), "want_folds": n_folds}
    report["bytes_equal"] = pmesh.collective_bytes == lmesh.collective_bytes
    report["bytes"] = pmesh.collective_bytes
    # the lockstep fault: rank 0 adds where its peers gather
    try:
        pmesh.run(lambda r: pmesh.psum(torch.ones(4, device=dev)) if r == 0
                  else pmesh.all_gather(torch.ones(4, device=dev)))
        report["lockstep"] = "no error"
    except pm.MeshLockstepError as e:
        report["lockstep"] = "MeshLockstepError: " + str(e)
    print("MESH_REPORT " + json.dumps(report), flush=True)
    # every rank leaves together and takes the group down before the
    # interpreter's teardown (gloo's threads must not outlive it)
    dist.barrier()
    dist.destroy_process_group()


def _mesh_reports(w, device="cpu", transport="auto"):
    port = _free_port()
    res = _spawn(w, ["mesh", str(w), str(port), device, transport])
    reports = []
    for r, (rc, out, _) in enumerate(res):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("MESH_REPORT")]
        reports.append(json.loads(line[-1].split(" ", 1)[1]))
    return reports


def check_mesh_reports(reports, w):
    """The assertions on every rank's mesh report (shared with the card
    test, tests/test_torch_parallel_card.py)."""
    for rep in reports:
        cases = rep["cases"]
        assert len(cases) == 3 * 14 + 3
        for name, c in cases.items():
            assert c["bits"], f"rank {rep['rank']} {name}: bits differ"
            assert c["folds"] == c["want_folds"], (rep["rank"], name, c)
            if c["folds"]:
                # every descriptor into the one receive buffer
                assert c["fold_buffers"] == [1], (rep["rank"], name, c)
        assert rep["bytes_equal"], rep["bytes"]
        assert rep["lockstep"].startswith("MeshLockstepError"), rep
        assert "out of lockstep" in rep["lockstep"]
    assert len({json.dumps(r["bytes"], sort_keys=True)
                for r in reports}) == 1
    assert [r["rank"] for r in reports] == list(range(w))


@pytest.mark.parametrize("w", [2, 3])
def test_process_mesh_bit_equal_to_local_mesh(w):
    reports = _mesh_reports(w)
    assert {r["transport"] for r in reports} == {"gloo"}
    check_mesh_reports(reports, w)


# --------------------------------------------------------- the CLI gang

def _gang_worker(runs_path):
    """One rank of a CLI gang: each run of the JSON list in turn
    (Application on the CPU; the process group comes up at the first);
    every rank writes its in-memory model text and its row counts."""
    from lightgbm_tpu_torch.application import Application
    rank = int(os.environ["LIGHTGBM_TPU_RANK"])
    with open(runs_path) as f:
        runs = json.load(f)
    for run in runs:
        app = Application(run["argv"], device="cpu")
        app.run()
        with open(f"{run['out']}.rank{rank}", "w") as f:
            f.write(app.boosting.save_model_to_string(-1))
        ds = app.train_data
        print("GANG_ROWS " + json.dumps({
            "tag": run["tag"], "rank": rank, "num_data": ds.num_data,
            "global_num_data": ds.global_num_data,
            "local_rows_max": ds.local_rows_max}), flush=True)


def _cli_local(argv):
    """The in-process run of the same command line (no machine list:
    the LocalMesh at num_machines shards)."""
    from lightgbm_tpu_torch.application import Application
    app = Application(argv, device="cpu")
    app.run()
    return app


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One 2-process gang: every learner on an even-N CSV, the data
    learner on an odd-N CSV and through the two-round load."""
    d = tmp_path_factory.mktemp("gang")
    even, odd = str(d / "even.csv"), str(d / "odd.csv")
    _write_csv(even, 2000, 0)
    _write_csv(odd, 2001, 1)
    mlist = _machine_list(d / "mlist.txt", 2)
    runs = []
    for tag, extra in LEARNERS.items():
        runs.append({"tag": tag, "out": str(d / f"{tag}.txt"), "argv": (
            GANG_ARGS + extra + [f"data={even}", f"machine_list_file={mlist}",
                                 f"output_model={d / (tag + '.txt')}"])})
    runs.append({"tag": "odd", "out": str(d / "odd.txt"), "argv": (
        GANG_ARGS + LEARNERS["data_rs"] + [
            f"data={odd}", f"machine_list_file={mlist}",
            f"output_model={d / 'odd.txt'}"])})
    runs.append({"tag": "two_round", "out": str(d / "two_round.txt"),
                 "argv": (GANG_ARGS + LEARNERS["data_rs"] + [
                     f"data={even}", f"machine_list_file={mlist}",
                     "use_two_round_loading=true",
                     f"output_model={d / 'two_round.txt'}"])})
    runs_path = d / "runs.json"
    runs_path.write_text(json.dumps(runs))
    res = _spawn(2, ["gang", str(runs_path)])
    rows = {}
    for r, (rc, out, _) in enumerate(res):
        assert rc == 0, f"rank {r} failed:\n{out[-4000:]}"
        for ln in out.splitlines():
            if ln.startswith("GANG_ROWS "):
                rec = json.loads(ln.split(" ", 1)[1])
                rows[(rec["tag"], rec["rank"])] = rec
    return {"dir": d, "even": even, "odd": odd, "rows": rows,
            "logs": [out for _, out, _ in res]}


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("tag", sorted(LEARNERS))
def test_gang_model_byte_equal_to_in_process_mesh(gang, tag):
    d = gang["dir"]
    text = _read(d / f"{tag}.txt")
    # every rank grew rank 0's trees
    for r in range(2):
        assert _read(f"{d / tag}.txt.rank{r}") == text
    local = _cli_local(GANG_ARGS + LEARNERS[tag] + [
        f"data={gang['even']}", f"output_model={d / (tag + '.local.txt')}"])
    assert local.boosting.tree_learner.n_proc == 1
    assert _read(d / f"{tag}.local.txt") == text
    rows = [gang["rows"][(tag, r)] for r in range(2)]
    if tag == "feature":
        # the feature learner keeps every row on every rank
        assert [r["num_data"] for r in rows] == [2000, 2000]
        assert rows[0]["global_num_data"] is None
    else:
        assert [r["num_data"] for r in rows] == [1000, 1000]
        assert [r["global_num_data"] for r in rows] == [2000, 2000]


def test_gang_odd_rows_match_the_jax_learner(gang):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import DatasetLoader as JLoader
    from lightgbm_tpu.models.gbdt import GBDT as JGBDT
    from lightgbm_tpu.objectives import create_objective as jobjective
    from lightgbm_tpu_torch.models.gbdt import GBDT
    rows = [gang["rows"][("odd", r)] for r in range(2)]
    # blocks of different lengths, padded to the longest on both ranks
    assert [r["num_data"] for r in rows] == [1000, 1001]
    assert {r["local_rows_max"] for r in rows} == {1001}
    params = {"objective": "binary", "num_leaves": 15,
              "num_iterations": ROUNDS, "tree_learner": "data",
              "min_data_in_leaf": 10, "metric_freq": 0, "max_bin": 255,
              "hist_compaction": "false", "verbose": -1}
    cfg = JConfig.from_params(params)
    ds = JLoader(cfg).load_from_file(gang["odd"])
    obj = jobjective(cfg.objective, cfg)
    obj.init(ds.metadata, ds.num_data)
    ref = JGBDT()
    ref.init(cfg, ds, obj, [])
    for _ in range(ROUNDS):
        ref.train_one_iter(is_eval=False)
    got = GBDT("cpu")
    got.load_model_from_string(_read(gang["dir"] / "odd.txt"))
    assert len(got.models) == len(ref.models) == ROUNDS
    for t, j in zip(got.models, ref.models):
        assert t.num_leaves == j.num_leaves
        np.testing.assert_array_equal(t.split_feature_real,
                                      j.split_feature_real)
        np.testing.assert_allclose(t.threshold, j.threshold, rtol=1e-12)
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=2e-4,
                                   atol=1e-7)


def test_gang_two_round_load_is_rank_filtered(gang):
    rows = [gang["rows"][("two_round", r)] for r in range(2)]
    assert [r["num_data"] for r in rows] == [1000, 1000]
    assert all(r["num_data"] < 2000 and r["global_num_data"] == 2000
               for r in rows)
    assert "streamed rows [1000, 2000) of 2000" in gang["logs"][1]
    d = gang["dir"]
    assert _read(d / "two_round.txt") == _read(d / "data_rs.txt")


def test_gang_logs_name_rank_and_transport(gang):
    for r, log in enumerate(gang["logs"]):
        assert f"[rank {r}]" in log
        assert "transport=gloo" in log and "2 process(es)" in log
        # one agreement line a run: every rank holds rank 0's model
        assert log.count("all 2 ranks hold the same model") == \
            len(LEARNERS) + 2


# ------------------------------------------------------ faults and resume

def _cli_argv(d, mlist, extra, model):
    return (["cli"] + GANG_ARGS + extra + [
        f"data={d / 'train.csv'}", f"machine_list_file={mlist}",
        f"output_model={model}"])


def test_killed_rank_ends_its_peer_with_117(tmp_path):
    _write_csv(str(tmp_path / "train.csv"), 2000, 2)
    mlist = _machine_list(tmp_path / "mlist.txt", 2)
    timeout = 20
    res = _spawn(2, _cli_argv(tmp_path, mlist, LEARNERS["data_rs"] + [
        f"collective_timeout_s={timeout}"], tmp_path / "model.txt"),
        env={1: {"LIGHTGBM_TPU_FAULTS": "rank_crash_at_iteration=1:2"}})
    (rc0, out0, t0), (rc1, out1, t1) = res
    assert rc1 == tfaults.HARD_CRASH_EXIT_CODE, out1[-2000:]
    assert rc0 == 117, out0[-3000:]
    assert t0 - t1 < timeout + 10.0
    line = [ln for ln in out0.splitlines() if "collective watchdog" in ln][-1]
    assert "rank 0" in line and "'data:tree_build'" in line \
        and "iteration 2" in line and "fold_exchange" in line
    marker = tmp_path / "model.txt.snapshots" / "heartbeats" / \
        "watchdog.rank0000.json"
    rec = json.loads(marker.read_text())
    assert (rec["rank"], rec["collective"], rec["iteration"]) == (
        0, "data:tree_build", 2)
    assert not os.path.exists(tmp_path / "model.txt")


def test_gang_crash_and_resume_is_byte_equal(tmp_path, gang):
    _write_csv(str(tmp_path / "train.csv"), 2000, 0)   # the gang's even rows
    model = tmp_path / "model.txt"
    args = LEARNERS["voting"] + ["snapshot_freq=2", "collective_timeout_s=30",
                                 "heartbeat_timeout_s=30"]
    res = _spawn(2, _cli_argv(tmp_path, _machine_list(
        tmp_path / "m1.txt", 2), args, model), env={
        1: {"LIGHTGBM_TPU_FAULTS": "rank_crash_at_iteration=1:3"}})
    assert [rc for rc, _, _ in res] == [117, tfaults.HARD_CRASH_EXIT_CODE]
    snaps = sorted(os.listdir(tmp_path / "model.txt.snapshots"))
    assert "snapshot.iter00000002.ckpt" in snaps and not model.exists()
    res = _spawn(2, _cli_argv(tmp_path, _machine_list(
        tmp_path / "m2.txt", 2), args, model))
    for r, (rc, out, _) in enumerate(res):
        assert rc == 0, out[-3000:]
        assert "Restored training state at iteration 2" in out
        assert f"heartbeat service: rank {r} of 2" in out
    assert model.read_text() == _read(gang["dir"] / "voting.txt")
    # the beats (the JAX package's format) end with each rank's done
    from lightgbm_tpu_torch.parallel import heartbeat as hb
    beats = [hb.read_heartbeat(hb.heartbeat_path(hb.heartbeat_dir(
        tmp_path / "model.txt.snapshots"), r)) for r in range(2)]
    assert [(b["rank"], b["done"], b["iteration"]) for b in beats] == [
        (0, True, ROUNDS), (1, True, ROUNDS)]


def _cli_worker(argv):
    """One rank of the CLI on the CPU."""
    from lightgbm_tpu_torch.application import Application
    Application(argv, device="cpu").run()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    mode = sys.argv[1]
    torch.set_num_threads(1)
    if mode == "mesh":
        _mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                     sys.argv[5])
    elif mode == "gang":
        _gang_worker(sys.argv[2])
    elif mode == "cli":
        _cli_worker(sys.argv[2:])
    else:
        raise SystemExit(f"unknown mode {mode}")
