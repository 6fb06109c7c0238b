"""lightgbm_tpu_torch's training telemetry against lightgbm_tpu's, on the
CPU.

Held here:
- the port's journal files pass the JAX package's `validate_record`,
  and its `merge_journals` reads them (the records keep its shapes);
- the span tracer, the comm profiler and the run history give the JAX
  modules' snapshots on the same inputs (their timing fields aside:
  both clocks are the host's);
- /trainz serves the JAX document's keys (and the port's server
  answers with them);
- a booster's `quality` records match the JAX booster's on one fixture:
  the same trees (the same split counts, the same top features), gains
  within GAIN_RTOL of each other (the packages' float32 gradients part
  in the last ulp, test_torch_train.py);
- `telemetry=true`, `run_history` and `profile` run through the CLI and
  through `lgt.train`: a journal whose every record is valid, a merged
  timeline with run_start, iteration, checkpoint and run_end, one
  `run_summary` a run, a torch.profiler Chrome trace;
- the roofline table records the histogram kernels' calls (on the CPU
  their plain versions, timed on the host) once telemetry is on.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
from lightgbm_tpu.telemetry import comm_profile as jcomm
from lightgbm_tpu.telemetry import history as jhistory
from lightgbm_tpu.telemetry import journal as jjournal
from lightgbm_tpu.telemetry import trace as jtrace
from lightgbm_tpu.telemetry import trainz as jtrainz

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.application import Application
from lightgbm_tpu_torch.telemetry import comm_profile as tcomm
from lightgbm_tpu_torch.telemetry import history as thistory
from lightgbm_tpu_torch.telemetry import journal as tjournal
from lightgbm_tpu_torch.telemetry import roofline
from lightgbm_tpu_torch.telemetry import trace as ttrace
from lightgbm_tpu_torch.telemetry import trainz as ttrainz

CPU = "cpu"
PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
          "verbose": -1, "hist_compaction": "false",
          "device_row_chunk": 4096}
GAIN_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    roofline.TABLE.enabled = False


def _data(n=1500, f=5, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.7 * rng.randn(n) > 0)
    return x, y.astype(np.float64)


def _strip(rec, keys=("ts", "mono", "pid")):
    return {k: v for k, v in rec.items() if k not in keys}


# ----------------------------------------------------------- journal

def test_port_journal_records_pass_jax_schema_and_merge(tmp_path):
    d = tmp_path / "j"
    for rank in (0, 1):
        j = tjournal.RunJournal(d, rank=rank, meta={"num_ranks": 2})
        for it in (1, 2):
            j.iteration(it, phases={"build": 0.01 * it}, leaf_count=7,
                        grad_norm=0.5, fused=False)
            j.event("comm", iteration=it, waits={"x": 0.1}, wait_s=0.1,
                    dispatch_s=0.0, wall_s=1.0, overlap_pct=90.0)
        j.event("block_reshard", blocks=3, shards=2, rank=rank,
                block_lo=rank, block_hi=rank + 1, attempt=0)
        j.event("run_end", iterations=2, train_s=0.5)
        j.close()
    tjournal.RunJournal(d, rank=0, emit_run_start=False,
                        source="supervisor").event(
        "restart", attempt=1, exit_code=117, reason="r", survivors=[0],
        new_rank=0, mesh_reshard=True)
    for path in tjournal.rank_files(d):
        recs, bad = jjournal.read_journal(path)
        assert bad == 0 and recs
        assert all(jjournal.validate_record(r) == [] for r in recs), path
    # the JAX merge and the port's give the same timeline
    jout = jjournal.merge_journals(d, out_path=str(tmp_path / "j.jsonl"))
    tout = tjournal.merge_journals(d, out_path=str(tmp_path / "t.jsonl"))
    jrecs, _ = jjournal.read_journal(jout)
    trecs, _ = tjournal.read_journal(tout)
    assert jrecs == trecs and len(trecs) == 2 * 7 + 1
    assert trecs[-1]["source"] == "supervisor"
    assert tjournal.tail(tout, 3) == jjournal.tail(jout, 3)
    per_rank = {p: tjournal.read_journal(p)[0]
                for p in tjournal.rank_files(d)}
    assert (tjournal.detect_clock_skew(per_rank)
            == jjournal.detect_clock_skew(per_rank))
    assert tjournal.SCHEMA == jjournal.SCHEMA


# --------------------------------------------- tracer, comm, history

def _drive_tracer(tr):
    with tr.span("train"):
        with tr.span("build", leaf=3):
            pass
    tr.add("capture", 0.25)
    tr.add("capture", 0.5)
    return tr


def test_tracer_snapshots_equal_jax():
    j, t = _drive_tracer(jtrace.SpanTracer()), _drive_tracer(
        ttrace.SpanTracer())
    assert sorted(j.acc) == sorted(t.acc) == ["build", "capture", "train"]
    assert dict(j.cnt) == dict(t.cnt)
    assert j.snapshot()["capture"] == t.snapshot()["capture"] == 0.75
    assert sorted(j.delta_snapshot()) == sorted(t.delta_snapshot())
    assert j.delta_snapshot() == t.delta_snapshot() == {}
    for a, b in zip(j.recent(None), t.recent(None)):
        assert ({k: v for k, v in a.items() if k not in ("start_s",
                                                         "duration_s",
                                                         "tid")}
                == {k: v for k, v in b.items() if k not in ("start_s",
                                                            "duration_s",
                                                            "tid")})
    assert [ln.split()[0] for ln in j.report().splitlines()] == \
        [ln.split()[0] for ln in t.report().splitlines()]
    # profiler ranges around the spans (the JAX annotations' place)
    tr = ttrace.SpanTracer(profiler_annotations=True)
    with torch.profiler.profile() as prof:
        with tr.span("annotated"):
            torch.zeros(4).add_(1)
    assert "annotated" in {e.key for e in prof.key_averages()}


SECTIONS = [("leaf_count_sync", 0.01), ("tree_build", 0.2),
            ("ooc:hist_exchange", 0.03), ("mesh:fold_exchange", 0.02),
            ("fused_block", 0.5), ("leaf_count_sync", 0.04)]


def test_comm_profiler_records_equal_jax():
    j, t = jcomm.CommProfiler(rank=1), tcomm.CommProfiler(rank=1)
    assert j.flush(0) is None and t.flush(0) is None
    for name, s in SECTIONS:
        j.record(name, s)
        t.record(name, s)
    jr, tr = j.flush(3), t.flush(3)
    for rec in (jr, tr):
        rec.pop("wall_s")
        rec.pop("overlap_pct")
    assert jr == tr
    assert jr["wait_s"] == pytest.approx(0.1)
    assert jr["dispatch_s"] == pytest.approx(0.7)
    assert j.totals() == t.totals()
    assert j.cum_wait_s == t.cum_wait_s
    for name in ("tree_build", "x_tree_build", "fused_block", "leaf"):
        assert jcomm.is_dispatch(name) == tcomm.is_dispatch(name)
    for w, wall in ((0.1, 1.0), (2.0, 1.0), (0.0, 0.0)):
        assert jcomm.overlap_pct(w, wall) == tcomm.overlap_pct(w, wall)
    js, ts = j.snapshot(), t.snapshot()
    assert set(js) == set(ts) and js["totals"] == ts["totals"]


def test_run_history_equals_jax(tmp_path):
    fields = {"label": "x", "rows": 100, "iterations": 5, "train_s": 1.5,
              "metrics": {"valid_1 auc": 0.9}, "auc": 0.9,
              "collective_bytes": 4096, "prefetch_overlap_pct": 50.0,
              "bogus": None}
    jp, tp = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    for _ in range(2):
        jhistory.append_run_summary(jp, "train", **fields)
        thistory.append_run_summary(tp, "train", **fields)
    jrecs = [_strip(r) for r in jhistory.read_history(jp)]
    trecs = [_strip(r) for r in thistory.read_history(tp)]
    assert jrecs == trecs and len(trecs) == 2
    assert thistory.read_history(tp) and jhistory.read_history(tp)
    assert "bogus" not in trecs[0]
    assert thistory.default_path("d") == jhistory.default_path("d")


# ------------------------------------------------------------ /trainz

def test_trainz_document_has_the_jax_keys(tmp_path):
    jt, tt = jtrace.SpanTracer(), ttrace.SpanTracer()
    from lightgbm_tpu.telemetry.registry import MetricsRegistry as JReg
    from lightgbm_tpu_torch.telemetry.registry import MetricsRegistry as TReg
    jj = jjournal.RunJournal(tmp_path / "jj")
    tj = tjournal.RunJournal(tmp_path / "tj")
    kw = dict(iteration_fn=lambda: 3, quality_fn=lambda: {},
              comm_fn=lambda: {})
    jsrc = jtrainz.build_sources(tracer=jt, registry=JReg(), journal=jj,
                                 **kw)
    tsrc = ttrainz.build_sources(tracer=tt, registry=TReg(), journal=tj,
                                 **kw)
    assert set(jsrc) == set(tsrc)
    srv = ttrainz.start_trainz(tsrc, port=0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/trainz",
                                    timeout=10) as r:
            doc = json.loads(r.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metricz?format=prometheus",
                timeout=10) as r:
            prom = r.read().decode()
    finally:
        ttrainz.stop_trainz(srv)
    assert set(doc) == set(jsrc)
    assert doc["iteration"] == 3 and "graph" in doc["roofline"]["note"]
    assert "iteration 3" in prom
    jj.close()
    tj.close()


# ------------------------------------------------------------ quality

def _quality_records(pkg, tmp_path, tag, x, y, **kw):
    d = str(tmp_path / tag)
    params = dict(PARAMS, telemetry=True, telemetry_dir=d,
                  quality_telemetry=True, metric="auc", metric_freq=1)
    ds = pkg.Dataset(x, y)
    # a callback of the caller's keeps both packages on the
    # per-iteration loop: one quality record an iteration
    b = pkg.train(dict(params), ds, 4, valid_sets=[ds],
                  verbose_eval=False, callbacks=[lambda env: None], **kw)
    b.gbdt.close_telemetry()
    recs, bad = tjournal.read_journal(os.path.join(d,
                                                   "journal.rank0000.jsonl"))
    assert bad == 0
    return b, recs


def test_quality_records_match_jax(tmp_path):
    x, y = _data()
    jb, jrecs = _quality_records(lgj, tmp_path, "jax", x, y)
    tb, trecs = _quality_records(lgt, tmp_path, "torch", x, y, device=CPU)
    # the iteration records' gradient and hessian RMS (the port's ride on
    # the tree's transfer) are the JAX package's host float64 ones
    jit, tit = ([r for r in recs if r["event"] == "iteration"]
                for recs in (jrecs, trecs))
    assert len(jit) == len(tit) == 4
    for a, b in zip(jit, tit):
        assert (a["iteration"], a["leaf_count"]) == \
            (b["iteration"], b["leaf_count"])
        np.testing.assert_allclose([b["grad_norm"], b["hess_norm"]],
                                   [a["grad_norm"], a["hess_norm"]],
                                   rtol=1e-6)
    jq, tq = ([r for r in recs if r["event"] == "quality"]
              for recs in (jrecs, trecs))
    assert len(jq) == len(tq) == 4
    for a, b in zip(jq, tq):
        assert jjournal.validate_record(b) == []
        assert (a["iteration"], a["trees"], a["splits"]) == \
            (b["iteration"], b["trees"], b["splits"])
        assert list(a["top_gain"]) == list(b["top_gain"])
        np.testing.assert_allclose(list(b["top_gain"].values()),
                                   list(a["top_gain"].values()),
                                   rtol=GAIN_RTOL)
        np.testing.assert_allclose(b["gain_total"], a["gain_total"],
                                   rtol=GAIN_RTOL)
        for k in ("min", "max", "mean", "rms"):
            np.testing.assert_allclose(b["leaf_values"][k],
                                       a["leaf_values"][k], rtol=0,
                                       atol=1e-6)
        assert set(a.get("values", ())) == set(b.get("values", ()))
    js, ts = jb.gbdt.quality.snapshot(), tb.gbdt.quality.snapshot()
    assert [f["feature"] for f in js["top_features"]] == \
        [f["feature"] for f in ts["top_features"]]
    tsnap = tb.gbdt.metrics.snapshot()["gauges"]
    assert tsnap["quality_trees_total"] == 4


# ------------------------------------------------ the CLI and train()

def _write_csv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), delimiter=",", fmt="%.6f")


def test_cli_telemetry_profile_and_run_history(tmp_path):
    x, y = _data()
    _write_csv(tmp_path / "tr.csv", x, y)
    hist = tmp_path / "RUN_HISTORY.jsonl"
    argv = ["task=train", f"data={tmp_path / 'tr.csv'}",
            "objective=binary", "num_leaves=7", "num_iterations=4",
            "min_data_in_leaf=10", "hist_compaction=false",
            "metric=auc", "metric_freq=2", "is_training_metric=true",
            "snapshot_freq=2", f"output_model={tmp_path / 'm.txt'}",
            "telemetry=true", "quality_telemetry=true",
            f"profile={tmp_path / 'trace'}", f"run_history={hist}",
            "telemetry_trace=true", "verbose=-1"]
    Application(argv, device=CPU).run()
    snaps = tmp_path / "m.txt.snapshots"
    merged, bad = tjournal.read_journal(snaps / "journal.jsonl")
    assert bad == 0
    assert all(jjournal.validate_record(r) == [] for r in merged)
    events = [r["event"] for r in merged]
    assert events[0] == "run_start" and events[-1] == "run_end"
    for ev in ("iteration", "checkpoint", "metrics", "quality", "memory",
               "spans"):
        assert ev in events, ev
    ckpt = [r for r in merged if r["event"] == "checkpoint"]
    assert [r["iteration"] for r in ckpt] == [2, 4]
    assert all(r["write_s"] > 0 for r in ckpt)
    its = [r for r in merged if r["event"] == "iteration"]
    assert sum(r.get("block", 1) for r in its) == 4
    summaries = thistory.read_history(hist)
    assert len(summaries) == 1 and summaries[0]["iterations"] == 4
    assert "training auc" in summaries[0]["metrics"]
    assert jhistory.read_history(hist) == summaries
    with open(tmp_path / "trace" / "trace.rank0000.json") as f:
        assert json.load(f)["traceEvents"]
    # the dataset profile beside the model, the JAX package's sidecar
    assert os.path.exists(str(tmp_path / "m.txt") + ".profile.json")
    # a resume of the same command appends a resume record to the
    # timeline
    Application(argv[:4] + ["num_iterations=6"] + argv[5:],
                device=CPU).run()
    merged, _ = tjournal.read_journal(snaps / "journal.jsonl")
    assert [r["iteration"] for r in merged if r["event"] == "resume"] \
        == [4]
    assert len(thistory.read_history(hist)) == 2


def test_train_telemetry_profile_and_run_history(tmp_path):
    x, y = _data()
    hist = tmp_path / "h.jsonl"
    params = dict(PARAMS, telemetry=True, telemetry_dir=str(tmp_path / "j"),
                  profile=str(tmp_path / "trace"), run_history=str(hist))
    b = lgt.train(params, lgt.Dataset(x, y), 3, device=CPU)
    assert b.gbdt.journal is not None
    recs, _ = tjournal.read_journal(b.gbdt.journal.path)
    assert all(jjournal.validate_record(r) == [] for r in recs)
    assert [r["event"] for r in recs][:2] == ["run_start", "iteration"]
    assert len(thistory.read_history(hist)) == 1
    assert os.path.exists(tmp_path / "trace" / "trace.rank0000.json")
    b.gbdt.close_telemetry()
    assert b.gbdt.journal is None and tjournal.current() is None


def test_roofline_records_the_fold_kernels_once_telemetry_is_on(tmp_path):
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.ops import mesh_kernels as mk
    roofline.TABLE.reset()
    rng = np.random.RandomState(0)
    f, b, n = 3, 16, hk.HIST_CHUNK
    bins = torch.from_numpy(rng.randint(0, b, (f, n)).astype(np.uint8))
    ghc = torch.from_numpy(rng.rand(3, n).astype(np.float32))
    row_leaf = torch.zeros(n, dtype=torch.int32)
    leaf = torch.zeros(1, dtype=torch.int32)
    acc = torch.zeros((f, b, 3))
    comp = torch.zeros_like(acc)
    hk.hist_pair_fold(acc, comp, bins, ghc, row_leaf, leaf, b)
    assert roofline.TABLE.snapshot()["kernels"] == {}
    roofline.TABLE.enabled = True
    for _ in range(2):
        hk.hist_pair_fold(acc, comp, bins, ghc, row_leaf, leaf, b)
    mk.mesh_fold(torch.stack([acc, -comp]))
    snap = roofline.TABLE.snapshot(warn_fraction=0.5, peak=1e12)
    fold = snap["kernels"]["hist_pair_fold"]
    assert fold["calls"] == 2 and fold["rows"] == 2 * n
    assert fold["bytes"] == 2 * (f * n + 16 * n + 2 * f * b * 12)
    assert snap["kernels"]["mesh_fold"]["calls"] == 1
    assert fold["below_peak_fraction"] in (True, False)
    assert snap["peak_bytes_per_s"] == 1e12


@pytest.mark.parametrize("policy", ["off", "warn_skip", "clamp", "raise"])
def test_iteration_records_under_every_guard_policy(tmp_path, policy):
    """The norms ride on the tree's transfer beside the guard's flag
    (raise) or alone (the other policies)."""
    x, y = _data(n=600)
    params = dict(PARAMS, telemetry=True, telemetry_dir=str(tmp_path),
                  nonfinite_guard=policy)
    b = lgt.train(params, lgt.Dataset(x, y), 2, device=CPU,
                  callbacks=[lambda env: None])
    recs, _ = tjournal.read_journal(b.gbdt.journal.path)
    its = [r for r in recs if r["event"] == "iteration"]
    assert [r["iteration"] for r in its] == [1, 2]
    assert all(r["grad_norm"] > 0 and r["hess_norm"] > 0 for r in its)
    b.gbdt.close_telemetry()
