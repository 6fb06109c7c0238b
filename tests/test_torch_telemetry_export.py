"""lightgbm_tpu_torch's trace exporter and fleet aggregator on the CPU.

On the same journal records (a CPU training with telemetry on, a
two-rank crash -> restart journal, comm records with cross-rank flows,
cross-process request spans, the registry's promote/rollback) the port's
collect_records and build_trace give the JAX package's output, and the
JAX validate_trace accepts it; the port's validate_trace rejects what the
JAX one rejects, with the same messages. Target parsing, stitch_traces,
fleet_view and the Prometheus page equal the JAX package's on the same
inputs; the aggregator polls the port's CPU server and a /trainz
endpoint, and serves /fleetz, /metricz, /healthz and /tracez.
"""

import json
import math
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from lightgbm_tpu.telemetry import aggregate as jagg
from lightgbm_tpu.telemetry import export as jexport

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.fleet import ModelRegistry
from lightgbm_tpu_torch.serving import CompiledPredictor, make_server
from lightgbm_tpu_torch.telemetry import aggregate as tagg
from lightgbm_tpu_torch.telemetry import disttrace, prometheus, trainz
from lightgbm_tpu_torch.telemetry import export as texport
from lightgbm_tpu_torch.telemetry.journal import RunJournal
from lightgbm_tpu_torch.telemetry.registry import MetricsRegistry

CPU = "cpu"
PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
          "verbose": -1}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=800, f=4, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    return x, (x[:, 0] + x[:, 1] > 1).astype(np.float32)


# ------------------------------------------------------- journal sources
def _training(d):
    x, y = _data()
    p = dict(PARAMS, telemetry=True, telemetry_dir=d, telemetry_trace=True)
    b = lgt.train(p, lgt.Dataset(x, y), 3, verbose_eval=False, device=CPU)
    b.gbdt.close_telemetry()         # dumps the span ring


def _crash_restart(d):
    j0 = RunJournal(d, rank=0, meta={"num_ranks": 2})
    j1 = RunJournal(d, rank=1, meta={"num_ranks": 2})
    for i in (1, 2):
        j0.iteration(i, phases={"build": 0.01, "score_upd": 0.002})
        j1.iteration(i, phases={"build": 0.012}, fused=True, block=2)
    j1.event("abort", exit_code=117, reason="collective_watchdog",
             collective="tree_build", iteration=3)
    RunJournal(d, rank=0, emit_run_start=False, source="supervisor").event(
        "restart", attempt=1, exit_code=117)
    j0.event("resume", iteration=2)
    j0.event("memory", iteration=2, host_rss_bytes=123456789)
    j0.event("checkpoint", iteration=2, path="snap", write_s=0.004)
    j0.event("compile", label="fused_block", seconds=0.5, cache_hit=False)
    j0.event("spans", epoch_ts=time.time() - 1.0,
             spans=[{"name": "build", "path": "train/build",
                     "start_s": 0.5, "duration_s": 0.01, "tid": 1111},
                    {"name": "hb", "path": "hb", "start_s": 0.6,
                     "duration_s": 0.002, "tid": 2222}])
    j0.event("mesh", shards=1, f_loc=4)
    j0.event("run_end", iterations=2)
    j0.close()
    j1.close()


def _comm_flows(d):
    for rank, wait in ((0, 0.01), (1, 0.05), (2, 0.03)):
        j = RunJournal(d, rank=rank, emit_run_start=False)
        for i in (1, 2):
            j.iteration(i, phases={"build": 0.1},
                        collective_bytes={"hist_reduce": 4096})
            j.event("comm", iteration=i,
                    waits={"leaf_count_sync": wait, "data:tree_build": 0.08},
                    wait_s=wait, dispatch_s=0.08, wall_s=0.2,
                    overlap_pct=round(100 * (1 - wait / 0.2), 2))
            j.event("quality", iteration=i, gain_total=1.5 * i, splits=6,
                    values={"auc": 0.8})
        j.close()


def _request_flows(d):
    router = disttrace.TraceRecorder(directory=d, rank=0, service="router",
                                     sample_rate=1.0)
    replica = disttrace.TraceRecorder(directory=d, rank=1,
                                      service="serving", sample_rate=1.0)
    ctx = disttrace.TraceContext(disttrace.new_trace_id(),
                                 disttrace.new_span_id(),
                                 flags=disttrace.FLAG_SAMPLED)
    with router.span("router.request", ctx=ctx):
        with replica.span("serve.request") as h:
            h.set_tag("http.status", 200)
    router.close()
    replica.close()


def _registry(d):
    paths = []
    x, y = _data()
    for rounds in (2, 3):
        b = lgt.train(PARAMS, lgt.Dataset(x, y), rounds, verbose_eval=False,
                      device=CPU)
        paths.append(os.path.join(d, f"m{rounds}.txt"))
        b.save_model(paths[-1])
    journal = RunJournal(os.path.join(d, "journal"), source="fleet")
    reg = ModelRegistry(os.path.join(d, "reg"), journal=journal)
    reg.promote(reg.publish(paths[0]))
    reg.promote(reg.publish(paths[1]))
    reg.rollback(reason="drill")
    journal.close()
    return os.path.join(d, "journal")


SOURCES = {"training": _training, "crash_restart": _crash_restart,
           "comm_flows": _comm_flows, "request_flows": _request_flows,
           "registry": _registry}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_build_trace_equals_jax(tmp_path, source):
    d = str(tmp_path)
    d = SOURCES[source](d) or d
    recs, torn = texport.collect_records(d)
    assert (recs, torn) == jexport.collect_records(d)
    assert recs and torn == 0
    trace = texport.build_trace(recs)
    assert trace == jexport.build_trace(recs)
    assert texport.validate_trace(trace) == []
    assert jexport.validate_trace(trace) == []
    out = os.path.join(d, "out.json")
    written, path = texport.export_trace(d, out)
    assert path == out
    with open(out, encoding="utf-8") as f:
        assert json.load(f) == written == trace
    events = trace["traceEvents"]
    names = {e["name"] for e in events}
    if source == "registry":
        assert {"promote v1", "promote v2", "rollback v1"} <= names
    if source in ("comm_flows", "request_flows"):
        flows = [e for e in events if e["ph"] in ("s", "t", "f")]
        assert flows and {e["pid"] for e in flows} >= {0, 1}
    if source == "training":
        assert {"block -> iter 3", "fused_block"} <= names
        assert any(e["tid"] >= texport.TID_SPAN_BASE for e in events)


def _bad(kind):
    ok = {"name": "x", "ph": "X", "ts": 0, "dur": 5, "pid": 0, "tid": 0}
    events = {
        "malformed_counter": [ok, {"name": "c", "ph": "C", "ts": 1, "pid": 0,
                                   "tid": 0, "args": {"v": "high"}}],
        "empty_counter": [ok, {"name": "c", "ph": "C", "ts": 1, "pid": 0,
                               "tid": 0, "args": {}}],
        "unpaired_flow": [ok, {"name": "f", "ph": "s", "cat": "c", "id": 1,
                               "ts": 1, "pid": 0, "tid": 0}],
        "flow_without_id": [ok, {"name": "f", "ph": "f", "ts": 1, "pid": 0,
                                 "tid": 0}],
        "zero_duration": [dict(ok, dur=0)],
        "unknown_phase": [dict(ok, ph="Q")],
        "negative_ts": [dict(ok, ts=-1)],
        "missing_pid": [{k: v for k, v in ok.items() if k != "pid"}],
        "nameless": [dict(ok, name="")],
        "not_an_object": [ok, 7],
        "nan_arg": [dict(ok, args={"v": math.nan})],
    }
    if kind == "empty":
        return {"traceEvents": []}
    if kind == "not_a_trace":
        return ["traceEvents"]
    return {"traceEvents": events[kind]}


@pytest.mark.parametrize("kind", [
    "malformed_counter", "empty_counter", "unpaired_flow", "flow_without_id",
    "zero_duration", "unknown_phase", "negative_ts", "missing_pid",
    "nameless", "not_an_object", "nan_arg", "empty", "not_a_trace"])
def test_validate_trace_rejects_as_jax(kind):
    errors = texport.validate_trace(_bad(kind))
    assert errors and errors == jexport.validate_trace(_bad(kind))


def test_export_main(tmp_path, capsys):
    d = str(tmp_path / "j")
    _crash_restart(d)
    assert texport.main([d, "--validate"]) == 0
    out = capsys.readouterr().out
    assert "trace invariants OK" in out and "2 rank track(s)" in out
    with open(os.path.join(d, "trace.json"), encoding="utf-8") as f:
        assert jexport.validate_trace(json.load(f)) == []
    one = os.path.join(d, "journal.rank0001.jsonl")
    assert texport.main([one, "-o", str(tmp_path / "one.json")]) == 0
    assert (tmp_path / "one.json").exists()
    (tmp_path / "empty").mkdir()
    assert texport.main([str(tmp_path / "empty")]) == 2
    assert "no journal records" in capsys.readouterr().err


# ------------------------------------------------------------ aggregator
@pytest.mark.parametrize("spec", [
    "train=127.0.0.1:80", "127.0.0.1:80", " SERVE = h:1", "router=h:2",
    "auto=h:3", "bogus=127.0.0.1:80", "no-port", "serve=no-port"])
def test_target_parsing_equals_jax(spec):
    def parse(mod):
        try:
            t = mod.Target(spec)
        except ValueError as e:
            return "error", str(e)
        return t.role, t.host_port, t.url("/metricz")
    assert parse(tagg) == parse(jagg)
    for mod in (tagg, jagg):
        with pytest.raises(ValueError, match="at least one target"):
            mod.FleetAggregator([])


def _span(trace_id, span_id, name, start, dur, parent=None,
          service="serving", tags=None, links=None, status="ok"):
    r = {"event": "trace", "ts": start, "rank": 0, "trace_id": trace_id,
         "span_id": span_id, "name": name, "start": start,
         "duration_s": dur, "kind": "internal", "status": status,
         "flags": 0, "service": service}
    for key, value in (("parent_span_id", parent), ("tags", tags),
                       ("links", links)):
        if value:
            r[key] = value
    return r


def test_stitch_traces_equals_jax(tmp_path):
    t0 = 1000.0
    recs = [
        _span("aa" * 8, "02" * 8, "serve.request", t0 + 0.001, 0.004,
              parent="01" * 8),
        _span("aa" * 8, "01" * 8, "router.request", t0, 0.006,
              service="router"),
        _span("bb" * 8, "03" * 8, "router.request", t0 + 1.0, 0.002,
              service="router", tags={"http.status": 503}),
        _span("aa" * 8, "04" * 8, "batch.dispatch", t0 + 0.002, 0.002,
              parent="02" * 8, links=["bb" * 8, "cc" * 8]),
        _span("dd" * 8, "05" * 8, "serve.request", t0 + 2.0, 0.01,
              status="error", parent="99" * 8),
        {"event": "trace", "trace_id": "ee" * 8, "start": "late"},
    ]
    traces = tagg.stitch_traces(recs)
    assert traces == jagg.stitch_traces(recs)
    assert [t["trace_id"] for t in traces][:2] == ["bb" * 8, "dd" * 8]
    _request_flows(str(tmp_path))
    recs = tagg.read_trace_records(str(tmp_path))
    assert recs == jagg.read_trace_records(str(tmp_path)) and len(recs) == 2
    z = tagg.TraceCollector(str(tmp_path), max_traces=5).tracez(n=3)
    assert z == jagg.TraceCollector(str(tmp_path), max_traces=5).tracez(n=3)
    assert z["trace_count"] == 1 and z["traces"][0]["span_count"] == 2


def _state():
    reg = MetricsRegistry()
    reg.histogram("sync_wait_s").observe(0.25)
    reg.set("prefetch_overlap_pct", 96.0)
    return {
        "h:1": {"role": "train", "ok": True, "label": "0", "data": {
            "iteration": 5, "comm": {"rank": 0, "cum_wait_s": 0.1,
                                     "overlap_pct": 90.0}}},
        "h:2": {"role": "train", "ok": True, "label": "1", "data": {
            "iteration": 7, "metrics": reg.snapshot()}},
        "h:3": {"role": "serve", "ok": True, "label": "2", "data": {
            "request_count": 10, "error_count": 1, "latency_p99_ms": 7.5,
            "swap_count": 1, "model_version": 2, "warmup_s": 0.5}},
        "h:4": {"role": "serve", "ok": True, "label": "3", "data": {
            "request_count": 4, "error_count": 0, "latency_p99_ms": 9.25}},
        "h:5": {"role": "router", "ok": True, "label": "4", "data": {
            "router": True, "request_count": 12, "retry_count": 2,
            "hedge_count": 1, "breaker_open_count": 1,
            "no_replica_count": 0, "healthy_replica_count": 2}},
        "h:6": {"role": "auto", "ok": False, "error": "URLError: refused"},
    }


def test_fleet_view_and_prometheus_equal_jax():
    state = _state()
    fleet = tagg.fleet_view(state)
    assert fleet == jagg.fleet_view(state)
    assert fleet["straggler_s"] == {"0": 0.0, "1": 0.15}
    assert fleet["worst_latency_p99_ms"] == 9.25
    assert fleet["request_count"] == 14 and fleet["unreachable"] == 1
    assert fleet["router_min_healthy_replicas"] == 2
    pages = []
    for mod in (tagg, jagg):
        agg = mod.FleetAggregator(list(state))
        agg._state = state
        pages.append(agg.prometheus())
    assert pages[0] == pages[1]
    assert prometheus.lint_names(pages[0]) == []
    prometheus.parse(pages[0])


def _http(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_aggregator_polls_port_server_and_trainz(tmp_path):
    """poll_once against the port's CPU server and a /trainz endpoint:
    the replica's request count and p99 equal the server's /metricz, the
    page parses, the HTTP views answer, /tracez stitches the server's
    request spans."""
    x, y = _data()
    path = str(tmp_path / "m.txt")
    lgt.train(PARAMS, lgt.Dataset(x, y), 3, verbose_eval=False,
              device=CPU).save_model(path)
    pred = CompiledPredictor.from_model_file(path, max_batch_rows=32,
                                             device=CPU)
    tdir = str(tmp_path / "traces")
    srv = make_server(pred, port=0, max_wait_ms=1.0, model_version=3,
                      trace_dir=tdir, trace_sample_rate=1.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    reg = MetricsRegistry()
    reg.histogram("sync_wait_s").observe(0.2)
    tz = trainz.start_trainz(trainz.build_sources(
        iteration_fn=lambda: 4, registry=reg,
        comm_fn=lambda: {"rank": 0, "cum_wait_s": 0.2, "overlap_pct": 88.0}),
        port=0)
    agg = tagg.FleetAggregator(
        [f"serve=127.0.0.1:{srv.server_address[1]}",
         f"train=127.0.0.1:{tz.server_address[1]}"],
        poll_s=999, trace_dir=tdir)
    hs = None
    try:
        for n in (1, 3, 5):
            req = urllib.request.Request(
                url + "/predict",
                data=json.dumps({"rows": x[:n].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
        srv.trace_recorder.flush_pending()
        snap = agg.poll_once()
        with urllib.request.urlopen(url + "/metricz", timeout=30) as r:
            mz = json.loads(r.read())
        replica = snap["targets"][f"127.0.0.1:{srv.server_address[1]}"]
        assert replica["ok"] and replica["role"] == "serve"
        assert replica["data"]["request_count"] == mz["request_count"] == 3
        assert replica["data"]["latency_p99_ms"] == mz["latency_p99_ms"]
        assert replica["data"]["model_version"] == 3
        fleet = snap["fleet"]
        assert fleet == jagg.fleet_view(snap["targets"])
        assert fleet["train_ranks"] == 1 and fleet["serve_replicas"] == 1
        assert fleet["request_count"] == 3
        assert fleet["worst_latency_p99_ms"] == round(mz["latency_p99_ms"], 4)
        assert fleet["max_sync_wait_s"] == 0.2
        page = agg.prometheus()
        parsed = prometheus.parse(page)
        assert prometheus.lint_names(page) == []
        assert "# TYPE lightgbm_tpu_request_total counter" in page
        assert parsed
        hs = agg.serve(0)
        base = f"http://127.0.0.1:{hs.server_address[1]}"
        status, body = _http(base + "/fleetz")
        assert status == 200 and json.loads(body)["fleet"] == fleet
        status, body = _http(base + "/healthz")
        assert status == 200 and all(json.loads(body)["targets"].values())
        status, body = _http(base + "/metricz?format=prometheus")
        assert status == 200 and body.decode() == page
        status, body = _http(base + "/tracez")
        z = json.loads(body)
        assert status == 200 and z["trace_count"] >= 1
        assert "serve.request" in {s["name"] for t in z["traces"]
                                   for s in t["spans"]}
        assert _http(base + "/nope")[0] == 404
    finally:
        agg.stop()
        trainz.stop_trainz(tz)
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        srv.trace_recorder.close()
    assert hs is not None
