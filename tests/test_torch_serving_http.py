"""lightgbm_tpu_torch's serving stack on the CPU: batcher, HTTP server,
admission, drift and skew monitors, hot-swap and the CLI.

Mirrors tests/test_serving.py (batcher, in-process server, request ids,
access/slow logs, Prometheus /metricz), tests/test_resilience.py
(deadlines, shedding, drain) and part of tests/test_drift.py (PSI, the
monitors, the host reference scorer) against the port, with the
predictor on device="cpu" (the traversal kernels' plain versions). HTTP
answers are held bit for bit against CompiledPredictor.predict, and the
in-process server's against the JAX package's CompiledPredictor on the
same model text; a request that shared a coalesced batch with others is
held within the f64 association bound (_assert_coalesced). A subprocess
serves through `python -m lightgbm_tpu_torch.serve --device cpu` and
shows that neither JAX nor the JAX package is loaded.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.serving import CompiledPredictor as JaxPredictor

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.io.profile import (DatasetProfile, group_counts,
                                           model_profile_path)
from lightgbm_tpu_torch.serving import (CompiledPredictor, MicroBatcher,
                                        ServingMetrics, build_monitors,
                                        drain, make_server, swap_model)
from lightgbm_tpu_torch.serving.drift import (DriftMonitor, SkewMonitor,
                                              host_reference_scorer, psi)
from lightgbm_tpu_torch.telemetry import prometheus
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.log import Log

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
          "verbose": -1}


@pytest.fixture(autouse=True)
def _fault_hygiene():
    faults.clear_faults()
    yield
    faults.clear_faults()


def _data(n=2000, f=4, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f)
    y = (x[:, 0] + x[:, 1] > 1).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port-trained binary model saved with its profile sidecar:
    (model path, rows, profile)."""
    x, y = _data()
    ds = lgt.Dataset(x.astype(np.float32), y)
    b = lgt.train(PARAMS, ds, 8, verbose_eval=False, device=CPU)
    path = str(tmp_path_factory.mktemp("model") / "model.txt")
    b.save_model(path)
    profile = DatasetProfile.from_dataset(ds._core)
    profile.save(model_profile_path(path))
    return path, x, profile


def _assert_coalesced(got, want, cp):
    """A request that rode a coalesced batch against the predictor on
    its rows alone: the exact path's f64 reduce is a BLAS product (the
    JAX predictor's) whose association follows the batch's row count,
    so the two sums of the same leaf values may differ by up to T trees
    x float64 eps x the sum of each tree's largest |leaf value|."""
    tol = (cp.num_trees * np.finfo(np.float64).eps
           * np.abs(cp._lv64).max(axis=1).sum())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _predictor(served, **kw):
    kw.setdefault("max_batch_rows", 32)
    return CompiledPredictor.from_model_file(served[0], device=CPU, **kw)


class _Server:
    """One in-process server with its own serve thread and teardown."""

    def __init__(self, predictor, **kw):
        kw.setdefault("max_wait_ms", 1.0)
        self.srv = make_server(predictor, port=0, **kw)
        self.port = self.srv.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.srv.batcher.close()
        if self.srv.trace_recorder is not None:
            self.srv.trace_recorder.close()


def _post(url, rows=None, path="/predict", body=None, headers=None,
          ct="application/json"):
    """POST; returns (status, parsed body, headers) for 2xx-5xx alike."""
    if body is None:
        body = json.dumps({"rows": np.asarray(rows).tolist()}).encode()
    req = urllib.request.Request(url + path, data=body,
                                 headers={"Content-Type": ct,
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else {}), dict(e.headers)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


# -------------------------------------------------------------- batcher
def test_batcher_coalesces_and_slices(served):
    _, x, _ = served
    cp = _predictor(served, max_batch_rows=256)
    metrics = ServingMetrics()
    mb = MicroBatcher(cp, max_wait_ms=300.0, metrics=metrics)
    n_clients = 6
    barrier = threading.Barrier(n_clients)
    results = [None] * n_clients
    slices = [x[i * 5:(i + 1) * 5 + i] for i in range(n_clients)]

    def client(i):
        barrier.wait()
        results[i] = mb.predict(slices[i], timeout=30)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    mb.close()
    for i in range(n_clients):
        _assert_coalesced(results[i], cp.predict(slices[i]), cp)
    assert metrics.batch_count < n_clients
    assert metrics.batched_requests == n_clients


def test_batcher_kinds_never_mix(served):
    _, x, _ = served
    cp = _predictor(served, max_batch_rows=64)
    metrics = ServingMetrics()
    mb = MicroBatcher(cp, max_wait_ms=50.0, metrics=metrics)
    futs = [mb.submit(x[:3], kind="predict"), mb.submit(x[3:5], kind="leaf"),
            mb.submit(x[5:9], kind="raw")]
    np.testing.assert_array_equal(futs[0].result(30), cp.predict(x[:3]))
    np.testing.assert_array_equal(futs[1].result(30),
                                  cp.predict_leaf_index(x[3:5]))
    np.testing.assert_array_equal(futs[2].result(30), cp.predict_raw(x[5:9]))
    mb.close()
    assert metrics.batch_count == 3


def test_batcher_survives_mixed_widths(served):
    _, x, _ = served
    cp = _predictor(served, max_batch_rows=64)
    mb = MicroBatcher(cp, max_wait_ms=100.0)
    f_narrow = mb.submit(x[:2, :3])
    f_wide = mb.submit(np.hstack([x[2:4], np.ones((2, 2))]))
    pad = np.hstack([x[:2, :3], np.zeros((2, x.shape[1] - 3))])
    _assert_coalesced(f_narrow.result(30), cp.predict(pad), cp)
    _assert_coalesced(f_wide.result(30), cp.predict(x[2:4]), cp)
    np.testing.assert_array_equal(mb.predict(x[4:6], timeout=30),
                                  cp.predict(x[4:6]))
    mb.close()


def test_batcher_error_propagates():
    class Boom:
        max_batch_rows = 8

        def predict(self, rows):
            raise RuntimeError("boom")

    mb = MicroBatcher(Boom(), max_wait_ms=1.0)
    fut = mb.submit(np.zeros((2, 3)))
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(10)
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.zeros((1, 3)))


def test_metrics_nearest_rank_percentiles():
    m = ServingMetrics()
    m.record_request(1, 0.001)
    m.record_request(1, 0.100)
    assert m.latency_percentiles()[50] == pytest.approx(1.0)
    m2 = ServingMetrics()
    for i in range(100):
        m2.record_request(1, (i + 1) / 1000.0)
    pct = m2.latency_percentiles()
    assert pct[50] == pytest.approx(50.0)
    assert pct[99] == pytest.approx(99.0)


# ---------------------------------------------------------- HTTP server
def test_server_in_process_bit_equal_to_both_predictors(served):
    path, x, _ = served
    cp = _predictor(served)
    with open(path) as f:
        jg = JaxGBDT()
        jg.load_model_from_string(f.read())
    jp = JaxPredictor.from_booster(jg, max_batch_rows=32)
    s = _Server(cp)
    try:
        health = _get(s.url, "/healthz")
        assert health["status"] == "ok"
        assert health["model"]["num_trees"] == cp.num_trees
        assert health["model"]["device"] == "cpu"
        for n in (1, 3, 40):
            status, out, _ = _post(s.url, x[:n])
            assert status == 200 and out["rows"] == n
            got = np.asarray(out["predictions"])
            np.testing.assert_array_equal(got, cp.predict(x[:n]))
            np.testing.assert_array_equal(got, jp.predict(x[:n]))
        # null -> NaN -> default-direction routing, single-row form
        row = x[0].tolist()
        row[0] = None
        nan_row = x[:1].copy()
        nan_row[0, 0] = np.nan
        _, out1, _ = _post(s.url, body=json.dumps({"row": row}).encode())
        np.testing.assert_array_equal(out1["predictions"],
                                      cp.predict(nan_row))
        csv = "\n".join(",".join(f"{v:.6f}" for v in r)
                        for r in x[:2]).encode()
        _, out2, _ = _post(s.url, path="/predict_raw", body=csv,
                           ct="text/csv")
        np.testing.assert_allclose(out2["predictions"], cp.predict_raw(x[:2]),
                                   rtol=0, atol=1e-6)
        _, out3, _ = _post(s.url, x[:2], path="/predict_leaf")
        np.testing.assert_array_equal(out3["predictions"],
                                      cp.predict_leaf_index(x[:2]))
        status, bad, _ = _post(s.url, body=b"{}")
        assert status == 400 and "error" in bad
        # POST to an unknown path drains its body: the same keep-alive
        # connection then serves a valid request
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=30)
        payload = json.dumps({"rows": x[:2].tolist()}).encode()
        conn.request("POST", "/predict_rows", body=payload,
                     headers={"Content-Type": "application/json"})
        assert conn.getresponse().read()
        conn.request("POST", "/predict", body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        np.testing.assert_array_equal(
            json.loads(resp.read())["predictions"], cp.predict(x[:2]))
        conn.close()
        m = _get(s.url, "/metricz")
        assert m["request_count"] == 7
        assert m["rows_served"] == 1 + 3 + 40 + 1 + 2 + 2 + 2
        assert m["error_count"] == 1
        assert m["cold_dispatches"] == 0
        assert m["latency_p50_ms"] > 0 and m["batch_count"] >= 1
        assert _get(s.url, "/tracez") == {"enabled": False}
        assert _get(s.url, "/quiescez")["quiescent"]
    finally:
        s.close()


def test_request_id_and_timing_breakdown(served):
    _, x, _ = served
    s = _Server(_predictor(served))
    try:
        status, body, hdr = _post(s.url, x[:3],
                                  headers={"X-Request-Id": "client-id-7"})
        assert status == 200 and hdr["X-Request-Id"] == "client-id-7"
        assert body["request_id"] == "client-id-7"
        timing = body["timing_ms"]
        for k in ("parse_ms", "queue_ms", "compute_ms", "total_ms"):
            assert timing[k] >= 0.0, timing
        assert (timing["parse_ms"] + timing["queue_ms"]
                + timing["compute_ms"]) <= timing["total_ms"] + 0.5
        assert body["latency_ms"] == timing["total_ms"]
        assert "queue=" in hdr["X-Timing-Ms"]
        assert "compute=" in hdr["X-Timing-Ms"]
        _, body2, hdr2 = _post(s.url, path="/predict_raw",
                               body=json.dumps({"row": x[0].tolist()})
                               .encode())
        assert hdr2["X-Request-Id"] == body2["request_id"] != "client-id-7"
        _, _, hdr3 = _post(s.url, x[:1],
                           headers={"X-Request-Id": "a b<c>d" + "x" * 200})
        assert "<" not in hdr3["X-Request-Id"]
        assert " " not in hdr3["X-Request-Id"]
        assert len(hdr3["X-Request-Id"]) <= 64
        status, err, hdr4 = _post(s.url, body=b"{}",
                                  headers={"X-Request-Id": "err-1"})
        assert status == 400 and hdr4["X-Request-Id"] == "err-1"
        assert err["request_id"] == "err-1"
    finally:
        s.close()


def test_access_and_slow_request_logs(served, capsys, monkeypatch):
    _, x, _ = served
    monkeypatch.setenv("LIGHTGBM_TPU_LOG_JSON", "1")
    monkeypatch.setattr(Log, "_level", 1)
    s = _Server(_predictor(served), slow_request_ms=0.0001)
    try:
        capsys.readouterr()
        _post(s.url, x[:2], headers={"X-Request-Id": "slowone"})
        time.sleep(0.05)
        lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        access = [r for r in lines if r.get("event") == "access"]
        assert len(access) == 1, lines
        rec = access[0]
        assert rec["request_id"] == "slowone" and rec["status"] == 200
        assert rec["path"] == "/predict" and rec["rows"] == 2
        for k in ("parse_ms", "queue_ms", "compute_ms", "total_ms"):
            assert k in rec
        slow = [r for r in lines if r.get("event") == "slow_request"]
        assert len(slow) == 1 and slow[0]["level"] == "Warning"
        assert slow[0]["request_id"] == "slowone"
    finally:
        s.close()


def test_metricz_prometheus_under_live_traffic(served):
    _, x, _ = served
    s = _Server(_predictor(served), max_wait_ms=2.0)
    errors, stop = [], threading.Event()

    def client():
        body = json.dumps({"rows": x[:4].tolist()}).encode()
        while not stop.is_set():
            try:
                status, _, _ = _post(s.url, body=body)
                assert status == 200
            except Exception as e:   # noqa: BLE001
                errors.append(repr(e))
                return

    workers = [threading.Thread(target=client) for _ in range(3)]
    try:
        for w in workers:
            w.start()
        pages = 0
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and pages < 20:
            with urllib.request.urlopen(
                    s.url + "/metricz?format=prometheus", timeout=30) as r:
                assert r.headers["Content-Type"].startswith("text/plain")
                page = prometheus.parse(r.read().decode())
            assert "lightgbm_tpu_request_total" in page
            assert "lightgbm_tpu_queue_depth" in page
            pages += 1
        stop.set()
        for w in workers:
            w.join(timeout=30)
        assert not errors, errors
        assert pages >= 20
        text = urllib.request.urlopen(s.url + "/metricz?format=prometheus",
                                      timeout=30).read().decode()
        assert prometheus.lint_names(text) == []
        final = prometheus.parse(text)
        assert final["lightgbm_tpu_request_total"] > 0
        assert final["lightgbm_tpu_rows_served_total"] > 0
        assert 'lightgbm_tpu_latency_seconds{quantile="0.5"}' in final
        snap = _get(s.url, "/metricz")
        assert snap["request_count"] == int(
            final["lightgbm_tpu_request_total"])
    finally:
        stop.set()
        s.close()


# ------------------------------------------------------------ resilience
def test_already_expired_deadline_is_504(served):
    _, x, _ = served
    s = _Server(_predictor(served))
    try:
        status, body, _ = _post(s.url, x[:2], headers={"X-Deadline-Ms": "0"})
        assert status == 504 and "expired" in body["error"]
        snap = _get(s.url, "/metricz")
        assert snap["deadline_expired_count"] == 1
        assert snap["shed_count"] == 0
        assert snap["batch_count"] == 0     # nothing reached the kernel
    finally:
        s.close()


def test_deadline_expires_in_queue_504_and_worker_survives(served):
    _, x, _ = served
    s = _Server(_predictor(served))
    try:
        s.srv.chaos["wedge_batcher"] = 1
        result = {}

        def client():
            result["out"] = _post(s.url, x[:2],
                                  headers={"X-Deadline-Ms": "150"})

        t = threading.Thread(target=client, daemon=True)
        t.start()
        time.sleep(0.4)
        del s.srv.chaos["wedge_batcher"]
        t.join(timeout=10)
        status, body, _ = result["out"]
        assert status == 504 and "queue" in body["error"]
        assert _get(s.url, "/metricz")["deadline_expired_count"] == 1
        status, body, _ = _post(s.url, x[:2])
        assert status == 200 and len(body["predictions"]) == 2
    finally:
        s.close()


def test_admission_sheds_429_with_retry_after_and_brownout(served):
    _, x, _ = served
    s = _Server(_predictor(served), max_wait_ms=80.0)
    try:
        status, body, hdr = _post(s.url, x[:2],
                                  headers={"X-Deadline-Ms": "10"})
        assert status == 429 and body["retry_after_s"] > 0
        assert int(hdr["Retry-After"]) >= 1
        snap = _get(s.url, "/metricz")
        assert snap["shed_count"] == 1 and snap["brownout_active"] == 1
        assert _get(s.url, "/healthz")["status"] == "ok"
        status, body, _ = _post(s.url, x[:2])
        assert status == 200 and not s.srv.admission.brownout_active
    finally:
        s.close()


def test_drain_is_retryable_and_strict_healthz(served):
    _, x, _ = served
    s = _Server(_predictor(served))
    try:
        s.srv.draining = True
        status, body, hdr = _post(s.url, x[:2])
        assert status == 503 and "draining" in body["error"]
        assert hdr["Retry-After"] == "1"
        assert _get(s.url, "/healthz")["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(s.url + "/healthz?strict=1", timeout=30)
        assert e.value.code == 503
        s.srv.draining = False
        assert drain(s.srv, timeout_s=5.0)
    finally:
        s.close()


# ----------------------------------------------------- drift and skew
def test_group_counts_and_psi_math():
    counts = np.arange(10, dtype=np.int64)
    np.testing.assert_array_equal(group_counts(counts, 0), counts)
    np.testing.assert_array_equal(group_counts(counts, 5), [1, 5, 9, 13, 17])
    base = np.asarray([100, 100, 100, 100])
    assert psi(base, base * 7) == pytest.approx(0.0, abs=1e-12)
    assert psi(base, np.asarray([400, 0, 0, 0])) > 0.5
    assert psi(base, np.zeros(4)) == 0.0


def test_profile_roundtrip_and_mapper(served):
    path, x, profile = served
    loaded = DatasetProfile.load(model_profile_path(path))
    assert loaded.num_rows == profile.num_rows == len(x)
    for u, (a, b) in enumerate(zip(profile.features, loaded.features)):
        assert int(a["counts"].sum()) == len(x)
        np.testing.assert_array_equal(a["counts"], b["counts"])
        np.testing.assert_array_equal(a["upper_bounds"], b["upper_bounds"])
        assert b["upper_bounds"][-1] == np.inf
        col = x[:, a["column"]].astype(np.float32)
        np.testing.assert_array_equal(
            loaded.mapper(u).value_to_bin(col),
            profile.mapper(u).value_to_bin(col))


def test_drift_monitor_quiet_and_shifted(served):
    _, _, profile = served
    mon = DriftMonitor(profile, sample_rate=1.0, psi_warn=0.2)
    rng = np.random.RandomState(1)
    mon.observe(rng.rand(600, 4))
    assert mon.gauges()["drift_psi_max"] < 0.2 and not mon.warnings
    shifted = rng.rand(600, 4)
    shifted[:, 0] += 3.0
    mon.observe(shifted)
    name0 = profile.features[0]["name"]
    assert mon.psi_by_feature()[name0] >= 0.2
    assert [w["feature"] for w in mon.warnings] == [name0]


def test_skew_monitor_and_host_reference(served, capsys, monkeypatch):
    path, x, _ = served
    Log.reset_log_level(1)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_PREDICT", "force")
    ref = host_reference_scorer(path)
    boosters = [c.cell_contents for c in ref.__closure__
                if hasattr(c.cell_contents, "_use_device_predict")]
    assert boosters and not boosters[0]._use_device_predict(10**9, 100)
    rows = x[:64]
    served_out = np.asarray(ref("predict", rows))
    # the exact serving path gives the host reference's values
    np.testing.assert_allclose(_predictor(served).predict(rows), served_out,
                               rtol=0, atol=1e-12)
    mon = SkewMonitor(ref, sample_rate=1.0, skew_warn=1,
                      max_rows_per_check=64)
    mon.observe(rows, served_out, "predict")
    assert mon.skew_count == 0 and mon.rows_checked == 64
    mon.observe(rows, served_out + 0.01, "predict")
    assert mon.snapshot()["skew_count"] == 64
    assert "skew_warn" in capsys.readouterr().out


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_monitors_armed_and_quiet_through_the_server(served, precision,
                                                     capsys):
    """build_monitors from the model's sidecar: unshifted traffic keeps
    drift and skew quiet (bf16: the skew tolerance is the predictor's
    pinned accuracy_bound), a shifted feature trips drift on /driftz,
    /metricz and the warning log."""
    _, _, profile = served
    cp = _predictor(served, max_batch_rows=256, serving_precision=precision)
    drift, skew = build_monitors(cp, drift_sample_rate=1.0, psi_warn=0.2,
                                 skew_sample_rate=1.0, skew_warn=1)
    assert drift is not None and skew is not None
    assert skew.tol >= cp.accuracy_bound
    Log.reset_log_level(1)
    s = _Server(cp, drift=drift, skew=skew)
    try:
        rng = np.random.RandomState(11)
        for _ in range(6):
            assert _post(s.url, rng.rand(100, 4))[0] == 200
        dz = _get(s.url, "/driftz")
        assert dz["enabled"] and dz["psi_max"] < 0.2 and not dz["warnings"]
        assert dz["skew"]["skew_count"] == 0
        assert dz["skew"]["skew_rows_checked"] > 0
        name0 = profile.features[0]["name"]
        for _ in range(6):
            rows = rng.rand(100, 4)
            rows[:, 0] += 3.0
            _post(s.url, rows)
        dz = _get(s.url, "/driftz")
        assert dz["features"][name0]["psi"] >= 0.2
        assert [w["feature"] for w in dz["warnings"]] == [name0]
        mz = _get(s.url, "/metricz")
        assert mz["drift_psi_max"] >= 0.2 and mz["skew_count"] == 0
        assert mz["serving_precision"] == precision
        prom = urllib.request.urlopen(s.url + "/metricz?format=prometheus",
                                      timeout=30).read().decode()
        assert "lightgbm_tpu_skew_count 0" in prom
        assert prometheus.lint_names(prom) == []
        assert "drift_warn" in capsys.readouterr().out
    finally:
        s.close()


# --------------------------------------------------- hot-swap, tracing
def test_swap_model_flips_the_served_model(served, tmp_path):
    path, x, _ = served
    old = _predictor(served)
    xs, ys = _data(seed=3)
    b2 = lgt.train(dict(PARAMS, num_leaves=5), lgt.Dataset(
        xs.astype(np.float32), 1.0 - ys), 4, verbose_eval=False, device=CPU)
    new = CompiledPredictor.from_booster(b2, max_batch_rows=32, device=CPU)
    s = _Server(old, model_version=1)
    try:
        _, before, _ = _post(s.url, x[:5])
        np.testing.assert_array_equal(before["predictions"],
                                      old.predict(x[:5]))
        retired = swap_model(s.srv, new, version=2)
        assert retired is old and s.srv.predictor is new
        _, after, _ = _post(s.url, x[:5])
        np.testing.assert_array_equal(after["predictions"],
                                      new.predict(x[:5]))
        health = _get(s.url, "/healthz")
        assert health["model_version"] == 2
        assert health["model"]["num_trees"] == new.num_trees
        assert _get(s.url, "/metricz")["swap_count"] == 1
    finally:
        s.close()


def test_trace_dir_spans_and_tracez(served, tmp_path):
    _, x, _ = served
    s = _Server(_predictor(served), trace_dir=str(tmp_path),
                trace_sample_rate=1.0)
    try:
        status, _, _ = _post(s.url, x[:3], headers={
            "X-Trace-Ctx": "0123456789abcdef0123456789abcdef/"
                           "0123456789abcdef/01"})
        assert status == 200
        s.srv.trace_recorder.flush_pending()
        tz = _get(s.url, "/tracez")
        assert tz["enabled"] and tz["traces_kept"] >= 1
        names = {sp["name"] for sp in tz["recent_spans"]}
        assert {"serve.request", "batch.dispatch", "serve.kernel"} <= names
        assert {sp["trace_id"] for sp in tz["recent_spans"]} == {
            "0123456789abcdef0123456789abcdef"}
    finally:
        s.close()


# ------------------------------------------------------------------- CLI
def test_serve_cli_on_the_cpu_without_jax(served):
    """`python -m lightgbm_tpu_torch.serve --device cpu`: readiness line,
    /healthz, a POST bit-equal to the predictor, /metricz, a clean
    SIGTERM drain, and neither jax nor lightgbm_tpu imported."""
    path, x, _ = served
    code = (
        "import atexit, sys\n"
        "def report():\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                 ('jax', 'jaxlib', 'lightgbm_tpu'))\n"
        "    print('IMPORTED', bad, flush=True)\n"
        "atexit.register(report)\n"
        "from lightgbm_tpu_torch.serving.server import main\n"
        "sys.exit(main(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", code, path, "--device", "cpu", "--port", "0",
         "--max-batch-rows", "16", "--max-wait-ms", "1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        url = None
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                assert proc.poll() is None, "server died during startup"
                continue
            if line.startswith("SERVING "):
                url = line.split()[1].strip()
                break
        assert url, "no readiness line"
        health = _get(url, "/healthz")
        assert health["status"] == "ok" and health["model"]["device"] == "cpu"
        status, out, _ = _post(url, x[:4])
        assert status == 200
        np.testing.assert_array_equal(
            out["predictions"],
            _predictor(served, max_batch_rows=16).predict(x[:4]))
        m = _get(url, "/metricz")
        assert m["request_count"] == 1 and m["cold_dispatches"] == 0
    finally:
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, rest[-2000:]
    assert "IMPORTED []" in rest, rest[-2000:]


def test_serve_cli_flags_and_registry_error(served):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.serve",
                        "--help"], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0
    for flag in ("--device", "--serving-precision", "--profile",
                 "--drift-sample-rate", "--skew-sample-rate",
                 "--trace-dir", "--deadline-default-ms"):
        assert flag in r.stdout
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.serve",
                        served[0], "--registry", "/nonexistent",
                        "--device", "cpu"], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env=env)
    assert r.returncode == 2
    assert "queue 1 item 9" in r.stderr
