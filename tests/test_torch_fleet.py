"""lightgbm_tpu_torch's fleet on the CPU: the model registry, hot swap,
the registry follower, the admin CLI and `serve --registry --follow`.

Mirrors tests/test_fleet.py's registry, hot-swap and follower cases
against the port, with every predictor on device="cpu". A registry
written by either package is read, verified and served by the other:
the same CURRENT pointer, manifests and describe(), and the same
version's predictions from the two packages' predictors bit for bit.
The follower is driven through poll_once with a large poll_s, so no
case waits on a clock.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from lightgbm_tpu.fleet import ModelRegistry as JaxRegistry
from lightgbm_tpu.serving import CompiledPredictor as JaxPredictor

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.fleet import ModelRegistry, RegistryError
from lightgbm_tpu_torch.fleet.__main__ import main as fleet_main
from lightgbm_tpu_torch.fleet.hotswap import (HotSwapper, RegistryFollower,
                                              attach_follower)
from lightgbm_tpu_torch.serving import CompiledPredictor, make_server
from lightgbm_tpu_torch.telemetry.journal import RunJournal, read_journal
from lightgbm_tpu_torch.utils import faults

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
          "verbose": -1}


@pytest.fixture(autouse=True)
def _hygiene():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear_faults()
    yield
    faults.clear_faults()
    torch.set_num_threads(threads)


def _data(n=1200, f=4, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f)
    y = (x[:, 0] + x[:, 1] > 1).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Three port-trained models saved with their profile sidecars:
    {name: path}, and the rows."""
    d = tmp_path_factory.mktemp("models")
    x, y = _data()
    out = {}
    for name, rounds in (("m1", 4), ("m2", 8), ("m3", 6)):
        b = lgt.train(PARAMS, lgt.Dataset(x.astype(np.float32), y), rounds,
                      verbose_eval=False, device=CPU)
        out[name] = str(d / f"{name}.txt")
        b.save_model(out[name])
    return out, x


@pytest.fixture
def registry(tmp_path):
    return ModelRegistry(str(tmp_path / "registry"))


def _flip_byte(path, at=None):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2 if at is None else at] ^= 0xFF
    open(path, "wb").write(bytes(blob))


def _predictor(path, **kw):
    kw.setdefault("max_batch_rows", 32)
    return CompiledPredictor.from_model_file(path, device=CPU, **kw)


class _Server:
    def __init__(self, predictor, version):
        self.srv = make_server(predictor, port=0, max_wait_ms=1.0,
                               model_version=version)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.srv.batcher.close()
        self.thread.join(10)


def _post(url, rows):
    req = urllib.request.Request(
        url + "/predict", data=json.dumps({"rows": rows.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return np.asarray(json.loads(r.read())["predictions"])


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


# ------------------------------------------------------------- registry
def test_registry_publish_promote_current(models, registry):
    paths, _ = models
    v1 = registry.publish(paths["m1"])
    assert v1 == 1 and registry.versions() == [1]
    assert registry.profile_path(v1) is not None   # the sidecar rode along
    assert registry.current() is None              # publish does not promote
    ptr = registry.promote(v1, reason="bootstrap")
    assert ptr["version"] == 1 and ptr["generation"] == 1
    assert registry.current_version() == 1
    manifest = registry.verify(v1)
    assert set(manifest["files"]) == {"model.txt", "model.txt.profile.json",
                                      "metadata.json"}
    assert "published_ts" in registry.metadata(v1)
    with open(registry.model_path(v1), "rb") as a, \
            open(paths["m1"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("how", ["flipped_byte", "injected_fault"])
def test_registry_refuses_a_corrupt_version(models, registry, how):
    paths, _ = models
    v1 = registry.publish(paths["m1"])
    if how == "flipped_byte":
        _flip_byte(registry.model_path(v1))
        match = "crc32"
    else:
        faults.set_fault("corrupt_registry_version", 1)
        match = "corrupt_registry_version"
    with pytest.raises(RegistryError, match=match):
        registry.verify(v1)
    if how == "injected_fault":
        registry.verify(v1)          # a one-shot fault: consumed
        faults.set_fault("corrupt_registry_version", 1)
    with pytest.raises(RegistryError):
        registry.promote(v1)         # promote re-verifies
    assert registry.current() is None


def test_registry_rollback_byte_identical(models, registry):
    paths, _ = models
    v1, v2 = registry.publish(paths["m1"]), registry.publish(paths["m2"])
    registry.promote(v1)
    v1_bytes = open(registry.model_path(v1), "rb").read()
    registry.promote(v2)
    assert registry.current_version() == v2
    ptr = registry.rollback(reason="bad rollout")
    assert ptr["version"] == v1 and ptr["generation"] == 3
    assert open(registry.model_path(v1), "rb").read() == v1_bytes
    with pytest.raises(RegistryError, match="prior"):
        registry.rollback()          # history exhausted


def test_registry_quarantine_rules(models, registry):
    paths, _ = models
    v1, v2 = registry.publish(paths["m1"]), registry.publish(paths["m2"])
    registry.promote(v1)
    registry.quarantine(v2, reason="failed validation")
    assert registry.is_quarantined(v2)
    with pytest.raises(RegistryError, match="quarantined"):
        registry.promote(v2)
    registry.promote(v2, force=True)
    assert registry.current_version() == v2
    with pytest.raises(RegistryError, match="live"):
        registry.quarantine(v2)
    with pytest.raises(RegistryError, match="no published"):
        registry.quarantine(9)


def test_registry_torn_pointer_and_abandoned_stage(models, registry):
    paths, _ = models
    v1 = registry.publish(paths["m1"])
    registry.promote(v1)
    # a crash mid-publish leaves a .tmp stage dir: never listed, and the
    # next publish allocates past it
    stage = os.path.join(registry.versions_dir, ".tmp.v00000099.123")
    os.makedirs(stage)
    open(os.path.join(stage, "model.txt"), "w").write("partial")
    assert registry.versions() == [v1]
    assert registry.publish(paths["m1"]) == v1 + 1
    with open(os.path.join(registry.directory, "CURRENT"), "w") as f:
        f.write('{"version": 1, "gen')   # torn write (foreign writer)
    assert registry.current() is None


def test_registry_journals_transitions(models, tmp_path):
    paths, _ = models
    jdir = str(tmp_path / "journal")
    journal = RunJournal(jdir, rank=0, source="fleet")
    reg = ModelRegistry(str(tmp_path / "reg"), journal=journal)
    v1, v2 = reg.publish(paths["m1"]), reg.publish(paths["m2"])
    reg.promote(v1)
    reg.promote(v2)
    reg.quarantine(reg.publish(paths["m3"]), reason="worse")
    reg.rollback()
    journal.close()
    recs, bad = read_journal(journal.path)
    assert bad == 0
    assert [(r["event"], r["version"]) for r in recs[1:]] == [
        ("promote", 1), ("promote", 2), ("reject", 3), ("rollback", 1)]
    assert recs[2]["from_version"] == 1 and recs[4]["from_version"] == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_crosses_packages(models, tmp_path, writer):
    """One package writes the registry (two versions, a promotion and a
    rollback, a quarantine); the other reads the same pointer, manifests
    and summary, verifies every version, and serves the live one with
    the writer's answers bit for bit."""
    paths, x = models
    d = str(tmp_path / "reg")
    w_cls, r_cls = ((JaxRegistry, ModelRegistry) if writer == "jax"
                    else (ModelRegistry, JaxRegistry))
    w = w_cls(d)
    v1, v2, v3 = (w.publish(paths[m], metadata={"source": writer})
                  for m in ("m1", "m2", "m3"))
    w.promote(v1)
    w.promote(v2)
    w.rollback()
    w.quarantine(v3, reason="held out")
    r = r_cls(d)
    assert r.current() == w.current()
    assert r.versions() == w.versions() == [1, 2, 3]
    for v in r.versions():
        assert r.verify(v) == w.verify(v)
    assert r.describe() == w.describe()
    assert r.is_quarantined(v3) and r.current_version() == v1
    assert r.promote(v2)["generation"] == 4
    assert w.current()["history"] == [1]
    rows = x[:64]
    # the live version (now v2) served by each package's predictor
    path = (ModelRegistry(d).model_path(2), JaxRegistry(d).model_path(2))
    assert path[0] == path[1]
    port = _predictor(path[0])
    jax = JaxPredictor.from_model_file(path[1], max_batch_rows=32)
    np.testing.assert_array_equal(port.predict(rows), jax.predict(rows))
    # and the port's swap path loads the JAX registry's version
    if writer == "jax":
        srv = _Server(_predictor(ModelRegistry(d).model_path(1)), 1)
        try:
            HotSwapper(srv.srv, ModelRegistry(d)).swap_to(2)
            np.testing.assert_array_equal(_post(srv.url, rows),
                                          jax.predict(rows))
        finally:
            srv.close()


# ------------------------------------------------------------- hot swap
def test_concurrent_predict_during_hot_swap(models, registry):
    """Under concurrent /predict traffic a flip gives no 5xx, every
    response equal to exactly one version's answers, cold_dispatches 0
    after the flip, the new version on /metricz and /healthz, and a
    challenger on the incumbent's device."""
    paths, x = models
    v1, v2 = registry.publish(paths["m1"]), registry.publish(paths["m2"])
    registry.promote(v1)
    rows = x[:16]
    want = {1: _predictor(paths["m1"]).predict(rows),
            2: _predictor(paths["m2"]).predict(rows)}
    assert np.abs(want[1] - want[2]).max() > 1e-4
    s = _Server(_predictor(registry.model_path(v1), max_batch_rows=256), v1)
    stop = threading.Event()
    responses, errors = [], []
    progress = threading.Condition()

    def client():
        while not stop.is_set():
            try:
                out = _post(s.url, rows)
            except Exception as e:  # noqa: BLE001 — any 5xx fails below
                errors.append(repr(e))
                return
            with progress:
                responses.append(out)
                progress.notify_all()

    def wait_for(n):
        with progress:
            assert progress.wait_for(
                lambda: len(responses) >= n or errors, timeout=60)

    workers = [threading.Thread(target=client) for _ in range(4)]
    try:
        for w in workers:
            w.start()
        wait_for(10)
        swapper = HotSwapper(s.srv, registry)
        swapper.swap_to(v2, reason="test flip")
        wait_for(len(responses) + 10)
        stop.set()
        for w in workers:
            w.join(timeout=30)
            assert not w.is_alive()
        assert not errors, errors
        seen = {1: 0, 2: 0}
        for out in responses:
            match = [v for v in (1, 2) if np.array_equal(out, want[v])]
            assert len(match) == 1, "a response matches no single version"
            seen[match[0]] += 1
        assert seen[1] > 0 and seen[2] > 0
        assert s.srv.predictor.device == torch.device(CPU)
        assert s.srv.predictor.stats["cold_dispatches"] == 0
        assert swapper.stats["swap_count"] == 1
        mz = _get(s.url, "/metricz")
        assert mz["model_version"] == v2 and mz["swap_count"] == 1
        assert mz["cold_dispatches"] == 0
        assert _get(s.url, "/healthz")["model_version"] == v2
        np.testing.assert_array_equal(_post(s.url, rows), want[2])
    finally:
        stop.set()
        s.close()


def test_follower_promotion_rollback_and_corrupt_version(models, registry):
    """poll_once swaps to a promotion and to a rollback (byte-equal
    answers), refuses a corrupt version while the incumbent serves, and
    parks after MAX_ATTEMPTS failures until the pointer moves."""
    paths, x = models
    rows = x[:32]
    v1 = registry.publish(paths["m1"])
    registry.promote(v1)
    s = _Server(_predictor(registry.model_path(v1)), v1)
    try:
        follower = attach_follower(s.srv, registry.directory, poll_s=999)
        assert s.srv.follower is follower
        assert follower.poll_once() is None       # seeded: no re-swap
        before = _post(s.url, rows)
        v2 = registry.publish(paths["m2"])
        registry.promote(v2)
        assert follower.poll_once() == v2 and s.srv.model_version == v2
        assert follower.poll_once() is None
        np.testing.assert_array_equal(_post(s.url, rows),
                                      _predictor(paths["m2"]).predict(rows))
        registry.rollback()
        assert follower.poll_once() == v1
        assert _post(s.url, rows).tobytes() == before.tobytes()
        # a corrupt NEXT version: the follower keeps serving v1
        v3 = registry.publish(paths["m3"])
        _flip_byte(registry.model_path(v3), at=10)
        registry._write_pointer(v3, registry.current(), "bad")
        stats = follower.swapper.stats
        for _ in range(RegistryFollower.MAX_ATTEMPTS + 2):
            assert follower.poll_once() is None
        assert stats["failed_swaps"] == RegistryFollower.MAX_ATTEMPTS
        assert s.srv.model_version == v1 and stats["swap_count"] == 2
        assert _post(s.url, rows).tobytes() == before.tobytes()
        assert s.srv.predictor.device == torch.device(CPU)
        # the pointer moves again: the follower un-parks
        registry.promote(v2)
        assert follower.poll_once() == v2
        follower.stop()
        assert not follower._thread.is_alive()
    finally:
        s.close()


# ------------------------------------------------------------------ CLI
def test_fleet_cli_admin_roundtrip(models, tmp_path, capsys):
    paths, _ = models
    reg = str(tmp_path / "reg")

    def cli(*args, rc=0):
        assert fleet_main(list(args)) == rc
        return capsys.readouterr()

    out = cli("publish", "--registry", reg, paths["m1"], "--promote").out
    assert "published v1" in out and "promoted v1" in out
    assert "published v2" in cli("publish", "--registry", reg,
                                 paths["m2"]).out
    assert "promoted v2 (generation 2)" in cli(
        "promote", "--registry", reg, "--version", "2").out
    listing = json.loads(cli("list", "--registry", reg).out)
    assert [v["version"] for v in listing["versions"]] == [1, 2]
    assert listing["current"]["version"] == 2
    assert listing == json.loads(json.dumps(JaxRegistry(reg).describe(),
                                            default=str))
    assert "rolled back to v1" in cli("rollback", "--registry", reg).out
    out = cli("verify", "--registry", reg).out
    assert "v1: OK" in out and "v2: OK" in out
    _flip_byte(ModelRegistry(reg).model_path(2))
    assert "crc32" in cli("verify", "--registry", reg, "--version", "2",
                          rc=1).err
    assert "no readable manifest" in cli(
        "promote", "--registry", reg, "--version", "7", rc=1).err
    for cmd in ("route", "watch"):
        err = cli(cmd, "--targets", "127.0.0.1:1", rc=2).err
        assert "ROADMAP queue 1 item 7" in err


def test_serve_cli_follows_registry_on_the_cpu(models, tmp_path):
    """`python -m lightgbm_tpu_torch.serve MODEL --registry DIR --follow
    --device cpu`: serves CURRENT (v1, not the model argument), picks up
    a promotion within its polls, answers with v2's predictions, drains
    on SIGTERM, and imports neither jax nor lightgbm_tpu."""
    paths, x = models
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.promote(reg.publish(paths["m1"]))
    code = (
        "import atexit, sys\n"
        "def report():\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                 ('jax', 'jaxlib', 'lightgbm_tpu'))\n"
        "    print('IMPORTED', bad, flush=True)\n"
        "atexit.register(report)\n"
        "from lightgbm_tpu_torch.serving.server import main\n"
        "sys.exit(main(sys.argv[1:]))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, paths["m3"], "--registry",
         reg.directory, "--follow", "--poll-s", "0.1", "--device", "cpu",
         "--port", "0", "--max-batch-rows", "16", "--max-wait-ms", "1"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("SERVING "):
                url = line.split()[1].strip()
                break
        assert url, "no readiness line"
        assert _get(url, "/metricz")["model_version"] == 1
        rows = x[:4]
        np.testing.assert_array_equal(
            _post(url, rows), _predictor(paths["m1"]).predict(rows))
        reg.promote(reg.publish(paths["m2"]))
        deadline = time.monotonic() + 60
        while _get(url, "/metricz")["model_version"] != 2:
            assert time.monotonic() < deadline, "no swap to v2"
            time.sleep(0.05)
        mz = _get(url, "/metricz")
        assert mz["swap_count"] == 1 and mz["cold_dispatches"] == 0
        np.testing.assert_array_equal(
            _post(url, rows), _predictor(paths["m2"]).predict(rows))
    finally:
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, rest[-2000:]
    assert "IMPORTED []" in rest, rest[-2000:]
