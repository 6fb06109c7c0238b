"""lightgbm_tpu_torch checkpoints: the file format, validation, rotation
and atomic writes (the cases of tests/test_fault_tolerance.py:228-309),
and checkpoints carried across the two packages.

The port keeps the JAX package's format byte for byte (LGBMTPUCKPT1,
digest and length headers, an npz payload with meta_json), so a
snapshot either package writes decodes in the other, and the port
resumes a JAX snapshot: from JAX's iteration-4 snapshot of an 8-round
run the port grows the JAX uninterrupted run's trees (the same
structure, leaf values and predictions within 1e-6, the bound
tests/test_torch_train.py holds the two packages to). feature_fraction
draws from the numpy stream both packages share; bagging and GOSS draw
from jax.random in the JAX package and from torch in the port, so they
are left out here.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import callback as jcallback
from lightgbm_tpu.utils import checkpoint as jckpt
from lightgbm_tpu.utils import faults as jfaults
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.checkpoint import (CheckpointError,
                                                 CheckpointManager,
                                                 atomic_write_text,
                                                 decode_checkpoint,
                                                 encode_checkpoint)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread_no_faults():
    # the plain histogram versions are many small CPU ops: one thread
    # each keeps the suite's parallel workers from oversubscribing
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear_faults()
    yield
    faults.clear_faults()
    torch.set_num_threads(threads)


def _state():
    return {"state_version": 1, "iter": 3, "name": "abc",
            "score": np.arange(12, dtype=np.float32).reshape(3, 4),
            "scores_list": [np.ones(2), np.zeros(3)],
            "best_score": [[float("-inf"), 0.5]]}


def test_checkpoint_roundtrip_and_digest():
    state = _state()
    blob = encode_checkpoint(state)
    assert blob.startswith(b"LGBMTPUCKPT1\ndigest=")
    out = decode_checkpoint(blob)
    assert out["iter"] == 3 and out["name"] == "abc"
    assert out["best_score"] == [[float("-inf"), 0.5]]
    np.testing.assert_array_equal(out["score"], state["score"])
    assert len(out["scores_list"]) == 2
    np.testing.assert_array_equal(out["scores_list"][1], np.zeros(3))
    bad = blob[:-1] + bytes([blob[-1] ^ 1])
    with pytest.raises(CheckpointError, match="digest"):
        decode_checkpoint(bad)
    with pytest.raises(CheckpointError, match="truncated"):
        decode_checkpoint(blob[:len(blob) - 4])
    with pytest.raises(CheckpointError, match="magic"):
        decode_checkpoint(b"garbage" + blob)


@pytest.mark.parametrize("fault", ["corrupt_digest", "truncate_checkpoint"])
def test_damaged_newest_falls_back_to_previous(tmp_path, fault):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=3)
    mgr.save({"state_version": 1, "tag": "good"}, 5)
    with faults.injected_faults(**{fault: 1}):
        mgr.save({"state_version": 1, "tag": "bad"}, 10)
    state, path = mgr.load_latest()
    assert state["tag"] == "good"
    assert path.endswith("snapshot.iter00000005.ckpt")


def test_all_checkpoints_corrupt_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=3)
    with faults.injected_faults(corrupt_digest=-1):
        mgr.save({"state_version": 1}, 5)
        mgr.save({"state_version": 1}, 10)
    assert mgr.load_latest() == (None, None)


def test_rotation_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
    for it in (5, 10, 15, 20):
        mgr.save({"state_version": 1}, it)
    assert [it for it, _ in mgr.checkpoints()] == [15, 20]
    # files of another prefix and tmp debris are not checkpoints
    open(os.path.join(str(tmp_path), "other.iter00000001.ckpt"), "w").close()
    open(mgr.path_for(25) + ".tmp.123", "w").close()
    assert [it for it, _ in mgr.checkpoints()] == [15, 20]


def test_atomic_write_leaves_no_tmp_and_survives_existing(tmp_path):
    target = tmp_path / "model.txt"
    atomic_write_text(str(target), "v1\n")
    atomic_write_text(str(target), "v2\n")
    assert target.read_text() == "v2\n"
    assert os.listdir(tmp_path) == ["model.txt"]


def test_kill_mid_write_keeps_the_previous_snapshot(tmp_path):
    """crash_in_checkpoint_write: half the file lands in the tmp sibling
    and the process exits 43 before the rename; the previous snapshot
    survives and is the newest valid one."""
    import subprocess
    import sys
    d = str(tmp_path)
    CheckpointManager(d).save({"state_version": 1, "tag": "good"}, 5)
    code = ("import sys; from lightgbm_tpu_torch.utils import faults; "
            "from lightgbm_tpu_torch.utils.checkpoint import "
            "CheckpointManager; faults.set_fault("
            "'crash_in_checkpoint_write', 1); CheckpointManager(sys.argv[1])"
            ".save({'state_version': 1, 'tag': 'torn'}, 10)")
    r = subprocess.run([sys.executable, "-c", code, d], capture_output=True,
                       text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == faults.HARD_CRASH_EXIT_CODE, r.stderr
    names = os.listdir(d)
    assert any(".tmp." in n for n in names)           # the debris
    state, path = CheckpointManager(d).load_latest()
    assert state["tag"] == "good" and path.endswith("iter00000005.ckpt")


def test_fire_points():
    with faults.injected_faults(crash_at_iteration=7):
        faults.crash_if_reached(3, 4)      # iterations 3..6
        with pytest.raises(faults.InjectedFault, match="iteration 7"):
            faults.crash_if_reached(5, 4)
    faults.crash_if_reached(7)              # disarmed on exit
    assert faults.HARD_CRASH_EXIT_CODE == jfaults.HARD_CRASH_EXIT_CODE


# ----------------------------------------------------- across the packages

def test_format_is_byte_identical_to_the_jax_package(tmp_path):
    """The same state encodes to the same bytes in both packages, and a
    file either writes decodes in the other with equal arrays and
    meta."""
    state = _state()
    blob = encode_checkpoint(state)
    assert blob == jckpt.encode_checkpoint(state)
    for dec, enc in ((decode_checkpoint, jckpt.encode_checkpoint),
                     (jckpt.decode_checkpoint, encode_checkpoint)):
        out = dec(enc(state))
        assert sorted(out) == sorted(state)
        for k, v in state.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(out[k], v)
            elif k == "scores_list":
                for a, b in zip(out[k], v):
                    np.testing.assert_array_equal(a, b)
            else:
                assert out[k] == v
    # a manager of either package finds the other's newest file
    jckpt.CheckpointManager(str(tmp_path)).save({"state_version": 1,
                                                 "tag": "jax"}, 4)
    CheckpointManager(str(tmp_path)).save({"state_version": 1,
                                           "tag": "port"}, 8)
    assert jckpt.CheckpointManager(str(tmp_path)).load_latest()[0][
        "tag"] == "port"
    assert CheckpointManager(str(tmp_path)).checkpoints()[0][1] \
        == jckpt.CheckpointManager(str(tmp_path)).path_for(4)


PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
          "verbose": -1, "feature_fraction": 0.6, "learning_rate": 0.2,
          "partitioned_build": "false", "hist_compaction": "false",
          "device_row_chunk": 4096}


def _data():
    rng = np.random.RandomState(7)
    x = rng.rand(600, 8).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.randn(600) > 0.8)
    return x, y.astype(np.float32)


def test_port_resumes_a_jax_snapshot(tmp_path):
    """JAX trains 8 rounds uninterrupted and, with snapshots every 4,
    crashes at round 6; the port resumes that run's iteration-4 snapshot
    (its trees, float32 scores and feature-sampler state) and finishes
    to the JAX run's trees; a port snapshot resumes in the JAX package
    the same way."""
    x, y = _data()
    want = lgj.train(PARAMS, lgj.Dataset(x, y), 8, verbose_eval=False)
    d = str(tmp_path / "jax")
    jfaults.set_fault("crash_at_iteration", 6)
    try:
        with pytest.raises(jfaults.InjectedFault):
            lgj.train(PARAMS, lgj.Dataset(x, y), 8, verbose_eval=False,
                      callbacks=[jcallback.checkpoint(d, period=4)])
    finally:
        jfaults.clear_faults()
    assert [it for it, _ in CheckpointManager(d).checkpoints()] == [4]
    got = lgt.train(PARAMS, lgt.Dataset(x, y), 8, verbose_eval=False,
                    resume_from=d, device=CPU)
    assert got.current_iteration() == 8
    _assert_same_model(want, got, x)

    # the reverse: the port's own uninterrupted run, crashed at round 6
    # with snapshots every 4, finished by the JAX package
    ref = lgt.train(PARAMS, lgt.Dataset(x, y), 8, verbose_eval=False,
                    device=CPU)
    d2 = str(tmp_path / "port")
    with faults.injected_faults(crash_at_iteration=6):
        with pytest.raises(faults.InjectedFault):
            lgt.train(PARAMS, lgt.Dataset(x, y), 8, verbose_eval=False,
                      callbacks=[lgt.callback.checkpoint(d2, period=4)],
                      device=CPU)
    back = lgj.train(PARAMS, lgj.Dataset(x, y), 8, verbose_eval=False,
                     resume_from=d2)
    _assert_same_model(back, ref, x)


def _assert_same_model(jb, tb, x):
    jt = [t.materialize() if hasattr(t, "materialize") else t
          for t in jb.gbdt.models]
    tt = tb.gbdt.models
    assert len(jt) == len(tt) == 8
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        for key in ("split_feature_real", "left_child", "right_child",
                    "leaf_parent", "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                          err_msg=key)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0,
                               atol=1e-6)
