"""lightgbm_tpu_torch crash and resume, byte for byte (the cases of
tests/test_fault_tolerance.py:83-300).

An injected crash (faults.crash_at_iteration) stops a run that writes
snapshots; a fresh run with resume_from the snapshot directory must
produce the uninterrupted run's model text byte for byte, on the fused
fast path, the blockwise path (with its eval history and early-stop
trackers) and the per-iteration path, under DART, GOSS, linear leaves
and multiclass; an off-cadence resume realigns the snapshot blocks;
period 0 writes nothing; an empty directory is a cold start; a corrupt
newest snapshot is skipped; the CLI's snapshot_freq resumes to the
uninterrupted model file. Bagging and feature_fraction are on wherever
the boosting allows, so the restored sampler state is what is proven.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import callback
from lightgbm_tpu_torch.application import Application
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.checkpoint import CheckpointManager

CPU = "cpu"
PARAMS = {"objective": "binary", "metric": "binary_logloss", "num_leaves": 7,
          "min_data_in_leaf": 10, "verbose": -1, "bagging_fraction": 0.7,
          "bagging_freq": 2, "feature_fraction": 0.6, "learning_rate": 0.2}
N_ROUNDS = 16


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


def _data(n=600, f=10, classes=2):
    rng = np.random.RandomState(7)
    x = rng.randn(n, f)
    z = x[:, 0] + 0.5 * rng.randn(n)
    y = (np.digitize(z, [-0.5, 0.5]) if classes > 2 else z > 0)
    y = y.astype(np.float64)
    return (x[:500], y[:500]), (x[500:], y[500:])


def _user_cb(env):
    """A callback train() did not make: forces the per-iteration loop."""


def _train(ckpt_dir=None, crash_at=None, resume=False, with_valid=True,
           per_iteration=False, params=PARAMS, early_stopping=None,
           period=5, classes=2):
    (x, y), (xv, yv) = _data(classes=classes)
    train_set = lgt.Dataset(x, y)
    valid = ([lgt.Dataset(xv, yv, reference=train_set)] if with_valid
             else None)
    cbs = []
    if ckpt_dir is not None:
        cbs.append(callback.checkpoint(ckpt_dir, period=period))
    if per_iteration:
        cbs.append(_user_cb)
    evals_result = {}
    if crash_at is not None:
        faults.set_fault("crash_at_iteration", crash_at)
    try:
        booster = lgt.train(params, train_set, num_boost_round=N_ROUNDS,
                            valid_sets=valid, verbose_eval=False,
                            evals_result=evals_result,
                            early_stopping_rounds=early_stopping,
                            callbacks=cbs,
                            resume_from=ckpt_dir if resume else None,
                            device=CPU)
    except faults.InjectedFault:
        return None, evals_result
    finally:
        faults.clear_faults()
    return booster.gbdt.save_model_to_string(-1), evals_result


def _plain(evals_result):
    return {k: {m: list(v) for m, v in h.items()}
            for k, h in evals_result.items()}


def _crash_and_resume(tmp_path, crash_at=12, **kw):
    ref, er_ref = _train(**kw)
    d = str(tmp_path / "ck")
    crashed, _ = _train(ckpt_dir=d, crash_at=crash_at, **kw)
    assert crashed is None  # the injected crash fired
    got, er_got = _train(ckpt_dir=d, resume=True, **kw)
    assert got == ref
    return d, er_ref, er_got


def test_resume_fused_fast_path(tmp_path):
    """No valid set: the fused path cut into blocks of the period;
    crash at 12, resume from the iteration-10 snapshot."""
    d, _, _ = _crash_and_resume(tmp_path, with_valid=False)
    assert [it for it, _ in CheckpointManager(d).checkpoints()] == [5, 10,
                                                                    15]


def test_resume_fused_blockwise(tmp_path):
    """A valid set: the blockwise path, snapshots at block boundaries."""
    _crash_and_resume(tmp_path)


def test_resume_per_iteration(tmp_path):
    """A user callback forces the per-iteration loop; the crash at 13 is
    off the cadence, so the resume trains 3 lost rounds again."""
    _crash_and_resume(tmp_path, crash_at=13, per_iteration=True)


def test_resume_restores_eval_history_and_early_stopping(tmp_path):
    """The evals_result history and the early-stop trackers ride inside
    the snapshot: the histories are equal element for element (the
    reference writes snapshots at the same cadence)."""
    ref, er_ref = _train(ckpt_dir=str(tmp_path / "ref"), early_stopping=6)
    d = str(tmp_path / "ck")
    crashed, _ = _train(ckpt_dir=d, crash_at=11, early_stopping=6)
    assert crashed is None
    got, er_got = _train(ckpt_dir=d, resume=True, early_stopping=6)
    assert got == ref
    assert _plain(er_got) == _plain(er_ref)


@pytest.mark.parametrize("extra", [
    {"boosting_type": "dart", "drop_rate": 0.3},
    {"boosting_type": "goss", "top_rate": 0.3, "other_rate": 0.2,
     "bagging_fraction": 1.0, "bagging_freq": 0},
    {"linear_tree": True},
], ids=["dart", "goss-fused", "linear"])
def test_resume_boosting_variants(tmp_path, extra):
    """DART re-scores restored trees in bin space (the snapshot's split
    encoding and drop sampler); GOSS trains fused from the restored
    iteration (its draws are keyed on it); linear leaves need the inner
    coefficient ids."""
    params = dict(PARAMS, **extra)
    params.pop("metric")
    _crash_and_resume(tmp_path, with_valid=False, params=params)


def test_resume_multiclass(tmp_path):
    params = dict(PARAMS, objective="multiclass", num_class=3,
                  metric="multi_logloss")
    _crash_and_resume(tmp_path, params=params, classes=3)


def test_resume_off_cadence_realigns_snapshot_boundaries(tmp_path):
    """Resume from an iteration-10 snapshot (period 5) with period 4:
    the fused blocks realign so snapshots land on 12 and 16."""
    ref, _ = _train(with_valid=False)
    d = str(tmp_path / "ck")
    _train(ckpt_dir=d, crash_at=12, with_valid=False)
    got, _ = _train(ckpt_dir=d, resume=True, with_valid=False, period=4)
    assert got == ref
    saved = [it for it, _ in CheckpointManager(d).checkpoints()]
    assert saved == [10, 12, 16]   # keep_last_k = 3


def test_period_zero_is_disabled(tmp_path):
    ref, _ = _train(with_valid=False)
    d = str(tmp_path / "ck")
    got, _ = _train(ckpt_dir=d, with_valid=False, period=0)
    assert got == ref
    assert CheckpointManager(d).checkpoints() == []


def test_resume_without_checkpoint_is_cold_start(tmp_path):
    ref, _ = _train(with_valid=False)
    got, _ = _train(ckpt_dir=str(tmp_path / "empty"), resume=True,
                    with_valid=False)
    assert got == ref


def test_resumed_run_skips_corrupt_newest_checkpoint(tmp_path):
    """A torn newest snapshot on disk: the loader falls back to the one
    before it and the model still equals the uninterrupted run's."""
    ref, _ = _train(with_valid=False)
    d = str(tmp_path / "ck")
    _train(ckpt_dir=d, crash_at=12, with_valid=False)
    newest = CheckpointManager(d).checkpoints()[-1][1]
    blob = open(newest, "rb").read()
    with open(newest, "wb") as f:
        f.write(blob[:len(blob) // 2])
    got, _ = _train(ckpt_dir=d, resume=True, with_valid=False)
    assert got == ref


def test_cli_snapshots_resume_to_the_uninterrupted_model(tmp_path):
    """The CLI with snapshot_freq and training metrics (metric_freq 3):
    fused blocks end on both cadences, the snapshots land on 5, 10, 15,
    and a run crashed at 12 and run again resumes to the uninterrupted
    model file byte for byte."""
    (x, y), _ = _data()
    data = str(tmp_path / "train.tsv")
    np.savetxt(data, np.column_stack([y, x]), delimiter="\t", fmt="%.9g")
    base = ["task=train", f"data={data}", "objective=binary",
            "metric=auc", "is_training_metric=true", "metric_freq=3",
            f"num_trees={N_ROUNDS}", "num_leaves=7", "min_data_in_leaf=10",
            "verbose=-1", "bagging_fraction=0.7", "bagging_freq=2",
            "feature_fraction=0.6"]
    ref_model = str(tmp_path / "ref.txt")
    Application(base + [f"output_model={ref_model}"], device=CPU).run()
    snap_model = str(tmp_path / "snap.txt")
    argv = base + [f"output_model={snap_model}", "snapshot_freq=5"]
    with faults.injected_faults(crash_at_iteration=12):
        with pytest.raises(faults.InjectedFault):
            Application(argv, device=CPU).run()
    assert not os.path.exists(snap_model)
    snaps = CheckpointManager(snap_model + ".snapshots")
    assert [it for it, _ in snaps.checkpoints()] == [5, 10]
    Application(argv, device=CPU).run()
    assert open(snap_model).read() == open(ref_model).read()
    assert [it for it, _ in snaps.checkpoints()] == [5, 10, 15]
