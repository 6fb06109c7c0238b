"""lightgbm_tpu_torch out-of-core crash and resume, byte for byte
(tests/test_out_of_core.py:416, :433; tests/test_fault_tolerance.py:511).

- a soft crash (faults.InjectedFault) of an out-of-core run with
  bagging and feature_fraction on, resumed from its snapshots, equals
  the uninterrupted out-of-core run and the in-RAM masked run;
- the CLI killed hard (os._exit(43)) mid-run with out_of_core and
  snapshot_freq set: its plain rerun reuses the on-disk block store (no
  rebuild), resumes from the snapshot and writes the uninterrupted
  run's model file byte for byte. The two CLI runs are subprocesses on
  the CPU (Application(argv, device="cpu"), as tests/test_torch_cli.py
  runs the CLI).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import callback
from lightgbm_tpu_torch.application import Application
from lightgbm_tpu_torch.data.block_store import MANIFEST_NAME
from lightgbm_tpu_torch.utils import faults

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
        "learning_rate": 0.1, "verbose": -1, "hist_compaction": "false",
        "device_row_chunk": 4096, "bagging_fraction": 0.7,
        "bagging_freq": 2, "feature_fraction": 0.7}
OOC = dict(BASE, out_of_core=True, block_rows=4096)
# the CLI on the CPU in a fresh process: argv are the command line's
CLI_ON_CPU = ("import sys, torch; torch.set_num_threads(1); "
              "from lightgbm_tpu_torch.application import Application; "
              "Application(sys.argv[1:], device='cpu').run()")


@pytest.fixture(autouse=True)
def _one_thread_no_faults():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear_faults()
    yield
    faults.clear_faults()
    torch.set_num_threads(threads)


def _data(n=9000, f=6, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    y = (x[:, 0] + 0.6 * x[:, 1] * x[:, 2] + 0.8 * rng.randn(n) > 0)
    return x, y.astype(np.float64)


def _train(params, ckpt_dir=None, crash_at=None, resume=False, rounds=10):
    x, y = _data()
    cbs = [callback.checkpoint(ckpt_dir, period=4)] if ckpt_dir else []
    if crash_at is not None:
        faults.set_fault("crash_at_iteration", crash_at)
    try:
        booster = lgt.train(dict(params),
                            lgt.Dataset(x, y, params=dict(params)), rounds,
                            callbacks=cbs, verbose_eval=False, device=CPU,
                            resume_from=ckpt_dir if resume else None)
    except faults.InjectedFault:
        return None
    finally:
        faults.clear_faults()
    return booster.gbdt.save_model_to_string(-1)


def test_soft_crash_resume_equals_uninterrupted_and_in_ram(tmp_path):
    ref_in_ram = _train(BASE)
    ref = _train(OOC)
    assert ref == ref_in_ram
    d = str(tmp_path / "ck")
    assert _train(OOC, ckpt_dir=d, crash_at=9) is None
    assert _train(OOC, ckpt_dir=d, resume=True) == ref


def test_cli_hard_crash_rerun_reuses_store_and_resumes(tmp_path):
    x, y = _data()
    data = str(tmp_path / "train.csv")
    np.savetxt(data, np.column_stack([y, x]), delimiter=",", fmt="%.6f")
    base = [f"data={data}", "task=train", "objective=binary",
            "num_trees=10", "num_leaves=7", "min_data_in_leaf=10",
            "verbose=-1", "metric_freq=0", "hist_compaction=false",
            "device_row_chunk=4096", "bagging_fraction=0.7",
            "bagging_freq=2"]
    ref_model = str(tmp_path / "ref.txt")
    Application(base + [f"output_model={ref_model}"], device=CPU).run()

    model = str(tmp_path / "ooc.txt")
    argv = base + [f"output_model={model}", "out_of_core=true",
                   "block_rows=4096", "snapshot_freq=3"]

    def cli(env_faults=""):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env[faults.ENV_VAR] = env_faults
        return subprocess.run([sys.executable, "-c", CLI_ON_CPU] + argv,
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)

    r = cli("crash_at_iteration=7,hard_crash=1")
    assert r.returncode == faults.HARD_CRASH_EXIT_CODE, r.stdout + r.stderr
    assert not os.path.exists(model)
    manifest = os.path.join(data + ".blocks", MANIFEST_NAME)
    stamp = os.path.getmtime(manifest)
    r = cli()
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.getmtime(manifest) == stamp   # the store was reused
    assert open(model).read() == open(ref_model).read()
