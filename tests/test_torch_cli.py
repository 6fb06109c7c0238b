"""lightgbm_tpu_torch's CLI (`Application`, `python -m lightgbm_tpu_torch`)
against lightgbm_tpu's on the same files and config file.

The JAX package trains once (train + predict, module fixture); the port
runs the same command lines with device="cpu". Its model holds the
port's contract with the JAX package's trees (structure and thresholds
equal, leaf values within 1e-6: the two frameworks' float32 histogram
sums differ in the last bit from the second tree on), and its text is
byte-equal to the port's own `train` on the same file. Predictions of
one model file are byte-equal across the two CLIs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightgbm_tpu.application import Application as JApplication
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.application import Application, main
from lightgbm_tpu_torch.models.gbdt import GBDT

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = """# binary classification, as examples/binary_classification
task = train
objective = binary
metric = auc
num_trees = 50
num_leaves = 7
learning_rate = 0.2
min_data_in_leaf = 20
partitioned_build = false
hist_compaction = false
device_row_chunk = 4096
"""
ROUNDS = 4


def _write_csv(path, n, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8) * scale
    x[rng.rand(n) < 0.03, 2] = np.nan
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.5 * rng.randn(n) > 0).astype(int)
    with open(path, "w") as f:
        for i in range(n):
            f.write(",".join([str(y[i])] + ["NA" if np.isnan(v) else
                                            "%.9g" % v for v in x[i]])
                    + "\n")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    paths = {k: str(d / v) for k, v in (
        ("train", "train.csv"), ("valid", "valid.csv"), ("conf", "train.conf"),
        ("jmodel", "jax_model.txt"), ("tmodel", "port_model.txt"),
        ("jpred", "jax_pred.txt"), ("tpred", "port_pred.txt"),
        ("tpred_j", "port_pred_of_jax_model.txt"))}
    _write_csv(paths["train"], 1500, 0)
    _write_csv(paths["valid"], 400, 1, scale=1.1)
    with open(paths["conf"], "w") as f:
        f.write(CONF)

    def train_argv(model):
        return [f"config={paths['conf']}", f"data={paths['train']}",
                f"valid_data={paths['valid']}", f"num_trees={ROUNDS}",
                f"output_model={model}", "verbose=-1"]

    def predict_argv(model, out):
        return ["task=predict", f"data={paths['valid']}",
                f"input_model={model}", f"output_result={out}", "verbose=-1"]

    japp = JApplication(train_argv(paths["jmodel"]))
    japp.run()
    JApplication(predict_argv(paths["jmodel"], paths["jpred"])).run()
    tapp = Application(train_argv(paths["tmodel"]), device=CPU)
    tapp.run()
    Application(predict_argv(paths["tmodel"], paths["tpred"]),
                device=CPU).run()
    Application(predict_argv(paths["jmodel"], paths["tpred_j"]),
                device=CPU).run()
    return paths, japp, tapp


def _load(path):
    g = GBDT(CPU)
    with open(path) as f:
        g.load_model_from_string(f.read())
    return g


def test_train_matches_jax_trees(run):
    paths, _, _ = run
    j, t = _load(paths["jmodel"]), _load(paths["tmodel"])
    assert len(t.models) == len(j.models) == ROUNDS
    for a, b in zip(j.models, t.models):
        assert a.num_leaves == b.num_leaves
        for key in ("split_feature_real", "threshold_in_bin", "left_child",
                    "right_child", "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                          err_msg=key)
        np.testing.assert_array_equal(b.threshold, a.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)


def test_train_text_equals_the_api_on_the_same_file(run):
    paths, _, _ = run
    params = {k.strip(): v.strip() for k, v in
              (line.split("=") for line in CONF.splitlines()
               if "=" in line and not line.startswith("#"))}
    params.update(num_trees=ROUNDS, verbose=-1, max_bin=256)
    train = lgt.Dataset(paths["train"], params=params)
    booster = lgt.train(params, train, ROUNDS, device=CPU,
                        valid_sets=[train.create_valid(paths["valid"])])
    with open(paths["tmodel"]) as f:
        assert booster.model_to_string() == f.read()


def test_predict_files_match_jax(run):
    paths, _, _ = run
    with open(paths["jpred"]) as a, open(paths["tpred_j"]) as b:
        assert a.read() == b.read()          # one model, byte for byte
    jv = np.loadtxt(paths["jpred"])
    tv = np.loadtxt(paths["tpred"])
    assert tv.shape == jv.shape == (400,)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)


@pytest.mark.parametrize("extra", [
    ["is_predict_raw_score=true"], ["is_predict_leaf_index=true"],
    ["num_iteration_predict=2"], ["libsvm"], ["predict_chunk_rows=37"]],
    ids=["raw", "leaf", "two_iterations", "libsvm", "small_chunks"])
def test_predict_modes_match_jax(run, tmp_path, extra):
    """The JAX package's model file through both CLIs' predict task:
    byte-equal result files, whatever the mode, chunking or format (a
    LibSVM file's trailing absent features padded to the model's)."""
    paths, _, _ = run
    data = paths["valid"]
    if extra == ["libsvm"]:
        data = str(tmp_path / "valid.svm")
        with open(paths["valid"]) as src, open(data, "w") as dst:
            for line in src:
                toks = line.strip().split(",")
                dst.write(" ".join([toks[0]] + [
                    f"{j}:{t}" for j, t in enumerate(toks[1:-1])
                    if t not in ("NA", "0")]) + "\n")
        extra = []
    outs = []
    for name, make in (("jax", JApplication),
                       ("port", lambda a: Application(a, device=CPU))):
        out = str(tmp_path / f"{name}.txt")
        make(["task=predict", f"data={data}", f"input_model={paths['jmodel']}",
              f"output_result={out}", "verbose=-1"] + extra).run()
        with open(out) as f:
            outs.append(f.read())
    assert outs[1] == outs[0] and outs[0]


def test_valid_metrics_match_jax(run):
    _, japp, tapp = run
    np.testing.assert_allclose(tapp.boosting.get_eval_at(1),
                               japp.boosting.get_eval_at(1), rtol=0,
                               atol=1e-6)


def test_command_line_overrides_config_file(run):
    paths, japp, tapp = run
    for app in (japp, tapp):
        assert app.config.num_iterations == ROUNDS       # 50 in the file
        assert app.config.learning_rate == 0.2           # from the file
        assert app.config.num_leaves == 7
    argv = [f"config={paths['conf']}", "num_leaves=5", "learning_rate=0.3"]
    assert Application(argv, device=CPU).config.num_leaves == 5
    assert JApplication(argv).config.learning_rate == \
        Application(argv, device=CPU).config.learning_rate == 0.3


@pytest.mark.parametrize("argv,item", [
    (["heartbeat_timeout_s=5"], "item 6"),
    (["num_machines=2", "tree_learner=data", "machine_list_file=ml.txt"],
     "item 6b"),
    (["telemetry=true"], "item 7"),
], ids=["heartbeat", "machines", "telemetry"])
def test_later_slice_settings_name_their_item(argv, item):
    with pytest.raises(NotImplementedError) as err:
        Application(["task=train"] + argv, device=CPU)
    assert "ROADMAP" in str(err.value) and item in str(err.value)


def test_main_reports_and_exits_1(tmp_path):
    with pytest.raises(SystemExit) as e:
        main(["task=nonsense", "verbose=-1"])
    assert e.value.code == 1


def test_continued_training_from_a_model_file(run, tmp_path):
    paths, _, _ = run
    out = str(tmp_path / "more.txt")
    Application([f"config={paths['conf']}", f"data={paths['train']}",
                 f"input_model={paths['tmodel']}", "num_trees=2",
                 f"output_model={out}", "verbose=-1"], device=CPU).run()
    first, more = _load(paths["tmodel"]), _load(out)
    assert len(more.models) == ROUNDS + 2
    for a, b in zip(first.models, more.models):
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def test_module_entry_point_runs_on_the_card(tmp_path, run):
    """`python -m lightgbm_tpu_torch` has no device switch: on a machine
    without a card it reports the missing card and exits 1; with one it
    trains."""
    paths, _, _ = run
    model = str(tmp_path / "m.txt")
    proc = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", f"config={paths['conf']}",
         f"data={paths['train']}", "num_trees=1", f"output_model={model}"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert os.path.exists(model)
    else:
        assert proc.returncode == 1
        assert "CUDA" in proc.stdout + proc.stderr
