"""lightgbm_tpu_torch's data-, feature- and voting-parallel learners on the
in-process shard mesh, on the CPU (parallel/learners.py), against the
port's serial learner and the JAX package's same learner at the same
number of shards (the conftest's host devices).

Contracts (tests/test_parallel.py, tests/test_comm.py):
- at comm_precision=pair the data learner (reduce-scatter, allgather,
  comm_groups) and the feature learner (replicated bins, and the owner's
  column broadcast with the replication threshold forced to 0) grow the
  port's serial masked trees: same split features and thresholds, leaf
  values within rtol 1e-5 (atol 1e-7). Against the JAX package's same
  learner the trees are equal the same way (the two frameworks' float32
  histogram sums part in the last bit from the second tree on);
- bagging at 2 shards, the same bag handed to both packages (the JAX
  package's own 4-shard case with sampling fails,
  test_comm.py::test_reduce_scatter_bit_parity_with_sampling[4]);
- the voting learner follows the PV-Tree protocol: the JAX package's
  hand-computable vote (test_parallel.py:169) on both cores, and the
  JAX voting learner's trees on the masked core (same features and
  thresholds, leaf values within rtol 1e-5);
- the partitioned data learner with GBDT, GOSS and DART grows the serial
  partitioned learner's trees (test_parallel.py:120, :253; its psum adds
  float32 words in shard order: leaf values within rtol 2e-4, as there)
  and, with GBDT and DART, the JAX partitioned data learner's;
- comm_precision f32 and bf16 grow the JAX learner's trees;
- bundled data on the data (allgather exchange) and feature (per-shard
  slots) learners equals the serial bundled trees;
- every tree's collective bytes, counted by the mesh as it exchanges,
  equal the learner's CommPlan;
- the meshed learners train on the per-iteration path, the CLI trains
  tree_learner=data num_machines=2, a crashed data-parallel run resumes
  to the uninterrupted text, a shard that raises ends training with its
  error at once, and the multi-process settings are refused naming
  ROADMAP queue 1 item 6b.
"""

import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.application import Application
from lightgbm_tpu_torch.parallel import learners as tl

CPU = "cpu"
ROUNDS = 3
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
        "learning_rate": 0.1, "verbose": -1, "hist_compaction": "false"}


@pytest.fixture(autouse=True)
def _one_thread():
    # many small CPU ops: one thread each keeps the suite's parallel
    # workers from oversubscribing
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=2000, f=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] - x[:, 2] * x[:, 3]
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def serial(data):
    return _port(BASE, *data)


def _port(params, x, y, rounds=ROUNDS, bag=None):
    b = lgt.Booster(dict(params), lgt.Dataset(x, y), device=CPU)
    if bag is not None:
        mask = torch.from_numpy(bag)
        b.gbdt._bagging = lambda it, g=None, h=None: mask
    for _ in range(rounds):
        b.update()
    return b.gbdt


def _jax(params, x, y, rounds=ROUNDS, bag=None):
    b = lgj.Booster(dict(params), lgj.Dataset(x, y))
    if bag is not None:
        b.gbdt._bagging = lambda it, g=None, h=None: bag
    for _ in range(rounds):
        b.update()
    return b.gbdt


def _same_trees(ga, gb, rtol=1e-5, atol=1e-7):
    assert len(ga.models) == len(gb.models)
    for ta, tb in zip(ga.models, gb.models):
        assert ta.num_leaves == tb.num_leaves
        np.testing.assert_array_equal(ta.split_feature_real,
                                      tb.split_feature_real)
        np.testing.assert_array_equal(ta.threshold_in_bin,
                                      tb.threshold_in_bin)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value,
                                   rtol=rtol, atol=atol)


def _bytes_match_plan(gbdt):
    """The mesh's counted bytes of every tree built equal the learner's
    CommPlan accounted per tree (and something was exchanged)."""
    learner = gbdt.tree_learner
    counted = learner.mesh.collective_bytes
    planned = {k: learner.collective_bytes.get(f"collective_bytes_{k}", 0)
               for k in counted}
    assert counted == planned
    trees = len(gbdt.models)
    assert planned == {k: v * trees for k, v in learner._comm_plan.per_tree(
        learner.split_iterations).items()}
    assert sum(counted.values()) > 0


CASES = {
    "data2": dict(tree_learner="data", num_machines=2),
    "data4": dict(tree_learner="data", num_machines=4),
    "data4_groups1": dict(tree_learner="data", num_machines=4, comm_groups=1),
    "data2_allgather": dict(tree_learner="data", num_machines=2,
                            hist_exchange="allgather"),
    "feature2": dict(tree_learner="feature", num_machines=2),
    "feature4": dict(tree_learner="feature", num_machines=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_learner_matches_serial_and_jax(case, data, serial):
    params = dict(BASE, **CASES[case])
    got = _port(params, *data)
    learner = got.tree_learner
    assert learner.name == params["tree_learner"]
    assert learner.mesh.n_shards == params["num_machines"]
    if case.startswith("data"):
        assert learner.use_reduce_scatter is (case != "data2_allgather")
    _same_trees(serial, got)
    _same_trees(_jax(params, *data), got)
    _bytes_match_plan(got)


def test_feature_owner_broadcast_matches_serial(data, serial, monkeypatch):
    """Above REPLICATED_BINS_MAX_BYTES the split column is the owner's,
    broadcast with a psum (learners.py:690-715); the threshold forced to
    0 takes that path, in both packages."""
    from lightgbm_tpu.parallel import learners as jl
    for mod in (tl, jl):
        monkeypatch.setattr(mod.FeatureParallelTreeLearner,
                            "REPLICATED_BINS_MAX_BYTES", 0)
    params = dict(BASE, tree_learner="feature", num_machines=2)
    got = _port(params, *data)
    assert got.tree_learner._bins_replicated is None
    _same_trees(serial, got)
    want = _jax(params, *data)
    assert want.tree_learner._bins_replicated is None
    _same_trees(want, got)
    assert got.tree_learner.collective_bytes["collective_bytes_leaf_sync"] \
        > 3 * len(got.models) * 2 * 4
    _bytes_match_plan(got)


@pytest.mark.parametrize("w,precision", [(4, "f32"), (2, "bf16")])
def test_compressed_exchange_matches_jax(data, w, precision):
    """comm_precision f32 and bf16 exchange fewer bytes and give up the
    serial bits; the folds are the JAX package's bit for bit
    (test_torch_mesh.py), so the trees are the JAX learner's."""
    params = dict(BASE, tree_learner="data", num_machines=w,
                  comm_precision=precision)
    got = _port(params, *data)
    assert got.tree_learner.topology.comm_precision == precision
    _same_trees(_jax(params, *data), got)
    _bytes_match_plan(got)


def test_data_with_bagging_matches_serial_and_jax(data):
    x, y = data
    bag = (np.random.RandomState(7).rand(len(y)) < 0.7).astype(np.float32)
    params = dict(BASE, bagging_fraction=0.7, bagging_freq=1)
    ser = _port(params, x, y, bag=bag)
    par = dict(params, tree_learner="data", num_machines=2)
    got = _port(par, x, y, bag=bag)
    _same_trees(ser, got)
    _same_trees(_jax(par, x, y, bag=bag), got)


def _vote_data(n):
    """test_parallel.py:169's construction: f0 matches the label on the
    first half of the rows, f1 on the second, f2 on 98% of both."""
    half = n // 2
    i = np.arange(n)
    y = (i % 2).astype(np.float32)
    f0 = np.where(i < half, y, 0.0)
    f1 = np.where(i < half, 0.0, y)
    f2 = np.where(i % 50 == 0, 1.0 - y, y)
    return np.stack([f0, f1, f2], axis=1).astype(np.float32), y


@pytest.mark.parametrize("core", ["masked", "partitioned"])
def test_voting_protocol_hand_computable(core):
    """With top_k=1 each machine nominates its local best (f0 and f1, tied
    in weighted gain: the smaller id wins) and the root splits on f0 where
    the serial learner takes f2; with top_k=3 f2 is voted and wins, and
    the split is the serial one. The partitioned core pads each shard to
    HIST_CHUNK rows, so its machines hold 4096 rows each."""
    n = 1024 if core == "masked" else 8192
    x, y = _vote_data(n)
    params = dict(BASE, num_leaves=2, num_machines=2,
                  partitioned_build="true" if core == "partitioned"
                  else "false")
    ser = _port(dict(params, num_machines=1), x, y, rounds=1)
    assert int(ser.models[0].split_feature_real[0]) == 2
    v1 = _port(dict(params, tree_learner="voting", top_k=1), x, y, rounds=1)
    assert v1.tree_learner.use_partitioned is (core == "partitioned")
    assert int(v1.models[0].split_feature_real[0]) == 0
    v3 = _port(dict(params, tree_learner="voting", top_k=3), x, y, rounds=1)
    assert int(v3.models[0].split_feature_real[0]) == 2
    np.testing.assert_array_equal(ser.models[0].threshold_in_bin,
                                  v3.models[0].threshold_in_bin)
    np.testing.assert_allclose(ser.models[0].leaf_value,
                               v3.models[0].leaf_value, rtol=1e-5)


@pytest.mark.parametrize("w", [2, 4])
def test_voting_matches_jax(data, w):
    params = dict(BASE, tree_learner="voting", num_machines=w, top_k=3)
    got = _port(params, *data)
    _same_trees(_jax(params, *data), got)
    _bytes_match_plan(got)
    p = np.asarray(got.predict(data[0])).reshape(len(data[1]), -1)[:, 0]
    assert np.mean((p > 0.5) != data[1]) < 0.2


def _part_data():
    rng = np.random.RandomState(5)
    x = rng.rand(4000, 8).astype(np.float32)
    y = (2 * x[:, 0] - x[:, 1] + 0.1 * rng.randn(4000) > 0.5).astype(
        np.float32)
    return x, y


@pytest.mark.parametrize("boosting", ["gbdt", "goss", "dart"])
def test_partitioned_data_matches_serial_partitioned(boosting):
    x, y = _part_data()
    params = dict(BASE, boosting=boosting, partitioned_build="true",
                  min_data_in_leaf=20, drop_seed=7)
    if boosting == "goss":
        params["learning_rate"] = 0.5        # a one-iteration warm-up
    ser = _port(params, x, y, rounds=4)
    got = _port(dict(params, tree_learner="data", num_machines=4), x, y,
                rounds=4)
    assert ser.tree_learner.use_partitioned
    assert got.tree_learner.use_partitioned
    _same_trees(ser, got, rtol=2e-4, atol=1e-6)
    _bytes_match_plan(got)
    if boosting != "goss":
        # GOSS draws other uniforms in the two packages (ROADMAP queue 3)
        _same_trees(_jax(dict(params, tree_learner="data", num_machines=4),
                         x, y, rounds=4), got, rtol=2e-4, atol=1e-6)


def _bundled_data(n=2000, seed=4):
    """Four dense columns and eight mutually exclusive sparse ones of a
    few values each (the loader bundles them, several to a slot)."""
    rng = np.random.RandomState(seed)
    x = np.zeros((n, 12), np.float32)
    x[:, :4] = rng.randn(n, 4)
    for j in range(8):
        rows = np.arange(j, n, 8)
        x[rows, 4 + j] = rng.randint(1, 6, len(rows))
    y = (x[:, 0] - x[:, 1] + (x[:, 4] > 0) + (x[:, 9] > 2.5)
         + 0.3 * rng.randn(n) > 0.5).astype(np.float32)
    return x, y


@pytest.mark.parametrize("learner", ["data", "feature", "voting"])
def test_bundled_data_matches_serial(learner):
    """Bin 0 of a bundled feature is its slot's total minus the other
    bins (io/bundling.py): a row-sharded exchange moves the slot total by
    its last ulps, and the subtraction carries that into a small leaf's
    sums. Leaf values within atol 5e-6 there (the feature learner, whose
    shards hold every row, stays within the serial bound)."""
    x, y = _bundled_data()
    ser = _port(BASE, x, y)
    assert ser.tree_learner.bundle is not None
    params = dict(BASE, tree_learner=learner, num_machines=2,
                  top_k=ser.tree_learner.num_features)
    got = _port(params, x, y)
    assert got.tree_learner.bundle is not None
    if learner == "data":
        assert not got.tree_learner.use_reduce_scatter
    _same_trees(ser, got, atol=1e-7 if learner == "feature" else 5e-6)
    _bytes_match_plan(got)


def test_feature_parallel_compacts_like_serial():
    """Above one HIST_CHUNK the feature learner takes the gather-compacted
    engine under hist_compaction=auto, as the serial learner does; the
    row-sharded learners keep it opt-in."""
    x, y = _data(n=5000, seed=1)
    auto = dict(BASE, hist_compaction="auto")
    ser = _port(auto, x, y, rounds=2)
    fp = _port(dict(auto, tree_learner="feature", num_machines=2), x, y,
               rounds=2)
    dp = lgt.Booster(dict(auto, tree_learner="data", num_machines=2),
                     lgt.Dataset(x, y), device=CPU).gbdt
    assert ser.tree_learner.use_compact and fp.tree_learner.use_compact
    assert not dp.tree_learner.use_compact
    _same_trees(ser, fp)


def test_meshed_learners_train_per_iteration(data):
    b = lgt.train(dict(BASE, tree_learner="data", num_machines=2),
                  lgt.Dataset(*data), ROUNDS, device=CPU)
    assert b.gbdt.tree_learner.meshed
    assert not b.gbdt._fused_eligible()
    assert not b.gbdt._fused_cache
    assert b.current_iteration() == ROUNDS


def test_cli_trains_the_data_learner(tmp_path, data):
    x, y = data
    train = tmp_path / "train.csv"
    with open(train, "w") as f:
        for xi, yi in zip(x, y):
            f.write(",".join([str(int(yi))] + ["%.9g" % v for v in xi])
                    + "\n")
    model = tmp_path / "model.txt"
    Application(["task=train", f"data={train}", "objective=binary",
                 "num_leaves=15", "min_data_in_leaf=10", "num_trees=3",
                 "hist_compaction=false", "tree_learner=data",
                 "num_machines=2", f"output_model={model}", "verbose=-1"],
                device=CPU).run()
    # the CLI's max_bin default is 256 (the Dataset's 255)
    params = dict(BASE, tree_learner="data", num_machines=2, max_bin=256)
    want = lgt.train(params, lgt.Dataset(str(train), params=params), ROUNDS,
                     device=CPU)
    assert model.read_text() == want.model_to_string()
    assert want.gbdt.tree_learner.name == "data"


def test_data_learner_resumes_to_the_uninterrupted_text(data, tmp_path):
    """A run crashed in process and resumed from its snapshots writes the
    uninterrupted run's model text (bagging and feature_fraction on: the
    samplers' streams are in the snapshot)."""
    from lightgbm_tpu_torch import callback
    from lightgbm_tpu_torch.utils import faults
    params = dict(BASE, tree_learner="data", num_machines=2,
                  bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8)
    want = lgt.train(params, lgt.Dataset(*data), 6, device=CPU)
    ckpt = [callback.checkpoint(str(tmp_path), period=2)]
    faults.set_fault("crash_at_iteration", 4)
    try:
        with pytest.raises(faults.InjectedFault):
            lgt.train(params, lgt.Dataset(*data), 6, device=CPU,
                      callbacks=ckpt)
    finally:
        faults.clear_faults()
    got = lgt.train(params, lgt.Dataset(*data), 6, device=CPU,
                    callbacks=[callback.checkpoint(str(tmp_path), period=2)],
                    resume_from=str(tmp_path))
    assert got.model_to_string() == want.model_to_string()


def test_a_failing_shard_ends_training_with_its_error(data):
    b = lgt.Booster(dict(BASE, tree_learner="data", num_machines=4),
                    lgt.Dataset(*data), device=CPU)
    b.update()
    learner = b.gbdt.tree_learner
    inner = learner._shard_fn

    def failing(r, *args):
        if r == 3:
            raise RuntimeError("shard 3 lost its device")
        return inner(r, *args)

    learner._shard_fn = failing
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard 3 lost its device"):
        b.update()
    assert time.perf_counter() - t0 < 10.0


@pytest.mark.parametrize("extra", [
    {"machine_list_file": "mlist.txt"}, {"heartbeat_timeout_s": 5},
    {"collective_timeout_s": 5}, {"out_of_core": True}],
    ids=["machine_list", "heartbeat", "collective_timeout", "out_of_core"])
def test_multi_process_settings_are_refused(data, extra):
    params = dict(BASE, tree_learner="data", num_machines=2, **extra)
    with pytest.raises(NotImplementedError, match="item 6b"):
        lgt.train(params, lgt.Dataset(*data, params=params), 1, device=CPU)
    if "out_of_core" not in extra:
        argv = [f"{k}={v}" for k, v in extra.items()]
        with pytest.raises(NotImplementedError, match="item 6b"):
            Application(["task=train", "tree_learner=data",
                         "num_machines=2"] + argv, device=CPU)
