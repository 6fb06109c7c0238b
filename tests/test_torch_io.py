"""lightgbm_tpu_torch host layer against lightgbm_tpu: binning, model
text, the numpy converters and the slice guards.

Both packages bin the same numpy matrix and must agree on every bin
and bound; a model written by either reads back into the other and
writes the same bytes.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import DatasetLoader as JLoader
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import DatasetLoader as TLoader
from lightgbm_tpu_torch.models.gbdt import GBDT as TGBDT
from lightgbm_tpu_torch.utils.random import Random as TRandom
from lightgbm_tpu.utils.random import Random as JRandom

CPU = "cpu"


def _matrix(seed, n=2000, f=5):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    x[:, 1] = np.round(x[:, 1] * 7)             # few distinct values
    x[rng.rand(n) < 0.1, 2] = 0.0               # zeros mixed in
    x[:, 3] = rng.randn(n)                      # negatives and positives
    return x, (x[:, 0] > 0.5).astype(np.float32)


def _assert_same_dataset(j, t):
    assert t.bins.dtype == j.bins.dtype
    np.testing.assert_array_equal(t.bins, j.bins)
    np.testing.assert_array_equal(t.real_feature_idx, j.real_feature_idx)
    np.testing.assert_array_equal(t.used_feature_map, j.used_feature_map)
    assert len(t.bin_mappers) == len(j.bin_mappers)
    for mj, mt in zip(j.bin_mappers, t.bin_mappers):
        for k, v in mj.to_dict().items():
            np.testing.assert_array_equal(mt.to_dict()[k], v, err_msg=k)
    np.testing.assert_array_equal(t.num_bin_array(), j.num_bin_array())


@pytest.mark.parametrize("max_bin", [255, 16, 400],
                         ids=["uint8-255", "uint8-16", "int16-400"])
def test_bins_and_mappers_equal_jax(max_bin):
    x, y = _matrix(0)
    params = {"max_bin": max_bin, "verbose": -1}
    j = JLoader(JConfig.from_params(params)).construct_from_matrix(x, y)
    t = TLoader(TConfig.from_params(params)).construct_from_matrix(x, y)
    _assert_same_dataset(j, t)
    assert t.bins.dtype == (np.int16 if max_bin > 256 else np.uint8)
    np.testing.assert_array_equal(t.bin_value_table(), j.bin_value_table())


def test_sampled_binning_equals_jax():
    """bin_construct_sample_cnt below N: both draw the same sample."""
    x, y = _matrix(1, n=3000)
    params = {"bin_construct_sample_cnt": 500, "verbose": -1}
    j = JLoader(JConfig.from_params(params)).construct_from_matrix(x, y)
    t = TLoader(TConfig.from_params(params)).construct_from_matrix(x, y)
    _assert_same_dataset(j, t)


def test_valid_set_binned_with_train_mappers():
    x, y = _matrix(2)
    xv, yv = _matrix(3, n=500)
    cfg = {"verbose": -1}
    jl, tl = JLoader(JConfig.from_params(cfg)), TLoader(
        TConfig.from_params(cfg))
    jt, tt = jl.construct_from_matrix(x, y), tl.construct_from_matrix(x, y)
    jv = jl.construct_from_matrix(xv, yv, reference=jt)
    tv = tl.construct_from_matrix(xv, yv, reference=tt)
    np.testing.assert_array_equal(tv.bins, jv.bins)
    assert tt.check_align(tv)


def test_random_draws_equal_jax():
    """feature_fraction sampling must draw what the JAX learner draws."""
    a, b = JRandom(2), TRandom(2)
    for n, k in [(28, 22), (6, 4), (100, 1)]:
        np.testing.assert_array_equal(a.sample_mask(n, k),
                                      b.sample_mask(n, k))


def _trained(seed=4, rounds=3):
    x, y = _matrix(seed)
    params = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 20,
              "verbose": -1}
    return lgt.train(params, lgt.Dataset(x, y), rounds, verbose_eval=False,
                     device=CPU), x


def test_model_text_round_trips_byte_for_byte():
    booster, _ = _trained()
    text = booster.model_to_string()
    again = TGBDT(device=CPU)
    again.load_model_from_string(text)
    assert again.save_model_to_string() == text


def test_model_text_crosses_packages_byte_for_byte():
    """The port's text loads in the JAX package and writes back the same
    bytes; the JAX package's text loads in the port the same way."""
    booster, x = _trained(seed=5)
    text = booster.model_to_string()
    j = JGBDT()
    j.load_model_from_string(text)
    assert j.save_model_to_string() == text
    jb = lgj.train({"objective": "regression", "num_leaves": 5,
                    "min_data_in_leaf": 50, "verbose": -1},
                   lgj.Dataset(x, x[:, 0] * 2.0), 2, verbose_eval=False)
    jtext = jb.gbdt.save_model_to_string()
    t = TGBDT(device=CPU)
    t.load_model_from_string(jtext)
    assert t.save_model_to_string() == jtext


def test_model_text_v2_reads():
    """A format-version-2 model (linear leaves) is read and written back
    byte for byte, as the JAX package writes it."""
    booster, _ = _trained()
    text = booster.model_to_string()
    v2 = text.replace("gbdt\n", "gbdt\nformat_version=2\n", 1)
    block_end = v2.index("internal_count=", v2.index("Tree=0"))
    block_end = v2.index("\n", block_end)
    tree0 = booster.gbdt.models[0]
    nl = tree0.num_leaves
    linear = ("\nis_linear=1\nleaf_const=" + " ".join(["0.5"] * nl)
              + "\nnum_leaf_coeff=1" + " 0" * (nl - 1)
              + "\nleaf_coeff_feature=0\nleaf_coeff=0.25")
    v2 = v2[:block_end] + linear + v2[block_end:]
    t = TGBDT(device=CPU)
    t.load_model_from_string(v2)
    assert t.models[0].is_linear and t.models[0].leaf_coeff_count[0] == 1
    assert t.save_model_to_string() == v2
    j = JGBDT()
    j.load_model_from_string(v2)
    assert j.save_model_to_string() == v2


def test_convert_dataset_from_jax_arrays():
    x, y = _matrix(6)
    j = JLoader(JConfig.from_params({"verbose": -1})).construct_from_matrix(
        x, y)
    t = convert.dataset_from_numpy(
        np.asarray(j.bins), [m.to_dict() for m in j.bin_mappers],
        np.asarray(j.metadata.label), real_feature_idx=j.real_feature_idx,
        num_total_features=j.num_total_features)
    _assert_same_dataset(j, t)
    np.testing.assert_array_equal(t.metadata.label, j.metadata.label)


def test_convert_trees_from_jax_arrays():
    """A JAX model's trees, carried as numpy dicts, score and serialize
    identically in the port."""
    x, y = _matrix(7)
    jb = lgj.train({"objective": "binary", "num_leaves": 7,
                    "min_data_in_leaf": 20, "verbose": -1},
                   lgj.Dataset(x, y), 3, verbose_eval=False)
    jtrees = [t.materialize() if hasattr(t, "materialize") else t
              for t in jb.gbdt.models]
    dicts = [{"num_leaves": t.num_leaves,
              **{k: getattr(t, k) for k in convert.TREE_FIELDS}}
             for t in jtrees]
    trees = convert.trees_from_numpy(dicts)
    for jt, tt in zip(jtrees, trees):
        assert tt.to_string() == jt.to_string()
        np.testing.assert_array_equal(tt.predict(x), jt.predict(x))


def test_convert_trees_from_builder_output():
    """One tree of the port's own builder output (numpy) converts to the
    Tree the learner itself makes."""
    booster, _ = _trained(seed=8, rounds=1)
    learner = booster.gbdt.tree_learner
    n = learner.num_data
    g = torch.randn(n, generator=torch.Generator().manual_seed(0))
    out = learner.train_device(g, torch.ones(n))
    host, _ = learner.fetch(out)
    want = learner.host_out_to_tree(host, shrink=0.1)
    got = convert.trees_from_numpy([host], dataset=learner.train_set,
                                   shrink=0.1)[0]
    assert got.to_string() == want.to_string()


@pytest.mark.parametrize("params", [
    {"boosting_type": "dart"},
    {"boosting_type": "goss"}, {"linear_tree": True},
    {"out_of_core": True}, {"tree_learner": "voting", "num_machines": 2},
    {"tree_learner": "data", "num_machines": 2},
    {"tree_learner": "feature", "num_machines": 2}])
def test_later_slice_settings_raise(params):
    """The settings of a later slice raise; DART, GOSS, linear leaves and
    out_of_core are this port's now and train one round."""
    x, y = _matrix(9, n=300)
    if "out_of_core" in params:
        p = dict(params, verbose=-1)
        b = lgt.train(p, lgt.Dataset(x, y, params=p), 1,
                      verbose_eval=False, device=CPU)
        assert b.current_iteration() == 1
        assert b.gbdt.tree_learner.name == "out_of_core"
        return
    if set(params) <= {"boosting_type", "linear_tree"}:
        b = lgt.train(dict(params, verbose=-1), lgt.Dataset(x, y), 1,
                      verbose_eval=False, device=CPU)
        assert b.current_iteration() == 1
        assert type(b.gbdt).__name__ == {"dart": "DART", "goss": "GOSS"}.get(
            params.get("boosting_type"), "GBDT")
        assert b.gbdt.models[0].is_linear is bool(params.get("linear_tree"))
        return
    with pytest.raises(NotImplementedError):
        lgt.train(dict(params, verbose=-1), lgt.Dataset(x, y), 1,
                  verbose_eval=False, device=CPU)


def test_bundling_candidates_raise():
    """Data the JAX loader bundles (eight mutually exclusive sparse
    columns) no longer raises: the port makes the JAX package's plan and
    stored bins."""
    rng = np.random.RandomState(10)
    x = np.zeros((1000, 8), np.float32)
    for j in range(8):
        x[j::8, j] = rng.rand(125) + 1.0
    j = JLoader(JConfig.from_params({"verbose": -1})).construct_from_matrix(
        x, np.zeros(1000))
    t = TLoader(TConfig.from_params({"verbose": -1})).construct_from_matrix(
        x, np.zeros(1000))
    assert j.bundle_plan is not None and t.bundle_plan is not None
    for k, v in j.bundle_plan.to_dict().items():
        np.testing.assert_array_equal(t.bundle_plan.to_dict()[k], v)
    assert t.bins.dtype == j.bins.dtype
    np.testing.assert_array_equal(t.bins, j.bins)
    ds = TLoader(TConfig.from_params(
        {"verbose": -1, "is_enable_sparse": False})).construct_from_matrix(
            x, np.zeros(1000))
    assert ds.bins.shape == (8, 1000)
