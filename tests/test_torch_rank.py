"""lightgbm_tpu_torch LambdaRank against lightgbm_tpu, on the CPU.

- The port's padded-query pair gradients (objectives/rank_device.py)
  against the JAX package's make_lambdarank_gradfn on the same (score,
  label, query) inputs, to 1e-5 of the largest |value| (both float32;
  the frameworks' exp and the pair sums' order differ in the last
  bits), with ties in the scores, a one-document query, a query whose
  labels are all equal, and weights.
- The port's device path against its own float64 host path, to 2e-4 of
  the largest |value|, the bound tests/test_rank_device.py holds the
  JAX package to; two calls are bitwise equal, and the gradients come
  back by a gather, not a float scatter-add.
- NDCG@k against the JAX package's ndcg_eval_padded to 1e-12.
- Training: trees equal the JAX package's (structure exact, leaves and
  predictions within 1e-6), the fused model text equals the
  per-iteration one, and query-unit bagging with one shared mask grows
  the same trees; the port's own bags keep whole queries.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objectives.rank_device import (
    PaddedQueryLayout as JLayout, make_lambdarank_gradfn as jgradfn,
    ndcg_eval_padded as jndcg)
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.metrics import create_metric as tmetric
from lightgbm_tpu_torch.objectives import rank_device
from lightgbm_tpu_torch.objectives import create_objective as tobj
from test_torch_multiclass import _assert_same_model, _loop

CPU = "cpu"
BASE = {"objective": "lambdarank", "verbose": -1, "metric_freq": 0,
        "num_leaves": 7, "min_data_in_leaf": 10,
        "partitioned_build": "false", "hist_compaction": "false",
        "device_row_chunk": 4096}
LABEL_GAIN = JConfig.from_params({"objective": "lambdarank"}).label_gain


def _queries(seed=0, nq=60):
    """Query lengths 1-40 (a one-document query first, a query of equal
    labels third), features whose first column drives relevance 0-4."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(2, 41, nq)
    counts[0] = 1
    n = int(counts.sum())
    x = rng.rand(n, 6).astype(np.float32)
    rel = x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.randn(n)
    label = np.clip(np.floor(rel * 3), 0, 4).astype(np.float32)
    qb = np.concatenate([[0], np.cumsum(counts)])
    label[qb[2]:qb[3]] = 2.0
    return x, label, counts, qb


def _scores(n, seed, ties=True):
    rng = np.random.RandomState(seed)
    s = rng.randn(n).astype(np.float32)
    if ties:
        s[::3] = np.round(s[::3])          # many equal scores
    return s


class _Meta:
    def __init__(self, label, qb, weights=None):
        self.label = label
        self.weights = weights
        self.query_boundaries = qb
        self.query_weights = None


def _port_obj(meta, n, params=None):
    cfg = TConfig.from_params(dict({"objective": "lambdarank"},
                                   **(params or {})))
    obj = tobj("lambdarank", cfg)
    obj.init(meta, n, torch.device(CPU))
    return obj


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_pair_gradients_match_jax(weighted, ties):
    _, label, _, qb = _queries()
    n = len(label)
    w = (np.random.RandomState(1).rand(n).astype(np.float32) + 0.5
         if weighted else None)
    score = _scores(n, 2, ties)[None, :]
    jg, jh = jgradfn(JLayout(qb, n), label, LABEL_GAIN, 1.0, 20, w)(
        jnp.asarray(score))
    obj = _port_obj(_Meta(label, qb, w), n)
    tg, th = obj.get_gradients(torch.from_numpy(score))
    for got, want in ((tg.numpy(), np.asarray(jg)),
                      (th.numpy(), np.asarray(jh))):
        assert got.shape == want.shape == (1, n)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale
    # a one-document query and an all-equal-label query get no gradient
    assert tg[0, 0] == 0 and th[0, 0] == 0
    assert not tg[0, qb[2]:qb[3]].any()


@pytest.mark.parametrize("score_kind", ["random", "zeros"])
def test_device_path_matches_host_float64(score_kind):
    _, label, _, qb = _queries(seed=3)
    n = len(label)
    obj = _port_obj(_Meta(label, qb), n)
    score = (np.zeros((1, n), np.float32) if score_kind == "zeros"
             else _scores(n, 4)[None, :])
    g, h = obj.get_gradients(torch.from_numpy(score))
    gh, hh = obj.get_gradients_host(score)
    for dev, host in ((g.numpy(), gh), (h.numpy(), hh)):
        scale = max(np.abs(host).max(), 1e-6)
        assert np.abs(dev - host).max() / scale < 2e-4


def test_gradients_are_deterministic():
    """Two calls give the same bits; the rows come back by a gather
    through the row -> slot map, with no float index_add_, and a
    -0.0 comes back as +0.0, as the JAX package's add into zeros."""
    _, label, _, qb = _queries(seed=5)
    n = len(label)
    obj = _port_obj(_Meta(label, qb), n)
    score = torch.from_numpy(_scores(n, 6)[None, :])
    a, b = obj.get_gradients(score), obj.get_gradients(score)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.signbit(a[0][a[0] == 0]).any()
    src = inspect.getsource(rank_device.make_lambdarank_gradfn)
    assert "index_add" not in src and "scatter_add" not in src
    # several blocks of queries: the pair budget cut to 3 queries a block
    layout = rank_device.PaddedQueryLayout(qb, n)
    small = rank_device._PAIR_BUDGET
    try:
        rank_device._PAIR_BUDGET = 3 * layout.max_docs ** 2
        blocked = _port_obj(_Meta(label, qb), n)
    finally:
        rank_device._PAIR_BUDGET = small
    assert blocked.layout.num_blocks > 1
    g2, h2 = blocked.get_gradients(score)
    np.testing.assert_allclose(g2.numpy(), a[0].numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
def test_ndcg_matches_jax(weighted):
    _, label, counts, qb = _queries(seed=7)
    n = len(label)
    w = (np.random.RandomState(8).rand(n).astype(np.float32) + 0.5
         if weighted else None)
    md = Metadata(n)
    md.set_label(label)
    md.set_weights(w)
    md.set_query(counts)
    cfg = TConfig.from_params({"objective": "lambdarank",
                               "ndcg_eval_at": "1,3,5,10"})
    m = tmetric("ndcg", cfg)
    m.init(md, n)
    score = _scores(n, 9).astype(np.float64)
    got = m.eval(score)
    want = jndcg(JLayout(qb, n), label, LABEL_GAIN, (1, 3, 5, 10), score,
                 md.query_weights)
    assert m.names == ("ndcg@1", "ndcg@3", "ndcg@5", "ndcg@10")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _datasets(pkg, x, label, counts, **kw):
    return pkg.Dataset(x, label, group=counts, **kw)


def test_lambdarank_train_matches_jax():
    """5 rounds: per-iteration trees equal the JAX package's; the
    port's fused block equals its per-iteration loop byte for byte;
    ndcg@3 rises."""
    x, label, counts, _ = _queries(seed=10, nq=80)
    jb = _loop(lgj.Booster(BASE, _datasets(lgj, x, label, counts)), 5)
    tb = _loop(lgt.Booster(BASE, _datasets(lgt, x, label, counts),
                           device=CPU), 5)
    tf = lgt.Booster(BASE, _datasets(lgt, x, label, counts), device=CPU)
    assert tf.gbdt._fused_eligible()
    tf.gbdt.train_many(5)
    assert len(tb.gbdt.models) == 5
    assert tf.model_to_string() == tb.model_to_string()
    _assert_same_model(jb, tb, x)
    ev = {}
    ds = _datasets(lgt, x, label, counts)
    lgt.train(dict(BASE, metric="ndcg", ndcg_eval_at="3", metric_freq=1),
              ds, 5, valid_sets=[ds], evals_result=ev, verbose_eval=False,
              device=CPU)
    hist = ev["training"]["ndcg@3"]
    assert len(hist) == 5 and hist[-1] > hist[0]


def _query_mask(counts, it, frac=0.7):
    """One whole-query mask per re-bag window, spread to rows."""
    rng = np.random.RandomState(100 + it // 2)
    q = rng.permutation(len(counts)) < int(frac * len(counts))
    return np.repeat(q, counts).astype(np.float32)


def test_query_bagging_with_one_shared_mask_matches_jax():
    x, label, counts, _ = _queries(seed=11, nq=80)
    params = dict(BASE, bagging_fraction=0.7, bagging_freq=2)
    jb = lgj.Booster(params, _datasets(lgj, x, label, counts))
    tb = lgt.Booster(params, _datasets(lgt, x, label, counts), device=CPU)
    jb.gbdt._bagging = lambda it, g=None, h=None: _query_mask(counts, it)
    tb.gbdt._bagging = lambda it, g=None, h=None: torch.from_numpy(
        _query_mask(counts, it))
    _loop(jb, 4)
    _loop(tb, 4)
    _assert_same_model(jb, tb, x)


def test_port_query_bags_keep_queries_whole():
    x, label, counts, qb = _queries(seed=12, nq=80)
    params = dict(BASE, bagging_fraction=0.7, bagging_freq=2,
                  bagging_seed=3)
    tb = lgt.Booster(params, _datasets(lgt, x, label, counts), device=CPU)
    masks = [tb.gbdt._bagging(it).clone() for it in range(4)]
    for m in masks:
        per_query = np.add.reduceat(m.numpy(), qb[:-1])
        assert set(np.unique(per_query / counts)) <= {0.0, 1.0}
        assert int((per_query > 0).sum()) == int(0.7 * len(counts))
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    # the fused trainer copies the same bags into its graph's buffer
    loop = _loop(lgt.Booster(params, _datasets(lgt, x, label, counts),
                             device=CPU), 4)
    tf = lgt.Booster(params, _datasets(lgt, x, label, counts), device=CPU)
    tf.gbdt.train_many(4)
    assert tf.model_to_string() == loop.model_to_string()
