"""lightgbm_tpu_torch's LambdaRank pair gradients on the card.

The kernel (csrc/rank.cu, ops/rank_kernels.lambdarank_pairs) against
its plain version on the card, bit for bit (NaN compared by position):
scores with ties, +-0.0, -inf and NaN, one-row queries, weights, rows
in no query, queries beyond the shared-memory cut (staged in device
memory); one launch a call.

The fused trainer captures the objective's gradients in its CUDA graph
of one boosting iteration, so the kernel's launch must capture: no host
sync, no data-dependent shape. These tests capture it alone and in the
fused trainer (through hist_kernels.CapturedGraph, which counts the
kernel's launches on every replay) and hold the replays to the eager
call bit for bit; the eager call to the host float64 path within 2e-4
of the largest |value| (tests/test_rank_device.py's bound for the JAX
package).

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_rank_card.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.metrics.dcg_calculator import DCGCalculator
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops import rank_kernels as rk

DEV = "cuda"

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _queries(seed=0, nq=300):
    rng = np.random.RandomState(seed)
    counts = rng.randint(1, 120, nq)
    n = int(counts.sum())
    x = rng.rand(n, 6).astype(np.float32)
    rel = x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.randn(n)
    label = np.clip(np.floor(rel * 3), 0, 4).astype(np.float32)
    return x, label, counts


def _objective(label, counts, weights=None):
    meta = Metadata(len(label))
    meta.set_label(label)
    meta.set_weights(weights)
    meta.set_query(counts)
    obj = create_objective("lambdarank",
                           Config.from_params({"objective": "lambdarank"}))
    obj.init(meta, len(label), torch.device(DEV))
    return obj


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
def test_graph_replay_equals_eager_call(weighted):
    _, label, counts = _queries()
    n = len(label)
    w = (np.random.RandomState(1).rand(n).astype(np.float32) + 0.5
         if weighted else None)
    obj = _objective(label, counts, w)
    score = torch.randn(1, n, device=DEV, generator=torch.Generator(
        DEV).manual_seed(2))
    score[0, ::4] = 0.0                       # ties
    eager = obj.get_gradients(score)
    again = obj.get_gradients(score)
    assert all(torch.equal(a, b) for a, b in zip(eager, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        obj.get_gradients(score)                 # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    # captured by CapturedGraph: the kernel's launches count on replay
    graph = hk.CapturedGraph()
    with graph.capture():
        out = obj.get_gradients(score)
    assert graph.launches == {"lambdarank_pairs": 1}
    before = rk.KERNELS["lambdarank_pairs"].launches
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert rk.KERNELS["lambdarank_pairs"].launches == before + 2
    # a new score in the captured tensor: the replay follows it
    score.copy_(torch.randn(1, n, device=DEV))
    graph.replay()
    want = obj.get_gradients(score)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    gh, hh = obj.get_gradients_host(score.cpu().numpy())
    for dev, host in ((want[0], gh), (want[1], hh)):
        scale = max(np.abs(host).max(), 1e-6)
        assert np.abs(dev.cpu().numpy() - host).max() / scale < 2e-4


def test_fused_lambdarank_equals_per_iteration_loop():
    x, label, counts = _queries(seed=3)
    params = {"objective": "lambdarank", "num_leaves": 15,
              "min_data_in_leaf": 20, "verbose": -1,
              "bagging_fraction": 0.7, "bagging_freq": 2}
    loop = lgt.train(params, lgt.Dataset(x, label, group=counts), 4,
                     verbose_eval=False, callbacks=[lambda env: None])
    fused = lgt.train(params, lgt.Dataset(x, label, group=counts), 4,
                      verbose_eval=False)
    runner = next(iter(fused.gbdt._fused_cache.values()))
    assert runner.graph is not None
    assert fused.model_to_string() == loop.model_to_string()


def _kernel_inputs(counts, seed, weighted=False, outside=(0, 0)):
    """The wrapper's inputs on the card for queries of `counts` rows,
    labels 0-4 (the second query's all equal), with `outside` rows
    before and after every query; and edge scores (ties, +-0.0, -inf,
    NaN)."""
    rng = np.random.RandomState(seed)
    counts = np.asarray(counts)
    n = int(counts.sum()) + sum(outside)
    label = rng.randint(0, 5, n)
    qb = outside[0] + np.concatenate([[0], np.cumsum(counts)])
    if len(counts) > 1:
        label[qb[1]:qb[2]] = 3
    dcg = DCGCalculator(Config.from_params(
        {"objective": "lambdarank"}).label_gain)
    inv = np.zeros(len(counts))
    for q in range(len(counts)):
        m = dcg.cal_maxdcg_at_k(20, label[qb[q]:qb[q + 1]])
        inv[q] = 1.0 / m if m > 0 else 0.0
    s = rng.randn(n).astype(np.float32)
    s[::3] = np.round(s[::3])
    s[rng.rand(n) < 0.1] = 0.0
    s[rng.rand(n) < 0.1] = -0.0
    s[rng.rand(n) < 0.05] = -np.inf
    s[rng.rand(n) < 0.01] = np.nan

    def dev(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(DEV, dt)

    args = dict(qb=dev(qb, torch.int32), gain=dev(dcg.label_gain[label]),
                inv=dev(inv), disc=dev(dcg.discount), sigmoid=1.0,
                max_docs=int(counts.max()),
                weight=dev(rng.rand(n) + 0.5) if weighted else None)
    return dev(s)[None, :], args


def _bits_equal(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32)))


@pytest.mark.parametrize("case", ["edges", "weights", "outside",
                                  "beyond-the-cut"])
def test_kernel_equals_plain_bit_for_bit(case):
    rng = np.random.RandomState(4)
    counts = rng.randint(1, 200, 150)
    counts[0] = counts[7] = 1
    if case == "beyond-the-cut":       # two queries past the 3,000-row cut
        counts = np.array([5000, 40, 1, 3100])
    score, args = _kernel_inputs(
        counts, seed=5, weighted=case == "weights",
        outside=(37, 101) if case == "outside" else (0, 0))
    before = rk.KERNELS["lambdarank_pairs"].launches
    got = rk.lambdarank_pairs(score, **args)
    again = rk.lambdarank_pairs(score, **args)
    torch.cuda.synchronize()
    assert rk.KERNELS["lambdarank_pairs"].launches == before + 2
    want = rk.lambdarank_grad_plain(score, **args)
    for a, b, c in zip(got, again, want):
        assert a.shape == c.shape == score.shape
        assert _bits_equal(a, b) and _bits_equal(a, c)
    if case == "outside":
        assert not got[0][0, :37].any() and not got[0][0, -101:].any()
    if case == "edges":
        assert torch.isnan(got[0]).any() and not torch.isnan(got[0]).all()
