"""lightgbm_tpu_torch's LambdaRank pair gradients on the card.

The fused trainer captures the objective's gradients in its CUDA graph
of one boosting iteration, so the padded-query program must capture:
no host sync, no data-dependent shape. These tests capture it alone and
in the fused trainer and hold the replays to the eager call bit for
bit; the eager call to the host float64 path within 2e-4 of the
largest |value| (tests/test_rank_device.py's bound for the JAX
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
from lightgbm_tpu_torch.objectives import create_objective

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
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = obj.get_gradients(score)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))
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
