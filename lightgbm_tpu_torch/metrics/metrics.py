"""Evaluation metrics (port of lightgbm_tpu/metrics/metrics.py).

Reference: src/metric/regression_metric.hpp, binary_metric.hpp,
multiclass_metric.hpp, rank_metric.hpp, factory
src/metric/metric.cpp:9-28. Metrics evaluate on the host
(numpy) on scores pulled from the device once per metric_freq
iterations; that is never the training bottleneck. The reference's `l2`
metric reports sqrt(mean squared error); reproduced as-is.
"""

import numpy as np

from ..utils.log import Log
from .dcg_calculator import DCGCalculator

K_EPSILON = 1e-15


class Metric:
    names = ()
    factor_to_bigger_better = -1.0

    def __init__(self, config=None):
        pass

    def init(self, metadata, num_data):
        self.num_data = num_data
        self.label = np.asarray(metadata.label, dtype=np.float64)
        self.weights = (None if metadata.weights is None
                        else np.asarray(metadata.weights, dtype=np.float64))
        self.sum_weights = (float(num_data) if self.weights is None
                            else float(np.sum(self.weights)))

    def eval(self, score):
        """score: flat (K*N,) host array, class-major. Returns list of doubles."""
        raise NotImplementedError

    def _weighted_mean(self, loss):
        if self.weights is None:
            return float(np.sum(loss) / self.sum_weights)
        return float(np.sum(loss * self.weights) / self.sum_weights)


class L2Metric(Metric):
    names = ("l2",)

    def eval(self, score):
        d = np.asarray(score, dtype=np.float64)[:self.num_data] - self.label
        return [float(np.sqrt(self._weighted_mean(d * d)))]


class L1Metric(Metric):
    names = ("l1",)

    def eval(self, score):
        d = np.abs(np.asarray(score, dtype=np.float64)[:self.num_data] - self.label)
        return [self._weighted_mean(d)]


class _BinaryMetric(Metric):
    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should greater than zero", self.sigmoid)

    def _prob(self, score):
        s = np.asarray(score, dtype=np.float64)[:self.num_data]
        return 1.0 / (1.0 + np.exp(-2.0 * self.sigmoid * s))


class BinaryLoglossMetric(_BinaryMetric):
    names = ("logloss",)  # display name per binary_metric.hpp:119

    def eval(self, score):
        p = np.clip(self._prob(score), K_EPSILON, 1.0 - K_EPSILON)
        loss = np.where(self.label == 0, -np.log(1.0 - p), -np.log(p))
        return [self._weighted_mean(loss)]


class BinaryErrorMetric(_BinaryMetric):
    names = ("error",)  # display name per binary_metric.hpp:138

    def eval(self, score):
        p = self._prob(score)
        loss = np.where(p < 0.5, self.label, 1.0 - self.label)
        return [self._weighted_mean(loss)]


class AUCMetric(Metric):
    """Sort-based weighted AUC (binary_metric.hpp:145-251)."""

    names = ("auc",)
    factor_to_bigger_better = 1.0

    def eval(self, score):
        s = np.asarray(score, dtype=np.float64)[:self.num_data]
        w = self.weights if self.weights is not None else np.ones_like(s)
        order = np.argsort(-s, kind="stable")
        lab = self.label[order]
        ws = w[order]
        pos = lab * ws
        neg = (1.0 - lab) * ws
        # group ties on score: accumulate trapezoid per distinct score
        ss = s[order]
        # boundaries of equal-score groups
        new_group = np.empty(len(ss), dtype=bool)
        if len(ss):
            new_group[0] = True
            new_group[1:] = ss[1:] != ss[:-1]
        gid = np.cumsum(new_group) - 1
        ngroups = gid[-1] + 1 if len(ss) else 0
        gpos = np.bincount(gid, weights=pos, minlength=ngroups)
        gneg = np.bincount(gid, weights=neg, minlength=ngroups)
        sum_pos_before = np.concatenate([[0.0], np.cumsum(gpos)[:-1]])
        accum = float(np.sum(gneg * (gpos * 0.5 + sum_pos_before)))
        sum_pos = float(np.sum(gpos))
        if sum_pos > 0.0 and sum_pos != self.sum_weights:
            return [accum / (sum_pos * (self.sum_weights - sum_pos))]
        return [1.0]


class _MulticlassMetric(Metric):
    def __init__(self, config):
        self.num_class = int(config.num_class)

    def _probs(self, score):
        s = np.asarray(score, dtype=np.float64)
        n = self.num_data
        mat = np.stack([s[k * n:(k + 1) * n] for k in range(self.num_class)], axis=1)
        m = mat.max(axis=1, keepdims=True)
        e = np.exp(mat - m)
        return e / e.sum(axis=1, keepdims=True)  # (N, K)


class MultiLoglossMetric(_MulticlassMetric):
    names = ("multi_logloss",)

    def eval(self, score):
        p = self._probs(score)
        idx = self.label.astype(np.int64)
        pl = np.clip(p[np.arange(self.num_data), idx], K_EPSILON, None)
        return [self._weighted_mean(-np.log(pl))]


class MultiErrorMetric(_MulticlassMetric):
    names = ("multi_error",)

    def eval(self, score):
        p = self._probs(score)
        pred = np.argmax(p, axis=1)
        loss = (pred != self.label.astype(np.int64)).astype(np.float64)
        return [self._weighted_mean(loss)]


class NDCGMetric(Metric):
    """NDCG@k averaged over queries with query weights
    (rank_metric.hpp:16-165), over the padded-query layout in one
    argsort (rank_device.ndcg_eval_padded)."""

    factor_to_bigger_better = 1.0

    def __init__(self, config):
        self.eval_at = tuple(config.ndcg_eval_at)
        self.names = tuple(f"ndcg@{k}" for k in self.eval_at)
        self.dcg = DCGCalculator(config.label_gain)

    def init(self, metadata, num_data):
        from ..objectives.rank_device import PaddedQueryLayout
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("The NDCG metric requires query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        self.num_queries = len(self.query_boundaries) - 1
        self.query_weights = metadata.query_weights
        self.layout = PaddedQueryLayout(self.query_boundaries, num_data)

    def eval(self, score):
        from ..objectives.rank_device import ndcg_eval_padded
        s = np.asarray(score, dtype=np.float64)[:self.num_data]
        return ndcg_eval_padded(self.layout, self.label, self.dcg.label_gain,
                                self.eval_at, s, self.query_weights)


def create_metric(name, config):
    """Factory (metric.cpp:9-28). Returns None for unknown names."""
    name = str(name).lower()
    if name == "l2":
        return L2Metric()
    if name == "l1":
        return L1Metric()
    if name == "binary_logloss":
        return BinaryLoglossMetric(config)
    if name == "binary_error":
        return BinaryErrorMetric(config)
    if name == "auc":
        return AUCMetric(config)
    if name == "ndcg":
        return NDCGMetric(config)
    if name == "multi_logloss":
        return MultiLoglossMetric(config)
    if name == "multi_error":
        return MultiErrorMetric(config)
    return None
