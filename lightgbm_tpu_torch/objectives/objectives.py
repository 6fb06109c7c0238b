"""Objective functions as tensor functions (port of
lightgbm_tpu/objectives/objectives.py :54, :79, :134 and :166).

Reference: src/objective/regression_objective.hpp,
binary_objective.hpp, multiclass_objective.hpp, rank_objective.hpp.
Scores and gradients are (num_class, N) float32 tensors on the training
device; the expressions keep the JAX package's operation order so the
float32 results round the same way. Every objective's get_gradients is
pure device work with no host sync, so the fused trainer captures it.
"""

import numpy as np
import torch

from ..utils.log import Log


def validate_labels(label, weights=None):
    """Non-finite labels or weights poison every gradient: fail at init
    with the offending row (lightgbm_tpu/utils/guardrails.py)."""
    for what, arr in (("Label", label), ("Weight", weights)):
        if arr is None:
            continue
        bad = ~np.isfinite(np.asarray(arr))
        if bad.any():
            row = int(np.argmax(bad))
            Log.fatal("%s contains non-finite value %r at row %d", what,
                      float(np.asarray(arr).reshape(-1)[row]), row)


class ObjectiveFunction:
    """Interface (include/LightGBM/objective_function.h:31-32)."""

    name = "none"

    def init(self, metadata, num_data, device):
        self.num_data = num_data
        self.device = device
        self.label = np.asarray(metadata.label, dtype=np.float32)
        self.weights = (None if metadata.weights is None
                        else np.asarray(metadata.weights, dtype=np.float32))
        validate_labels(self.label, self.weights)
        self._weights = (None if self.weights is None
                         else torch.from_numpy(self.weights).to(device))

    def get_gradients(self, score):
        """score: (K, N) tensor -> (grad, hess), each (K, N) float32."""
        raise NotImplementedError


class RegressionL2loss(ObjectiveFunction):
    """L2 regression (regression_objective.hpp:10-52)."""

    name = "regression"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self._label = torch.from_numpy(self.label).to(device)

    def get_gradients(self, score):
        s = score[0]
        if self._weights is not None:
            g = (s - self._label) * self._weights
            h = self._weights.expand_as(s)
        else:
            g = s - self._label
            h = torch.ones_like(s)
        return g[None, :], h[None, :]


class BinaryLogloss(ObjectiveFunction):
    """Binary logloss with sigmoid scaling / unbalance / scale_pos_weight
    (binary_objective.hpp:13-109)."""

    name = "binary"

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero",
                      self.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        cnt_positive = int(np.sum(self.label == 1))
        cnt_negative = num_data - cnt_positive
        Log.info("Number of postive: %d, number of negative: %d",
                 cnt_positive, cnt_negative)
        if cnt_positive == 0 or cnt_negative == 0:
            Log.fatal("Training data only contains one class")
        label_weights = [1.0, 1.0]
        if self.is_unbalance:
            if cnt_positive > cnt_negative:
                label_weights[0] = cnt_positive / cnt_negative
            else:
                label_weights[1] = cnt_negative / cnt_positive
        label_weights[1] *= self.scale_pos_weight
        pos = self.label == 1
        self._sign = torch.from_numpy(
            np.where(pos, 1.0, -1.0).astype(np.float32)).to(device)
        self._lw = torch.from_numpy(np.where(
            pos, label_weights[1], label_weights[0]).astype(np.float32)
        ).to(device)

    def get_gradients(self, score):
        s = score[0]
        sig = self.sigmoid
        sign = self._sign
        response = -2.0 * sign * sig / (1.0 + torch.exp(2.0 * sign * sig * s))
        abs_response = torch.abs(response)
        g = response * self._lw
        h = abs_response * (2.0 * sig - abs_response) * self._lw
        if self._weights is not None:
            g = g * self._weights
            h = h * self._weights
        return g[None, :], h[None, :]


class MulticlassLogloss(ObjectiveFunction):
    """Softmax multiclass (multiclass_objective.hpp:13-94)."""

    name = "multiclass"

    def __init__(self, config):
        self.num_class = int(config.num_class)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label_int = self.label.astype(np.int32)
        if label_int.min() < 0 or label_int.max() >= self.num_class:
            Log.fatal("Label must be in [0, %d), but found %d in label",
                      self.num_class, int(label_int.min() if label_int.min() < 0
                                          else label_int.max()))
        self._onehot = torch.from_numpy(np.ascontiguousarray(
            np.eye(self.num_class, dtype=np.float32)[label_int].T)).to(device)

    def get_gradients(self, score):
        # jax.nn.softmax's order: exp(x - max) over its sum, class axis
        e = torch.exp(score - score.amax(dim=0, keepdim=True))
        p = e / e.sum(dim=0, keepdim=True)                      # (K, N)
        g = p - self._onehot
        h = 2.0 * p * (1.0 - p)
        if self._weights is not None:
            g = g * self._weights[None, :]
            h = h * self._weights[None, :]
        return g, h


class LambdarankNDCG(ObjectiveFunction):
    """LambdaRank with NDCG weighting (rank_objective.hpp:19-227).

    The gradients run on the device through the padded-query pair
    program (rank_device.py), so lambdarank trains fused like the other
    objectives. The float64 host path (get_gradients_host) is kept as
    the accuracy reference, as in the JAX package.
    """

    name = "lambdarank"

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid param %f should be greater than zero", self.sigmoid)
        self.label_gain = np.asarray(config.label_gain, dtype=np.float64)
        self.optimize_pos_at = int(config.max_position)
        self.min_input = -50.0 / self.sigmoid / 2.0
        self.max_input = -self.min_input

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        from ..metrics.dcg_calculator import DCGCalculator
        from .rank_device import PaddedQueryLayout, make_lambdarank_gradfn
        self.dcg = DCGCalculator(self.label_gain)
        if metadata.query_boundaries is None:
            Log.fatal("Lambdarank tasks require query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        self.num_queries = len(self.query_boundaries) - 1
        self.inverse_max_dcgs = np.zeros(self.num_queries)
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            maxdcg = self.dcg.cal_maxdcg_at_k(self.optimize_pos_at,
                                              self.label[lo:hi])
            self.inverse_max_dcgs[q] = 1.0 / maxdcg if maxdcg > 0 else 0.0
        self.layout = PaddedQueryLayout(self.query_boundaries, num_data)
        self._grad = make_lambdarank_gradfn(
            self.layout, self.label, self.label_gain, self.sigmoid,
            self.optimize_pos_at, self.weights, device)

    def get_gradients(self, score):
        return self._grad(score.reshape(1, -1))

    def _sigmoid(self, x):
        x = np.clip(x, self.min_input, self.max_input)
        return 2.0 / (1.0 + np.exp(2.0 * x * self.sigmoid))

    def get_gradients_host(self, score):
        """The float64 per-query loop (objectives.py:205-256): (1, N)
        float64 numpy gradients and hessians."""
        score = np.asarray(score, dtype=np.float32).reshape(-1)
        grad = np.zeros_like(score, dtype=np.float64)
        hess = np.zeros_like(score, dtype=np.float64)
        discount = self.dcg.discount
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            cnt = hi - lo
            if cnt <= 1:
                continue
            s = score[lo:hi].astype(np.float64)
            lab = self.label[lo:hi].astype(np.int64)
            inv_max_dcg = self.inverse_max_dcgs[q]
            order = np.argsort(-s, kind="stable")
            rank_of = np.empty(cnt, dtype=np.int64)
            rank_of[order] = np.arange(cnt)
            best = s[order[0]]
            worst_idx = cnt - 1
            if worst_idx > 0 and s[order[worst_idx]] == -np.inf:
                worst_idx -= 1
            worst = s[order[worst_idx]]

            # pair matrix: i = high (larger label), j = low
            lg = self.label_gain[lab]
            dcg_gap = lg[:, None] - lg[None, :]
            pair_mask = dcg_gap > 0
            disc = discount[np.minimum(rank_of, len(discount) - 1)]
            paired_discount = np.abs(disc[:, None] - disc[None, :])
            delta_ndcg = dcg_gap * paired_discount * inv_max_dcg
            delta_score = s[:, None] - s[None, :]
            if best != worst:
                delta_ndcg = delta_ndcg / (0.01 + np.abs(delta_score))
            p_lambda = self._sigmoid(delta_score)
            p_hess = p_lambda * (2.0 - p_lambda)
            lam = -p_lambda * delta_ndcg * pair_mask
            hes = 2.0 * p_hess * delta_ndcg * pair_mask
            g = lam.sum(axis=1) - lam.sum(axis=0)
            h = hes.sum(axis=1) + hes.sum(axis=0)
            if self.weights is not None:
                g *= self.weights[lo:hi]
                h *= self.weights[lo:hi]
            grad[lo:hi] = g
            hess[lo:hi] = h
        return grad[None, :], hess[None, :]


def create_objective(name, config):
    """Factory (objective_function.cpp:9-20). None for "none"/"" (custom
    objectives)."""
    name = str(name).lower()
    if name == "regression":
        return RegressionL2loss()
    if name == "binary":
        return BinaryLogloss(config)
    if name == "multiclass":
        return MulticlassLogloss(config)
    if name == "lambdarank":
        return LambdarankNDCG(config)
    if name in ("none", ""):
        return None
    Log.fatal("Unknown objective type name: %s", name)
