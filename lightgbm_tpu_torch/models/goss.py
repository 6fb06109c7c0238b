"""GOSS (Gradient-based One-Side Sampling) boosting; port of
lightgbm_tpu/models/goss.py.

Keep the top_rate fraction of rows by gradient magnitude, sample
other_rate of the rest uniformly, and amplify the sampled rest by
n_rest / rand_n so that split gains stay unbiased. The sample is a
fractional in-bag weight vector: the builders multiply the gradient,
hessian and count columns by `inbag` (models/tree_learner.py
build_tree_device, models/partitioned.py), so amplified rows add
weighted statistics, weighted counts included (min_data_in_leaf acts on
weighted rows), and out-of-bag rows still get their score updates
through the full-row partition. Row score = sum over classes of |g * h|,
with a plain-boosting warm-up of ceil(1 / learning_rate) iterations.

The weights are torch operations on the gradients' device with no host
sync, so the fused trainer computes them inside its captured iteration
(GBDT._fused_weights_fn) and the per-iteration loop calls the same
function: both draw the same sample. The uniform draw is not
jax.random's: it is a counter-based hash of (bagging_seed, iteration,
row) in int64 torch operations (goss_uniform), which gives the same bits
on the CPU and the card, per iteration or replayed, whatever the
iteration number's device. Tests that compare trees with the JAX package
give both packages one weight vector.
"""

import numpy as np
import torch

from ..utils.log import Log
from .gbdt import GBDT

_MASK32 = 0xFFFFFFFF
# multipliers below 2^31: a 32-bit value times one stays inside int64
_MIX_MUL = 0x045D9F3B
_ITER_MUL = 0x27D4EB2D
_ROW_MUL = 0x165667B1
# keeps (seed 0, iteration 0) off the hash's fixed point at 0
_KEY_ADD = 0x3C6EF372


def _mix32(h):
    """A 32-bit integer hash of an int64 tensor of 32-bit values: two
    xorshift-multiply rounds and a final xorshift."""
    h = (((h >> 16) ^ h) * _MIX_MUL) & _MASK32
    h = (((h >> 16) ^ h) * _MIX_MUL) & _MASK32
    return (h >> 16) ^ h


def goss_uniform(seed, it, n, device):
    """(n,) float32 uniforms in [0, 1) for iteration `it` (a host int or
    an int64 tensor on `device`): u[r] = (hash(seed, it, r) >> 8) *
    2^-24, exact in float32."""
    it = torch.as_tensor(it, dtype=torch.int64, device=device).reshape(-1)
    key = _mix32((it * _ITER_MUL + (int(seed) & _MASK32) + _KEY_ADD)
                 & _MASK32)
    rows = torch.arange(n, dtype=torch.int64, device=device)
    h = _mix32(((rows * _ROW_MUL) & _MASK32) ^ key)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


class GOSS(GBDT):
    name = "goss"

    def init(self, config, train_data, objective, training_metrics=()):
        super().init(config, train_data, objective, training_metrics)
        if not (0.0 <= config.top_rate <= 1.0
                and 0.0 <= config.other_rate <= 1.0
                and config.top_rate + config.other_rate <= 1.0):
            Log.fatal("GOSS needs top_rate >= 0, other_rate >= 0 and "
                      "top_rate + other_rate <= 1.0 (got %g, %g)",
                      config.top_rate, config.other_rate)
        if config.bagging_fraction < 1.0 and config.bagging_freq > 0:
            Log.fatal("Cannot use bagging in GOSS (bagging_fraction/"
                      "bagging_freq conflict with gradient-based sampling)")
        self._warmup = int(np.ceil(1.0 / max(config.learning_rate, 1e-6)))

    def _goss_weights(self, it, gradients, hessians):
        """(K, N) device gradients -> (N,) float32 in-bag weights on
        their device (goss.py:50-87); `it` a host int or an int64 device
        tensor. Ties at the threshold land in the top set, and both the
        sampling probability p = rand_n / n_rest and the amplification
        n_rest / rand_n are float32, so that E[#sampled] = rand_n and
        p * amp = 1. (The JAX function also takes padded rows; the
        port's gradients hold num_data rows.)"""
        cfg = self.config
        n = self.num_data
        dev = gradients.device
        score = (gradients * hessians).abs().sum(dim=0)
        top_n = max(1, int(cfg.top_rate * n))
        rand_n = int(cfg.other_rate * n)
        thr = torch.sort(score).values[n - top_n]
        top = score >= thr
        weights = top.to(torch.float32)
        if rand_n > 0:
            n_rest = (~top).sum().clamp(min=1).to(torch.float32)
            rand_f = torch.full((), float(rand_n), dtype=torch.float32,
                                device=dev)
            p = rand_f / n_rest
            amp = n_rest / rand_f
            u = goss_uniform(cfg.bagging_seed, it, n, dev)
            weights = torch.where(~top & (u < p), amp, weights)
        if isinstance(it, torch.Tensor):
            # warm-up iterations train on all rows
            weights = torch.where(it < self._warmup,
                                  torch.ones_like(weights), weights)
        return weights

    def _fused_boosting_ok(self):
        return True  # the sample is drawn inside the captured iteration

    def _fused_weights_fn(self):
        return self._goss_weights

    def _bagging(self, it, gradients=None, hessians=None):
        if gradients is None or it < self._warmup:
            return None
        w = self._goss_weights(
            it, gradients.reshape(self.num_class, -1),
            hessians.reshape(self.num_class, -1))
        Log.debug("GOSS: re-sampled at iteration %d", it)
        return w
