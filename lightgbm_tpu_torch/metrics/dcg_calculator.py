"""DCG/NDCG calculator (the port's copy of
lightgbm_tpu/metrics/dcg_calculator.py; host numpy).

Reference: include/LightGBM/metric.h:56-123, src/metric/dcg_calculator.cpp:13-136.
Discount LUT 1/log2(2+i) for positions up to 10000; label gains 2^i - 1.
"""

import numpy as np

K_MAX_POSITION = 10000


class DCGCalculator:
    def __init__(self, label_gain):
        self.label_gain = np.asarray(label_gain, dtype=np.float64)
        self.discount = 1.0 / np.log2(2.0 + np.arange(K_MAX_POSITION, dtype=np.float64))

    def cal_dcg_at_k(self, k, labels, scores):
        """DCG@k of `scores` ranking against relevance `labels`."""
        labels = np.asarray(labels)
        order = np.argsort(-np.asarray(scores), kind="stable")
        k = min(int(k), len(labels))
        top = labels[order[:k]].astype(np.int64)
        return float(np.sum(self.label_gain[top] * self.discount[:k]))

    def cal_maxdcg_at_k(self, k, labels):
        """Ideal DCG@k (labels sorted descending)."""
        labels = np.asarray(labels).astype(np.int64)
        srt = np.sort(self.label_gain[labels])[::-1]
        k = min(int(k), len(labels))
        return float(np.sum(srt[:k] * self.discount[:k]))
