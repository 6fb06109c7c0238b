"""Evaluation metrics."""

from .metrics import (AUCMetric, BinaryErrorMetric, BinaryLoglossMetric,
                      L1Metric, L2Metric, Metric, MultiErrorMetric,
                      MultiLoglossMetric, NDCGMetric, create_metric)

__all__ = ["Metric", "L1Metric", "L2Metric", "BinaryLoglossMetric",
           "BinaryErrorMetric", "AUCMetric", "MultiLoglossMetric",
           "MultiErrorMetric", "NDCGMetric", "create_metric"]
