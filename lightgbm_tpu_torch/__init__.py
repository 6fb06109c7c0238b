"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

The JAX package beside it is the reference; this package imports
neither it nor JAX. Its entry points (`train`, `Booster.predict`, the
CLI `python -m lightgbm_tpu_torch task=train ...`) run on a CUDA device
unless the caller passes device="cpu", and raise when there is no card
and no device. On the card the histogram engines and the binning of a
dense float32 matrix are hand-written CUDA (csrc/hist.cu, csrc/seg_hist.cu,
csrc/compact.cu, csrc/compact_hist.cu and csrc/bin.cu, built with nvcc
at first use); on the CPU they are the kernels' plain PyTorch versions.

The port covers in-memory matrices, scipy sparse matrices, CSV/TSV/LibSVM
files (in memory or streamed in two rounds) and the binary dataset
cache, with numerical and categorical
features under the binary, L2, multiclass and lambdarank objectives
(with weights, query groups, init scores and custom objectives and
metrics), the serial learner with the gather-compacted, masked and
frontier histogram engines (the JAX learner's selection off the TPU:
compacted above 4,096 rows by default) or the leaf-contiguous builder
(partitioned_build=true), the fused
multi-iteration trainer (one boosting iteration captured as a CUDA
graph and replayed), continued training, cv, prediction and serving,
the scikit-learn estimators (sklearn.py; they run without scikit-learn
too) and the C API (capi_bridge.py behind lib_lightgbm_torch.so, built
from native/c_api_shim.cpp at first use).
ROADMAP.md lists the modules still to port.
"""

from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .engine import cv, train
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Dataset", "Booster", "LightGBMError", "train", "cv",
           "print_evaluation", "record_evaluation", "reset_parameter",
           "early_stopping", "EarlyStopException", "LGBMModel",
           "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]

_ESTIMATORS = ("LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker")


def __getattr__(name):
    # the estimators load sklearn.py, and scikit-learn with it where it
    # is installed, at their first use, not with the package
    if name in _ESTIMATORS:
        from . import sklearn
        return getattr(sklearn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
