"""Online inference: frozen predictor, micro-batching queue, HTTP
endpoint, drift and skew monitors (the port of lightgbm_tpu/serving/).

The device work is the traversal kernels of csrc/traverse.cu
(ops/traverse_kernels.py); everything else is stdlib and numpy. The
top-level package does not import this one, so training never loads
the serving stack.
"""

from .batcher import DeadlineExceeded, MicroBatcher
from .compiled_model import CompiledPredictor
from .metrics import ServingMetrics
from .server import build_monitors, drain, make_server, swap_model

__all__ = ["CompiledPredictor", "DeadlineExceeded", "MicroBatcher",
           "ServingMetrics", "build_monitors", "drain", "make_server",
           "swap_model"]
