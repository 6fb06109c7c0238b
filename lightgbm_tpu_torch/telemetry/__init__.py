"""Telemetry of the port (lightgbm_tpu/telemetry/): serving's and
training's.

- `registry.MetricsRegistry`: thread-safe counters, gauges and
  histograms; the serving /metricz accounting (serving/metrics.py) is
  built on it.
- `prometheus.render`: a registry in Prometheus text exposition
  (`?format=prometheus` on /metricz), with the naming contract
  (`canonical_name`, `lint_names`).
- `disttrace`: request tracing across processes (the X-Trace-Ctx
  header, tail-sampled spans written to a `journal.RunJournal`) and the
  crash flight recorder.
- `ledger.LEDGER`: set-up work a process pays before its first answer
  (kernel-library builds, per-bucket warm-up), and `sample_memory`.
- `quality`: the "coeff" feature importance of linear-leaf trees, the
  split ledger and the booster's `QualityTracker` (quality records).
- the training timeline: `journal` (the run journal, its schema, rank
  merging), `trace.SpanTracer` (a booster's phases), `comm_profile`
  (collective waits from the heartbeat timing sink), `history` (one
  run_summary a run), `roofline` (kernel calls timed by CUDA events
  against the card's copy peak) and `trainz` (the /trainz endpoint).

stdlib and numpy only; importing it touches no device.
"""

from . import (disttrace, journal, ledger, prometheus, quality,  # noqa: F401
               registry)
from .journal import RunJournal, read_journal  # noqa: F401
from .ledger import LEDGER, SetupLedger, sample_memory  # noqa: F401
from .registry import MetricsRegistry  # noqa: F401
