"""Telemetry of the port's serving path (lightgbm_tpu/telemetry/, the
part serving reads).

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

stdlib and numpy only; importing it touches no device.
"""

from . import disttrace, journal, ledger, prometheus, registry  # noqa: F401
from .journal import RunJournal, read_journal  # noqa: F401
from .ledger import LEDGER, SetupLedger, sample_memory  # noqa: F401
from .registry import MetricsRegistry  # noqa: F401
