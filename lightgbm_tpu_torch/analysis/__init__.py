"""The port's own AST lint: the engine of lightgbm_tpu/analysis/,
copied, and rules aimed at lightgbm_tpu_torch/ and chip_smoke.py.

The port keeps the JAX package's contracts in its own idioms; these
rules check them (each rule module states its provenance):

- ``unguarded-collective``  blocking device syncs (``.item()``,
                            ``.tolist()``, ``.cpu()``,
                            ``torch.cuda.synchronize``, the
                            ``torch.distributed`` calls, a work handle's
                            ``.wait()``) in ``parallel/``, ``data/`` and
                            ``models/`` outside ``collective_guard``
- ``non-atomic-shared-write``  shared run artifacts written without the
                            tmp+fsync+rename / append-only discipline
- ``precision-contract``    ``torch.float64`` in device builder code,
                            f32 accumulation in documented-f64 host
                            reductions, raw ``float()`` on Kahan pairs
- ``nondeterminism``        wall clocks / unseeded RNG in modules under
                            the bit-parity and byte-equal-resume contracts
- ``journal-schema``        journal ``.event()`` record types missing
                            from telemetry/journal.py SCHEMA
- ``prometheus-naming``     metric name literals that violate the
                            exposition naming contract (the port's
                            telemetry/prometheus.py lint_family_name)
- ``config-doc-drift``      config.py knobs without a row in
                            docs/Parameters.md or the README's port
                            section, or without a read site
- ``unbounded-io``          outbound network calls in serving/ without
                            a timeout
- ``trace-context-propagation``  outbound HTTP calls in serving/ that
                            set headers without disttrace.inject_headers
- ``no-jax-import``         an import of ``jax`` or ``lightgbm_tpu`` in
                            the port or chip_smoke.py (the port's own)

The JAX package's ``callback-in-mesh`` has no counterpart: the port
runs no host callbacks inside shard_map programs.

Stdlib ``ast`` only. It has a REGISTRY of its own, so loading these
rules leaves lightgbm_tpu.analysis's untouched. Suppression: inline
``# graftlint: disable=<rule>`` pragmas (same or preceding line) and the
committed baseline ``lightgbm_tpu_torch/analysis/lint_baseline.json``
(every entry carries a justification). CLI:

    python -m lightgbm_tpu_torch.analysis [--json out.json] [--self-check]
"""

from .core import (REGISTRY, Fixture, ParsedFile, Project, Rule,
                   Severity, Violation, register)
from .engine import lint_project, load_rules
from .baseline import Baseline

__all__ = ["REGISTRY", "Fixture", "ParsedFile", "Project", "Rule",
           "Severity", "Violation", "register", "lint_project",
           "load_rules", "Baseline"]
