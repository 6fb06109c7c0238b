"""The port's rule modules. Importing this package registers every rule
(``@register`` in each module populates the port's ``core.REGISTRY``)."""

from . import (atomic_writes, collectives, config_doc, determinism,
               imports, journal_schema, precision, prom_naming,
               trace_context, unbounded_io)  # noqa: F401
