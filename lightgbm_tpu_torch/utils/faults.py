"""Fault injection for the serving path (the serving chaos hooks of
lightgbm_tpu/utils/faults.py).

Activation is env- or API-driven:

- env: ``LIGHTGBM_TPU_FAULTS="slow_replica_ms=120,error_rate=10"``
  (read once per process at import; re-read with `reload_from_env`).
- API: ``faults.set_fault("wedge_batcher", 1)`` / `clear_faults()`;
  `injected_faults` is the context-manager form that always restores the
  previous state.

Serving chaos faults (serving/server.py, serving/batcher.py), readable
through a per-server overrides dict (`serving_chaos`) so a test can slow
ONE in-process replica while its siblings stay healthy; the env/API
global still applies to every server that has no override:

- ``slow_replica_ms`` (milliseconds): every predict handler sleeps that
  long before dispatch — a degraded/overcommitted replica.
- ``error_rate`` (integer percent): that share of predict requests fail
  with an injected 500. Firing is DETERMINISTIC (Bresenham over a
  request counter, `error_rate_fires`), no RNG.
- ``drop_connection`` (count): the next k predict replies close the
  socket without writing a response.
- ``wedge_batcher`` (flag): the MicroBatcher worker parks before taking
  work until the fault clears — the queue grows and admission control
  must shed; clearing the fault un-wedges without a restart.

The training faults (crashes, checkpoint corruption, rank faults) come
with the port's fault-tolerance slice.
"""

import os

ENV_VAR = "LIGHTGBM_TPU_FAULTS"

_active = {}


def _parse_spec(spec):
    out = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, value = item.partition("=")
        name = name.strip()
        if not name:
            continue
        try:
            out[name] = int(value) if value else 1
        except ValueError:
            out[name] = value.strip()
    return out


def reload_from_env():
    """Replace the active fault set with $LIGHTGBM_TPU_FAULTS."""
    _active.clear()
    _active.update(_parse_spec(os.environ.get(ENV_VAR, "")))


def set_fault(name, value=1):
    _active[name] = value


def clear_faults():
    _active.clear()


def active():
    return dict(_active)


def get(name, default=None):
    return _active.get(name, default)


def consume(name):
    """Count-based faults: True (and decrement) while the counter is
    positive; a negative counter fires forever."""
    count = _active.get(name)
    if not isinstance(count, int) or count == 0:
        return False
    if count > 0:
        _active[name] = count - 1
    return True


class injected_faults:
    """Context manager arming a fault set and restoring the previous
    state on exit (the test suite's idiom)."""

    def __init__(self, **faults):
        self._faults = faults
        self._saved = None

    def __enter__(self):
        self._saved = dict(_active)
        _active.update(self._faults)
        return self

    def __exit__(self, *exc):
        _active.clear()
        _active.update(self._saved)
        return False


# ------------------------------------------------------- serving chaos

def serving_chaos(overrides=None):
    """Merged fault view for the serving layer: the process-global
    fault set overlaid with a per-server overrides dict (so one
    in-process replica can be slowed/broken while siblings sharing the
    process-global table stay healthy)."""
    merged = dict(_active)
    if overrides:
        merged.update(overrides)
    return merged


def consume_from(name, overrides=None):
    """Count-based consume honoring a per-server overrides dict first:
    decrements the override counter when the name is overridden there,
    the global counter otherwise. Negative counters fire forever."""
    if overrides is not None and name in overrides:
        count = overrides.get(name)
        if not isinstance(count, int) or count == 0:
            return False
        if count > 0:
            overrides[name] = count - 1
        return True
    return consume(name)


def error_rate_fires(state, rate):
    """Deterministic percent-based firing for ``error_rate``: `rate` is
    an integer percent; request k fires when floor(k*rate/100) advances
    (Bresenham), so EXACTLY rate% of requests fail with no RNG — chaos
    assertions stay exact and reproducible. `state` is a mutable dict
    owned by the caller (one per server)."""
    try:
        rate = int(rate)
    except (TypeError, ValueError):
        return False
    if rate <= 0:
        return False
    rate = min(100, rate)
    state["seen"] = state.get("seen", 0) + 1
    should_have_fired = (state["seen"] * rate) // 100
    if should_have_fired > state.get("fired", 0):
        state["fired"] = should_have_fired
        return True
    return False


reload_from_env()
