"""Hot-swap serving: load and warm a challenger behind the incumbent,
flip atomically under the batcher, follow a registry (the port's copy
of lightgbm_tpu/fleet/hotswap.py).

The flip discipline:

1. the challenger `CompiledPredictor` is built on the incumbent's
   device and `warm_up()`-ed BEFORE the incumbent sees any change —
   every row bucket launches the traversal kernel once and copies its
   answer back to the host (serving/compiled_model.py), so the
   challenger's uploads and its kernel library are complete while the
   incumbent keeps serving;
2. the batcher's predictor reference swaps under the batcher lock —
   the worker snapshots the predictor once per coalesced batch, so a
   batch is scored ENTIRELY by one model version, never mixed;
3. the handler-facing surfaces (health/metricz stats, drift + skew
   monitors) follow after the flip: monitoring lag is cosmetic, score
   provenance is not.

`RegistryFollower` is the polling thread behind `python -m
lightgbm_tpu_torch.serve --registry DIR --follow`: a promotion (or
rollback — it's just another pointer move) lands in the running server
without a restart, in-flight requests drain onto the new model, and
`cold_dispatches` stays 0 across the flip.
"""

import os
import threading
import time

from ..utils.log import Log

DEFAULT_POLL_S = 2.0


class HotSwapper:
    """Loads registry versions into warmed CompiledPredictors and flips
    a live server to them. One per serving process."""

    def __init__(self, srv, registry, serving_precision=None,
                 max_batch_rows=None, num_iteration=None,
                 monitor_settings=None):
        self.srv = srv
        self.registry = registry
        incumbent = srv.predictor
        self.serving_precision = (serving_precision
                                  or getattr(incumbent,
                                             "serving_precision", "f32"))
        self.max_batch_rows = int(max_batch_rows
                                  or getattr(incumbent, "max_batch_rows",
                                             0) or 4096)
        # a challenger serves where the incumbent does: a `--device cpu`
        # server must not swap onto the card (or raise where none is)
        self.device = getattr(incumbent, "device", None)
        # the server's --num-iteration knob must survive a swap: a
        # server of truncated ensembles keeps serving truncated
        # ensembles across promotions
        self.num_iteration = int(
            num_iteration if num_iteration is not None
            else getattr(srv, "num_iteration", -1))
        # the drift/skew knobs the server was started with — a swapped
        # model gets monitors rebuilt against ITS baseline profile
        self.monitor_settings = dict(monitor_settings
                                     or getattr(srv, "monitor_settings",
                                                None) or {})
        self._lock = threading.Lock()
        self.stats = {"swap_count": 0, "last_swap_s": 0.0,
                      "last_warmup_s": 0.0, "failed_swaps": 0}

    def load_version(self, version):
        """Build and warm a CompiledPredictor for one registry version
        (manifest verified first) on the incumbent's device. Pure load —
        the incumbent is untouched."""
        from ..serving.compiled_model import CompiledPredictor
        self.registry.verify(version)
        model_path = self.registry.model_path(version)
        return CompiledPredictor.from_model_file(
            model_path, num_iteration=self.num_iteration,
            max_batch_rows=self.max_batch_rows,
            serving_precision=self.serving_precision, device=self.device)

    def swap_to(self, version, reason=""):
        """Load, warm, and atomically flip the server to `version`.
        Returns the retired predictor. Raises RegistryError on a
        version that fails verification."""
        from ..serving.server import build_monitors, swap_model
        t0 = time.monotonic()
        with self._lock:   # one swap in flight at a time
            predictor = self.load_version(version)
            drift, skew = build_monitors(predictor,
                                         **self.monitor_settings)
            old = swap_model(self.srv, predictor, drift=drift, skew=skew,
                             version=int(version))
            self.stats["swap_count"] += 1
            self.stats["last_warmup_s"] = predictor.stats["warmup_s"]
            self.stats["last_swap_s"] = round(time.monotonic() - t0, 3)
        Log.structured(
            "Info", "hot_swap", version=int(version),
            reason=str(reason or ""),
            swap_s=self.stats["last_swap_s"],
            warmup_s=self.stats["last_warmup_s"],
            compile_cache_hits=predictor.stats["compile_cache_hits"])
        return old


class RegistryFollower:
    """Background thread that polls the registry CURRENT pointer and
    hot-swaps the server whenever the live version (or generation —
    a rollback re-promotes an older version) changes."""

    # a permanently-broken promotion (parser-rejected model, local bit
    # rot) must not re-verify + re-warm every poll forever: after
    # MAX_ATTEMPTS failures on one generation the follower parks until
    # the pointer moves again
    MAX_ATTEMPTS = 5

    def __init__(self, swapper, poll_s=DEFAULT_POLL_S):
        self.swapper = swapper
        self.poll_s = float(poll_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="registry-follower",
                                        daemon=True)
        self._seen_generation = None
        self._failed_generation = None
        self._failed_attempts = 0

    def start(self):
        # seed with the CURRENT generation so following a registry the
        # server was just started from does not immediately re-swap
        cur = self.swapper.registry.current()
        if cur is not None and self.swapper.srv.model_version == int(
                cur["version"]):
            self._seen_generation = int(cur.get("generation", 0))
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        self._thread.join(timeout=timeout)

    def poll_once(self):
        """One poll step (the thread loop body; tests call it
        directly). Returns the version swapped to, or None."""
        cur = self.swapper.registry.current()
        if cur is None:
            return None
        generation = int(cur.get("generation", 0))
        if generation == self._seen_generation:
            return None
        if (generation == self._failed_generation
                and self._failed_attempts >= self.MAX_ATTEMPTS):
            return None   # parked until the pointer moves again
        version = int(cur["version"])
        try:
            self.swapper.swap_to(version,
                                 reason=cur.get("reason", "registry"))
        except Exception as e:
            # ANY load/verify failure (torn publish, CRC mismatch, a
            # model file the parser rejects) must not kill the
            # follower — it counts as a failed swap, the incumbent
            # keeps serving, and the next poll retries (bounded by
            # MAX_ATTEMPTS per generation)
            self.swapper.stats["failed_swaps"] += 1
            if generation != self._failed_generation:
                self._failed_generation, self._failed_attempts = \
                    generation, 0
            self._failed_attempts += 1
            Log.warning(
                "registry follower: swap to v%d failed (attempt %d/%d"
                "%s): %s", version, self._failed_attempts,
                self.MAX_ATTEMPTS,
                "; parked until the pointer moves"
                if self._failed_attempts >= self.MAX_ATTEMPTS else "",
                e)
            return None
        self._seen_generation = generation
        self._failed_generation, self._failed_attempts = None, 0
        return version

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:   # never die; the server outlives us
                Log.warning("registry follower poll failed: %s", e)
            self._stop.wait(self.poll_s)


def attach_follower(srv, registry_dir, poll_s=DEFAULT_POLL_S,
                    serving_precision=None):
    """Wire a HotSwapper + RegistryFollower onto a running server
    (the `--registry --follow` path). Returns the started follower."""
    from .registry import ModelRegistry
    registry = (registry_dir if hasattr(registry_dir, "current")
                else ModelRegistry(os.fspath(registry_dir)))
    swapper = HotSwapper(srv, registry,
                         serving_precision=serving_precision)
    follower = RegistryFollower(swapper, poll_s=poll_s).start()
    srv.follower = follower
    return follower
