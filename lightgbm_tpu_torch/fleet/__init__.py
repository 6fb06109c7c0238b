"""Fleet subsystem of the port (lightgbm_tpu/fleet/): the model
registry, hot-swap serving and the registry follower.

- `registry.ModelRegistry` — versioned on-disk store of model +
  profile sidecar + metadata with atomic publish (tmp+fsync+rename,
  CRC manifest like the block store) and promote/rollback pointers;
  the JAX package's layout, so either package reads the other's
  registry;
- `hotswap` — load and warm a challenger CompiledPredictor on the
  incumbent's device, flip atomically under the micro-batcher, and a
  registry follower so a running server picks up promotions without
  restart (`python -m lightgbm_tpu_torch.serve --registry DIR
  --follow`);
- `python -m lightgbm_tpu_torch.fleet` — the registry admin CLI.

The front-door router, the load generator and the drift -> retrain ->
promote pipeline are not ported yet (ROADMAP queue 1 item 7).

`hotswap` reaches the serving stack only when it loads a version.
"""

from .registry import ModelRegistry, RegistryError

__all__ = ["ModelRegistry", "RegistryError"]
