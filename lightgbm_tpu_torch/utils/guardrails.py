"""Non-finite guardrails: detect NaN/Inf training state early.

A copy of lightgbm_tpu/utils/guardrails.py (first_nonfinite, describe,
guard_gradients, guard_scores): the port must word its diagnostics and
apply its policies as the JAX package does. The functions take host
(numpy) arrays; the boosting loop (models/gbdt.py) keeps the check off
the host until a device-side finiteness flag says something is wrong.

The `nonfinite_guard` policy is applied to gradients/hessians before
every tree of the per-iteration loop and to scores at fused-block
boundaries:

- ``raise`` (default): abort with a diagnostic naming the first
  offending (class, row) pair and the offending value;
- ``warn_skip``: log a warning and skip the boosting round (no tree is
  appended for it);
- ``clamp``: sanitize — NaN -> 0, +-Inf -> +-CLAMP_MAGNITUDE — and log
  once per offending iteration;
- ``off``: no checks (no host sync on the guarded paths).
"""

import numpy as np

from .log import LightGBMError, Log

POLICIES = ("raise", "warn_skip", "clamp", "off")

# Inf replacement under `clamp`: large enough to dominate any sane
# gradient, small enough that a full histogram's f32 accumulation
# (<= ~2^24 rows per bin) stays finite.
CLAMP_MAGNITUDE = 1e15


def first_nonfinite(arr):
    """(class_idx, row_idx, value) of the first non-finite entry of a
    (num_class, num_data)-shaped array, or None when all finite."""
    a = np.asarray(arr)
    flat = a.reshape(-1)
    bad = ~np.isfinite(flat)
    if not bad.any():
        return None
    idx = int(np.argmax(bad))
    cols = a.shape[-1] if a.ndim > 1 else flat.shape[0]
    return idx // cols, idx % cols, float(flat[idx])


def describe(what, iteration, cls, row, value):
    return (f"Non-finite {what} at iteration {iteration}: class {cls}, "
            f"row {row} is {value!r}. A custom objective returning "
            "NaN/Inf or a divergent learning_rate is the usual cause; "
            "set nonfinite_guard=warn_skip|clamp to train through it, "
            "or nonfinite_guard=off to disable this check.")


def guard_gradients(gradients, hessians, iteration, policy):
    """Apply the policy to a gradient/hessian pair.

    Returns (gradients, hessians, skip): `skip` True means the caller
    must skip this boosting round (warn_skip). Under `clamp` the
    returned arrays are sanitized host copies. Raises LightGBMError
    under `raise`."""
    if policy in ("off", None):
        return gradients, hessians, False
    for what, arr in (("gradient", gradients), ("hessian", hessians)):
        hit = first_nonfinite(arr)
        if hit is None:
            continue
        msg = describe(what, iteration, *hit)
        if policy == "raise":
            raise LightGBMError(msg)
        if policy == "warn_skip":
            Log.warning("%s Skipping this boosting round.", msg)
            return gradients, hessians, True
        # clamp
        Log.warning("%s Clamping (NaN->0, Inf->+-%g).", msg,
                    CLAMP_MAGNITUDE)
        gradients = np.nan_to_num(
            np.asarray(gradients, dtype=np.float32), nan=0.0,
            posinf=CLAMP_MAGNITUDE, neginf=-CLAMP_MAGNITUDE)
        hessians = np.nan_to_num(
            np.asarray(hessians, dtype=np.float32), nan=0.0,
            posinf=CLAMP_MAGNITUDE, neginf=-CLAMP_MAGNITUDE)
    return gradients, hessians, False


def guard_scores(score, iteration, policy, what="model score"):
    """Score guard (fused-block boundaries). Scores cannot be
    meaningfully clamped mid-training, so every non-`off` policy
    detects; only `raise` aborts."""
    if policy in ("off", None):
        return
    hit = first_nonfinite(score)
    if hit is None:
        return
    msg = describe(what, iteration, *hit)
    if policy == "raise":
        raise LightGBMError(msg)
    Log.warning("%s", msg)
