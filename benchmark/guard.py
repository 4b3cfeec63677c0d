"""What a run may not have loaded: JAX, the libraries around it, the JAX
package and its measuring scripts. Modules are compared by their top-level
name, whole: ``stereo_depth_estimation_tpu_torch`` is allowed although its
name begins with the JAX package's."""

from __future__ import annotations

import sys

BANNED = frozenset({
    "jax", "jaxlib", "flax", "optax", "orbax",
    "stereo_depth_estimation_tpu", "bench", "chip_smoke", "augment_timing",
})


def banned_modules(names=None) -> list[str]:
    """The loaded modules (or ``names``) whose top-level name is banned."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)
