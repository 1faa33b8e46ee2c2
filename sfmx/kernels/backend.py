"""The one place that chooses an implementation for the device.

- ``gpu``: the hand-written Hopper kernels that measured faster than XLA on
  an H100 (``sfmx.kernels.top2``).
- ``cpu``: the plain JAX references.  The tests and CPU users run these.

Any other platform raises: no path falls back silently, and no kernel runs
in interpret mode unless a test asks for it.
"""
from __future__ import annotations

import jax

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """The default backend, checked against the platforms sfmx supports."""
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(
            f"sfmx runs on {' or '.join(PLATFORMS)}; JAX's default backend "
            f"is {p!r}")
    return p


def use_kernels() -> bool:
    """True where the hand-written kernels run (the GPU)."""
    return platform() == "gpu"
